"""Decode kernels the JAX package keeps in its ``ops/experimental``, as
counterparts of its modules of the same names.

* ``decode_kernel_v8``: latency mode, one launch per chunk of tokens (a
  persistent cooperative kernel), the default of the latency path;
* ``decode_kernel_v7``: latency mode, L + 2 launches a token (one per
  layer), selected by ``RLMG_LATENCY_KERNEL=v7``.
  Both are reached from ``generate/sampler.py generate_tokens_latency``,
  which the JAX dispatch rules make opt-in (``RLMG_LATENCY_DECODE``,
  ``RLMG_LATENCY_MAX_BATCH``).
* ``decode_kernel``: the per-layer v1 and v2 steps on the augmented state,
  reached through ``fused_decode_step(variant="v1" | "v2")``, which only
  tests and ``chip_smoke.py`` call, as in the JAX package.
* ``decode_kernel_v5``: T tokens of any batch in one launch with the state
  batch-major in device memory, reached from
  ``scripts/profile_torch_decode_v5.py`` (its parity and perf modes), the
  counterpart of the JAX ``scripts/profile_decode_v5.py``.
"""
