"""The latency-mode decode kernels, counterparts of the JAX package's
``ops/experimental`` modules of the same names.

* ``decode_kernel_v8``: one launch per chunk of tokens (a persistent
  cooperative kernel), the default of the latency path;
* ``decode_kernel_v7``: L + 2 launches a token (one per layer), selected by
  ``RLMG_LATENCY_KERNEL=v7``.

Both are reached from ``generate/sampler.py generate_tokens_latency``, which
the JAX dispatch rules make opt-in (``RLMG_LATENCY_DECODE``,
``RLMG_LATENCY_MAX_BATCH``).
"""
