#!/usr/bin/env python3
"""The v5 decode kernel of the PyTorch port on one GPU: greedy parity with
the plain per-step path, and a sweep of its batch-chunk size.

    python3 scripts/profile_torch_decode_v5.py [parity|perf]

The counterpart of the JAX package's ``scripts/profile_decode_v5.py``, at its
shapes: ``config.agent_config`` (12 layers, d_model 512, 8 heads, FFN 2048)
with bf16 weights (random, from a seed), the f32 state packed batch-major,
the CP seed row fed first.
  * parity: B=8, T=64, one greedy call of ``fused_decode_v5`` against
    ``generate_tokens(greedy=True, fused=False, fused_sampling=True)``; prints
    the tokens that match and the first mismatch (the streams part after a
    near-tie flips one argmax), then one stochastic call whose tokens must
    lie in their fields' vocabularies.  With bf16 weights the reference
    carries its activations in bf16 (the residual stream too) and the kernel
    in f32, so they part early; ``parity(dtype=torch.float32)`` takes both to
    f32, where they differ only in the order of their sums;
  * perf: B=256, T=128, bb 8, 16 and 32 (CP sampling), one call to warm up,
    then the best of three timed with CUDA events: ms a call, ms a token,
    tokens/s.
It prints the card's name and power limit first and one JSON line last.
Needs a CUDA card: the kernel has no CPU mode.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from reinforcement_learning_in_music_generation_torch import config as C  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import tokenizer  # noqa: E402
from reinforcement_learning_in_music_generation_torch.generate import sampler  # noqa: E402
from reinforcement_learning_in_music_generation_torch.models import (  # noqa: E402
    common as cm, linear_transformer as lt)
from reinforcement_learning_in_music_generation_torch.ops import sampling as smp  # noqa: E402
from reinforcement_learning_in_music_generation_torch.ops.experimental import (  # noqa: E402
    decode_kernel_v5 as dk5)


def agent_config():
    e2w, _ = tokenizer.drop_type(tokenizer.construct_cp_dict())
    return C.agent_config(tuple(tokenizer.n_classes(e2w)))


def make(cfg, batch, dev, dtype=torch.bfloat16):
    """(params, v5 params, tok0 (B, 6) the CP seed row, packed zero state)."""
    params = lt.cast_params(lt.init_params(cfg, seed=0, device=dev), dtype)
    v5p = dk5.make_v5_params(params, cfg, dtype=dtype)
    tok0 = torch.tensor([sampler.CP_SEED] * batch, dtype=torch.int32, device=dev)
    st = lt.init_decode_state(cfg, batch, device=dev)
    s5, z5 = dk5.pack_state(st.s, st.z)
    return params, v5p, tok0, s5, z5


def run_v5(cfg, v5p, tok0, s5, z5, T, bb, greedy, seed=0):
    """One call from a copy of the state: (tokens (T, B, 6), s5', z5')."""
    settings = smp.GREEDY if greedy else smp.CP_SAMPLING
    pe = cm.sinusoidal_table(cfg.max_len, cfg.d_model, torch.float32, tok0.device)[:T]
    return dk5.fused_decode_v5(
        v5p, tok0, s5.clone(), z5.clone(), pe, seed, n_head=cfg.n_head, max_tokens=T, bb=bb,
        vocab_sizes=cfg.vocab_sizes, temps=tuple(s.temperature for s in settings),
        topps=tuple(s.top_p if s.top_p is not None else float("inf") for s in settings),
        greedy=greedy, eps=cfg.attn_eps)


def in_range(cfg, toks) -> bool:
    return bool(((toks >= 0) & (toks < torch.tensor(cfg.vocab_sizes, device=toks.device)))
                .all())


def parity(batch=8, T=64, dev="cuda", dtype=torch.bfloat16) -> dict:
    cfg = agent_config()
    params, v5p, tok0, s5, z5 = make(cfg, batch, dev, dtype)
    toks, _, _ = run_v5(cfg, v5p, tok0, s5, z5, T, bb=batch, greedy=True)
    toks = toks.transpose(0, 1)                                  # (B, T, 6)
    ref = sampler.generate_tokens(params, cfg, tok0[:, None, :], max_tokens=T, greedy=True,
                                  settings=smp.GREEDY, fused=False, fused_sampling=True)
    ref_toks = ref.tokens[:, 1:]
    n = toks.numel()
    mism = int((toks != ref_toks).sum())
    print(f"greedy parity, {str(dtype)[6:]} weights: {n - mism}/{n} tokens match ({mism} "
          f"mismatches)", flush=True)
    first = torch.nonzero(toks != ref_toks)
    first_at = None
    if len(first):
        b0, t0, f0 = (int(v) for v in first[0])
        first_at = [b0, t0, f0]
        print(f"first mismatch at {first_at} v5: {toks[b0, t0].tolist()} ref: "
              f"{ref_toks[b0, t0].tolist()}", flush=True)
    stoks, _, _ = run_v5(cfg, v5p, tok0, s5, z5, T, bb=batch, greedy=False, seed=7)
    ok = in_range(cfg, stoks)
    print(f"stochastic decode: {'all fields in vocab range' if ok else 'OUT OF RANGE'}",
          flush=True)
    return {"batch": batch, "T": T, "dtype": str(dtype)[6:], "tokens": n, "mismatches": mism,
            "first_mismatch": first_at, "stochastic_in_range": ok}


def perf(batch=256, T=128, dev="cuda", reps=3) -> dict:
    cfg = agent_config()
    _, v5p, tok0, s5, z5 = make(cfg, batch, dev)
    out = {}
    for bb in (8, 16, 32):
        toks, _, _ = run_v5(cfg, v5p, tok0, s5, z5, T, bb=bb, greedy=False)
        ms = []
        for i in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            toks, _, _ = run_v5(cfg, v5p, tok0, s5, z5, T, bb=bb, greedy=False, seed=2 + i)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        best = min(ms)
        out[bb] = {"ms": best, "ms_per_token": best / T, "tokens_per_s": batch * T / best * 1e3,
                   "in_range": in_range(cfg, toks)}
        print(f"bb={bb}: {best:.3f} ms  {out[bb]['tokens_per_s']:,.0f} tok/s  "
              f"{best / T * 1e3:.1f} us/step  (tokens in range: {out[bb]['in_range']})",
              flush=True)
    return {"batch": batch, "T": T, "by_bb": out}


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_torch_decode_v5: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(f"card: {card}", flush=True)
    mode = sys.argv[1] if len(sys.argv) > 1 else "parity"
    if mode not in ("parity", "perf"):
        sys.exit(f"mode must be parity or perf, not {mode!r}")
    res = parity() if mode == "parity" else perf()
    print(json.dumps({"card": card, "mode": mode, **res}))


if __name__ == "__main__":
    main()
