#!/usr/bin/env python3
"""Kernel F (``ops/linear_attention_kernel.py``, ``csrc/causal_product.cu``)
of two checkouts of the repo, held against each other on one card.

    python3 scripts/ab_torch_causal_product.py <checkout A> <checkout B> [ROUNDS]

Each checkout builds its own library (into its ``build/torch_kernels/``)
and runs in its own process, in turns A, B, B, A, ROUNDS times (default
2).  A run times the forward and the backward call of F at a rollout
episode (1, 8, 50, 64), a DQN update (30, 8, 50, 64) and pretrain
(32, 8, 512, 64), on bf16 and on f32 tensors, in the model's layout
((B, H, S, E) views of (B, S, H, E) tensors, made from one seed): the
host-bound ms a call (CUDA events over back-to-back calls of
``forward_kernel`` / ``backward_kernel``, which the host paces where it is
slower than the card) and the device ms a call (the mean time of each of
the call's kernels under torch.profiler, summed over them).  The first
run of each checkout also keeps its outputs (out, den, dq, dk, dv at every
shape and dtype), and the two checkouts' are compared bit for bit: the
count of differing elements of each.  It prints the card and one line per
run and case, the comparison, then the median of each number per
checkout.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile

SHAPES = ((1, 8, 50, 64), (30, 8, 50, 64), (32, 8, 512, 64))
DTYPES = ("bfloat16", "float32")
OUTPUTS = ("out", "den", "dq", "dk", "dv")

CHILD = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from reinforcement_learning_in_music_generation_torch.ops import (
    _build, linear_attention as tla, linear_attention_kernel as tlk)
_build.load("causal_product")
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
def events(fn, reps):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps
def device(fn, reps):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # each of the call's kernels runs once a call: the sum of their means
    return sum(ev.self_device_time_total / ev.count for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count) / 1e3
out, keep = {}, {}
for dt in json.loads(sys.argv[3]):
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    for shape in json.loads(sys.argv[2]):
        b, h, s, e = shape
        t = [torch.randn((b, s, h, e), generator=gen, device=dev).transpose(1, 2)
             for _ in range(4)]
        pq, pk, v, g = (x.to(getattr(torch, dt)) for x in
                        (tla.feature_map(t[0]), tla.feature_map(t[1]), t[2], t[3]))
        o, d = tlk.forward_kernel(pq, pk, v, 1e-6)
        fwd = lambda: tlk.forward_kernel(pq, pk, v, 1e-6)
        bwd = lambda: tlk.backward_kernel(pq, pk, v, o, d, g, 1e-6)
        key = f"{dt} {tuple(shape)}"
        if sys.argv[4]:
            keep[key] = [x.cpu() for x in (o, d, *bwd())]
        reps = 200 if s <= 64 else 50
        out[key] = dict(host_fwd=events(fwd, reps), host_bwd=events(bwd, reps),
                        dev_fwd=device(fwd, reps), dev_bwd=device(bwd, reps))
if sys.argv[4]:
    torch.save(keep, sys.argv[4])
print("RESULT " + json.dumps(out))
'''


def run(checkout: str, keep: str = "") -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(checkout),
                           json.dumps(SHAPES), json.dumps(DTYPES), keep],
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{checkout}: no result (rc {proc.returncode})\n{proc.stdout}\n"
                       f"{proc.stderr[-4000:]}")


def bit_diffs(x, y) -> int:
    """Elements whose bits differ (tensors of one shape and type)."""
    import torch
    if x.shape != y.shape or x.dtype != y.dtype:
        return x.numel()
    it = {2: torch.int16, 4: torch.int32}[x.element_size()]
    return int((x.contiguous().view(it) != y.contiguous().view(it)).sum())


def compare(path_a: str, path_b: str) -> None:
    import torch
    ka, kb = torch.load(path_a), torch.load(path_b)
    for key in ka:
        diffs = [bit_diffs(x, y) for x, y in zip(ka[key], kb[key])]
        print(f"bits A vs B {key}: differing elements " + ", ".join(
            f"{n} {c} of {x.numel()}" for n, c, x in zip(OUTPUTS, diffs, ka[key]))
            + ("; bit-equal" if not any(diffs) else "; DIFFERENT"), flush=True)


def main() -> None:
    a, b = sys.argv[1], sys.argv[2]
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    runs = {a: [], b: []}
    with tempfile.TemporaryDirectory() as tmp:
        kept = {}
        for _ in range(rounds):
            for ck in (a, b, b, a):
                keep = "" if ck in kept else os.path.join(tmp, f"{len(kept)}.pt")
                res = run(ck, keep)
                if keep:
                    kept[ck] = keep
                runs[ck].append(res)
                for case, r in res.items():
                    print(f"{ck} {case}: host-bound ms fwd {r['host_fwd']:.4f} bwd "
                          f"{r['host_bwd']:.4f}; device ms fwd {r['dev_fwd']:.4f} bwd "
                          f"{r['dev_bwd']:.4f}", flush=True)
        compare(kept[a], kept[b])
    print("medians (ms a call):")
    for ck in (a, b):
        for case in runs[ck][0]:
            med = {k: statistics.median(r[case][k] for r in runs[ck])
                   for k in ("host_fwd", "host_bwd", "dev_fwd", "dev_bwd")}
            print(f"  {ck} {case}: " + ", ".join(f"{k} {v:.4f}" for k, v in med.items()),
                  flush=True)


if __name__ == "__main__":
    main()
