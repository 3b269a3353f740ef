#!/usr/bin/env python3
"""Kernel F (``ops/linear_attention_kernel.py``, ``csrc/causal_product.cu``)
of two checkouts of the repo, held against each other on one card.

    python3 scripts/ab_torch_causal_product.py <checkout A> <checkout B> [ROUNDS]

Each checkout builds its own library (into its ``build/torch_kernels/``)
and runs in its own process, in turns A, B, B, A, ROUNDS times (default
2).  A run times the forward and the backward call of F at a rollout
episode (1, 8, 50, 64), a DQN update (30, 8, 50, 64) and pretrain
(32, 8, 512, 64), f32, in the model's layout ((B, H, S, E) views of
(B, S, H, E) tensors, made from one seed): the host-bound ms a call
(CUDA events over back-to-back calls of ``forward_kernel`` /
``backward_kernel``, which the host paces where it is slower than the
card) and the device ms a call (the mean time of each of the call's
kernels under torch.profiler, summed over them).  It prints the card and
one line per run and shape, then the median of each number per checkout.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

SHAPES = ((1, 8, 50, 64), (30, 8, 50, 64), (32, 8, 512, 64))

CHILD = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from reinforcement_learning_in_music_generation_torch.ops import (
    _build, linear_attention as tla, linear_attention_kernel as tlk)
_build.load("causal_product")
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev)
gen.manual_seed(11)
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
out = {}
for shape in json.loads(sys.argv[2]):
    b, h, s, e = shape
    t = [torch.randn((b, s, h, e), generator=gen, device=dev).transpose(1, 2) for _ in range(4)]
    pq, pk, v, g = tla.feature_map(t[0]), tla.feature_map(t[1]), t[2], t[3]
    o, d = tlk.forward_kernel(pq, pk, v, 1e-6)
    fwd = lambda: tlk.forward_kernel(pq, pk, v, 1e-6)
    bwd = lambda: tlk.backward_kernel(pq, pk, v, o, d, g, 1e-6)
    reps = 200 if s <= 64 else 50
    out[str(tuple(shape))] = dict(host_fwd=events(fwd, reps), host_bwd=events(bwd, reps),
                                  dev_fwd=device(fwd, reps), dev_bwd=device(bwd, reps))
print("RESULT " + json.dumps(out))
'''


def run(checkout: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(checkout),
                           json.dumps(SHAPES)], capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{checkout}: no result (rc {proc.returncode})\n{proc.stdout}\n"
                       f"{proc.stderr[-4000:]}")


def main() -> None:
    a, b = sys.argv[1], sys.argv[2]
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    runs = {a: [], b: []}
    for _ in range(rounds):
        for ck in (a, b, b, a):
            res = run(ck)
            runs[ck].append(res)
            for shape, r in res.items():
                print(f"{ck} {shape}: host-bound ms fwd {r['host_fwd']:.4f} bwd "
                      f"{r['host_bwd']:.4f}; device ms fwd {r['dev_fwd']:.4f} bwd "
                      f"{r['dev_bwd']:.4f}", flush=True)
    print("medians (ms a call):")
    for ck in (a, b):
        for shape in runs[ck][0]:
            med = {k: statistics.median(r[shape][k] for r in runs[ck])
                   for k in ("host_fwd", "host_bwd", "dev_fwd", "dev_bwd")}
            print(f"  {ck} {shape}: " + ", ".join(f"{k} {v:.4f}" for k, v in med.items()),
                  flush=True)


if __name__ == "__main__":
    main()
