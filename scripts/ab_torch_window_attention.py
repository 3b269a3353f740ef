#!/usr/bin/env python3
"""Kernel E (``ops/window_attention_kernel.py``, ``csrc/window_attention.cu``)
of two checkouts of the repo, held against each other on one card.

    python3 scripts/ab_torch_window_attention.py <checkout A> <checkout B> [ROUNDS]

Each checkout builds its own library (into its ``build/torch_kernels/``)
and runs in its own process, in turns A, B, B, A, ROUNDS times (default
2).  A run times the forward and the backward call of E at the
discriminator LM's shape, (B, H, S, E) = (4, 8, 3584, 64), window 512
(one-sided w = 256), f32, in the Longformer's layout ((B, H, S, E) views of
(B, S, H, E) tensors, made from one seed), with the padding mask of
``synthetic_cp_dataset(4, 3584)`` (seed 0) and dO zero on padded rows: the
device ms a call (the mean time of each of the call's kernels under
torch.profiler, summed over them) and the host-bound ms a call (CUDA
events over back-to-back calls of ``forward_kernel`` / ``backward_kernel``).
It prints the card and one line per run, then the median of each number
per checkout.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

SHAPE, WINDOW = (4, 8, 3584, 64), 512

CHILD = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from reinforcement_learning_in_music_generation_torch.data import dataset
from reinforcement_learning_in_music_generation_torch.ops import (
    _build, window_attention_kernel as twk)
_build.load("window_attention")
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
b, h, s, e = json.loads(sys.argv[2])
window = int(sys.argv[3])
_, _, m = dataset.synthetic_cp_dataset(b, s, n_class=(56, 135, 18, 87, 18, 25), seed=0)
mask = torch.from_numpy(m).to(dev).float()
q, k, v, g = [torch.randn((b, s, h, e), generator=gen, device=dev).transpose(1, 2)
              for _ in range(4)]
g = g * mask[:, None, :, None]
o, st = twk.forward_kernel(q, k, v, mask, window)
fwd = lambda: twk.forward_kernel(q, k, v, mask, window)
bwd = lambda: twk.backward_kernel(q, k, v, mask, o, st, g, window)
out = dict(dev_fwd=device(fwd, 20), dev_bwd=device(bwd, 20), host_fwd=events(fwd, 20),
           host_bwd=events(bwd, 20))
print("RESULT " + json.dumps(out))
'''


def run(checkout: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(checkout),
                           json.dumps(SHAPE), str(WINDOW)], capture_output=True, text=True,
                          timeout=900)
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
    keys = ("dev_fwd", "dev_bwd", "host_fwd", "host_bwd")
    for _ in range(rounds):
        for ck in (a, b, b, a):
            r = run(ck)
            runs[ck].append(r)
            print(f"{ck} {SHAPE} window {WINDOW}: " + ", ".join(f"{k} {r[k]:.4f}" for k in keys),
                  flush=True)
    print("medians (ms a call):")
    for ck in (a, b):
        print(f"  {ck}: " + ", ".join(f"{k} {statistics.median(r[k] for r in runs[ck]):.4f}"
                                      for k in keys), flush=True)


if __name__ == "__main__":
    main()
