#!/usr/bin/env python3
"""Kernel E (``ops/window_attention_kernel.py``, ``csrc/window_attention.cu``)
of two checkouts of the repo, held against each other on one card.

    python3 scripts/ab_torch_window_attention.py <checkout A> <checkout B> [ROUNDS]

Each checkout builds its own library (into its ``build/torch_kernels/``)
and runs in its own process, in turns A, B, B, A, ROUNDS times (default
2).  A run times the forward and the backward call of E at the
discriminator LM's shape, (B, H, S, E) = (4, 8, 3584, 64), window 512
(one-sided w = 256), on bf16 and on f32 tensors, in the Longformer's layout
((B, H, S, E) views of (B, S, H, E) tensors, made from one seed), with the
padding mask of ``synthetic_cp_dataset(4, 3584)`` (seed 0) and dO zero on
padded rows: the device ms a call (the mean time of each of the call's
kernels under torch.profiler, summed over them) and the host-bound ms a
call (CUDA events over back-to-back calls of ``forward_kernel`` /
``backward_kernel``); beside them, on the same tensors, the library
yardstick: ``scaled_dot_product_attention`` with the (B, 1, S, S) additive
band mask, forward and backward, device ms.  The first run of each
checkout also keeps E's outputs (out, the row statistics, dq, dk, dv at
both dtypes), and the two checkouts' are compared bit for bit: the count
of differing elements of each.  It prints the card and one line per run
and dtype, the comparison, then the median of each number per checkout.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile

SHAPE, WINDOW = (4, 8, 3584, 64), 512
DTYPES = ("bfloat16", "float32")
OUTPUTS = ("out", "stats", "dq", "dk", "dv")
KEYS = ("dev_fwd", "dev_bwd", "host_fwd", "host_bwd", "sdpa_fwd", "sdpa_bwd")

CHILD = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from reinforcement_learning_in_music_generation_torch.data import dataset
from reinforcement_learning_in_music_generation_torch.ops import (
    _build, window_attention_kernel as twk)
_build.load("window_attention")
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
    # the device time of the calls' kernels, a call
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / reps / 1e3
b, h, s, e = json.loads(sys.argv[2])
window = int(sys.argv[3])
w = max(1, window // 2)
_, _, m = dataset.synthetic_cp_dataset(b, s, n_class=(56, 135, 18, 87, 18, 25), seed=0)
mask = torch.from_numpy(m).to(dev).float()
pos = torch.arange(s, device=dev)
band = (pos[:, None] - pos[None, :]).abs() <= w
lib_mask = torch.where(band[None, None] & (mask[:, None, None, :] > 0), 0.0, -1e9)
gen = torch.Generator(device=dev)
gen.manual_seed(11)
x = [torch.randn((b, s, h, e), generator=gen, device=dev).transpose(1, 2) for _ in range(4)]
out, keep = {}, {}
for dt in json.loads(sys.argv[4]):
    q, k, v, g = (t.to(getattr(torch, dt)) for t in x)
    g = g * mask[:, None, :, None].to(g.dtype)
    o, st = twk.forward_kernel(q, k, v, mask, window)
    fwd = lambda: twk.forward_kernel(q, k, v, mask, window)
    bwd = lambda: twk.backward_kernel(q, k, v, mask, o, st, g, window)
    if sys.argv[5]:
        keep[dt] = [t.cpu() for t in (o, st, *bwd())]
    r = dict(dev_fwd=device(fwd, 20), dev_bwd=device(bwd, 20), host_fwd=events(fwd, 20),
             host_bwd=events(bwd, 20))
    # the library yardstick on the same tensors: SDPA with the band mask
    lm = lib_mask.to(q.dtype)
    ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    with torch.no_grad():
        r["sdpa_fwd"] = device(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=lm), 10)
    ol = torch.nn.functional.scaled_dot_product_attention(*ts, attn_mask=lm)
    r["sdpa_bwd"] = device(lambda: torch.autograd.grad(ol, ts, g, retain_graph=True), 10)
    del ol, ts, lm
    out[dt] = r
if sys.argv[5]:
    torch.save(keep, sys.argv[5])
print("RESULT " + json.dumps(out))
'''


def run(checkout: str, keep: str = "") -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(checkout),
                           json.dumps(SHAPE), str(WINDOW), json.dumps(DTYPES), keep],
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
                for dt, r in res.items():
                    print(f"{ck} {dt} {SHAPE} window {WINDOW}: " + ", ".join(
                        f"{k} {r[k]:.4f}" for k in KEYS), flush=True)
        compare(kept[a], kept[b])
    print("medians (ms a call):")
    for ck in (a, b):
        for dt in runs[ck][0]:
            print(f"  {ck} {dt}: " + ", ".join(
                f"{k} {statistics.median(r[dt][k] for r in runs[ck]):.4f}" for k in KEYS),
                flush=True)


if __name__ == "__main__":
    main()
