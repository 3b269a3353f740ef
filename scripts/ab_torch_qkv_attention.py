#!/usr/bin/env python3
"""Kernel C (``ops/attention_block.py qkv_attention_block``) of two checkouts
of the repo, held against each other on one card.

    python3 scripts/ab_torch_qkv_attention.py <checkout A> <checkout B> [ROUNDS]

Each checkout builds its own library (into its ``build/torch_kernels/``)
and runs in its own process, in turns A, B, B, A, ROUNDS times (default
2).  A run times C at pretrain's shape (16384 rows = 32 sequences of 512,
d_model 512, 8 heads of 64, the agent's first-layer weights' shapes from
one seed) on float32 and on bfloat16 tensors: the forward and the
backward through the wrapper and autograd (CUDA events over back-to-back
calls; the backward includes the dh / dW / db products), the same calls'
device time (the sum over the call's kernels of each one's mean time under
torch.profiler, times its launches a call), and, where the checkout has
them, its parts alone: the projection (``project_kernel``) and the
attention passes forward (``attention_kernel``) and backward
(``backward_kernel``), as device time; and, as a yardstick for the
projection, the same product on kernels D and G's ``mma.sync`` tile
(``ffn_block.tile_product``, f32 out, no bias or phi).  The first run of
each checkout also keeps the attention passes' outputs (att, den and the
backward's dqkv at both dtypes), and the two checkouts' are compared bit
for bit: the count of differing elements of each.  It prints the card and
one line per run and dtype, the comparison, then the median of each
number per checkout.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile

CHILD = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from reinforcement_learning_in_music_generation_torch.ops import (
    _build, attention_block as tab, ffn_block as tfb)
_build.load("attention_block")
_build.load("ffn_block")
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
N, D, H, B, EPS = 16384, 512, 8, 32, 1e-6
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
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / reps / 1e3
out, keep = {}, {}
for dt in (torch.float32, torch.bfloat16):
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    rnd = lambda *shape, sc=1.0: (torch.randn(shape, generator=gen, device=dev) * sc).to(dt)
    h, w, b, g = rnd(N, D), rnd(D, 3 * D, sc=0.05), rnd(3 * D, sc=0.1), rnd(N, D)
    ts = [t.detach().clone().requires_grad_(True) for t in (h, w, b)]
    with torch.no_grad():
        fwd = lambda: tab.qkv_attention_block(h, w, b, B, H, eps=EPS)
        r = dict(host_fwd=events(fwd, 30), dev_fwd=device(fwd, 20))
    o = tab.qkv_attention_block(*ts, B, H, eps=EPS)
    bwd = lambda: torch.autograd.grad(o, ts, g, retain_graph=True)
    r.update(host_bwd=events(bwd, 30), dev_bwd=device(bwd, 20))
    att, pqkv, den = tab.forward_kernel(h, w, b, B, H, EPS)
    r["dev_attn_bwd"] = device(lambda: tab.backward_kernel(pqkv, g, att, den, B, H, EPS), 20)
    if sys.argv[2]:
        keep[str(dt)[6:]] = [t.cpu() for t in (att, den,
                                                tab.backward_kernel(pqkv, g, att, den, B, H, EPS))]
    if hasattr(tab, "project_kernel"):
        x = tab.project_kernel(h, w, b)[1]
        r["dev_proj"] = device(lambda: tab.project_kernel(h, w, b), 20)
        r["dev_attn_fwd"] = device(lambda: tab.attention_kernel(x, B, H, EPS, dt), 20)
    # the same product (no bias, no phi) on kernels D and G's mma.sync tile
    r["dev_mma_sync_tile"] = device(lambda: tfb.tile_product(h, w), 20)
    out[str(dt)[6:]] = r
if sys.argv[2]:
    torch.save(keep, sys.argv[2])
print("RESULT " + json.dumps(out))
'''

KEYS = ("host_fwd", "host_bwd", "dev_fwd", "dev_bwd", "dev_proj", "dev_attn_fwd", "dev_attn_bwd",
        "dev_mma_sync_tile")


OUTPUTS = ("att", "den", "dqkv")


def run(checkout: str, keep: str = "") -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(checkout), keep],
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
                    print(f"{ck} {dt}: " + ", ".join(f"{k} {r[k]:.4f}" for k in KEYS if k in r),
                          flush=True)
        compare(kept[a], kept[b])
    print("medians (ms a call):")
    for ck in (a, b):
        for dt in runs[ck][0]:
            med = {k: statistics.median(r[dt][k] for r in runs[ck])
                   for k in KEYS if k in runs[ck][0][dt]}
            print(f"  {ck} {dt}: " + ", ".join(f"{k} {v:.4f}" for k, v in med.items()),
                  flush=True)


if __name__ == "__main__":
    main()
