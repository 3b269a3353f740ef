#!/usr/bin/env python3
"""The agent's pretrain step of two checkouts of the repo, held against each
other on one card.

    python3 scripts/ab_torch_pretrain.py <checkout A> <checkout B> [ROUNDS]

Each checkout builds its own libraries (into its ``build/torch_kernels/``)
and runs in its own process, in turns A, B, B, A, ROUNDS times (default
2).  A run takes ``train.pretrain.agent_train_step`` (the step ``cli
pretrain`` calls) on the flagship ``config.agent_config`` at B=32 x S=512,
the default route on a card (kernels C and D in every layer), random
weights from seed 0 and synthetic CP rows, at float32 and at bfloat16
(bf16 compute, f32 master weights, as ``cli pretrain --dtype bfloat16``).
For each dtype, after two warm steps: the wall time of 8 steps run back to
back as the CLI runs them (no host sync between steps), per step
(``wall_ms``); the host's time to issue them, per step, up to the last
call's return (``host_ms``: below wall_ms the card paces the step, equal
to it the host does); the device time of a step, summed over its kernels
under torch.profiler over 2 more steps (``device_ms``) and its kernel
launches (``launches``); and the host's cost of one call of kernel C's
wrapper, forward and backward at 128 rows where the card's work is a few
microseconds (``c_host_us``).  It prints the card and one line per run
and dtype, then the median of each number per checkout.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

CHILD = r'''
import dataclasses, json, sys, time, torch
sys.path.insert(0, sys.argv[1])
from reinforcement_learning_in_music_generation_torch import config as C
from reinforcement_learning_in_music_generation_torch.data import dataset
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as lt
from reinforcement_learning_in_music_generation_torch.ops import _build, attention_block as tab
from reinforcement_learning_in_music_generation_torch.train import optim, pretrain
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
B, S, STEPS = 32, 512, 8
out = {}
for dt in ("float32", "bfloat16"):
    cfg = dataclasses.replace(C.agent_config(), dtype=dt)
    x, y, m = (torch.from_numpy(a).to(dev) for a in
               dataset.synthetic_cp_dataset(B, S, n_class=cfg.vocab_sizes, seed=0))
    params = lt.init_params(cfg, seed=0, device=dev)
    tx = optim.adam(1e-4, grad_clip=3.0)
    st = [params, tx.init(params)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    def steps(n):
        for _ in range(n):
            st[0], st[1], _ = pretrain.agent_train_step(st[0], st[1], cfg, tx, x, y, m, gen)
    steps(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(STEPS)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    r = dict(wall_ms=(t2 - t0) * 1e3 / STEPS, host_ms=(t1 - t0) * 1e3 / STEPS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        steps(2)
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    r["device_ms"] = sum(e.self_device_time_total for e in evs) / 2 / 1e3
    r["launches"] = sum(e.count for e in evs) / 2
    del st, params
    # kernel C's wrapper at 128 rows: the host's cost of a call
    tdt = getattr(torch, dt)
    h = torch.randn((128, 512), device=dev).to(tdt).requires_grad_(True)
    w = (torch.randn((512, 1536), device=dev) * 0.05).to(tdt).requires_grad_(True)
    b = torch.zeros(1536, device=dev, dtype=tdt).requires_grad_(True)
    g = torch.randn((128, 512), device=dev).to(tdt)
    def c_call():
        o = tab.qkv_attention_block(h, w, b, 2, 8, chunk=64)
        torch.autograd.grad(o, (h, w, b), g)
    for _ in range(5):
        c_call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        c_call()
    r["c_host_us"] = (time.perf_counter() - t0) * 1e6 / 100
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out[dt] = r
print("RESULT " + json.dumps(out))
'''

KEYS = ("wall_ms", "host_ms", "device_ms", "launches", "c_host_us")


def run(checkout: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(checkout)],
                          capture_output=True, text=True, timeout=900)
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
            for dt, r in res.items():
                print(f"{ck} {dt}: " + ", ".join(f"{k} {r[k]:.4f}" for k in KEYS), flush=True)
    print("medians (a step; c_host_us a call):")
    for ck in (a, b):
        for dt in runs[ck][0]:
            med = {k: statistics.median(r[dt][k] for r in runs[ck]) for k in KEYS}
            print(f"  {ck} {dt}: " + ", ".join(f"{k} {v:.4f}" for k, v in med.items()),
                  flush=True)


if __name__ == "__main__":
    main()
