#!/usr/bin/env python3
"""A/B of variants of the training product tile (``csrc/train_gemm_tc.cuh``,
kernels D and G) on one card.

    python3 scripts/ab_torch_train_tile.py [VARIANT ...]

Each variant is the port package copied under ``build/ab_tile/<variant>/``
with one or more text substitutions in ``train_gemm_tc.cuh`` (``base``: as
committed).  All variants are built first (one nvcc per library, in
parallel), then each runs in its own process, in turns (the listed order,
then reversed): kernels D and G against their plain twins at 100 and 1500
rows (f32 and bf16, dropout 0.1: the largest difference of the output and
of the gradients, each over its magnitude), then CUDA-event ms of D's
forward and backward launches at 16384 rows and G's at 50 and 1500 rows
(dropout 0), f32 and bf16, and the most registers and spill bytes ptxas
reports for the two libraries.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import shutil
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PKG = "reinforcement_learning_in_music_generation_torch"
HEADER = os.path.join("csrc", "train_gemm_tc.cuh")
TILE_L = "using TTileL = TrainTile<128, 128, 2, 4, 114 * 1024, 2>;"
VARIANTS = {
    "base": [],
    # 4 warps of 64 x 64 instead of 8 of 64 x 32
    "warps4": [(TILE_L, "using TTileL = TrainTile<128, 128, 2, 2, 114 * 1024, 2>;")],
    # registers for one block an SM, not two
    "minb1": [(TILE_L, "using TTileL = TrainTile<128, 128, 2, 4, 114 * 1024, 1>;")],
    # at most 3 slices in flight
    "stages3": [("constexpr int TT_MAX_STAGES = 8;", "constexpr int TT_MAX_STAGES = 3;")],
    # K slices of 64
    "bk64": [("constexpr int TT_BK = 32, TT_PAD = 8;", "constexpr int TT_BK = 64, TT_PAD = 8;")],
    # large tiles from 2^31 multiply-adds (1500 rows on the small tiles)
    "large31": [("constexpr long long TT_LARGE_MACS = 1LL << 28;",
                 "constexpr long long TT_LARGE_MACS = 1LL << 31;")],
}

CHILD = r'''
import re, sys, torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import chip_smoke as cs
from reinforcement_learning_in_music_generation_torch.ops import _build, ffn_block as tfb
regs, spills = 0, 0
for name in ("attn_tail", "ffn_block"):
    _build.load(name)
    log = _build.build_log(name)
    regs = max([regs] + [int(r) for r in re.findall(r"Used (\d+) registers", log)])
    spills = max([spills] + [int(b) for b in re.findall(r"(\d+) bytes spill stores", log)])
print(f"ptxas: at most {regs} registers, {spills} bytes of spill stores")
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev)
gen.manual_seed(5)
seed = torch.tensor(777, dtype=torch.int32, device=dev)
def rnd(*s, sc=1.0, off=0.0):
    return (off + sc * torch.randn(s, generator=gen, device=dev)).contiguous()
def ffn_ws(d, di):
    return [rnd(d, di, sc=d ** -0.5), rnd(di, sc=0.1), rnd(di, d, sc=di ** -0.5),
            rnd(d, sc=0.1), rnd(d, sc=0.1, off=1.0), rnd(d, sc=0.1)]
def tail_ws(d, di):
    return [rnd(d, d, sc=d ** -0.5), rnd(d, sc=0.1), rnd(d, sc=0.1, off=1.0),
            rnd(d, sc=0.1)] + ffn_ws(d, di)
def check(tag, kern, plain, inputs, g):
    ok, gk = cs.fwd_bwd(kern, inputs, g)
    op, gp = cs.fwd_bwd(plain, inputs, g)
    e = cs.max_err(ok, op) / cs.magnitude(op)
    ge = max(cs.max_err(x, y) / cs.magnitude(y) for x, y in zip(gk, gp))
    print(f"check {tag}: out {e:.2e}, gradients {ge:.2e}", flush=True)
for dt in (torch.float32, torch.bfloat16):
    for n in (100, 1500):
        h, a, g = (rnd(n, 512).to(dt) for _ in range(3))
        ws = [w.to(dt) for w in ffn_ws(512, 2048)]
        check(f"G {str(dt)[6:]} N={n}", lambda *x: tfb.ffn_block(*x, seed, 0.1),
              lambda *x: tfb.ffn_block_plain(*x, seed, 0.1), [h] + ws, g)
        tw = [w.to(dt) for w in tail_ws(512, 2048)]
        check(f"D {str(dt)[6:]} N={n}", lambda *x: tfb.attn_tail_block(*x, seed, 0.1),
              lambda *x: tfb.attn_tail_block_plain(*x, seed, 0.1), [h, a] + tw, g)
for dt in (torch.float32, torch.bfloat16):
    h, a, g = (rnd(16384, 512).to(dt) for _ in range(3))
    tw = [w.to(dt) for w in tail_ws(512, 2048)]
    f = cs.time_ms(lambda: tfb.forward_kernel(h, a, tw, seed, 0.0, True), 10)
    b = cs.time_ms(lambda: tfb.backward_kernel(h, a, tw, g, seed, 0.0, True), 5)
    print(f"time {str(dt)[6:]} D N=16384: fwd {f:.4f} bwd {b:.4f} ms", flush=True)
    for n in (50, 1500):
        h, g = rnd(n, 512).to(dt), rnd(n, 512).to(dt)
        ws = [w.to(dt) for w in ffn_ws(512, 2048)]
        f = cs.time_ms(lambda: tfb.ffn_forward_kernel(h, ws, seed, 0.0), 50)
        b = cs.time_ms(lambda: tfb.ffn_backward_kernel(h, ws, g, seed, 0.0), 50)
        print(f"time {str(dt)[6:]} G N={n}: fwd {f:.4f} bwd {b:.4f} ms", flush=True)
'''


def prepare(name: str) -> str:
    dst = os.path.join(ROOT, "build", "ab_tile", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, PKG, HEADER)
    with open(path) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if old not in text:
            sys.exit(f"variant {name}: {old!r} not in {HEADER}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return dst


def build(dst: str):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from reinforcement_learning_in_music_generation_torch.ops import _build; "
            "[_build.load(n) for n in ('attn_tail', 'ffn_block')]")
    return subprocess.run([sys.executable, "-c", code, dst], capture_output=True, text=True)


def main():
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        sys.exit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    dsts = {n: prepare(n) for n in names}
    with cf.ThreadPoolExecutor(len(names)) as ex:
        for n, r in zip(names, ex.map(build, dsts.values())):
            if r.returncode:
                sys.exit(f"variant {n} does not build:\n{r.stderr[-3000:]}")
    for order in (names, names[::-1]):
        for n in order:
            r = subprocess.run([sys.executable, "-c", CHILD, dsts[n], os.path.abspath(ROOT)],
                               capture_output=True, text=True)
            print(f"== {n}", flush=True)
            print(r.stdout.strip(), flush=True)
            if r.returncode:
                sys.exit(f"variant {n} failed:\n{r.stderr[-3000:]}")


if __name__ == "__main__":
    main()
