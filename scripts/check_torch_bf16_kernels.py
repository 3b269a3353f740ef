#!/usr/bin/env python3
"""Kernels F and E on bf16 tensors (``csrc/causal_product.cu``,
``csrc/window_attention.cu``) held against their twins of JAX's bf16
arithmetic on one card, with the gates and controls of ``chip_smoke.py``,
and timed; their f32 routes and kernel C (which runs F's passes) checked
beside them.  A quick call for work on these kernels (about 90 s with the
build; ``chip_smoke.py`` runs the same gates at fewer shapes).

    python3 scripts/check_torch_bf16_kernels.py [--parent CHECKOUT]

Builds ``causal_product``, ``window_attention`` and ``attention_block``
(one nvcc each, in parallel) and prints the ptxas registers and spills of
F's, C's and E's kernels; then, for F at seven (B, H, S, E) shapes in the
model's layout ((B, H, S, E) views of (B, S, H, E) tensors) and E at
three (B, H, S, D, window) shapes with padding, each tensor's max / mean
share against the twin (``chip_smoke.bf16_shares``) beside the controls'
mean shares and the gate's verdict, the exact gate (the bf16 route
against the f32 route on the widened inputs, rounded: differing elements,
and the dropped-plane control's), two bf16 backward runs compared bit for
bit, and the f32 route against its twin; C on bf16 tensors at the
pretrain shape (C's gate: C runs F's passes); the device ms of F's and
E's calls at both dtypes (torch.profiler); the HMMA and SASS instruction
counts of every instantiation of F's, C's and E's kernels (cuobjdump).
With ``--parent`` the parent checkout's three libraries are built beside
(in its own ``build/torch_kernels/``) and its counts printed beside each,
and an f32 instantiation or C's forward (``Args<float, T>``) whose HMMA
count differs fails.  The first line names the card and its power limit.  Exits
non-zero if a gate fails.
"""

from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from reinforcement_learning_in_music_generation_torch.data import dataset  # noqa: E402
from reinforcement_learning_in_music_generation_torch.ops import (  # noqa: E402
    _build, attention_block as tab, linear_attention as tla, linear_attention_kernel as tlk,
    window_attention_kernel as twk)

F_SHAPES = [(1, 8, 50, 64), (30, 8, 50, 64), (32, 8, 512, 64), (4, 8, 300, 64), (4, 8, 65, 64),
            (4, 8, 64, 64), (2, 2, 67, 8), (3, 2, 130, 20)]
E_SHAPES = [(2, 2, 160, 16, 50), (2, 2, 600, 20, 100), (4, 8, 3584, 64, 512)]
EPS = 1e-6


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT,
                                                                             "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LIBS = ("causal_product", "window_attention", "attention_block")

# A checkout's libraries built in its own process (the parent's package has
# this one's name): prints the path of each.
BUILD_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from reinforcement_learning_in_music_generation_torch.ops import _build
started = {n: _build._start(n) for n in sys.argv[2:]}
for n, st in started.items():
    if st:
        _build._finish(n, st)
for n in sys.argv[2:]:
    print("LIB", n, _build._target(n))
"""


def hmma(cs, path) -> dict:
    """{instantiation: (HMMA count, SASS instructions)} of F's, C's and E's
    kernels in a library, keyed by the mangled name before its parameter
    list."""
    sass = subprocess.run([cs.cuobjdump_path(), "-sass", str(path)], capture_output=True,
                          text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1).split("Ev")[0] if ("cp_" in m.group(1) or "wa_" in m.group(1)) \
                else None
            if fn:
                counts[fn] = [0, 0]
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            counts[fn][1] += 1
            counts[fn][0] += bool(re.search(r"\bH(G)?MMA\b", line))
    return {k: tuple(v) for k, v in counts.items()}


def f32_code(name: str) -> bool:
    """An instantiation that must compile as its parent's: F's and C's on
    f32 tiles (Args<float, ...>: F's f32 route, C's forward) and E's f32."""
    return "ArgsIf" in name or name.endswith("Ef") or "EfE" in name


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    parent = sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv else None
    cs = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t = time.time()
    pbuild = None if parent is None else subprocess.Popen(
        [sys.executable, "-c", BUILD_CHILD, os.path.abspath(parent), *LIBS],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    started = {n: _build._start(n) for n in LIBS}
    for n, st in started.items():
        if st:
            _build._finish(n, st)
    print(f"build {time.time() - t:.1f} s", flush=True)
    for n in started:
        fn = None
        for ln in _build.build_log(n).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                fn = m.group(1)
            elif fn and ("cp_" in fn or "wa_" in fn) and ("registers" in ln or "spill" in ln):
                print(f"{n} {fn.split('Ev')[0]}: {ln.split(':', 1)[-1].strip()}", flush=True)
    bad = []
    if pbuild is not None:
        plog, _ = pbuild.communicate()
        plibs = dict(ln.split()[1:3] for ln in plog.splitlines() if ln.startswith("LIB "))
        if len(plibs) != len(LIBS):
            sys.exit(f"the parent's build failed:\n{plog[-4000:]}")
    for n in LIBS:
        mine = hmma(cs, _build._target(n))
        theirs = hmma(cs, plibs[n]) if pbuild is not None else {}
        for fn in sorted(mine):
            line = f"HMMA, instructions {n} {fn}: {mine[fn][0]}, {mine[fn][1]}"
            if pbuild is not None:
                par = theirs.get(fn)
                line += f" (parent {par[0]}, {par[1]})" if par else " (parent none)"
                if f32_code(fn) and (par is None or par[0] != mine[fn][0]):
                    bad.append(f"{n} {fn}: HMMA {mine[fn][0]}, parent {par}")
            print(line, flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def product_inputs(b, h, s, e):
        x = [torch.randn((b, s, h, e), generator=gen, device=dev).transpose(1, 2)
             for _ in range(4)]
        return tla.feature_map(x[0]), tla.feature_map(x[1]), x[2], x[3]

    for shape in F_SHAPES:
        pq, pk, v, g = product_inputs(*shape)
        b16 = cs.as_bf16((pq, pk, v, g))
        r, _ = cs.product_bf16_readings(tlk, tla, *b16, EPS, 128)
        fails = cs.bf16_gate_failures(r, cs.F_BF16_GATES, {"control": "the bf16 composition",
                                                           "control_f32_route": "F's f32 route"})
        bad += fails
        print(f"F bf16 {shape}: " + "; ".join(
            f"{n} {x['kernel'][0]:.2e} / {x['kernel'][1]:.2e} (controls {x['control'][1]:.2e}"
            + (f", {x['control_f32_route'][1]:.2e}" if "control_f32_route" in x else "") + ")"
            for n, x in r.items()) + f"; gate {'fails: ' + str(fails) if fails else 'holds'}",
            flush=True)
        o, d = tlk.forward_kernel(*b16[:3], EPS)
        ex = cs.product_exact_readings(tlk.forward_kernel, *b16[:3], EPS, (o, d), 128)
        bad += [f"F bf16 {shape} exact: {m}" for m in cs.exact_gate_failures(ex)]
        print(f"  exact gate (differing elements; control): " + ", ".join(
            f"{n} {r['kernel']} ({r['control']})" for n, r in ex.items()), flush=True)
        g1 = tlk.backward_kernel(*b16[:3], o, d, b16[3], EPS)
        g2 = tlk.backward_kernel(*b16[:3], o, d, b16[3], EPS)
        same = all(torch.equal(a, c) for a, c in zip(g1, g2))
        bad += [] if same else [f"F bf16 {shape}: two backward runs differ"]
        ok, gk = cs.fwd_bwd(lambda *a: tlk.causal_product(*a)[0], (pq, pk, v), g)
        op, gp = cs.fwd_bwd(lambda *a: tlk.causal_product_plain(*a)[0], (pq, pk, v), g)
        print(f"  bf16 backward runs bit-equal: {same}; f32 out "
              f"{cs.max_err(ok, op) / cs.magnitude(op):.2e}, gradients " + ", ".join(
                  f"{cs.max_err(a, c) / cs.magnitude(c):.2e}" for a, c in zip(gk, gp)),
              flush=True)
    dms = torch.from_numpy(dataset.synthetic_cp_dataset(4, 3584, n_class=(56, 135, 18, 87, 18, 25),
                                                        seed=0)[2]).to(dev)
    for b, h, s, d, win in E_SHAPES:
        if s == 3584:
            mask = dms
        else:
            mask = torch.ones((b, s), device=dev)
            mask[0, -70:] = 0.0
        x = [torch.randn((b, s, h, d), generator=gen, device=dev).transpose(1, 2)
             for _ in range(4)]
        g = x[3] * mask[:, None, :, None]
        r, got = cs.band_bf16_readings(twk, *cs.as_bf16(x[:3]), mask, win, g.bfloat16())
        ex = cs.band_exact_readings(twk, twk.forward_kernel, twk.backward_kernel,
                                    *cs.as_bf16(x[:3]), mask, win, g.bfloat16(), got)
        bad += [f"E bf16 {(b, h, s, d, win)} exact: {m}" for m in cs.exact_gate_failures(ex)]
        print(f"E bf16 {(b, h, s, d, win)} exact gate (differing elements; control): " + ", ".join(
            f"{n} {y['kernel']} ({y['control']})" for n, y in ex.items()), flush=True)
        fails = cs.bf16_gate_failures(r, cs.E_BF16_GATES, {"control": "the P / dS rounded control"})
        bad += fails
        print(f"E bf16 {(b, h, s, d, win)}: " + "; ".join(
            f"{n} {y['kernel'][0]:.2e} / {y['kernel'][1]:.2e} (control {y['control'][1]:.2e})"
            for n, y in r.items()) + f"; gate {'fails: ' + str(fails) if fails else 'holds'}",
            flush=True)
        ok, gk = cs.fwd_bwd(lambda *a: twk.window_attention_band(*a, mask, win), x[:3], g)
        op, gp = cs.fwd_bwd(lambda *a: twk.window_attention_band_plain(*a, mask, win)[0], x[:3], g)
        print(f"  f32 out {cs.max_err(ok, op) / cs.magnitude(op):.2e}, gradients " + ", ".join(
            f"{cs.max_err(a, c) / cs.magnitude(c):.2e}" for a, c in zip(gk, gp)), flush=True)
    d_, h_, bt, st = 512, 8, 32, 512
    h_tr, g_tr = (torch.randn((bt * st, d_), generator=gen, device=dev) for _ in range(2))
    w = torch.randn((d_, 3 * d_), generator=gen, device=dev) * 0.04
    bias = torch.randn(3 * d_, generator=gen, device=dev) * 0.02
    rc = cs.qkv_bf16_readings(tab, *cs.as_bf16((h_tr, w, bias)), g_tr.bfloat16(), bt, h_, 128)
    fails = cs.qkv_bf16_gate_failures(rc)
    bad += fails
    print("C bf16 at 16384 rows: " + "; ".join(
        f"{n} {x['kernel'][0]:.2e} / {x['kernel'][1]:.2e} (control {x['control'][1]:.2e})"
        for n, x in rc.items()) + f"; gate {'fails' if fails else 'holds'}", flush=True)
    for shape in F_SHAPES[:3]:
        row = []
        for dt in (torch.bfloat16, torch.float32):
            pq, pk, v, g = (t.to(dt) for t in product_inputs(*shape))
            o, d = tlk.forward_kernel(pq, pk, v, EPS)
            row.append((cs.device_ms(lambda: tlk.forward_kernel(pq, pk, v, EPS), 20),
                        cs.device_ms(lambda: tlk.backward_kernel(pq, pk, v, o, d, g, EPS), 20)))
        print(f"F device ms {shape}: bf16 {row[0][0]:.4f} / {row[0][1]:.4f}, f32 "
              f"{row[1][0]:.4f} / {row[1][1]:.4f}", flush=True)
    x = [torch.randn((4, 3584, 8, 64), generator=gen, device=dev).transpose(1, 2)
         for _ in range(4)]
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, g = (t.to(dt) for t in x)
        o, sts = twk.forward_kernel(q, k, v, dms, 512)
        fwd = cs.device_ms(lambda: twk.forward_kernel(q, k, v, dms, 512), 10)
        bwd = cs.device_ms(lambda: twk.backward_kernel(q, k, v, dms, o, sts, g, 512), 10)
        print(f"E device ms {dt}: {fwd:.4f} / {bwd:.4f}", flush=True)
    if bad:
        sys.exit("FAIL: " + "; ".join(bad))
    print("all gates hold")


if __name__ == "__main__":
    main()
