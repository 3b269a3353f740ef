#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's generation path, on one GPU.

    python3 scripts/profile_torch_decode.py [--out build/profile]
    python3 scripts/profile_torch_decode.py --ablate [--reps 2]

At the flagship width (config.agent_config, random weights from a seed) it
traces, with torch.profiler, the decode paths of ``generate``:
  * per-step: ``generate_tokens(fused=True, fused_sampling=True)``, 5 songs,
    64 steps (the decode_step kernel plus the sampling in PyTorch), with
    f32 weights and again with bf16 (``generate``'s default);
  * chunked: ``generate_tokens_persistent``, 128 songs, one 128-token call
    (the decode_chunk kernel on the tensor cores, sampling included), f32
    weights (f32-grade products) and bf16 weights (``generate``'s default);
  * latency: ``generate_tokens_latency``, 5 songs, one 64-token call, bf16
    weights, on v8 and under ``RLMG_LATENCY_KERNEL=v7`` on v7 (the
    latency_decode kernels, sampling included);
  * v3: 32 songs, 64 steps of ``decode_step_v3`` (the decode_aug kernel),
    bf16 weights, f32 augmented state, the counterparts of runs E ("v3
    kernel only": a constant token fed back, no heads) and F ("v3 +
    sampling": heads and CP sampling in PyTorch) of the JAX package's
    ``scripts/profile_decode.py``.
Each window runs once untraced first (kernels built, caches warm).  For
each it prints the wall time, the summed device time of all kernels, the
device busy share (the union of the kernels' intervals over the wall
time) and the kernels that took most of it, then one JSON line with the
same numbers.  The tensor-core route launches each kernel as a
programmatic dependent of the one before it, so a kernel starts before its
predecessor ends and waits on the card: its intervals overlap, their sum
exceeds the busy time and a kernel's own time includes that wait.  Chrome
traces go to ``--out``.

``--ablate`` measures instead what each pass of that route adds to a
token's critical path: it copies ``csrc/`` into
``build/ablate_decode_chunk/<variant>/``, patches one pass out of
``decode_chunk_tc.cuh`` (its launch returns at once; the outputs are then
garbage, the timing is not), builds each variant with nvcc in parallel and
times a 128-token call at B=128 and a 64-token call at B=1024 (bf16
state, CP sampling, CUDA events after a warm call), with bf16 weights and
with f32 weights, for every variant in turn, ``--reps`` rounds.
Variants: full; no_pdl (plain stream order); no_state (the state pass);
no_ln (both LN passes); no_products (every product); no_ffn1 (FFN1 only);
w_hi_plane (f32 weights: the products copy only the weights' hi plane, a
third of the planes' bytes and half the f32 weights', so its gain bounds
what reading the weights as f32 and splitting them in shared memory could
save in bytes).  The difference from ``full`` is the pass's share of the
critical path.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from reinforcement_learning_in_music_generation_torch import config as C  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import tokenizer  # noqa: E402
from reinforcement_learning_in_music_generation_torch.generate import sampler  # noqa: E402
from reinforcement_learning_in_music_generation_torch.models import (  # noqa: E402
    common as cm, linear_transformer as lt)
from reinforcement_learning_in_music_generation_torch.ops import _build  # noqa: E402
from reinforcement_learning_in_music_generation_torch.ops import (  # noqa: E402
    decode_kernel_v3 as dk3, decode_kernel_v4 as dk4, decode_kernel_v6 as dk6, sampling as smp)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SKIP = "  return 0;\n"


def skip(line):
    """A patch that returns 0 from the launcher whose body starts with line."""
    return (line, SKIP + line)


ABLATIONS = {
    "full": [],
    "no_pdl": [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")],
    "no_state": [skip("  switch (E) {\n    case 16:")],
    "no_ln": [skip("  return pdl_launch(tc_ln_kernel<TW>,")],
    "no_products": [skip("  return sp.large ? tc_gemm_tile<")],
    "no_ffn1": [("    RLMG_TC_STEP(tc_gemm<TC_EPI_GELU>(",
                 "    if (0) RLMG_TC_STEP(tc_gemm<TC_EPI_GELU>(")],
    "w_hi_plane": [("        cp_async_bytes(s + pl * T::W_ELEMS",
                    "        if (pl == 0) cp_async_bytes(s + pl * T::W_ELEMS")],
}


def profile(name, fn, out_dir, top=10):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    trace = os.path.join(out_dir, f"{name}.json")
    prof.export_chrome_trace(trace)
    kernels = {ev.key: (ev.count, ev.self_device_time_total / 1e3)   # us -> ms
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA}
    dev_ms = sum(v[1] for v in kernels.values())
    busy_ms = kernel_union_ms(trace)
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    print(f"[{name}] wall {wall * 1e3:.3f} ms, device {dev_ms:.3f} ms (kernels' union "
          f"{busy_ms:.3f} ms), busy {busy_ms / (wall * 1e3):.1%}, "
          f"{sum(v[0] for v in kernels.values())} launches")
    for kname, (n, ms) in rows:
        print(f"    {ms:10.3f} ms {n:6d}x  {kname[:100]}")
    return {"window": name, "wall_ms": wall * 1e3, "device_ms": dev_ms,
            "union_ms": busy_ms, "busy": busy_ms / (wall * 1e3) if wall else None,
            "launches": sum(v[0] for v in kernels.values()),
            "top": [{"kernel": k[:100], "n": n, "ms": ms} for k, (n, ms) in rows]}


def kernel_union_ms(trace_path):
    """Length of the union of the kernels' intervals in a Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "kernel" and "dur" in e)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3                                             # us -> ms


def ablation_libs():
    """{variant: ctypes library of decode_chunk}, built in parallel."""
    src = os.path.join(ROOT, "reinforcement_learning_in_music_generation_torch", "csrc")
    out_root = os.path.join(ROOT, "build", "ablate_decode_chunk")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, patches in ABLATIONS.items():
        d = os.path.join(out_root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        header = os.path.join(d, "decode_chunk_tc.cuh")
        with open(header) as f:
            text = f.read()
        for old, new in patches:
            if old not in text:
                sys.exit(f"profile_torch_decode: the anchor of {name} is gone: {old!r}")
            text = text.replace(old, new)
        with open(header, "w") as f:
            f.write(text)
        lib = os.path.join(d, "libdecode_chunk.so")
        cmd = [_build.nvcc_path(), *flags, "-o", lib, os.path.join(d, "decode_chunk.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    real = dk6._lib()
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"profile_torch_decode: nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(path)
        for fn in ("rlmg_tc_workspace_bytes", "rlmg_decode_chunk_tc", "rlmg_heads_sample",
                   "rlmg_error_string"):
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = getattr(real, fn).restype
        libs[name] = lib
    return libs


def ablate(cfg, params, dev, reps):
    """Each variant's us a token at B=128 (128-token calls) and B=1024 (64),
    bf16 and f32 weights."""
    libs = ablation_libs()
    v6ps = {"bf16": dk6.make_v6_params(params, cfg, dtype=torch.bfloat16),
            "f32": dk6.make_v6_params(params, cfg, dtype=torch.float32)}
    kw = dict(n_head=cfg.n_head, vocab_sizes=cfg.vocab_sizes, eps=cfg.attn_eps,
              temps=tuple(s.temperature for s in smp.CP_SAMPLING),
              topps=tuple(s.top_p if s.top_p is not None else float("inf")
                          for s in smp.CP_SAMPLING))

    def time_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    for rnd in range(reps):
        for name, lib in libs.items():
            dk6._LIB = lib
            res = []
            for wname, v6p in v6ps.items():
                for b, T in ((128, 128), (1024, 64)):
                    st = dk4.init_state(cfg, b, torch.bfloat16, dev)
                    tok0 = torch.zeros((b, 6), dtype=torch.int32, device=dev)
                    ms = time_ms(lambda: dk6.fused_decode_v6(v6p, tok0, st.s, st.z, 0, 1,
                                                             max_tokens=T, **kw), 3)
                    res.append(f"{wname} B={b} {ms / T * 1e3:.1f} us a token")
            print(f"[ablate round {rnd}] {name:12s} " + ", ".join(res), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--ablate", action="store_true",
                    help="time kernel B's bf16 route with one pass patched out at a time")
    ap.add_argument("--reps", type=int, default=2, help="--ablate: rounds over the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_decode: needs a CUDA card")
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(f"card: {card}")
    _build.build_all()
    e2w, _ = tokenizer.drop_type(tokenizer.construct_cp_dict())
    cfg = C.agent_config(tuple(tokenizer.n_classes(e2w)))
    dev = torch.device("cuda")
    params = lt.init_params(cfg, seed=0, device=dev)
    if args.ablate:
        ablate(cfg, params, dev, args.reps)
        return
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def init(b):
        return torch.tensor([[sampler.CP_SEED]], dtype=torch.int32,
                            device=dev).expand(b, 1, 6).contiguous()

    p16 = lt.cast_params(params, torch.bfloat16)

    def latency(version):
        os.environ["RLMG_LATENCY_KERNEL"] = version
        return sampler.generate_tokens_latency(p16, cfg, init(5), generator=gen,
                                               max_tokens=64)

    pe16 = cm.sinusoidal_table(cfg.max_len, cfg.d_model, torch.bfloat16, dev)
    v3p = dk3.make_v3_params(p16, cfg, dtype=torch.bfloat16)

    def v3_steps(sample):
        b = 32
        st = lt.DecodeState(dk3.init_aug_state(cfg, b, dev), torch.zeros(1, device=dev), 0)
        h = torch.zeros((b, cfg.d_model), dtype=torch.bfloat16, device=dev)
        tok = torch.zeros((b, 6), dtype=torch.int32, device=dev)
        work = dk3.workspace(v3p, b)
        for _ in range(64):
            if sample:
                tok = smp.sample_fields(gen, lt.forward_output(p16, cfg, h), smp.CP_SAMPLING)
            h, st = dk3.decode_step_v3(p16, v3p, cfg, tok, st, pe_table=pe16, work=work)
        return h

    res = [
        profile("per_step_B5_64steps", lambda: sampler.generate_tokens(
            params, cfg, init(5), generator=gen, max_tokens=64, fused=True,
            fused_sampling=True), args.out),
        profile("chunked_B128_128tokens", lambda: sampler.generate_tokens_persistent(
            params, cfg, init(128), generator=gen, max_tokens=128), args.out),
        profile("chunked_B128_128tokens_bf16", lambda: sampler.generate_tokens_persistent(
            p16, cfg, init(128), generator=gen, max_tokens=128), args.out),
        profile("per_step_B5_64steps_bf16", lambda: sampler.generate_tokens(
            p16, cfg, init(5), generator=gen, max_tokens=64, fused=True,
            fused_sampling=True), args.out),
        profile("latency_v8_B5_64tokens_bf16", lambda: latency("v8"), args.out),
        profile("latency_v7_B5_64tokens_bf16", lambda: latency("v7"), args.out),
        profile("v3_B32_64steps_bf16", lambda: v3_steps(False), args.out),
        profile("v3_sampling_B32_64steps_bf16", lambda: v3_steps(True), args.out),
    ]
    print(json.dumps({"card": card, "windows": res}))


if __name__ == "__main__":
    main()
