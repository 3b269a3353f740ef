#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's generation path, on one GPU.

    python3 scripts/profile_torch_decode.py [--out build/profile]

At the flagship width (config.agent_config, random weights from a seed) it
traces, with torch.profiler, the decode paths of ``generate``:
  * per-step: ``generate_tokens(fused=True, fused_sampling=True)``, 5 songs,
    64 steps (the decode_step kernel plus the sampling in PyTorch), with
    f32 weights and again with bf16 (``generate``'s default);
  * chunked: ``generate_tokens_persistent``, 128 songs, one 128-token call
    (the decode_chunk kernel, sampling included), f32 weights;
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
device busy share (device time over wall time; launches overlap rarely
here, so the sum is close to the busy time) and the kernels that took most
of it, then one JSON line with the same numbers.  Chrome traces go to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
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
    decode_kernel_v3 as dk3, sampling as smp)


def profile(name, fn, out_dir, top=10):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}.json"))
    kernels = {ev.key: (ev.count, ev.self_device_time_total / 1e3)   # us -> ms
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA}
    dev_ms = sum(v[1] for v in kernels.values())
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    print(f"[{name}] wall {wall * 1e3:.3f} ms, device {dev_ms:.3f} ms, "
          f"busy {dev_ms / (wall * 1e3):.1%}, {sum(v[0] for v in kernels.values())} launches")
    for kname, (n, ms) in rows:
        print(f"    {ms:10.3f} ms {n:6d}x  {kname[:100]}")
    return {"window": name, "wall_ms": wall * 1e3, "device_ms": dev_ms,
            "busy": dev_ms / (wall * 1e3) if wall else None,
            "launches": sum(v[0] for v in kernels.values()),
            "top": [{"kernel": k[:100], "n": n, "ms": ms} for k, (n, ms) in rows]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/profile")
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
        for _ in range(64):
            if sample:
                tok = smp.sample_fields(gen, lt.forward_output(p16, cfg, h), smp.CP_SAMPLING)
            h, st = dk3.decode_step_v3(p16, v3p, cfg, tok, st, pe_table=pe16)
        return h

    res = [
        profile("per_step_B5_64steps", lambda: sampler.generate_tokens(
            params, cfg, init(5), generator=gen, max_tokens=64, fused=True,
            fused_sampling=True), args.out),
        profile("chunked_B128_128tokens", lambda: sampler.generate_tokens_persistent(
            params, cfg, init(128), generator=gen, max_tokens=128), args.out),
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
