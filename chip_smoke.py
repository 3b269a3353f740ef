#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port
(``reinforcement_learning_in_music_generation_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and nvcc.  It
  1. builds every kernel of the generation path from ``csrc/`` (one nvcc
     per source, in parallel) and prints the card's name and power limit;
  2. at the full width of ``config.agent_config`` (12 layers, d_model 512,
     8 heads, FFN 2048) with random weights from a seed, holds each kernel
     against its plain PyTorch version on the same inputs:
       decode_step (v4 counterpart), 16 teacher-forced steps at B=5 and
       B=128 (and B=5 with bf16 weights): max |h| difference <= 1e-3 with
       an f32 state (both sides accumulate in f32; only the summation order
       differs), and >= 99% greedy next-token agreement with the default
       bf16 state;
       decode_chunk (v6 counterpart), B=128: >= 99% teacher-forced greedy
       agreement with f32 and bf16 states and bf16 weights (state
       difference <= 1e-4 of its magnitude with f32); chunk invariance (64 tokens in one call equal
       2 x 32, bit for bit); a greedy 128-token call (>= 95% of tokens
       equal: the fed-back streams part only after a near-tie); its heads +
       sample pass on fixed h against the plain version with the same seed
       (>= 99% of tokens equal: they differ only at near-ties);
  3. runs ``apps/cli.py generate`` end to end twice, 5 songs (the per-step
     v4 path) and 128 songs (the chunked v6 path), checks the MIDI files
     and fails if a kernel of the path was launched no time;
  4. times each kernel and its plain version at the main path's shapes
     (CUDA events) beside the least time the card could take.
It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # f32 FMA outside the tensor cores
FIELDS = 6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    try:
        from reinforcement_learning_in_music_generation_torch import config as C
        from reinforcement_learning_in_music_generation_torch.apps import cli
        from reinforcement_learning_in_music_generation_torch.data import tokenizer
        from reinforcement_learning_in_music_generation_torch.generate import sampler
        from reinforcement_learning_in_music_generation_torch.models import (
            common as cm, linear_transformer as lt)
        from reinforcement_learning_in_music_generation_torch.ops import (
            _build, decode_kernel_v4 as dk4, decode_kernel_v6 as dk6, sampling as smp)
    except ImportError as e:
        fail(f"the port's package is not importable ({e}); run from the repo root")

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"card: {smi_line}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # -- 1. build ---------------------------------------------------------
    t = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t:.1f}s", flush=True)
    for name in libs:                        # ptxas -v: registers and spills per kernel
        log = _build.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))
        print(f"[build] {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
              f"registers a thread, {spills} bytes of spill stores")

    e2w, _ = tokenizer.drop_type(tokenizer.construct_cp_dict())
    cfg = C.agent_config(tuple(tokenizer.n_classes(e2w)))
    L, D, H, E, DI = cfg.n_layer, cfg.d_model, cfg.n_head, cfg.d_head, cfg.d_inner
    params = lt.init_params(cfg, seed=0, device=dev)
    dparams = lt.make_decode_params(params, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def rand_tokens(steps, b):
        return torch.stack([torch.randint(0, v, (steps, b), generator=gen, device=dev)
                            for v in cfg.vocab_sizes], dim=-1).to(torch.int32)

    def greedy_next(h):
        logits = lt.fused_logits(dparams, cfg, cm.layernorm(params["final_ln"], h))
        return torch.stack([lg.argmax(-1) for lg in logits], dim=-1)

    # -- 2a. decode_step (v4 counterpart) against its plain version --------
    # (weights, songs, state): the generate default (f32 weights, bf16 state)
    # at both batches, an f32 state for the tight check, and --dtype bfloat16
    f32, bf16 = torch.float32, torch.bfloat16
    dparams_bf16 = lt.make_decode_params(params, cfg, bf16)
    a_err = 0.0
    for wdt, b, sdt in ((f32, 5, f32), (f32, 5, bf16), (f32, 128, f32), (f32, 128, bf16),
                        (bf16, 5, f32), (bf16, 5, bf16)):
        dp = dparams if wdt == f32 else dparams_bf16
        toks = rand_tokens(16, b)
        sk = dk4.init_state(cfg, b, sdt, dev)
        sp = dk4.init_state(cfg, b, sdt, dev)
        agree = total = 0
        dh = 0.0
        for t in range(16):
            h0 = lt.embed_input(params, cfg, toks[t], t, None).float()
            hk, _, _ = dk4.fused_stack_step(dp, h0, sk.s, sk.z, n_head=H, eps=cfg.attn_eps)
            hp, _, _ = dk4.fused_stack_step_plain(dp, h0, sp.s, sp.z, n_head=H,
                                                  eps=cfg.attn_eps)
            dh = max(dh, (hk - hp).abs().max().item())
            gk, gp = greedy_next(hk), greedy_next(hp)
            agree += (gk == gp).sum().item()
            total += gk.numel()
        torch.cuda.synchronize()
        ds = (sk.s.float() - sp.s.float()).abs().max().item()
        rate = agree / total
        tag = f"B={b} weights {str(wdt)[6:]} state {str(sdt)[6:]}"
        print(f"[decode_step] {tag}: max|dh| {dh:.3e}, max|ds| {ds:.3e}, "
              f"greedy agreement {rate:.4%}", flush=True)
        if sdt == f32:
            check(dh <= 1e-3, f"decode_step {tag}: max|dh| {dh} > 1e-3")
            a_err = max(a_err, dh)
        else:
            check(rate >= 0.99, f"decode_step {tag}: agreement {rate} < 99%")

    # -- 2b. decode_chunk (v6 counterpart) against its plain version -------
    v6p = dk6.make_v6_params(params, cfg)
    b6 = 128
    temps = tuple(s.temperature for s in smp.CP_SAMPLING)
    topps = tuple(s.top_p if s.top_p is not None else float("inf") for s in smp.CP_SAMPLING)
    kw = dict(n_head=H, vocab_sizes=cfg.vocab_sizes, temps=temps, topps=topps,
              eps=cfg.attn_eps)
    b_err = 0.0
    toks = rand_tokens(16, b6)
    v6p_bf16 = dk6.make_v6_params(params, cfg, dtype=bf16)
    for wdt, sdt in ((f32, f32), (f32, bf16), (bf16, bf16)):
        vp = v6p if wdt == f32 else v6p_bf16
        sk = dk4.init_state(cfg, b6, sdt, dev)
        sp = dk4.init_state(cfg, b6, sdt, dev)
        agree = total = 0
        for t in range(16):
            ok, _, _ = dk6.fused_decode_v6(vp, toks[t], sk.s, sk.z, t, 7, max_tokens=1,
                                           greedy=True, **kw)
            op, _, _ = dk6.fused_decode_v6_plain(vp, toks[t], sp.s, sp.z, t, 7,
                                                 max_tokens=1, greedy=True, n_head=H,
                                                 temps=temps, topps=topps, eps=cfg.attn_eps)
            agree += (ok == op).sum().item()
            total += ok.numel()
        rate = agree / total
        ds = (sk.s.float() - sp.s.float()).abs().max().item()
        mag = sp.s.float().abs().max().item()
        tag = f"B={b6} weights {str(wdt)[6:]} state {str(sdt)[6:]}"
        print(f"[decode_chunk] {tag}: teacher-forced greedy agreement {rate:.4%}, "
              f"max|ds| {ds:.3e} (max|s| {mag:.3e})", flush=True)
        check(rate >= 0.99, f"decode_chunk {tag}: agreement {rate} < 99%")
        if sdt == f32:
            check(ds <= 1e-4 * max(1.0, mag), f"decode_chunk {tag}: max|ds| {ds}")
            b_err = ds

    tok0 = torch.tensor(sampler.CP_SEED, dtype=torch.int32, device=dev).repeat(b6, 1)
    s1 = dk4.init_state(cfg, b6, device=dev)
    s2 = dk4.init_state(cfg, b6, device=dev)
    one, _, _ = dk6.fused_decode_v6(v6p, tok0, s1.s, s1.z, 0, 99, max_tokens=64, **kw)
    first, _, _ = dk6.fused_decode_v6(v6p, tok0, s2.s, s2.z, 0, 99, max_tokens=32, **kw)
    second, _, _ = dk6.fused_decode_v6(v6p, first[-1].contiguous(), s2.s, s2.z, 32, 99,
                                       max_tokens=32, **kw)
    same = torch.equal(one, torch.cat([first, second])) and torch.equal(s1.s, s2.s) \
        and torch.equal(s1.z, s2.z)
    print(f"[decode_chunk] chunk invariance (64 vs 2x32 tokens, B={b6}): "
          f"{'identical' if same else 'DIFFERENT'}", flush=True)
    check(same, "decode_chunk: one call of 64 tokens differs from two of 32")

    # a whole 128-token call (the main path's chunk) feeds each token back:
    # greedy with an f32 state, the streams agree until a near-tie flips one
    sk = dk4.init_state(cfg, b6, torch.float32, dev)
    sp = dk4.init_state(cfg, b6, torch.float32, dev)
    gk, _, _ = dk6.fused_decode_v6(v6p, tok0, sk.s, sk.z, 0, 0, max_tokens=128,
                                   greedy=True, **kw)
    gp, _, _ = dk6.fused_decode_v6_plain(v6p, tok0, sp.s, sp.z, 0, 0, max_tokens=128,
                                         greedy=True, n_head=H, temps=temps, topps=topps,
                                         eps=cfg.attn_eps)
    rate = (gk == gp).float().mean().item()
    print(f"[decode_chunk] greedy 128-token call, B={b6}, f32 state: {rate:.4%} of "
          f"tokens equal to the plain version", flush=True)
    check(rate >= 0.95, f"decode_chunk greedy 128-token call: {rate} < 95% equal")

    hfix = torch.randn((b6, D), generator=gen, device=dev)
    for greedy in (False, True):
        hk = dk6.heads_sample(v6p, hfix, seed=5, pos=3, temps=temps, topps=topps,
                              greedy=greedy)
        hp = dk6.heads_sample_plain(v6p, hfix, seed=5, pos=3, temps=temps, topps=topps,
                                    greedy=greedy)
        rate = (hk == hp).float().mean().item()
        print(f"[decode_chunk] heads+sample on fixed h ({'greedy' if greedy else 'CP sampling'}"
              f"): {rate:.4%} of tokens equal", flush=True)
        check(rate >= 0.99, f"heads+sample: agreement {rate} < 99%")

    # -- 3. the main path, end to end -------------------------------------
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, songs, max_tok, counter in (
                ("v4", 5, 512, dk4.fused_stack_step), ("v6", 128, 256, dk6.fused_decode_v6)):
            out = os.path.join(tmp, name)
            dk4.fused_stack_step.launches = 0
            dk6.fused_decode_v6.launches = 0
            res = cli.main(["generate", "--songs", str(songs), "--bars", "8",
                            "--max-tokens", str(max_tok), "--out-dir", out])
            torch.cuda.synchronize()
            launches[name] = counter.launches
            print(f"[generate] {songs} songs: {res['tokens']} tokens in "
                  f"{res['seconds']:.3f}s = {res['tokens_per_s']:.1f} tokens/s; launches "
                  f"decode_step {dk4.fused_stack_step.launches}, decode_chunk "
                  f"{dk6.fused_decode_v6.launches}", flush=True)
            check(counter.launches > 0, f"generate {songs} songs: its kernel never launched")
            for i in range(songs):
                with open(os.path.join(out, f"get_{i}.mid"), "rb") as f:
                    head = f.read(4)
                check(head == b"MThd", f"generate {songs} songs: get_{i}.mid is not a MIDI")
            check(res["songs"] == songs and res["tokens"] >= songs, "generate: no tokens")

    # -- 4. times at the main path's shapes --------------------------------
    st = dk4.init_state(cfg, 5, device=dev)
    sdt = st.s.dtype
    h5 = lt.embed_input(params, cfg, rand_tokens(1, 5)[0], 0, None).float()
    a_ms = time_ms(lambda: dk4.fused_stack_step(dparams, h5, st.s, st.z, n_head=H), 50)
    a_plain = time_ms(lambda: dk4.fused_stack_step_plain(dparams, h5, st.s, st.z,
                                                         n_head=H), 20)
    wts = dk4.layer_weights(dparams)
    a_bytes = nbytes(wts) + 2 * nbytes([st.s, st.z]) + 2 * h5.numel() * 4
    a_flops = 2 * 5 * L * (4 * D * D + 2 * D * DI) + 4 * L * 5 * H * E * E
    a_bound, a_by = bound(a_bytes, a_flops)

    T6 = 128
    st6 = dk4.init_state(cfg, b6, device=dev)
    b_ms = time_ms(lambda: dk6.fused_decode_v6(v6p, tok0, st6.s, st6.z, 0, 1,
                                               max_tokens=T6, **kw), 3)
    b_plain = time_ms(lambda: dk6.fused_decode_v6_plain(
        v6p, tok0, st6.s, st6.z, 0, 1, max_tokens=T6, n_head=H, temps=temps,
        topps=topps, eps=cfg.attn_eps), 1)
    b_bytes = (nbytes(wts) + nbytes([v6p.head_w, v6p.head_b, v6p.m, v6p.b_in, v6p.fls,
                                     v6p.flb]) + T6 * D * 4 + 2 * nbytes([st6.s, st6.z])
               + b6 * FIELDS * 4 * (T6 + 1))
    b_flops = T6 * (2 * b6 * (L * (4 * D * D + 2 * D * DI) + D * FIELDS * 256)
                    + 4 * L * b6 * H * E * E)
    b_bound, b_by = bound(b_bytes, b_flops)
    print(f"[time] decode_step B=5 (f32 weights, {str(sdt)[6:]} state): {a_ms:.3f} ms, "
          f"plain {a_plain:.3f} ms, bound {a_bound:.4f} ms ({a_by})")
    print(f"[time] decode_chunk B={b6} T={T6}: {b_ms:.3f} ms, plain {b_plain:.3f} ms, "
          f"bound {b_bound:.4f} ms ({b_by})")

    pkg = "reinforcement_learning_in_music_generation_torch"
    tpu = "reinforcement_learning_in_music_generation_tpu/ops"
    kernels = [
        {"name": "decode_step_v4", "route": "cuda", "source": f"{pkg}/csrc/decode_step.cu",
         "replaces": f"{tpu}/decode_kernel_v4.py:155", "launches": launches["v4"],
         "max_abs_err": a_err, "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
         "bound_by": a_by, "library_ms": None},
        {"name": "decode_chunk_v6", "route": "cuda", "source": f"{pkg}/csrc/decode_chunk.cu",
         "replaces": f"{tpu}/decode_kernel_v6.py:364", "launches": launches["v6"],
         "max_abs_err": b_err, "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound,
         "bound_by": b_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
