#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port
(``reinforcement_learning_in_music_generation_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and nvcc.  It
  1. builds every kernel of the generation and training paths from
     ``csrc/`` (one nvcc per source, in parallel), prints each library's
     ptxas registers and spills, and the card's name and power limit;
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
  4. holds the two training kernels against their plain versions at the
     pretrain slice's shapes (B=32 x S=512 rows, flagship width, f32,
     TF32 off): qkv_attention_block (kernel C) forward within 1e-4 of the
     output's magnitude and (dh, dWqkv, dbqkv) within 1e-3 of each
     gradient's; attn_tail_block (kernel D) the same, at dropout 0 and 0.1
     (the plain version draws the same Philox bits);
  5. takes one full-width train step (dropout 0, same weights and batch)
     on the kernel route and on the plain route: losses within 1e-4
     relative, every gradient within 1e-3 of its leaf's magnitude, every
     parameter after the Adam update within 1e-4 of its magnitude, and the
     Adam updates themselves within 1e-3 of the leaf's largest update
     wherever the plain gradient's sign is settled (|g| above the gradient
     check's limit); then times two more steps of each;
  6. runs ``apps/cli.py pretrain`` for 4 steps at B=32, S=512 on each route
     and fails unless each training-kernel counter reads 12 x steps on the
     kernel route (0 on the plain one) and every logged loss is finite;
  7. times each kernel and its plain version at the main path's shapes
     (CUDA events) beside the least time the card could take.
It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.
"""

from __future__ import annotations

import json
import math
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


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def magnitude(t) -> float:
    return max(1.0, t.float().abs().max().item())


def named_leaves(tree, prefix=""):
    """{"/layers/wq/w": detached copy, ...} of a nested dict of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(named_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().clone()}


def fwd_bwd(fn, inputs, g):
    """fn's output and the gradients of <output, g> w.r.t. every input."""
    ts = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ts)
    return out.detach(), torch.autograd.grad(out, ts, g)


def time_fwd_bwd(fn, inputs, g, reps: int):
    """(forward ms, backward ms): the forward without autograd, the
    backward of one retained graph."""
    with torch.no_grad():
        f_ms = time_ms(lambda: fn(*inputs), reps)
    ts = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ts)
    b_ms = time_ms(lambda: torch.autograd.grad(out, ts, g, retain_graph=True), reps)
    return f_ms, b_ms


def qkv_attention_work(n, d, h, n_seq, tile=64):
    """(forward, backward) operations and bytes of qkv_attention_block at
    this shape, the attention counted at the kernel's 64-row tile: a score
    product (q k^T, A v and their backward counterparts) counts only its
    causal half, tile (tile + 1) e operations, and a state product
    (q S, S += k^T v, ...) 2 tile e^2.  Forward: 2 score and 2 state
    products a tile; backward: 2 + 2 in the prefix pass, 4 + 3 in the
    suffix pass, plus the dh / dW / db products."""
    e, s = d // h, n // n_seq
    tiles = n_seq * h * -(-s // tile)
    tri, state = tile * (tile + 1) * e, 2 * tile * e * e
    f_ops = 2 * n * d * 3 * d + tiles * (2 * tri + 2 * state)
    b_ops = tiles * (6 * tri + 5 * state) + 4 * n * d * 3 * d + n * 3 * d
    f_bytes = 4 * (n * d + 3 * d * d + 3 * d + n * d + 3 * n * d + n * h)
    b_bytes = 4 * (3 * n * d + n * d + n * d + n * h + n * d + 3 * d * d + n * d + 3 * d * d
                   + 3 * d)
    return (f_ops, f_bytes), (b_ops, b_bytes)


def attn_tail_work(n, d, di):
    """(forward, backward) operations and bytes of attn_tail_block: the
    backward recomputes the forward and takes two products per weight."""
    w = 4 * (d * d + 2 * d * di + 7 * d + di)
    f_ops = 2 * n * (d * d + 2 * d * di)
    return (f_ops, 4 * 3 * n * d + w), (3 * f_ops, 4 * 5 * n * d + 2 * w)


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

    # -- 4. the training kernels against their plain versions -------------
    from reinforcement_learning_in_music_generation_torch.data import dataset
    from reinforcement_learning_in_music_generation_torch.ops import (
        attention_block as tab, ffn_block as tfb)
    from reinforcement_learning_in_music_generation_torch.train import (
        optim as topt, pretrain as tpre)
    BT, ST, CHUNK = 32, 512, cfg.attn_chunk
    NT = BT * ST
    lp0 = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in params["layers"].items()}
    wqkv = torch.cat([lp0["wq"]["w"], lp0["wk"]["w"], lp0["wv"]["w"]], -1).contiguous()
    bqkv = torch.cat([lp0["wq"]["b"], lp0["wk"]["b"], lp0["wv"]["b"]]).contiguous()
    h_tr = torch.randn((NT, D), generator=gen, device=dev)
    g_tr = torch.randn((NT, D), generator=gen, device=dev)
    c_in = (h_tr, wqkv, bqkv)
    c_kernel = lambda h_, w_, b_: tab.qkv_attention_block(h_, w_, b_, BT, H, chunk=CHUNK)
    c_plain = lambda h_, w_, b_: tab.qkv_attention_block_plain(h_, w_, b_, BT, H, chunk=CHUNK)
    ok, gk = fwd_bwd(c_kernel, c_in, g_tr)
    op, gp = fwd_bwd(c_plain, c_in, g_tr)
    c_err = max_err(ok, op)
    print(f"[qkv_attention] B={BT} S={ST} D={D} H={H} chunk {CHUNK}: max|d att| {c_err:.3e} "
          f"(max|att| {magnitude(op):.3e})", flush=True)
    check(c_err <= 1e-4 * magnitude(op), f"qkv_attention forward: max|d att| {c_err}")
    for name, x, y in zip(("dh", "dWqkv", "dbqkv"), gk, gp):
        e = max_err(x, y)
        print(f"[qkv_attention] {name}: max|diff| {e:.3e} of magnitude {magnitude(y):.3e}",
              flush=True)
        check(e <= 1e-3 * magnitude(y), f"qkv_attention {name}: max|diff| {e}")

    tail_ws = [lp0["wo"]["w"], lp0["wo"]["b"], lp0["ln1"]["scale"], lp0["ln1"]["bias"],
               lp0["ffn1"]["w"], lp0["ffn1"]["b"], lp0["ffn2"]["w"], lp0["ffn2"]["b"],
               lp0["ln2"]["scale"], lp0["ln2"]["bias"]]
    tail_ws = [t.contiguous() for t in tail_ws]
    d_in = (h_tr, op.contiguous(), *tail_ws)
    seed_t = torch.tensor(20260, dtype=torch.int32, device=dev)
    d_err = 0.0
    tail_names = ("dh_in", "da_pre", "dWo", "dbo", "dln1_s", "dln1_b", "dW1", "db1", "dW2",
                  "db2", "dln2_s", "dln2_b")
    for p_drop in (0.0, 0.1):
        ok, gk = fwd_bwd(lambda *a: tfb.attn_tail_block(*a, seed_t, p_drop), d_in, g_tr)
        op_, gp = fwd_bwd(lambda *a: tfb.attn_tail_block_plain(*a, seed_t, p_drop), d_in, g_tr)
        e = max_err(ok, op_)
        d_err = max(d_err, e)
        print(f"[attn_tail] N={NT} D={D} DI={DI} p={p_drop}: max|d out| {e:.3e} "
              f"(max|out| {magnitude(op_):.3e})", flush=True)
        check(e <= 1e-4 * magnitude(op_), f"attn_tail p={p_drop} forward: max|diff| {e}")
        worst = 0.0
        for name, x, y in zip(tail_names, gk, gp):
            e = max_err(x, y) / magnitude(y)
            worst = max(worst, e)
            check(e <= 1e-3, f"attn_tail p={p_drop} {name}: max|diff| {e} of its magnitude")
        print(f"[attn_tail] p={p_drop}: 12 gradients, worst max|diff| / magnitude "
              f"{worst:.3e}", flush=True)
    del gk, gp

    # -- 5. one full-width train step, kernel route against plain route ----
    tcfg = C.agent_config(cfg.vocab_sizes, dropout=0.0)
    p0 = lt.init_params(tcfg, seed=0, device=dev)
    xs, ys, ms = (torch.from_numpy(a).to(dev) for a in
                  dataset.synthetic_cp_dataset(BT, ST, n_class=cfg.vocab_sizes, seed=0))
    xs, ys = xs.long(), ys.long()
    routes = {"kernel": {}, "plain": {"RLMG_FFN_BACKEND": "xla", "RLMG_ATTN_BACKEND": "xla"}}
    knobs = ("RLMG_FFN_BACKEND", "RLMG_ATTN_BACKEND", "RLMG_FFN_MIN_ROWS")
    saved_env = {k: os.environ.get(k) for k in knobs}

    def set_route(name):
        for k in knobs:
            os.environ.pop(k, None)
        os.environ.update(routes[name])

    def restore_env():
        for k, v in saved_env.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v

    counters = ((tab.qkv_attention_block, "launches_fwd"), (tab.qkv_attention_block, "launches_bwd"),
                (tfb.attn_tail_block, "launches_fwd"), (tfb.attn_tail_block, "launches_bwd"))

    def zero_counts():
        for fn, attr in counters:
            setattr(fn, attr, 0)

    def read_counts():
        return [getattr(fn, attr) for fn, attr in counters]

    step_out, step_ms = {}, {}
    for name in ("kernel", "plain"):
        set_route(name)
        prm = topt.tree_map(torch.clone, p0)
        tx = topt.adam(1e-4, grad_clip=3.0)
        state = tx.init(prm)
        zero_counts()
        grads, (loss, losses) = tpre.agent_grad_step(prm, tcfg, xs, ys, ms, None)
        updates, _ = tx.update(grads, state, prm)     # pure: what apply_grads adds
        prm, state = tpre.apply_grads(prm, state, tx, grads)
        torch.cuda.synchronize()
        counts = read_counts()
        step_out[name] = (float(loss), losses.cpu(), named_leaves(prm), named_leaves(grads),
                          named_leaves(updates))
        del grads, updates
        t = time.perf_counter()
        for _ in range(2):
            prm, state, (loss, _) = tpre.agent_train_step(prm, state, tcfg, tx, xs, ys, ms, None)
        torch.cuda.synchronize()
        step_ms[name] = (time.perf_counter() - t) / 2 * 1e3
        print(f"[train_step] {name} route: loss {step_out[name][0]:.6f}, kernel launches "
              f"(C fwd, C bwd, D fwd, D bwd) {counts}, {step_ms[name]:.1f} ms/step, "
              f"{NT / step_ms[name] * 1e3:.1f} tokens/s", flush=True)
        want = [tcfg.n_layer] * 4 if name == "kernel" else [0] * 4
        check(counts == want, f"train step, {name} route: launches {counts}, expected {want}")
        del prm, state
    restore_env()
    lk, lsk, pk, gk, uk = step_out["kernel"]
    lp_, lsp, pp, gp, up = step_out["plain"]
    rel = abs(lk - lp_) / abs(lp_)
    print(f"[train_step] loss kernel {lk:.7f} plain {lp_:.7f} (relative {rel:.2e}); "
          f"per field max relative {((lsk - lsp).abs() / lsp.abs()).max().item():.2e}",
          flush=True)
    check(rel <= 1e-4, f"train step: losses differ by {rel} relative")
    # gradients: each leaf within 1e-3 of its own magnitude.  Parameters
    # after Adam: within 1e-4 of magnitude(p) = max(1, max|p|), the
    # convention of every check here.  Per leaf without the floor, Adam's
    # g / (|g| + eps) magnifies gradient rounding near g = 0 by up to 1/eps,
    # which shows on the zero-initialised LayerNorm biases; printed too.
    # One step at lr 1e-4 moves a parameter by at most about 1e-4, so the
    # parameter check alone cannot see a wrong update: the updates are
    # compared on their own scale, wherever |g_plain| exceeds the gradient
    # check's limit (1e-3 of the leaf's largest), so no sign is left to
    # rounding; there g / (|g| + eps) moves by at most eps |dg| / g^2.
    g_worst = max((max_err(gk[k], gp[k]) / max(gp[k].abs().max().item(), 1e-30), k)
                  for k in gp)
    u_worst, u_seen = (0.0, ""), 0
    for k in up:
        settled = gp[k].abs() > 1e-3 * gp[k].abs().max()
        u_seen += int(settled.sum().item())
        if settled.any():
            e = (uk[k] - up[k])[settled].abs().max().item() / up[k].abs().max().item()
            u_worst = max(u_worst, (e, k))
    p_worst = max((max_err(pk[k], pp[k]) / magnitude(pp[k]), k) for k in pp)
    p_leaf = max((max_err(pk[k], pp[k]) / max(pp[k].abs().max().item(), 1e-30), k)
                 for k in pp)
    print(f"[train_step] gradients: worst max|diff| / leaf magnitude {g_worst[0]:.3e} "
          f"({g_worst[1]})", flush=True)
    print(f"[train_step] params after one Adam step: worst max|diff| / magnitude "
          f"{p_worst[0]:.3e} ({p_worst[1]}); without the floor of 1: {p_leaf[0]:.3e} "
          f"({p_leaf[1]})", flush=True)
    n_prm = sum(t.numel() for t in up.values())
    print(f"[train_step] Adam updates: worst max|diff| / leaf's largest update "
          f"{u_worst[0]:.3e} ({u_worst[1]}) over the {u_seen} of {n_prm} elements whose "
          f"gradient sign is settled", flush=True)
    check(g_worst[0] <= 1e-3, f"train step: gradient {g_worst[1]} differs by {g_worst[0]}")
    check(p_worst[0] <= 1e-4, f"train step: param {p_worst[1]} differs by {p_worst[0]}")
    check(u_worst[0] <= 1e-3, f"train step: update of {u_worst[1]} differs by {u_worst[0]}")
    del step_out, pk, pp, gk, gp, uk, up, p0

    # -- 6. the training main path: cli pretrain, 4 steps at B=32 x S=512 ---
    cli_res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("kernel", "plain"):
            set_route(name)
            zero_counts()
            res = cli.main(["pretrain", "--synthetic", "--synthetic-songs", "64",
                            "--batch-size", str(BT), "--seq-len", str(ST), "--max-steps", "4",
                            "--exp-dir", os.path.join(tmp, name, "exp"),
                            "--ckpt-dir", os.path.join(tmp, name, "ckpt")])
            torch.cuda.synchronize()
            counts = read_counts()
            cli_res[name] = (res, counts)
            ms_step = res["seconds"] / res["steps"] * 1e3
            print(f"[pretrain] {name} route: {res['steps']} steps in {res['seconds']:.3f}s "
                  f"= {ms_step:.1f} ms/step, {res['tokens_per_s']:.1f} tokens/s (with one "
                  f"epoch-end checkpoint); logged losses {res['batch_losses']}; launches "
                  f"(C fwd, C bwd, D fwd, D bwd) {counts}", flush=True)
            check(res["steps"] == 4, f"pretrain {name}: {res['steps']} steps, expected 4")
            check(len(res["batch_losses"]) > 0 and all(
                math.isfinite(v) for v in res["batch_losses"] + res["history"]),
                f"pretrain {name}: a logged loss is not finite")
            want = [12 * 4] * 4 if name == "kernel" else [0] * 4
            check(counts == want, f"pretrain {name}: launches {counts}, expected {want}")
    restore_env()
    launches["C"] = cli_res["kernel"][1][:2]
    launches["D"] = cli_res["kernel"][1][2:]

    # -- 7. times at the main path's shapes --------------------------------
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

    c_fwd, c_bwd = time_fwd_bwd(c_kernel, c_in, g_tr, 20)
    c_pf, c_pb = time_fwd_bwd(c_plain, c_in, g_tr, 5)
    att_k, pqkv_k, den_k = tab.forward_kernel(h_tr, wqkv, bqkv, BT, H, cfg.attn_eps)
    c_pass = time_ms(lambda: tab.backward_kernel(pqkv_k, g_tr, att_k, den_k, BT, H,
                                                 cfg.attn_eps), 20)
    (cf_ops, cf_b), (cb_ops, cb_b) = qkv_attention_work(NT, D, H, BT)
    c_bf, c_bfby = bound(cf_b, cf_ops)
    c_bb, c_bbby = bound(cb_b, cb_ops)
    d_tr = (h_tr, att_k.contiguous(), *tail_ws)
    d_fwd, d_bwd = time_fwd_bwd(lambda *a: tfb.attn_tail_block(*a, seed_t, 0.1), d_tr, g_tr, 10)
    d_pf, d_pb = time_fwd_bwd(lambda *a: tfb.attn_tail_block_plain(*a, seed_t, 0.1), d_tr,
                              g_tr, 3)
    (df_ops, df_b), (db_ops, db_b) = attn_tail_work(NT, D, DI)
    d_bf, d_bfby = bound(df_b, df_ops)
    d_bb, d_bbby = bound(db_b, db_ops)
    print(f"[time] qkv_attention N={NT}: forward {c_fwd:.3f} ms (plain {c_pf:.3f}, bound "
          f"{c_bf:.4f} {c_bfby}, {cf_ops / 1e9:.2f} GFLOP), backward {c_bwd:.3f} ms (plain "
          f"{c_pb:.3f}, bound {c_bb:.4f} {c_bbby}, {cb_ops / 1e9:.2f} GFLOP; the two kernel "
          f"passes alone {c_pass:.3f} ms)")
    print(f"[time] attn_tail N={NT} p=0.1: forward {d_fwd:.3f} ms (plain {d_pf:.3f}, bound "
          f"{d_bf:.4f} {d_bfby}, {df_ops / 1e9:.2f} GFLOP), backward {d_bwd:.3f} ms (plain "
          f"{d_pb:.3f}, bound {d_bb:.4f} {d_bbby}, {db_ops / 1e9:.2f} GFLOP)")
    print(f"[time] train step B={BT} S={ST}: kernel route {step_ms['kernel']:.1f} ms, plain "
          f"route {step_ms['plain']:.1f} ms")

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
        {"name": "qkv_attention_block", "route": "cuda",
         "source": f"{pkg}/csrc/attention_block.cu",
         "replaces": f"{tpu}/attention_block.py:346", "launches": sum(launches["C"]),
         "launches_fwd": launches["C"][0], "launches_bwd": launches["C"][1],
         "max_abs_err": c_err, "ms": c_fwd + c_bwd, "ms_fwd": c_fwd, "ms_bwd": c_bwd,
         "plain_ms": c_pf + c_pb, "bound_ms": c_bf + c_bb, "bound_ms_fwd": c_bf,
         "bound_ms_bwd": c_bb, "bound_by": c_bfby if c_bfby == c_bbby else "operations",
         "library_ms": None},
        {"name": "attn_tail_block", "route": "cuda", "source": f"{pkg}/csrc/attn_tail.cu",
         "replaces": f"{tpu}/ffn_block.py:419", "launches": sum(launches["D"]),
         "launches_fwd": launches["D"][0], "launches_bwd": launches["D"][1],
         "max_abs_err": d_err, "ms": d_fwd + d_bwd, "ms_fwd": d_fwd, "ms_bwd": d_bwd,
         "plain_ms": d_pf + d_pb, "bound_ms": d_bf + d_bb, "bound_ms_fwd": d_bf,
         "bound_ms_bwd": d_bb, "bound_by": d_bfby if d_bfby == d_bbby else "operations",
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
