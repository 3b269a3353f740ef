#!/usr/bin/env python3
"""Two checkouts' decode kernels held against each other on one card: the
outputs of kernel A, v3, v8 and v7 bit for bit, and the ms of those and of
v5 and v2, each checkout's run in turns A, B, B, A.

    python3 scripts/ab_torch_decode_kernels.py <checkout A> <checkout B> [rounds]
    python3 scripts/ab_torch_decode_kernels.py --run <checkout> <out.pt>

A run imports the package of its checkout (each builds its own kernels into
its build/torch_kernels/) and, at ``config.agent_config`` (12 layers,
d_model 512, 8 heads, FFN 2048) with random weights from seed 0 and tokens
from seed 1:
  * outputs: kernel A (``decode_kernel_v4.fused_stack_step``) over 8 tokens
    at B=5, bf16 weights and state and f32 weights and state (h and the
    state); v3 at one head of 512, B=5, both weight types (h and the
    augmented state); v8 and v7 one 32-token call at B=5, CP sampling, bf16
    weights and state (the tokens and the state);
  * ms (CUDA events over a run of calls after a warm one): A and v3 a
    token at B=5, v8 and v7 a token in 32-token calls at B=1, 5, 16, v5 a
    token at B=256 (32-token calls, bb 8, 16, 32) and B=8 (64-token
    calls), bf16 weights; v2 a layer call at B=32, f32 weights.
The comparison prints, for each output, whether the checkouts agree bit for
bit (and the max |diff| where not), then each time's per-run values and
medians.  It prints the card's name and power limit first and one JSON
line last; it exits 1 when an output differs.  Needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile


def _run(checkout: str, out: str) -> None:
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    from reinforcement_learning_in_music_generation_torch import config as C
    from reinforcement_learning_in_music_generation_torch.data import tokenizer
    from reinforcement_learning_in_music_generation_torch.models import (
        common as cm, linear_transformer as lt)
    from reinforcement_learning_in_music_generation_torch.ops import (
        decode_kernel_v3 as dk3, decode_kernel_v4 as dk4, sampling as smp)
    from reinforcement_learning_in_music_generation_torch.ops.experimental import (
        decode_kernel as dk, decode_kernel_v5 as dk5, decode_kernel_v7 as dk7,
        decode_kernel_v8 as dk8)
    from reinforcement_learning_in_music_generation_torch.ops import _build

    assert os.path.abspath(dk4.__file__).startswith(os.path.abspath(checkout))
    started = {n: _build._start(n) for n in ("decode_step", "decode_aug", "latency_decode")}
    for n, st in started.items():            # one nvcc a source, in parallel
        if st is not None:
            _build._finish(n, st)
    dev = "cuda"
    f32, bf16 = torch.float32, torch.bfloat16
    e2w, _ = tokenizer.drop_type(tokenizer.construct_cp_dict())
    cfg = C.agent_config(tuple(tokenizer.n_classes(e2w)))
    cfg1 = dataclasses.replace(cfg, n_head=1)
    params = lt.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def tokens(steps, b):
        return torch.stack([torch.randint(0, v, (steps, b), generator=gen, device=dev)
                            for v in cfg.vocab_sizes], dim=-1).to(torch.int32)

    def time_ms(fn, reps):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    kw = dict(vocab_sizes=cfg.vocab_sizes, greedy=False, eps=cfg.attn_eps,
              temps=tuple(s.temperature for s in smp.CP_SAMPLING),
              topps=tuple(s.top_p if s.top_p is not None else float("inf")
                          for s in smp.CP_SAMPLING))
    outs, ms = {}, {}
    b = 5
    toks = tokens(8, b)
    for wdt, sdt in ((bf16, bf16), (f32, f32)):
        dp = lt.make_decode_params(params, cfg, wdt)
        st = dk4.init_state(cfg, b, sdt, dev)
        for t in range(8):
            h0 = lt.embed_input(params, cfg, toks[t], t, None).float()
            h = dk4.fused_stack_step(dp, h0, st.s, st.z, n_head=cfg.n_head)[0]
        tag = f"A {str(wdt)[6:]} weights {str(sdt)[6:]} state"
        outs[tag + " h"], outs[tag + " s"], outs[tag + " z"] = h.cpu(), st.s.cpu(), st.z.cpu()
        if wdt == bf16:
            work = dk4.workspace(dp, b)
            ms["A B=5"] = time_ms(lambda: dk4.fused_stack_step(
                None, h0, st.s, st.z, n_head=cfg.n_head, work=work), 30)
    for wdt in (bf16, f32):
        v3p = dk3.make_v3_params(params, cfg1, dtype=wdt)
        sa = dk3.init_aug_state(cfg1, b, dev)
        for t in range(8):
            h0 = lt.embed_input(params, cfg1, toks[t], t, None).float()
            h = dk3.fused_stack_step(v3p, h0, sa, n_head=1)[0]
        tag = f"v3 one head {str(wdt)[6:]} weights"
        outs[tag + " h"], outs[tag + " s"] = h.cpu(), sa.cpu()
        if wdt == bf16:
            work = dk3.workspace(v3p, b)
            ms["v3 one head B=5"] = time_ms(lambda: dk3.fused_stack_step(
                None, h0, sa, n_head=1, work=work), 30)
    rp = dk8.make_resident_params(params, cfg, dtype=bf16)
    tok0 = tokens(1, b)[0]
    for name, fn in (("v8", dk8.fused_decode_v8), ("v7", dk7.fused_decode_v7)):
        st = dk4.init_state(cfg, b, bf16, dev)
        tk, s, z = fn(rp, tok0, st.s, st.z, 0, 7, n_head=cfg.n_head, max_tokens=32, **kw)
        outs[f"{name} tokens"], outs[f"{name} s"], outs[f"{name} z"] = tk.cpu(), s.cpu(), z.cpu()
        for bt in (1, 5, 16):
            tb = tokens(1, bt)[0]
            st = dk4.init_state(cfg, bt, bf16, dev)
            ms[f"{name} B={bt}"] = time_ms(lambda: fn(rp, tb, st.s, st.z, 0, 1,
                                                      n_head=cfg.n_head, max_tokens=32, **kw),
                                           5) / 32
    v5p = dk5.make_v5_params(params, cfg)
    pe = cm.sinusoidal_table(cfg.max_len, cfg.d_model, f32, dev)
    for bt, T, bbs in ((256, 32, (8, 16, 32)), (8, 64, (8,))):
        st = lt.init_decode_state(cfg, bt, device=dev)
        s5, z5 = dk5.pack_state(st.s, st.z)
        tb = tokens(1, bt)[0]
        for bb in bbs:
            ms[f"v5 B={bt} bb={bb}"] = time_ms(lambda: dk5.fused_decode_v5(
                v5p, tb, s5, z5, pe[:T], 1, n_head=cfg.n_head, max_tokens=T, bb=bb, **kw),
                3) / T
        del s5, z5, st
    h32 = lt.embed_input(params, cfg, tokens(1, 32)[0], 0, None).float()
    lp = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in params["layers"].items()}
    s1 = dk.aug_state_init(cfg, 32, dev)[0]
    ms["v2 one layer B=32"] = time_ms(lambda: dk.fused_layer_step_v2(
        h32, lp, s1, n_head=cfg.n_head), 20)
    torch.cuda.synchronize()
    torch.save({"outputs": outs, "ms": ms}, out)


def main() -> None:
    if sys.argv[1:2] == ["--run"]:
        _run(sys.argv[2], sys.argv[3])
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_torch_decode_kernels: needs a CUDA card")
    a, b = sys.argv[1], sys.argv[2]
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(f"card: {card}", flush=True)
    runs = {a: [], b: []}
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(rounds):
            for i, tree in enumerate((a, b, b, a)):
                path = os.path.join(tmp, f"{r}-{i}.pt")
                subprocess.run([sys.executable, os.path.abspath(__file__), "--run", tree, path],
                               check=True)
                runs[tree].append(torch.load(path))
                print(f"run {r}.{i}: {tree}", flush=True)
    differ = []
    for key in runs[a][0]["outputs"]:
        x, y = runs[a][0]["outputs"][key], runs[b][0]["outputs"][key]
        same = torch.equal(x, y)
        extra = "" if same else f", max |diff| {(x.float() - y.float()).abs().max().item():.3e}"
        print(f"[outputs] {key}: {'bit-equal' if same else 'DIFFER'}{extra}", flush=True)
        if not same:
            differ.append(key)
    for tree in (a, b):        # each checkout's runs reproduce themselves
        for other in runs[tree][1:]:
            for key, x in runs[tree][0]["outputs"].items():
                if not torch.equal(x, other["outputs"][key]):
                    differ.append(f"{tree}: {key} not reproduced")
    times = {}
    for key in runs[a][0]["ms"]:
        va = [r["ms"][key] for r in runs[a]]
        vb = [r["ms"][key] for r in runs[b]]
        times[key] = {"a": va, "b": vb, "a_median": statistics.median(va),
                      "b_median": statistics.median(vb)}
        print(f"[ms] {key}: A {' '.join(f'{v:.4f}' for v in va)} (median "
              f"{times[key]['a_median']:.4f}) | B {' '.join(f'{v:.4f}' for v in vb)} (median "
              f"{times[key]['b_median']:.4f})", flush=True)
    print(json.dumps({"card": card, "a": a, "b": b, "rounds": rounds, "differ": differ,
                      "ms": times}))
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
