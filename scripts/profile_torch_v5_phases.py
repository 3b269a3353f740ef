#!/usr/bin/env python3
"""Where a token of the v5 kernel goes, phase by phase, on the card.

Builds ``csrc/latency_decode.cu`` with ``-DV5_PROFILE`` (each block records
``%globaltimer`` as each phase of a call's last token starts and ends) into
``build/profile_v5/``, decodes 8-token calls at agent_config's width with
bf16 weights and an f32 state at B = 256 and 8, and prints, averaged over
the layers, each phase's span (first block in to last block out) and the
barrier gap after it (last block out to first block into the next), in
microseconds, then the token's own phases and its whole span.  Then ms a
token (CUDA events, 32-token calls) of the kernel as built from the
package, plain and under each ``RLMG_V5_ABLATE`` setting.  It prints the
card's name and power limit first and one JSON line last.

    python3 scripts/profile_torch_v5_phases.py
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from reinforcement_learning_in_music_generation_torch import config as C  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import tokenizer  # noqa: E402
from reinforcement_learning_in_music_generation_torch.models import (  # noqa: E402
    common as cm, linear_transformer as lt)
from reinforcement_learning_in_music_generation_torch.ops import _build  # noqa: E402
from reinforcement_learning_in_music_generation_torch.ops import sampling as smp  # noqa: E402
from reinforcement_learning_in_music_generation_torch.ops.experimental import (  # noqa: E402
    decode_kernel_v5 as dk5, decode_kernel_v8 as dk8)

MARKS, PROF_L, PROF_G = 14, 17, 160
LAYER = ("Q", "state", "O", "LN1", "F1", "F2", "LN2")
TOKEN = ("embedding", "final LN", "heads", "sampling")


def build_profile_lib() -> ctypes.CDLL:
    out = os.path.join(os.path.dirname(_build.BUILD_DIR), "profile_v5", "latency_decode_prof.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DV5_PROFILE", "-o", out,
                        str(_build.CSRC / "latency_decode.cu")], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    return ctypes.CDLL(out)


def spans(marks: np.ndarray, L: int, G: int) -> dict:
    """Phase spans and the barrier gaps after them, microseconds."""
    m = marks.reshape(PROF_L, MARKS, PROF_G)[:, :, :G].astype(np.int64)
    out = {}
    for p, name in enumerate(LAYER):
        layers = range(L - 1) if name == "LN2" else range(L)
        span = [m[l, 2 * p + 1].max() - m[l, 2 * p].min() for l in layers]
        nxt = [(l, 2 * p + 2) if p + 1 < len(LAYER) else (l + 1, 0) for l in layers]
        if name == "F2":                  # the last layer's F2 is followed by the final LN
            nxt = [(l, 12) if l + 1 < L else (L, 2) for l in layers]
        gap = [m[a, b].min() - m[l, 2 * p + 1].max() for l, (a, b) in zip(layers, nxt)]
        out[name] = {"span_us": float(np.mean(span)) / 1e3, "gap_us": float(np.mean(gap)) / 1e3}
    for p, name in enumerate(TOKEN):
        out[name] = {"span_us": float(m[L, 2 * p + 1].max() - m[L, 2 * p].min()) / 1e3}
    out["token_us"] = float(m[L, 7].max() - m[L, 0].min()) / 1e3
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_v5_phases: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    e2w, _ = tokenizer.drop_type(tokenizer.construct_cp_dict())
    cfg = C.agent_config(tuple(tokenizer.n_classes(e2w)))
    params = lt.init_params(cfg, seed=0, device=dev)
    v5p = dk5.make_v5_params(params, cfg)
    pe = cm.sinusoidal_table(cfg.max_len, cfg.d_model, torch.float32, dev)
    kw = dict(n_head=cfg.n_head, vocab_sizes=cfg.vocab_sizes, greedy=False, eps=cfg.attn_eps,
              temps=tuple(s.temperature for s in smp.CP_SAMPLING),
              topps=tuple(s.top_p if s.top_p is not None else float("inf")
                          for s in smp.CP_SAMPLING))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def call(b, T, s5, z5, tok):
        return dk5.fused_decode_v5(v5p, tok, s5, z5, pe[:T], 1, max_tokens=T, bb=8, **kw)

    res = {"card": smi, "phases": {}, "ms_per_token": {}}
    real = dk8._LIB
    prof = build_profile_lib()
    load = _build.load
    _build.load = lambda name: prof if name == "latency_decode" else load(name)
    dk8._LIB = None
    dk8._lib()                            # the profile library, its argtypes set
    prof.rlmg_v5_marks.argtypes = [ctypes.c_void_p]
    marks = np.zeros(PROF_L * MARKS * PROF_G, dtype=np.uint64)
    for b in (256, 8):
        st = lt.init_decode_state(cfg, b, device=dev)
        s5, z5 = dk5.pack_state(st.s, st.z)
        tok = torch.zeros((b, cfg.n_fields), dtype=torch.int32, device=dev)
        call(b, 8, s5, z5, tok)
        torch.cuda.synchronize()
        prof.rlmg_v5_marks(marks.ctypes.data)           # clears them
        call(b, 8, s5, z5, tok)
        torch.cuda.synchronize()
        prof.rlmg_v5_marks(marks.ctypes.data)
        ph = spans(marks, cfg.n_layer, min(n_sm, PROF_G))
        res["phases"][str(b)] = ph
        print(f"B={b}, bf16 weights, f32 state, the last token of an 8-token call: "
              f"{ph['token_us']:.1f} us", flush=True)
        for name in LAYER:
            print(f"  {name:9s} span {ph[name]['span_us']:8.2f} us, then a barrier gap "
                  f"{ph[name]['gap_us']:6.2f} us (mean over the layers)", flush=True)
        for name in TOKEN:
            print(f"  {name:9s} span {ph[name]['span_us']:8.2f} us (once a token)", flush=True)
    _build.load = load
    dk8._LIB = real
    for b in (256, 8):
        st = lt.init_decode_state(cfg, b, device=dev)
        s5, z5 = dk5.pack_state(st.s, st.z)
        tok = torch.zeros((b, cfg.n_fields), dtype=torch.int32, device=dev)
        for ablate in ("", "attn", "state"):
            os.environ["RLMG_V5_ABLATE"] = ablate
            call(b, 32, s5, z5, tok)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                call(b, 32, s5, z5, tok)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 3 / 32
            res["ms_per_token"][f"B={b} {ablate or 'plain'}"] = ms
            print(f"B={b} RLMG_V5_ABLATE={ablate!r}: {ms:.4f} ms a token", flush=True)
        os.environ.pop("RLMG_V5_ABLATE")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
