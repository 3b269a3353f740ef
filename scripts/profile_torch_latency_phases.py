"""Where a v8 token's time goes, phase by phase, on the card.

Builds ``csrc/latency_decode.cu`` with ``-DLP_PROFILE`` into
``build/torch_kernels/latency_decode_phases.so`` (the package's own build is
not touched), in which thread 0 of every block records ``%globaltimer`` at
the start and end of each phase of ``latency_v8_kernel``.  Then decodes
3-token calls at agent_config width with random bf16 weights and a bf16
state (CP sampling) and prints, per phase kind (Q, S, F1, F2 a layer; H and
the sampling a token), the slowest block's time in the phase and the gap
from the last block's arrival at the following grid barrier to the first
block's departure, averaged over the calls' tokens after the first.  The
marks add a block barrier at every phase boundary, so the token's total here
is a little above the kernel's CUDA-event time.

    python3 scripts/profile_torch_latency_phases.py [--batch 1,5,16]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from reinforcement_learning_in_music_generation_torch import config as C  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import tokenizer  # noqa: E402
from reinforcement_learning_in_music_generation_torch.models import (  # noqa: E402
    linear_transformer as lt)
from reinforcement_learning_in_music_generation_torch.ops import (  # noqa: E402
    _build, decode_kernel_v4 as dk4, sampling as smp)
from reinforcement_learning_in_music_generation_torch.ops.experimental import (  # noqa: E402
    decode_kernel_v8 as dk8)

MARKS = 4096                       # csrc/latency_decode.cu LP_PROFILE_MARKS
KINDS = ("Q", "S", "F1", "F2")


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "latency_decode_phases.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DLP_PROFILE", "-o", str(out),
           str(_build.CSRC / "latency_decode.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout[-3000:]}{r.stderr[-3000:]}")
    return ctypes.CDLL(str(out))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", default="1,5,16")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    lib = build()
    real = _build.load
    _build.load = lambda name: lib if name == "latency_decode" else real(name)
    dk8._LIB = None
    dev = torch.device("cuda")
    e2w, _ = tokenizer.drop_type(tokenizer.construct_cp_dict())
    cfg = C.agent_config(tuple(tokenizer.n_classes(e2w)))
    params = lt.init_params(cfg, seed=0, device=dev)
    rp = dk8.make_resident_params(params, cfg, dtype=torch.bfloat16)
    kw = dict(n_head=cfg.n_head, vocab_sizes=cfg.vocab_sizes, greedy=False, eps=cfg.attn_eps,
              temps=tuple(s.temperature for s in smp.CP_SAMPLING),
              topps=tuple(s.top_p if s.top_p is not None else float("inf")
                          for s in smp.CP_SAMPLING))
    n_sm, _ = dk8.card_limits()
    prof = torch.zeros(n_sm * MARKS, dtype=torch.int64, device=dev)
    lib.rlmg_lp_set_prof(ctypes.c_void_p(prof.data_ptr()))
    L, T, per_tok = cfg.n_layer, 3, 8 * cfg.n_layer + 4
    for b in (int(x) for x in args.batch.split(",")):
        tok = torch.zeros((b, len(cfg.vocab_sizes)), dtype=torch.int32, device=dev)
        st = dk4.init_state(cfg, b, torch.bfloat16, dev)
        acc = {}
        calls = 3
        for c in range(calls + 1):
            dk8.fused_decode_v8(rp, tok, st.s, st.z, 0, 1, max_tokens=T, **kw)
            torch.cuda.synchronize()
            if c == 0:                      # the first call warms the card
                continue
            E = prof.view(n_sm, MARKS).double().cpu()
            for t in range(1, T):
                base = t * per_tok
                spans = [(KINDS[k], base + 8 * l + 2 * k) for l in range(L) for k in range(4)]
                spans += [("H", base + 8 * L), ("sample", base + 8 * L + 2)]
                for i, (kind, s0) in enumerate(spans):
                    work = (E[:, s0 + 1] - E[:, s0]).max().item()
                    nxt = spans[i + 1][1] if i + 1 < len(spans) else None
                    gap = (E[:, nxt].min() - E[:, s0 + 1].max()).item() if nxt else 0.0
                    a = acc.setdefault(kind, [0.0, 0.0, 0])
                    a[0] += work
                    a[1] += gap
                    a[2] += 1
        total = sum(w + g for w, g, _ in acc.values()) / calls / (T - 1) / 1e3
        print(f"B={b}, bf16 weights and state, {T}-token calls: {total:.1f} us a token, the "
              f"phases' slowest blocks and the barrier gaps added (marks included); "
              f"{dk8.barriers_per_token(L)} grid barriers a token")
        for kind, (w, g, n) in acc.items():
            per = n // (calls * (T - 1))
            print(f"  {kind:6s} x{per:<3d} slowest block {w / n / 1e3:7.2f} us, barrier "
                  f"(last arrival to first departure) {g / n / 1e3:5.2f} us")


if __name__ == "__main__":
    main()
