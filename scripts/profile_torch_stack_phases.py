"""Where a token of kernel A's token kernel goes, phase by phase, on the card.

Builds ``csrc/decode_step.cu`` with ``-DSK_PROFILE`` (each block records
``%globaltimer`` at nine marks a layer: the qkv products, the state items,
then the Wo, FFN1 and FFN2 products, each followed by its grid barrier) into
``build/profile_stack/``, runs one token at agent_config's width with bf16
weights and state at B = 1, 5, 32, 64 and 128, and prints, averaged over
the layers, each phase's span (first block in to last block out) and each
barrier's gap (last block in to first block out), in microseconds.

    python3 scripts/profile_torch_stack_phases.py
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from reinforcement_learning_in_music_generation_torch import config as C  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import tokenizer  # noqa: E402
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as lt  # noqa: E402
from reinforcement_learning_in_music_generation_torch.ops import _build, decode_kernel_v4 as dk4  # noqa: E402

MARKS, MAX_L, MAX_G = 24, 16, 160
# (name, from mark, to mark): a phase's span or a barrier's gap
SPANS = (("Q products", 0, 1), ("state items", 1, 2), ("O (z, Wo)", 3, 4), ("F1", 5, 6),
         ("F2", 7, 8))
GAPS = (("barrier after S", 2, 3), ("barrier after O", 4, 5), ("barrier after F1", 6, 7))


def build() -> ctypes.CDLL:
    out = os.path.join(os.path.dirname(_build.BUILD_DIR), "profile_stack",
                       "decode_step_prof.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DSK_PROFILE", "-o",
                        out, str(_build.CSRC / "decode_step.cu")], capture_output=True,
                       text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    lib = ctypes.CDLL(out)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rlmg_stack_tc_step.argtypes = [p] * 8 + [i] * 5 + [f, i, i, p, ctypes.POINTER(i)]
    lib.rlmg_stack_tc_marks.argtypes = [p]
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    lib = build()
    dev = torch.device("cuda", 0)
    e2w, _ = tokenizer.drop_type(tokenizer.construct_cp_dict())
    cfg = C.agent_config(tuple(tokenizer.n_classes(e2w)))
    L, D, H, DI = cfg.n_layer, cfg.d_model, cfg.n_head, cfg.d_inner
    params = lt.init_params(cfg, seed=0, device=dev)
    dp = lt.make_decode_params(params, cfg, torch.bfloat16)
    marks = np.zeros(MAX_L * MARKS * MAX_G, dtype=np.uint64)
    for b in (1, 5, 32, 64, 128):
        st = dk4.init_state(cfg, b, torch.bfloat16, dev)
        h = torch.randn((b, D), device=dev)
        work = dk4.workspace(dp, b)
        launched = ctypes.c_int()
        for rep in range(3):              # two warm launches, then the one read
            if rep == 2:
                torch.cuda.synchronize()
                lib.rlmg_stack_tc_marks(marks.ctypes.data)   # clears the marks
            rc = lib.rlmg_stack_tc_step(
                work.wptr, work.vptr, st.s.data_ptr(), st.z.data_ptr(), h.data_ptr(),
                work.h_out.data_ptr(), work.scratch.data_ptr(), work.cnt.data_ptr(), L, b, D, H,
                DI, cfg.attn_eps, 1, 1, torch.cuda.current_stream().cuda_stream,
                ctypes.byref(launched))
            torch.cuda.synchronize()
            if rc:
                raise SystemExit(f"kernel error {rc}")
        g = lib.rlmg_stack_tc_marks(marks.ctypes.data)
        m = marks.reshape(MAX_L, MARKS, MAX_G)[:L, :, :g].astype(np.float64) / 1e3   # us
        parts = []
        for name, a, z in SPANS:
            parts.append(f"{name} {np.mean(m[:, z].max(1) - m[:, a].min(1)):.2f}")
        for name, a, z in GAPS:
            parts.append(f"{name} {np.mean(m[:, z].min(1) - m[:, a].max(1)):.2f}")
        layer = np.mean(m[1:, 0].min(1) - m[:-1, 0].min(1)) if L > 1 else float("nan")
        print(f"[phases] B={b}: " + ", ".join(parts) + f"; a layer {layer:.2f} us", flush=True)
        # inside the first item of each block that has one: from the phase's
        # start to staged, staged to multiplied, multiplied to stored (median
        # over blocks, then the mean over layers)
        raw = marks.reshape(MAX_L, MARKS, MAX_G)[:L, :, :g].astype(np.float64) / 1e3
        inner = []
        for ph, (name, start) in enumerate((("Q", 0), ("O", 3), ("F1", 5), ("F2", 7))):
            t = raw[:, [start, 9 + 3 * ph, 10 + 3 * ph, 11 + 3 * ph]]
            have = raw[:, 9 + 3 * ph] > 0
            d = np.where(have[:, None], np.diff(t, axis=1), np.nan)
            med = np.nanmean(np.nanmedian(d, axis=2), axis=0)
            mx = np.nanmean(np.nanmax(d, axis=2), axis=0)
            inner.append(f"{name} stage {med[0]:.2f}/{mx[0]:.2f} mma {med[1]:.2f}/{mx[1]:.2f} "
                         f"store {med[2]:.2f}/{mx[2]:.2f}")
        t = raw[:, [1, 21, 22, 23]]
        have = raw[:, 21] > 0
        d = np.where(have[:, None], np.diff(t, axis=1), np.nan)
        med = np.nanmean(np.nanmedian(d, axis=2), axis=0)
        mx = np.nanmean(np.nanmax(d, axis=2), axis=0)
        inner.append(f"S reads {med[0]:.2f}/{mx[0]:.2f} wait {med[1]:.2f}/{mx[1]:.2f} "
                     f"item {med[2]:.2f}/{mx[2]:.2f}")
        print(f"[items] B={b} (median/max us): " + "; ".join(inner), flush=True)


if __name__ == "__main__":
    main()
