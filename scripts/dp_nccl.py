#!/usr/bin/env python3
"""Data parallelism over NCCL, one card a rank, at agent_config's width:
``chip_smoke.py``'s phases 34-35 (``dp_rank``, gated by
``dp_gate_failures``) with rank r on card r, B=32 x S=512 global at 2 ranks
and B=64 at 4 (8192 rows a rank, so C and D run on each), then
``apps/cli.py pretrain --dp`` (4 steps) and ``generate --dp`` (8 songs) on
CUDA, which take NCCL.  Needs a card a rank:

    python3 scripts/dp_nccl.py            # 2 ranks, and 4 where there are 4 cards

Builds the kernels first (``ops/_build.py``).  Prints the card's name and
power limit beside the readings; exits non-zero where a gate fails.
"""

import math
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402


def main() -> None:
    if torch.cuda.device_count() < 2:
        chip_smoke.fail(f"{torch.cuda.device_count()} CUDA card(s): NCCL needs a card a rank")
    from reinforcement_learning_in_music_generation_torch import config as C
    from reinforcement_learning_in_music_generation_torch.apps import cli
    from reinforcement_learning_in_music_generation_torch.data import tokenizer
    from reinforcement_learning_in_music_generation_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    smi_line = f"{len(smi)} x {smi[0]}" if smi else "nvidia-smi gave nothing"
    print(f"cards: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t = time.perf_counter()
    _build.build_all()
    print(f"[build] {time.perf_counter() - t:.1f}s", flush=True)
    e2w, _ = tokenizer.drop_type(tokenizer.construct_cp_dict())
    cfg = C.agent_config(tuple(tokenizer.n_classes(e2w)))
    runs = [(2, 32)] + ([(4, 64)] if torch.cuda.device_count() >= 4 else [])
    for world, batch in runs:
        chip_smoke.dp_run(cfg, smi_line, world=world, backend="nccl", batch=batch)
    with tempfile.TemporaryDirectory() as tmp:
        res = cli.main(["pretrain", "--synthetic", "--synthetic-songs", "64", "--batch-size", "32",
                        "--seq-len", "512", "--max-steps", "4", "--dp", "2",
                        "--exp-dir", os.path.join(tmp, "exp"), "--ckpt-dir", os.path.join(tmp, "c")])
        losses = res["batch_losses"]
        print(f"[dp] cli pretrain --dp 2 (NCCL): {res['steps']} steps in {res['seconds']:.3f}s, "
              f"{res['tokens_per_s']:.1f} tokens/s, batch losses {losses} ({smi_line})", flush=True)
        chip_smoke.check(res["steps"] == 4 and all(math.isfinite(x) for x in losses),
                         f"cli pretrain --dp 2: {res}")
        res = cli.main(["generate", "--songs", "8", "--bars", "8", "--dp", "2", "--warmup",
                        "--out-dir", os.path.join(tmp, "g")])
        print(f"[dp] cli generate --dp 2 (NCCL): {res['songs']} songs, {res['tokens']} tokens in "
              f"{res['seconds']:.3f}s, {res['tokens_per_s']:.1f} tokens/s ({smi_line})",
              flush=True)
        chip_smoke.check(res["songs"] == 8 and len(os.listdir(os.path.join(tmp, "g"))) == 8,
                         f"cli generate --dp 2: {res}")
    print("dp_nccl: ok", flush=True)


if __name__ == "__main__":
    main()
