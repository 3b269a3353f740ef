#!/usr/bin/env python3
"""Data, tensor, sequence and pipeline parallelism over NCCL, one card a
rank, at agent_config's width.  Needs a card a rank:

    python3 scripts/dp_nccl.py            # dp: 2 ranks, and 4 where there are 4 cards
    python3 scripts/dp_nccl.py --tp       # tp: tp = 2, and tp = 4 and dp = 2 x tp = 2
                                          # where there are 4 cards
    python3 scripts/dp_nccl.py --rl       # the RL steps: tp = 2, and tp = 4 and
                                          # dp = 2 x tp = 2 where there are 4 cards
    python3 scripts/dp_nccl.py --sp --pp  # sp = 2 (and 4), pp = 2 (and dp = 2 x pp = 2
                                          # and cli pretrain --pp 2 --dp 2) where there
                                          # are 4 cards

dp: ``chip_smoke.py``'s phases 34-35 (``dp_rank``, gated by
``dp_gate_failures``) with rank r on card r, B=32 x S=512 global at 2 ranks
and B=64 at 4 (8192 rows a rank, so C and D run on each), then
``apps/cli.py pretrain --dp`` (4 steps) and ``generate --dp`` (8 songs) on
CUDA, which take NCCL.

tp: phases 36-37 (``tp_rank``, gated by ``tp_gate_failures``) with rank r
on card r: tp = 2 at B=8 x S=512 on the plain and F routes (with the
control) and 38's 8 greedy songs of 256 tokens against one process; tp = 4
at B=8 on the F route; dp = 2 x tp = 2 at B=16 on the F route at f32 and
bf16; then ``cli pretrain --tp 2`` (4 steps), ``cli pretrain --dp 2 --tp 2``
and ``cli generate --tp 2`` (8 songs) on CUDA over NCCL.

rl: phases 39-40 (``rl_rank``, gated by ``rl_gate_failures``) with rank r
on card r: tp = 2 (the DQN update, the discriminator step at 100 x 50 and
4 x 2048, a DQN rollout song), dp = 2 x tp = 1 under RLMG_FFN_BACKEND=pallas
(the graphed DQN and PPO rollouts, the DQN update, the PPO step), tp = 4
(the update and both discriminator steps), dp = 2 x tp = 2 (the PPO
rollout song and update step, the DQN update with control (i), the
discriminator step), each against one process; then ``cli dqn-train --tp
2`` and ``cli ppo-train --dp 2 --tp 2`` (``RL_CLI``'s flags) on CUDA over
NCCL (``chip_smoke.rl_cli_rank``: the ranks' trees and generator digested).

sp: phase 42 (``sp_rank``, gated by ``sp_gate_failures``) with rank r on
card r: q, k, v (32, 8, 512, 64) split over sp = 2, and over sp = 4 where
there are 4 cards.  pp: phase 43 (``pp_rank``, gated by
``pp_gate_failures``) under RLMG_FFN_BACKEND=pallas-tail: pp = 2 (with the
control, the step under RLMG_FFN_BACKEND=pallas and the dropout steps) and dp = 2 x pp = 2 where there are 4 cards,
B=32 x S=512, then phase 44's ``cli pretrain --pp 2 --dp 2`` over NCCL
(``chip_smoke.pp_cli_run``).  The hop between stages takes NCCL's
``batch_isend_irecv`` here (gloo's a host copy).

Builds the kernels first (``ops/_build.py``).  Prints the cards' name and
power limit beside the readings; exits non-zero where a gate fails.
"""

import argparse
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402


def _cli_pretrain(cli, tmp, smi_line, flags):
    res = cli.main(["pretrain", "--synthetic", "--synthetic-songs", "64", "--batch-size", "32",
                    "--seq-len", "512", "--max-steps", "4", *flags,
                    "--exp-dir", os.path.join(tmp, "exp"), "--ckpt-dir", os.path.join(tmp, "c")])
    losses = res["batch_losses"]
    print(f"[nccl] cli pretrain {' '.join(flags)}: {res['steps']} steps in {res['seconds']:.3f}s, "
          f"{res['tokens_per_s']:.1f} tokens/s, batch losses {losses} ({smi_line})", flush=True)
    chip_smoke.check(res["steps"] == 4 and all(math.isfinite(x) for x in losses),
                     f"cli pretrain {flags}: {res}")


def _cli_generate(cli, tmp, smi_line, flags):
    out = os.path.join(tmp, "g" + "".join(flags).replace("-", ""))
    res = cli.main(["generate", "--songs", "8", "--bars", "8", *flags, "--warmup",
                    "--out-dir", out])
    print(f"[nccl] cli generate {' '.join(flags)}: {res['songs']} songs, {res['tokens']} tokens "
          f"in {res['seconds']:.3f}s, {res['tokens_per_s']:.1f} tokens/s ({smi_line})", flush=True)
    chip_smoke.check(res["songs"] == 8 and len(os.listdir(out)) == 8,
                     f"cli generate {flags}: {res}")


def _cli_rl(tmp, smi_line, cmd, dp, tp):
    """``cmd`` on dp x tp NCCL ranks, a card each, through
    ``chip_smoke.rl_cli_rank`` (the command's own rank body, then the
    ranks' digests of their trees and generator)."""
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    out = os.path.join(tmp, cmd)
    flags = ["--dp", str(dp), "--tp", str(tp)]
    argv = [cmd, *chip_smoke.RL_CLI[cmd], *flags, "--exp-dir", os.path.join(out, "e"),
            "--ckpt-dir", os.path.join(out, "c")]
    ranks = pm.launch(chip_smoke.rl_cli_rank, dp * tp, (argv, dp * tp), backend="nccl",
                      timeout_s=900)
    res = ranks[0]["res"]
    med = lambda v: sorted(v)[len(v) // 2]
    print(f"[nccl] cli {cmd} {' '.join(flags)}: ms per rollout song {res['rollout_ms']} "
          f"(median {med(res['rollout_ms']):.1f}), ms per update {res['update_ms']}, metrics "
          f"{res['metrics']}, digests {res['digests']}, runs {chip_smoke.RL_RUNS} a rank "
          f"{[r['runs'] for r in ranks]} ({smi_line})", flush=True)
    chip_smoke.check(bool(res["metrics"]) and all(
        math.isfinite(v) for m in res["metrics"] for v in m.values())
        and all(len(set(d)) == 1 for d in res["digests"].values()), f"cli {cmd} {flags}: {res}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tp", action="store_true", help="the tensor-parallel runs (else dp)")
    ap.add_argument("--rl", action="store_true",
                    help="the RL steps and commands on the mesh (else dp)")
    ap.add_argument("--sp", action="store_true",
                    help="the sequence-parallel attention (else dp)")
    ap.add_argument("--pp", action="store_true",
                    help="the pipeline step and cli pretrain --pp (else dp)")
    args = ap.parse_args()
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        chip_smoke.fail(f"{n_cards} CUDA card(s): NCCL needs a card a rank")
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
    if args.sp or args.pp:
        if args.sp:
            for n in (2, 4) if n_cards >= 4 else (2,):
                chip_smoke.sp_run(smi_line, backend="nccl", n=n)
        if args.pp:
            meshes = [dict(phase="43n", dp=1, pp=2, control=True, g_route=True,
                           dropout=("float32", "bfloat16"))]
            if n_cards >= 4:
                meshes += [dict(phase="43bn", dp=2, pp=2)]
            chip_smoke.pp_run(cfg, smi_line, backend="nccl", meshes=meshes, cli=n_cards >= 4)
        print("dp_nccl --sp/--pp: ok", flush=True)
        return
    if args.rl:
        meshes = [dict(phase="39n", dp=1, tp=2, steps=("dqn", "disc", "disc_long", "rollout")),
                  dict(phase="40bn", dp=2, tp=1, ffn="pallas", steps=("rollout", "dqn", "ppo"))]
        if n_cards >= 4:
            meshes += [dict(phase="39n4", dp=1, tp=4, steps=("dqn", "disc", "disc_long")),
                       dict(phase="40n", dp=2, tp=2, steps=("ppo", "dqn", "control", "disc"))]
        chip_smoke.rl_run(cfg, smi_line, backend="nccl", meshes=meshes)
        with tempfile.TemporaryDirectory() as tmp:
            _cli_rl(tmp, smi_line, "dqn-train", 1, 2)
            if n_cards >= 4:
                _cli_rl(tmp, smi_line, "ppo-train", 2, 2)
        print("dp_nccl --rl: ok", flush=True)
        return
    if args.tp:
        base = {"cfg": dict(vocab_sizes=cfg.vocab_sizes), "S": 512, "valid_tail": 100}
        meshes = [dict(base, phase="36n", dp=1, tp=2, B=8, routes=("plain", "f"), control=True,
                       songs=8, max_tokens=256)]
        if n_cards >= 4:
            meshes += [dict(base, phase="36n4", dp=1, tp=4, B=8, routes=("f",)),
                       dict(base, phase="37n", dp=2, tp=2, B=16, routes=("f",), bf16=True)]
        chip_smoke.tp_run(cfg, smi_line, backend="nccl", meshes=meshes)
        with tempfile.TemporaryDirectory() as tmp:
            _cli_pretrain(cli, tmp, smi_line, ["--tp", "2"])
            if n_cards >= 4:
                _cli_pretrain(cli, tmp, smi_line, ["--dp", "2", "--tp", "2"])
            _cli_generate(cli, tmp, smi_line, ["--tp", "2"])
        print("dp_nccl --tp: ok", flush=True)
        return
    runs = [(2, 32)] + ([(4, 64)] if n_cards >= 4 else [])
    for world, batch in runs:
        chip_smoke.dp_run(cfg, smi_line, world=world, backend="nccl", batch=batch)
    with tempfile.TemporaryDirectory() as tmp:
        _cli_pretrain(cli, tmp, smi_line, ["--dp", "2"])
        _cli_generate(cli, tmp, smi_line, ["--dp", "2"])
    print("dp_nccl: ok", flush=True)


if __name__ == "__main__":
    main()
