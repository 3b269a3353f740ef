"""Command line of the port (counterpart of the JAX package's ``apps/cli.py``).

Ported so far:
  * ``generate`` (JAX cmd_generate, cli.py:510), batched CP song generation
    written out as MIDI files;
  * ``pretrain`` (JAX cmd_pretrain, cli.py:125), agent CE pretraining;
  * ``discrim-pretrain`` (JAX cmd_discrim_pretrain, cli.py:238), the
    Longformer discriminator LM's CE pretraining on synthetic songs;
  * ``my-pretrain`` (JAX cmd_my_pretrain, cli.py:166), the PPO actor's or,
    with ``--reward-pretrain``, the reward model's pretraining.
Run them as

    python -m reinforcement_learning_in_music_generation_torch.apps.cli generate --songs 5
    python -m reinforcement_learning_in_music_generation_torch.apps.cli pretrain --synthetic \
        --batch-size 32 --seq-len 512 --max-steps 10
    python -m reinforcement_learning_in_music_generation_torch.apps.cli discrim-pretrain \
        --seq-len 3584 --batch-size 4 --synthetic-songs 8 --max-steps 4

They run on the GPU unless ``--device cpu`` is given.  Without ``--ckpt``
the generation weights are random, drawn from ``--seed``; ``--ckpt`` reads
a checkpoint written by the JAX package's ``save_checkpoint`` or by the
port's ``pretrain``.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time
from typing import List, Optional

import torch

from .. import config as C
from ..data import dataset, tokenizer
from ..generate import sampler
from ..models import linear_transformer as lt
from ..models import longformer as lf
from ..train import pretrain as pretrain_lib
from ..utils.saver import MetricsBus, Saver
from ..weights import _ParamsUnpickler, load_jax_checkpoint

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cmd_generate(args) -> dict:
    """Generate ``--songs`` songs in one batch and write get_<i>.mid files.
    Returns {"songs", "tokens", "seconds", "tokens_per_s"}."""
    e2w, w2e = tokenizer.drop_type(tokenizer.construct_cp_dict())
    vocab = tuple(tokenizer.n_classes(e2w))
    mcfg = C.agent_config(vocab, n_layer=args.layers)
    device = torch.device(args.device)
    if args.ckpt:
        template = lt.init_params(mcfg, seed=0, device="cpu")
        params = load_jax_checkpoint(args.ckpt, template, device=device)
    else:
        params = lt.init_params(mcfg, seed=args.seed, device=device)
    params = lt.cast_params(params, _DTYPES[args.dtype])
    os.makedirs(args.out_dir, exist_ok=True)
    gcfg = C.GenerateConfig(n_songs=args.songs, bar_production=args.bars,
                            max_tokens=args.max_tokens, greedy=args.greedy,
                            batch_size=args.songs, out_dir=args.out_dir,
                            seed=args.seed)
    if args.warmup:
        sampler.generate_songs(params, mcfg, gcfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    songs = sampler.generate_songs(params, mcfg, gcfg)
    elapsed = time.perf_counter() - t0
    total = sum(len(s) for s in songs)
    for i, song in enumerate(songs):
        path = os.path.join(args.out_dir, f"get_{i}.mid")
        tokenizer.write_midi_cp(song, path, w2e)
        print(f"song {i}: {len(song)} tokens -> {path}")
    rate = total / elapsed if elapsed > 0 else float("inf")
    print(f"ave token time: {rate:.1f} tokens/sec ({total} tokens in {elapsed:.2f}s, "
          f"{args.songs} songs on {device})")
    return {"songs": len(songs), "tokens": total, "seconds": elapsed, "tokens_per_s": rate}


def _load_pretrain_data(args, vocab):
    if args.synthetic or not args.train_data:
        return dataset.synthetic_cp_dataset(args.synthetic_songs, args.seq_len, n_class=vocab)
    x, y, mask, _, _ = dataset.load_cp_npz(args.train_data, args.dictionary)
    return x[:, :args.seq_len], y[:, :args.seq_len], mask[:, :args.seq_len]


def _run_pretrain(params, mcfg, x, y, mask, pcfg: C.PretrainConfig, device, *,
                  use_wandb: bool = False, max_steps=None, resume=None,
                  step_fn=pretrain_lib.agent_train_step) -> dict:
    """The pretrain loop, timed after the data and the weights are made.
    Returns {"steps", "seconds", "tokens_per_s", "batch_losses", "history"}."""
    print(f"n_parameters: {lt.n_params(params):,}")
    bus = MetricsBus(Saver(pcfg.exp_dir), use_wandb=use_wandb)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    params, _, history = pretrain_lib.pretrain(params, mcfg, x, y, mask, pcfg, step_fn=step_fn,
                                               metrics=bus, max_steps=max_steps,
                                               resume_from=resume)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    bus.saver.close()
    steps = bus.saver.global_step
    tokens = steps * pcfg.batch_size * x.shape[1]
    rate = tokens / elapsed if elapsed > 0 else float("inf")
    print(f"done in {elapsed:.1f}s ({steps} steps, {rate:.1f} tokens/s on {device}); "
          f"last epoch loss: {history[-1] if history else float('nan')}")
    return {"steps": steps, "seconds": elapsed, "tokens_per_s": rate,
            "batch_losses": bus.history.get("batch loss", []), "history": history}


def cmd_pretrain(args) -> dict:
    """Agent CE pretrain (dqn_policy/agent_pretrain.py:485-632); returns
    ``_run_pretrain``'s numbers."""
    for flag in ("dp", "tp", "pp"):
        if getattr(args, flag) > 1:
            raise NotImplementedError(f"--{flag} > 1: parallelism is not ported yet "
                                      "(ROADMAP Queue 1 item 9)")
    vocab = (tuple(int(v) for v in args.vocab.split(",")) if args.vocab
             else (56, 135, 18, 87, 18, 25))
    mcfg = C.agent_config(vocab, n_layer=args.layers, dtype=args.dtype)
    x, y, mask = _load_pretrain_data(args, vocab)
    device = torch.device(args.device)
    params = lt.init_params(mcfg, seed=args.seed, device=device)
    pcfg = C.PretrainConfig(n_epoch=args.epochs, batch_size=args.batch_size, lr=args.lr,
                            ckpt_dir=args.ckpt_dir, exp_dir=args.exp_dir, seed=args.seed,
                            zero1=args.zero1, grad_accum=args.grad_accum,
                            ckpt_backend=args.ckpt_backend,
                            save_on_interrupt=args.save_on_interrupt)
    return _run_pretrain(params, mcfg, x, y, mask, pcfg, device, use_wandb=args.wandb,
                         max_steps=args.max_steps, resume=args.resume)


def cmd_discrim_pretrain(args) -> dict:
    """Longformer LM pretrain on synthetic songs (dqn_policy/discrim-pretrain.py:
    342-490), at ``discrim_lm_config``'s width; returns ``_run_pretrain``'s
    numbers."""
    vocab = (56, 135, 18, 3, 87, 18, 25) if args.with_type else (56, 135, 18, 87, 18, 25)
    mcfg = (C.discrim_lm_config(vocab) if args.with_type else
            C.discrim_lm_config(vocab, emb_sizes=(128, 256, 64, 512, 256, 128)))
    x, y, mask = dataset.synthetic_cp_dataset(args.synthetic_songs, args.seq_len, n_class=vocab)
    device = torch.device(args.device)
    params = lf.init_params(mcfg, seed=args.seed, device=device)
    pcfg = C.PretrainConfig(n_epoch=args.epochs, batch_size=args.batch_size, lr=args.lr,
                            ckpt_dir=args.ckpt_dir, exp_dir=args.exp_dir, seed=args.seed,
                            grad_accum=args.grad_accum)
    return _run_pretrain(params, mcfg, x, y, mask, pcfg, device, use_wandb=args.wandb,
                         max_steps=args.max_steps, step_fn=pretrain_lib.longformer_lm_step)


def cmd_my_pretrain(args) -> dict:
    """Pretrain of the PPO actor or, with --reward-pretrain, of the window-
    transformer reward model as a token-CE LM (ppo_policy/my_pretrain.py:
    34-201), into a timestamped ./Exp-Pretrain/<ts>/{model,log}.  Returns
    ``_run_pretrain``'s numbers and "exp_root"."""
    ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    exp_root = os.path.join("./Exp-Pretrain", ts)
    ckpt_dir, log_dir = os.path.join(exp_root, "model"), os.path.join(exp_root, "log")
    os.makedirs(ckpt_dir, exist_ok=True)
    os.makedirs(log_dir, exist_ok=True)
    vocab = (49, 19, 19, 89, 67, 25)
    if args.train_data and os.path.exists(args.train_data):
        with open(args.train_data, "rb") as f:
            packed = _ParamsUnpickler(f).load()
        x, y, mask = packed["train_x"], packed["train_y"], packed["mask"]
    else:
        x, y, mask = dataset.synthetic_cp_dataset(args.synthetic_songs, args.seq_len,
                                                  n_class=vocab)
    milestones = tuple(int(m) for m in args.lr_milestones.split(",")
                       if m.strip()) if args.lr_milestones else ()
    pcfg = C.PretrainConfig(n_epoch=args.epochs, batch_size=args.batch_size, lr=args.lr,
                            ckpt_dir=ckpt_dir, exp_dir=log_dir, seed=args.seed,
                            lr_milestones=milestones, lr_gamma=args.lr_gamma)
    device = torch.device(args.device)
    if args.reward_pretrain:
        mcfg = C.ppo_reward_config(vocab, n_layer=args.reward_layers)
        params = lf.init_params(mcfg, seed=args.seed, device=device)
        step_fn = pretrain_lib.longformer_lm_step
    else:
        mcfg = C.actor_config(vocab, n_layer=args.layers)
        params = lt.init_params(mcfg, seed=args.seed, device=device)
        step_fn = pretrain_lib.agent_train_step
    res = _run_pretrain(params, mcfg, x, y, mask, pcfg, device, use_wandb=args.wandb,
                        max_steps=args.max_steps, step_fn=step_fn)
    print(f"experiment dir: {exp_root}")
    return {**res, "exp_root": exp_root}


def _train_common(d: argparse.ArgumentParser, layers_help: Optional[str] = None) -> None:
    """The JAX CLI's shared training flags (cli.py:727-744) without
    --scan-unroll (the port runs its layers in an eager loop), plus --device."""
    d.add_argument("--synthetic", action="store_true")
    d.add_argument("--synthetic-songs", type=int, default=16)
    d.add_argument("--seq-len", type=int, default=512)
    d.add_argument("--train-data", default=None)
    d.add_argument("--dictionary", default=None)
    d.add_argument("--layers", type=int, default=12, help=layers_help)
    d.add_argument("--batch-size", type=int, default=4)
    d.add_argument("--lr", type=float, default=1e-4)
    d.add_argument("--epochs", type=int, default=4000)
    d.add_argument("--max-steps", type=int, default=None)
    d.add_argument("--ckpt-dir", default="./ckpt")
    d.add_argument("--exp-dir", default="./exp")
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--wandb", action="store_true")
    d.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions of the kernels")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rlmg-torch", description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("generate", help="unconditional generation (CP)")
    d.add_argument("--songs", type=int, default=5)
    d.add_argument("--bars", type=int, default=50)
    d.add_argument("--max-tokens", type=int, default=4096)
    d.add_argument("--layers", type=int, default=12)
    d.add_argument("--greedy", action="store_true")
    d.add_argument("--ckpt", default=None,
                   help="params of a JAX save_checkpoint pickle")
    d.add_argument("--out-dir", default="gen_midis")
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--warmup", action="store_true",
                   help="run once before timing (builds the kernels)")
    d.add_argument("--dtype", default="float32", choices=tuple(_DTYPES),
                   help="decode weight dtype (bf16 halves the weight stream)")
    d.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions of the kernels")
    d.set_defaults(fn=cmd_generate)

    d = sub.add_parser(
        "pretrain", help="agent CE pretrain",
        description="Agent CE pretrain, with the flags of the JAX package's pretrain. "
                    "--scan-unroll is left out: the port runs its layers in an eager loop "
                    "and has no scan to unroll.")
    _train_common(d)
    d.add_argument("--vocab", default=None)
    d.add_argument("--resume", default=None,
                   help="checkpoint of the port's pretrain to resume from "
                        "(params + optimizer state + epoch)")
    d.add_argument("--dtype", default="float32", choices=tuple(_DTYPES),
                   help="compute dtype; bfloat16 keeps float32 master weights")
    d.add_argument("--dp", type=int, default=1, help="not ported yet (> 1 raises)")
    d.add_argument("--tp", type=int, default=1, help="not ported yet (> 1 raises)")
    d.add_argument("--pp", type=int, default=1, help="not ported yet (> 1 raises)")
    d.add_argument("--save-on-interrupt", action="store_true",
                   help="SIGTERM/SIGINT checkpoints to interrupt.ckpt and returns")
    d.add_argument("--ckpt-backend", choices=("pickle", "orbax"), default="pickle",
                   help="orbax is not ported yet (raises)")
    d.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches per optimizer step")
    d.add_argument("--zero1", action="store_true", help="not ported yet (raises)")
    d.set_defaults(fn=cmd_pretrain)

    d = sub.add_parser(
        "discrim-pretrain", help="longformer LM pretrain",
        description="Longformer discriminator-LM pretrain on synthetic songs, at "
                    "discrim_lm_config's width, with the flags of the JAX package's "
                    "discrim-pretrain (--scan-unroll left out). As there, --train-data, "
                    "--dictionary, --synthetic and --layers are read and not used.")
    _train_common(d, layers_help="read but not used, as in the JAX package: the LM has "
                                 "discrim_lm_config's 12 layers")
    d.add_argument("--with-type", action="store_true",
                   help="7 CP fields (with 'type'); default the 6 of the agent")
    d.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches per optimizer step")
    d.set_defaults(fn=cmd_discrim_pretrain)

    d = sub.add_parser(
        "my-pretrain", help="actor/reward pretrain (ppo side)",
        description="PPO actor pretrain or, with --reward-pretrain, the reward model "
                    "trained as a token-CE LM, into ./Exp-Pretrain/<timestamp>; the flags "
                    "of the JAX package's my-pretrain (--scan-unroll left out; --ckpt-dir, "
                    "--exp-dir and --dictionary are read and not used, as there).")
    d.add_argument("--lr-milestones", default="500",
                   help="MultiStepLR epochs, comma-separated; empty disables")
    d.add_argument("--lr-gamma", type=float, default=0.1)
    _train_common(d)
    d.add_argument("--reward-pretrain", action="store_true")
    d.add_argument("--reward-layers", type=int, default=12, help="reward-model depth")
    d.set_defaults(fn=cmd_my_pretrain)
    return ap


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
