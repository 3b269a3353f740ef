"""Command line of the port (counterpart of the JAX package's ``apps/cli.py``).

Ported so far:
  * ``generate`` (JAX cmd_generate, cli.py:510), batched CP song generation
    written out as MIDI files;
  * ``pretrain`` (JAX cmd_pretrain, cli.py:125), agent CE pretraining.
Run them as

    python -m reinforcement_learning_in_music_generation_torch.apps.cli generate --songs 5
    python -m reinforcement_learning_in_music_generation_torch.apps.cli pretrain --synthetic \
        --batch-size 32 --seq-len 512 --max-steps 10

They run on the GPU unless ``--device cpu`` is given.  Without ``--ckpt``
the generation weights are random, drawn from ``--seed``; ``--ckpt`` reads
a checkpoint written by the JAX package's ``save_checkpoint`` or by the
port's ``pretrain``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import torch

from .. import config as C
from ..data import dataset, tokenizer
from ..generate import sampler
from ..models import linear_transformer as lt
from ..train import pretrain as pretrain_lib
from ..utils.saver import MetricsBus, Saver
from ..weights import load_jax_checkpoint

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


def cmd_pretrain(args) -> dict:
    """Agent CE pretrain (dqn_policy/agent_pretrain.py:485-632).  Returns
    {"steps", "seconds", "tokens_per_s", "batch_losses", "history"}; the
    seconds are the loop's, after the data and the weights are made."""
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
    print(f"n_parameters: {lt.n_params(params):,}")
    pcfg = C.PretrainConfig(n_epoch=args.epochs, batch_size=args.batch_size, lr=args.lr,
                            ckpt_dir=args.ckpt_dir, exp_dir=args.exp_dir, seed=args.seed,
                            zero1=args.zero1, grad_accum=args.grad_accum,
                            ckpt_backend=args.ckpt_backend,
                            save_on_interrupt=args.save_on_interrupt)
    bus = MetricsBus(Saver(args.exp_dir), use_wandb=args.wandb)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    params, _, history = pretrain_lib.pretrain(params, mcfg, x, y, mask, pcfg, metrics=bus,
                                               max_steps=args.max_steps,
                                               resume_from=args.resume)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    bus.saver.close()
    steps = bus.saver.global_step
    tokens = steps * args.batch_size * x.shape[1]
    rate = tokens / elapsed if elapsed > 0 else float("inf")
    print(f"done in {elapsed:.1f}s ({steps} steps, {rate:.1f} tokens/s on {device}); "
          f"last epoch loss: {history[-1] if history else float('nan')}")
    return {"steps": steps, "seconds": elapsed, "tokens_per_s": rate,
            "batch_losses": bus.history.get("batch loss", []), "history": history}


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
    d.add_argument("--synthetic", action="store_true")
    d.add_argument("--synthetic-songs", type=int, default=16)
    d.add_argument("--seq-len", type=int, default=512)
    d.add_argument("--train-data", default=None)
    d.add_argument("--dictionary", default=None)
    d.add_argument("--layers", type=int, default=12)
    d.add_argument("--batch-size", type=int, default=4)
    d.add_argument("--lr", type=float, default=1e-4)
    d.add_argument("--epochs", type=int, default=4000)
    d.add_argument("--max-steps", type=int, default=None)
    d.add_argument("--ckpt-dir", default="./ckpt")
    d.add_argument("--exp-dir", default="./exp")
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--wandb", action="store_true")
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
    d.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions of the kernels")
    d.set_defaults(fn=cmd_pretrain)
    return ap


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
