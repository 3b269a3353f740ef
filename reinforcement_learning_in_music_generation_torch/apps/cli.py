"""Command line of the port (counterpart of the JAX package's ``apps/cli.py``).

Ported so far: ``generate`` (JAX cmd_generate, cli.py:510), batched CP song
generation written out as MIDI files.  Run it as

    python -m reinforcement_learning_in_music_generation_torch.apps.cli generate --songs 5

It runs on the GPU unless ``--device cpu`` is given.  Without ``--ckpt`` the
weights are random, drawn from ``--seed``; ``--ckpt`` reads a checkpoint
written by the JAX package's ``save_checkpoint``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import torch

from .. import config as C
from ..data import tokenizer
from ..generate import sampler
from ..models import linear_transformer as lt
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
    return ap


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
