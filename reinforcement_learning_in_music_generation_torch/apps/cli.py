"""Command line of the port (counterpart of the JAX package's ``apps/cli.py``).

Ported so far:
  * ``generate`` (JAX cmd_generate, cli.py:510), batched CP song generation
    written out as MIDI files;
  * ``pretrain`` (JAX cmd_pretrain, cli.py:125), agent CE pretraining;
  * ``discrim-pretrain`` (JAX cmd_discrim_pretrain, cli.py:238), the
    Longformer discriminator LM's CE pretraining on synthetic songs;
  * ``my-pretrain`` (JAX cmd_my_pretrain, cli.py:166), the PPO actor's or,
    with ``--reward-pretrain``, the reward model's pretraining;
  * ``dqn-train`` (JAX cmd_dqn_train, cli.py:262), DQN + AIRL fine-tuning;
  * ``ppo-train`` (JAX cmd_ppo_train, cli.py:414), PPO fine-tuning with a
    learned reward;
  * ``inference`` (JAX cmd_inference, cli.py:666), the PPO actor's fixed-
    token generation written out as a tuple-event MIDI file;
  * ``serve`` (JAX cmd_serve, cli.py:601), the generation daemon over a
    JSONL request file, and ``generate --continuous`` / ``--prompt``;
  * ``prepare-data``, ``preprocess``, ``split-data`` and ``data-midi`` (JAX
    cli.py:46-109, 218), the host-side corpus commands.
Run them as

    python -m reinforcement_learning_in_music_generation_torch.apps.cli generate --songs 5
    python -m reinforcement_learning_in_music_generation_torch.apps.cli pretrain --synthetic \
        --batch-size 32 --seq-len 512 --max-steps 10
    python -m reinforcement_learning_in_music_generation_torch.apps.cli discrim-pretrain \
        --seq-len 3584 --batch-size 4 --synthetic-songs 8 --max-steps 4
    python -m reinforcement_learning_in_music_generation_torch.apps.cli dqn-train --synthetic \
        --batch-size 30 --buffer-size 500 --songs 12 --max-updates 2
    python -m reinforcement_learning_in_music_generation_torch.apps.cli ppo-train --synthetic \
        --seq-len 130 --songs 2
    python -m reinforcement_learning_in_music_generation_torch.apps.cli inference --tokens 150
    python -m reinforcement_learning_in_music_generation_torch.apps.cli generate --continuous \
        --songs 24 --continuous-batch 8 --bars 8
    python -m reinforcement_learning_in_music_generation_torch.apps.cli serve --requests r.jsonl

``pretrain``, ``generate``, ``dqn-train`` and ``ppo-train`` with ``--dp N
--tp M`` run N x M ranks on a (dp, tp) mesh (``parallel/mesh.py``): each dp
index takes 1/N of every batch (of the songs; the RL commands' update
batches), each tp rank of it 1/M of the Megatron-split weights.
``pretrain --pp P`` adds P pipeline stages, each holding 1/P of the layers
(``parallel/pipeline.py``): N x P x M ranks on a (dp, pp, tp) mesh.  The RL
commands' rollouts, their AIRL passes and their generator are the same on
every rank.
The command starts the ranks itself, one process each: with ``--device
cpu`` over gloo on the CPU, on CUDA over NCCL with a card a rank; started
by ``torchrun --nproc_per_node N*M``, each process joins torchrun's group
instead.  Rank 0 prints and writes the files.

The model commands run on the GPU unless ``--device cpu`` is given.  Without ``--ckpt``
the generation weights are random, drawn from ``--seed``; ``--ckpt`` reads
a checkpoint written by the JAX package's ``save_checkpoint`` or by the
port's ``pretrain``.  ``RLMG_ATTN_BACKEND=pallas`` sends the agent's
attention to kernel F (``ops/linear_attention_kernel.py``), as it sends the
JAX package's to its Pallas causal product; ``RLMG_FFN_BACKEND=pallas``
sends the post-LN1 half of every linear-transformer layer to kernel G
(``ops/ffn_block.py ffn_block``).  ``RLMG_LATENCY_DECODE=1`` sends
``generate`` to the latency kernels (v8, or v7 under
``RLMG_LATENCY_KERNEL=v7``, ``ops/experimental``), as in the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import os
import sys
import pickle
import time
from typing import List, Optional

import numpy as np
import torch

from .. import config as C
from ..data import cp_tokenizer, dataset, parallel_encode, tokenizer
from ..generate import sampler, serving
from ..models import linear_transformer as lt
from ..models import longformer as lf
from ..ops import sampling as smp
from ..parallel import mesh as pmesh
from ..parallel.sharding import gather_params, shard_params
from ..rl import airl, buffers, dqn, env, ppo
from ..train import optim
from ..train import pretrain as pretrain_lib
from ..utils import plotting
from ..utils.checkpoint import full_opt_state, save_checkpoint
from ..utils.metrics import RuntimeStats
from ..utils.saver import MetricsBus, QuietSaver, Saver
from ..weights import _ParamsUnpickler, load_jax_checkpoint

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _generation_params(args, mcfg, device: torch.device) -> dict:
    """The agent's weights for ``generate`` and ``serve``: ``--ckpt``'s
    params, or random ones drawn from ``--seed``, cast to ``--dtype``."""
    if args.ckpt:
        template = lt.init_params(mcfg, seed=0, device="cpu")
        params = load_jax_checkpoint(args.ckpt, template, device=device)
    else:
        params = lt.init_params(mcfg, seed=args.seed, device=device)
    return lt.cast_params(params, _DTYPES[args.dtype])


def _run_ranks(args):
    """Run ``args.fn`` on ``args.dp`` x ``args.pp`` x ``args.tp`` ranks and
    return rank 0's result: in the group of a ``torchrun`` that started this process,
    else in ranks started here (``parallel.launch``).  gloo with ``--device
    cpu``, else NCCL (a card a rank)."""
    backend = "gloo" if torch.device(args.device).type == "cpu" else "nccl"
    if pmesh.launched_by_torchrun():
        pmesh.join_torchrun_group(backend)
        try:
            return _rank_main(args)
        finally:
            torch.distributed.destroy_process_group()
    world = C.MeshConfig(args.dp, args.tp, getattr(args, "pp", 1)).n_ranks()
    return pmesh.launch(_rank_main, world, (args,), backend=backend)[0]


def _rank_main(args):
    """One rank of ``_run_ranks``: its mesh ((dp, pp, tp) with ``--pp`` >
    1, else (dp, tp)), then the command; ranks other than 0 print nothing.
    The RL commands' "final" (the rank's trees) stays on the rank."""
    pp = getattr(args, "pp", 1)
    mesh = (pmesh.make_pp_mesh(pp, dp=args.dp, tp=args.tp) if pp > 1
            else pmesh.make_mesh(dp=args.dp, tp=args.tp))
    if mesh.rank == 0:
        res = args.fn(args, mesh=mesh)
    else:
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            res = args.fn(args, mesh=mesh)
    res.pop("final", None)
    return res


def _prompt_rows(path: str) -> np.ndarray:
    """A MIDI file CP-encoded to (T0, 6) rows, the 'type' column dropped."""
    return np.delete(cp_tokenizer.CPEncoder().encode(path), 3, axis=1)


def cmd_generate(args, mesh=None) -> dict:
    """Generate ``--songs`` songs, write get_<i>.mid files and
    ``runtime_stats.json`` beside ``--out-dir`` (JAX :510-598).  One batch
    through ``sampler.generate_songs`` (``--prompt``: the MIDI file's CP rows
    seed every song), or with ``--continuous`` through the continuous batcher
    over ``--continuous-batch`` slots (``generate/serving.py``).  ``--dp N``:
    the songs split over N dp indices (``_run_ranks``), each decoding its
    share; ``--tp M``: M ranks a dp index, each on its 1/M of the weights.
    Returns {"songs", "tokens", "seconds", "tokens_per_s"} (and "steps" with
    ``--continuous``)."""
    if args.continuous and (args.prompt or args.greedy or args.dp > 1 or args.tp > 1):
        raise SystemExit(
            "--continuous does not combine with --prompt/--greedy/--dp/--tp yet (the serving "
            "loop is stochastic, unconditional, single-device); drop --continuous or those flags")
    if (args.dp > 1 or args.tp > 1) and mesh is None:
        return _run_ranks(args)
    e2w, w2e = tokenizer.drop_type(tokenizer.construct_cp_dict())
    vocab = tuple(tokenizer.n_classes(e2w))
    mcfg = C.agent_config(vocab, n_layer=args.layers)
    device = torch.device(args.device) if mesh is None else mesh.device
    params = _generation_params(args, mcfg, device)
    if mesh is None or mesh.rank == 0:
        os.makedirs(args.out_dir, exist_ok=True)
    init = sampler.CP_SEED
    if args.prompt:
        rows = _prompt_rows(args.prompt)
        init = rows[: args.prompt_tokens] if args.prompt_tokens else rows
        print(f"prompt: {args.prompt} -> {len(init)} seed tokens")
    gcfg = C.GenerateConfig(n_songs=args.songs, bar_production=args.bars,
                            max_tokens=args.max_tokens, greedy=args.greedy,
                            batch_size=args.songs, out_dir=args.out_dir,
                            seed=args.seed)
    extra = {}
    if args.continuous:
        batch = args.continuous_batch or min(args.songs, 8)

        def run(seed):
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            return serving.generate_songs_continuous(
                params, mcfg, gen, n_songs=args.songs, bar_cond=args.bars, batch=batch,
                max_tokens_per_song=args.max_tokens)
    else:
        def run(seed):
            return sampler.generate_songs(params, mcfg, dataclasses.replace(gcfg, seed=seed),
                                          init=init, mesh=mesh)
    if args.warmup:
        run(args.seed + 1)      # another seed, so that the timed call is a new request
    _sync(device)
    t0 = time.perf_counter()
    out = run(args.seed)
    elapsed = time.perf_counter() - t0
    if args.continuous:
        songs = out.songs
        extra = {"steps": out.steps}
        print(f"continuous batching: {len(songs)} songs in {out.steps} decode steps "
              f"(batch {batch})")
    else:
        songs = out
    total = sum(len(s) for s in songs)
    stats = RuntimeStats()
    writer = mesh is None or mesh.rank == 0
    for i, song in enumerate(songs):
        path = os.path.join(args.out_dir, f"get_{i}.mid")
        if writer:
            tokenizer.write_midi_cp(song, path, w2e)
        stats.add_song(elapsed / len(songs), len(song))
        print(f"song {i}: {len(song)} tokens -> {path}")
    if writer:
        stats.dump(os.path.join(args.out_dir, "..", "runtime_stats.json"))
    rate = total / elapsed if elapsed > 0 else float("inf")
    ranks = "" if mesh is None else f", {mesh.dp} x {mesh.tp} ranks (dp x tp)"
    print(f"ave token time: {rate:.1f} tokens/sec ({total} tokens in {elapsed:.2f}s, "
          f"{len(songs)} songs on {device}{ranks})")
    return {"songs": len(songs), "tokens": total, "seconds": elapsed, "tokens_per_s": rate,
            **extra}


def cmd_serve(args) -> dict:
    """Generation daemon (JAX cmd_serve, :601-663): tails ``--requests``
    (JSON lines), answers each request with the continuous batcher, or
    through ``generate_songs`` for a request with a MIDI "prompt", writes
    <id>_<k>.mid files and a responses.jsonl line per request into
    ``--out-dir``, and journals what it served (``serving.serve_requests``).
    The weights load once.  SIGTERM or SIGINT drains and returns (it sets
    ``train/pretrain.py INTERRUPT``).  Returns {"served", "seconds"}."""
    e2w, w2e = tokenizer.drop_type(tokenizer.construct_cp_dict())
    vocab = tuple(tokenizer.n_classes(e2w))
    mcfg = C.agent_config(vocab, n_layer=args.layers)
    device = torch.device(args.device)
    params = _generation_params(args, mcfg, device)
    os.makedirs(args.out_dir, exist_ok=True)
    resp_path = os.path.join(args.out_dir, "responses.jsonl")

    def on_result(req, res):
        rid = str(req.get("id", "req"))
        paths = []
        for k, song in enumerate(res.songs):
            path = os.path.join(args.out_dir, f"{rid}_{k}.mid")
            tokenizer.write_midi_cp(np.asarray(song), path, w2e)
            paths.append(path)
        line = {"id": rid, "songs": len(res.songs), "steps": res.steps, "files": paths}
        with open(resp_path, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(f"served {rid}: {len(res.songs)} songs in {res.steps} steps")

    pretrain_lib._install_interrupt_handler()      # SIGTERM = clean drain
    print(f"serving from {args.requests} (batch {args.batch}) on {device}; "
          f"shutdown: SIGTERM or a {{\"cmd\": \"shutdown\"}} line")
    t0 = time.perf_counter()
    n = serving.serve_requests(
        params, mcfg, args.requests, on_result, batch=args.batch, poll_s=args.poll,
        max_requests=args.max_requests, idle_timeout_s=args.idle_timeout,
        max_tokens_per_song=args.max_tokens, stop_event=pretrain_lib.INTERRUPT,
        prompt_loader=_prompt_rows)
    elapsed = time.perf_counter() - t0
    print(f"served {n} requests; exiting")
    return {"served": n, "seconds": elapsed}


# -- data commands (host-side; no device) ------------------------------------------

def cmd_prepare_data(args) -> None:
    """MIDI folder -> worded_data.pickle + dictionary.pickle (``--scheme
    tuple``, ppo_policy/prepare_data.py:360-380) or train_data_linear.npz +
    dictionary.pkl (``--scheme cp``, the DQN side's files); JAX :46-85."""
    os.makedirs(args.save_folder, exist_ok=True)
    midis = []
    for root, _, files in os.walk(args.midi_folder):
        for f in files:
            if f.endswith((".mid", ".midi")):
                midis.append(os.path.join(root, f))
    print(f"number of midis: {len(midis)}")
    if args.scheme == "cp":
        x, y, mask, dicts = cp_tokenizer.build_cp_training_data(
            midis, seq_len=args.cp_seq_len, with_type=True, workers=args.workers)
        np.savez(os.path.join(args.save_folder, "train_data_linear.npz"), x=x, y=y, mask=mask)
        with open(os.path.join(args.save_folder, "dictionary.pkl"), "wb") as f:
            pickle.dump([dicts[0], dicts[1]], f)
        print(f"CP dataset: x {x.shape} -> {args.save_folder}")
        return
    songs = parallel_encode.tuple_extract_corpus(midis, workers=args.workers)
    dicts = tokenizer.construct_tuple_dict()
    tokenizer.save_dict(dicts, os.path.join(args.save_folder, "dictionary.pickle"))
    worded = tokenizer.tuple_events_to_words(songs, dicts[0])
    with open(os.path.join(args.save_folder, "worded_data.pickle"), "wb") as f:
        pickle.dump(worded, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"saved dictionary + worded_data to {args.save_folder}")


def cmd_preprocess(args) -> None:
    """worded_data.pickle -> our_dataset.pickle (ppo_policy/preprocess.py;
    JAX :88-100)."""
    with open(args.worded_data, "rb") as f:
        worded = pickle.load(f)
    packed = dataset.process_data(dataset.flatten_worded_songs(worded),
                                  max_seq_len=args.max_seq_len)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(packed, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"train_x {packed['train_x'].shape} -> {args.out}")


def cmd_split_data(args) -> None:
    """90/10 split -> worded_data_{train,test}.pickle beside the input
    (ppo_policy/prepare_data.py:443-464; JAX :103-109)."""
    n_train, n_test = dataset.split_data(args.worded_data, seed=args.seed)
    print(f"n_train: {n_train}, n_test: {n_test}")


def cmd_data_midi(args) -> None:
    """One packed-dataset row decoded back to a tuple-event MIDI file
    (ppo_policy/data_midi.py:39-56; JAX :218-235)."""
    with open(args.dictionary, "rb") as f:
        _, w2e = pickle.load(f)
    with open(args.dataset, "rb") as f:
        packed = pickle.load(f)
    row = packed["train_x"][args.row]
    mask = packed.get("mask")
    if mask is not None:
        row = row[mask[args.row] > 0]
    events = tokenizer.words_to_tuple_events(row, w2e)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    tokenizer.tuple_events_to_midi(events, args.out)
    print(f"row {args.row} ({len(events)} events) -> {args.out}")


def _load_pretrain_data(args, vocab):
    if args.synthetic or not args.train_data:
        return dataset.synthetic_cp_dataset(args.synthetic_songs, args.seq_len, n_class=vocab)
    x, y, mask, _, _ = dataset.load_cp_npz(args.train_data, args.dictionary)
    return x[:, :args.seq_len], y[:, :args.seq_len], mask[:, :args.seq_len]


def _run_pretrain(params, mcfg, x, y, mask, pcfg: C.PretrainConfig, device, *,
                  use_wandb: bool = False, max_steps=None, resume=None,
                  step_fn=pretrain_lib.agent_train_step, mesh=None) -> dict:
    """The pretrain loop, timed after the data and the weights are made.
    Returns {"steps", "seconds", "tokens_per_s", "batch_losses", "history"}.
    Under a mesh only rank 0 logs."""
    print(f"n_parameters: {lt.n_params(params):,}")
    rank0 = mesh is None or mesh.rank == 0
    bus = MetricsBus(Saver(pcfg.exp_dir) if rank0 else QuietSaver(),
                     use_wandb=use_wandb and rank0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    params, _, history = pretrain_lib.pretrain(params, mcfg, x, y, mask, pcfg, step_fn=step_fn,
                                               mesh=mesh, metrics=bus, max_steps=max_steps,
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


def cmd_pretrain(args, mesh=None) -> dict:
    """Agent CE pretrain (dqn_policy/agent_pretrain.py:485-632); returns
    ``_run_pretrain``'s numbers.  ``--dp N``: N dp indices (``_run_ranks``),
    each on its 1/N of every ``--batch-size`` batch; ``--tp M``: M ranks a
    dp index, each holding its 1/M of the Megatron-split weights; ``--pp
    P``: P pipeline stages (JAX :139-146), each holding 1/P of the layers.
    The flags the ranks would refuse are refused here first: the orbax
    backend (``NotImplementedError``), ZeRO-1 with ``--pp`` and a ``--pp``
    that does not divide the layers (``ValueError``, JAX's)."""
    if args.ckpt_backend != "pickle":
        raise NotImplementedError(f"--ckpt-backend {args.ckpt_backend}: only the pickle format "
                                  "is ported (ROADMAP Queue 1 item 9(e))")
    if args.pp > 1 and args.zero1:
        raise ValueError("zero1 on a pipeline mesh is not implemented (moments would need the "
                         "layer-stack 'pp' sharding on top of 'dp'); use a ('dp','tp') mesh")
    if args.layers % args.pp:
        raise ValueError(f"n_layer={args.layers} not divisible by pp={args.pp}")
    if (args.dp > 1 or args.tp > 1 or args.pp > 1) and mesh is None:
        return _run_ranks(args)
    vocab = (tuple(int(v) for v in args.vocab.split(",")) if args.vocab
             else (56, 135, 18, 87, 18, 25))
    mcfg = C.agent_config(vocab, n_layer=args.layers, dtype=args.dtype)
    x, y, mask = _load_pretrain_data(args, vocab)
    device = torch.device(args.device) if mesh is None else mesh.device
    params = lt.init_params(mcfg, seed=args.seed, device=device)
    pcfg = C.PretrainConfig(n_epoch=args.epochs, batch_size=args.batch_size, lr=args.lr,
                            ckpt_dir=args.ckpt_dir, exp_dir=args.exp_dir, seed=args.seed,
                            zero1=args.zero1, grad_accum=args.grad_accum,
                            ckpt_backend=args.ckpt_backend,
                            save_on_interrupt=args.save_on_interrupt)
    return _run_pretrain(params, mcfg, x, y, mask, pcfg, device, use_wandb=args.wandb,
                         max_steps=args.max_steps, resume=args.resume, mesh=mesh)


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _plot_dqn(exp_dir: str, mse_hist, ce_hist, total_hist, agent_scores, expert_scores):
    plotting.bi_loss_plot(mse_hist, ce_hist, total_hist, ["MSE", "CE", "Global"],
                          os.path.join(exp_dir, "agent_loss.png"))
    plotting.score_plotting(agent_scores, expert_scores, os.path.join(exp_dir, "disc_scores.png"))
    plotting.curve_plot({"D(agent)": agent_scores, "D(expert)": expert_scores},
                        os.path.join(exp_dir, "disc_separation.png"), xlabel="Update",
                        ylabel="Mean discriminator score")


def _whole(mesh, params: dict, tx=None, opt_state=None):
    """(params, optimizer state) as a checkpoint holds them: whole trees,
    the tp shards gathered (collectives: every rank calls it)."""
    if mesh is None:
        return params, opt_state
    return gather_params(mesh, params), full_opt_state(tx, opt_state, mesh)


def cmd_dqn_train(args, mesh=None) -> dict:
    """DQN + AIRL fine-tune (dqn_policy/IRL_dqn_train.py:386-498): per song,
    a 50-episode rollout into the agent and expert buffers; once the agent
    buffer has wrapped, an AIRL pass (discriminator training on the first
    one, or every one with --retrain-disc, then both buffers re-scored as
    rewards) and one DQN update.  Writes ``dqn_last.ckpt`` and, from epoch
    ``--ckpt-epoch-gate`` on, ``dqn_best.ckpt`` and ``agent_info.pickle``.
    Returns {"updates", "metrics" (one dict of floats per update),
    "rollout_ms" (per song), "update_ms" and "airl_ms" (per update), each
    timed to a device synchronisation; "final": the eval and discriminator
    trees and the generator at the end, the rank's own, which
    ``_run_ranks`` does not carry back}.

    ``--dp N --tp M`` (``_run_ranks``; JAX cli.py:299-351): the eval and
    target nets, their Adam moments and the discriminator are each rank's
    tp shards; the rollouts and the AIRL pass (on the whole buffers) are
    the same on every rank; one generator seeded ``cfg.seed`` on every rank
    draws the discriminator's dropout, both buffer samples and the update's
    dropout, in one order, and the update splits its batches over dp
    (``dqn.update``).  Rank 0 logs, plots and writes whole trees; the
    metrics are the global ones, the times rank 0's."""
    if (args.dp > 1 or args.tp > 1) and mesh is None:
        return _run_ranks(args)
    vocab = (56, 135, 18, 87, 18, 25)
    mcfg = C.agent_config(vocab, n_layer=args.layers)
    wcfg = C.airl_discriminator_config(vocab, n_layer=max(1, args.layers - 2))
    cfg = C.DQNConfig(num_songs=args.songs, episodes=args.episodes, buffer_size=args.buffer_size,
                      batch_size=args.batch_size, n_states=args.n_states,
                      n_actions=args.n_actions, ckpt_epoch_gate=args.ckpt_epoch_gate)
    acfg = C.AIRLConfig(batch_size=min(100, args.buffer_size), epochs=args.disc_epochs,
                        lr_step=args.disc_lr_step, lr=args.disc_lr,
                        score_batch_size=min(args.score_batch_size, args.buffer_size))
    device = torch.device(args.device) if mesh is None else mesh.device
    rank0 = mesh is None or mesh.rank == 0
    x, y, mask = (torch.from_numpy(a).to(device) for a in _load_pretrain_data(args, vocab))

    pretrain_params = None
    if args.pretrain_ckpt:
        template = lt.init_params(mcfg, seed=0, device="cpu")
        pretrain_params = load_jax_checkpoint(args.pretrain_ckpt, template, device=device)
    state = dqn.init_state(mcfg, cfg, pretrain_params, seed=cfg.seed, device=device)
    tx = dqn.make_optimizer(cfg)
    rstate = airl.init_state(wcfg, acfg, seed=cfg.seed + 1, device=device)
    rtx = airl.make_optimizer(acfg)
    if mesh is not None:
        eval_params = shard_params(mesh, state.eval_params)
        state = dqn.DQNState(eval_params, optim.tree_map(torch.clone, eval_params),
                             tx.init(eval_params), state.target_count)
        disc = shard_params(mesh, rstate.params)
        rstate = airl.AIRLState(disc, rstate.bn_state, rtx.init(disc))
    agent_buf = buffers.buffer_init(cfg.buffer_size, buffers.agent_field_specs(
        cfg.n_states, cfg.n_actions, cfg.n_features), device)
    expert_buf = buffers.buffer_init(cfg.buffer_size, buffers.expert_field_specs(
        cfg.n_states, cfg.n_actions, cfg.n_features), device)
    # one stream on every rank: offset by the dp index, the ranks would
    # train the discriminator on other masks and sample other batches
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)

    bus = MetricsBus(Saver(args.exp_dir) if rank0 else QuietSaver(),
                     use_wandb=args.wandb and rank0)
    mse_hist, ce_hist, total_hist = [], [], []
    agent_score_hist, expert_score_hist = [], []
    times = {"rollout_ms": [], "update_ms": [], "airl_ms": []}
    updates = 0
    for epoch in range(cfg.num_songs):
        song = epoch % x.shape[0]
        _sync(device)
        t0 = time.perf_counter()
        agent_ts, expert_ts = env.dqn_rollout_song(
            state.eval_params, mcfg, x[song], y[song], mask[song], episodes=cfg.episodes,
            n_states=cfg.n_states, n_actions=cfg.n_actions, mesh=mesh)
        agent_buf = buffers.buffer_store_batch(agent_buf, agent_ts)
        expert_buf = buffers.buffer_store_batch(expert_buf, expert_ts)
        _sync(device)
        t1 = time.perf_counter()
        times["rollout_ms"].append((t1 - t0) * 1e3)

        # the same decision on every rank: the rollouts are the same
        if agent_buf.counter > cfg.buffer_size:
            rstate, agent_r, expert_r, _ = airl.update_disc(
                rstate, wcfg, acfg, rtx, buffers.buffer_get(agent_buf),
                buffers.buffer_get(expert_buf), gen, train=(updates == 0 or args.retrain_disc),
                mesh=mesh)
            # the discriminator's mean expert and agent buffer scores
            # (the learning-effect curves of AIRL.py:194-226)
            agent_score_hist.append(float(agent_r.mean()))
            expert_score_hist.append(float(expert_r.mean()))
            t2 = time.perf_counter()
            times["airl_ms"].append((t2 - t1) * 1e3)
            agent_buf = agent_buf._replace(data={**agent_buf.data, "reward": agent_r})
            batch = buffers.buffer_sample(agent_buf, gen, cfg.batch_size)
            ebatch = buffers.buffer_sample(expert_buf, gen, cfg.batch_size)
            rewards = batch["reward"]                       # the whole batch's
            state, metrics = dqn.update(
                state, mcfg, cfg, tx, batch,
                {"state": ebatch["state"], "next_state": ebatch["next_state"],
                 "mask_next_state": ebatch["mask_next_state"]}, gen, mesh)
            metrics = {k: float(v) for k, v in metrics.items()}
            times["update_ms"].append((time.perf_counter() - t2) * 1e3)
            updates += 1
            bus.log({**metrics, "agent_score": agent_score_hist[-1],
                     "expert_score": expert_score_hist[-1]})
            mse_hist.append(metrics["mse"])
            ce_hist.append(metrics["ce"])
            total_hist.append(metrics["total"])
            print(f"Epoch {epoch}/{cfg.num_songs} | MSE {metrics['mse']:.4f} "
                  f"| CE {metrics['ce']:.4f} | total {metrics['total']:.4f} "
                  f"| D(agent) {agent_score_hist[-1]:.3f} "
                  f"| D(expert) {expert_score_hist[-1]:.3f}")
            if epoch >= cfg.ckpt_epoch_gate:
                ckpt_path = os.path.join(args.ckpt_dir, "dqn_best.ckpt")
                params_w, opt_w = _whole(mesh, state.eval_params, tx, state.opt_state)
                if rank0:
                    save_checkpoint(ckpt_path, params_w, opt_w, epoch)
                    bus.save_file(ckpt_path)          # IRL_dqn_train.py:370 wandb.save
                    # the training record (IRL_dqn_train.py:380-383): 'Agent' = the
                    # last update batch's rewards, and the three loss histories under
                    # the reference's keys (with its literal ' global_loss')
                    record = {"Agent": rewards.cpu().numpy(), "first_loss": mse_hist,
                              "sec_loss": ce_hist, " global_loss": total_hist}
                    with open(os.path.join(args.ckpt_dir, "agent_info.pickle"), "wb") as f:
                        pickle.dump(record, f)
                    _plot_dqn(args.exp_dir, mse_hist, ce_hist, total_hist, agent_score_hist,
                              expert_score_hist)
        else:
            print(f"Epoch {epoch}/{cfg.num_songs} | buffer "
                  f"{agent_buf.counter}/{cfg.buffer_size}")
        if args.max_updates and updates >= args.max_updates:
            break
    params_w, opt_w = _whole(mesh, state.eval_params, tx, state.opt_state)
    if rank0:
        save_checkpoint(os.path.join(args.ckpt_dir, "dqn_last.ckpt"), params_w, opt_w,
                        cfg.num_songs)
        if updates:
            _plot_dqn(args.exp_dir, mse_hist, ce_hist, total_hist, agent_score_hist,
                      expert_score_hist)
    bus.saver.close()
    mean = lambda v: sum(v) / len(v) if v else float("nan")
    ranks = "" if mesh is None else f", {mesh.dp} x {mesh.tp} ranks (dp x tp)"
    print(f"done: {updates} updates on {device}{ranks}; {mean(times['rollout_ms']):.1f} ms per "
          f"rollout song ({cfg.episodes} episodes), {mean(times['update_ms']):.1f} ms per DQN "
          f"update, {mean(times['airl_ms']):.1f} ms per AIRL pass")
    history = [{**{"mse": a, "ce": b, "total": c}, "agent_score": d, "expert_score": e}
               for a, b, c, d, e in zip(mse_hist, ce_hist, total_hist, agent_score_hist,
                                        expert_score_hist)]
    return {"updates": updates, "metrics": history, **times,
            "final": {"eval": state.eval_params, "disc": rstate.params, "generator": gen}}


def _depth(params: Optional[dict]) -> Optional[int]:
    """Layers of a checkpoint's trunk (its stacked leaves' leading size)."""
    return None if params is None else int(params["layers"]["wq"]["w"].shape[0])


def cmd_ppo_train(args, mesh=None) -> dict:
    """PPO fine-tune (ppo_policy/ppo_train.py:419-528): per song, a rollout
    of ``--episodes`` episodes (actor action, critic value, learned reward),
    returns and advantages, then ``--ppo-steps`` clipped-surrogate updates of
    the actor and the critic.  Writes ``ppo_best.ckpt`` (the actor) and the
    reward curve every 5 songs.  ``--pretrain-actor`` / ``--pretrain-reward``
    read checkpoints of ``my-pretrain`` (the port's or the JAX package's);
    a model read from one keeps the checkpoint's depth, as the JAX package's
    layer scan does.  Returns {"songs", "metrics" (one dict of floats per
    song, with "mean_reward"), "rollout_ms" and "update_ms" (per song, each
    timed to a device synchronisation); "final": the three trees at the end,
    as ``cmd_dqn_train``'s}.

    ``--dp N --tp M`` (``_run_ranks``; JAX cli.py:452-484): the actor, the
    critic, the reward model and the two optimizers' moments are each
    rank's tp shards; the rollout is the same on every rank, returns and
    advantages are computed on the whole rollout, then the transitions and
    both are split over dp.  Rank 0 logs, plots and writes the whole actor;
    the metrics are the global ones, the times rank 0's."""
    if (args.dp > 1 or args.tp > 1) and mesh is None:
        return _run_ranks(args)
    vocab = (49, 19, 19, 89, 67, 25)
    device = torch.device(args.device) if mesh is None else mesh.device
    rank0 = mesh is None or mesh.rank == 0
    actor_params = reward_params = None
    if args.pretrain_actor:
        actor_params = load_jax_checkpoint(args.pretrain_actor, device=device)
    if args.pretrain_reward:
        # the reward model of `my-pretrain --reward-pretrain`; a random one
        # scores a flat ~0.5 and the reward curve has nothing to climb
        reward_params = load_jax_checkpoint(args.pretrain_reward, device=device)
    acfg = C.actor_config(vocab, n_layer=_depth(actor_params) or args.layers)
    ccfg = C.critic_config(vocab, n_layer=args.layers)
    rcfg = C.ppo_reward_config(vocab, n_layer=_depth(reward_params) or max(1, args.layers - 2))
    cfg = C.PPOConfig(num_songs=args.songs, episodes=args.episodes, n_states=args.n_states,
                      n_actions=args.n_actions, ppo_steps=args.ppo_steps,
                      compat_forward_returns=args.compat_forward_returns)
    x, y, mask = (torch.from_numpy(a).to(device) for a in _load_pretrain_data(args, vocab))
    state = ppo.init_state(acfg, ccfg, rcfg, cfg, actor_params=actor_params,
                           reward_params=reward_params, seed=cfg.seed, device=device)
    txs = ppo.make_optimizers(cfg)
    cfgs = (acfg, ccfg, rcfg)
    if mesh is not None:
        actor, critic = shard_params(mesh, state.actor_params), shard_params(mesh,
                                                                             state.critic_params)
        state = ppo.PPOState(actor, critic, shard_params(mesh, state.reward_params),
                             txs[0].init(actor), txs[1].init(critic))

    bus = MetricsBus(Saver(args.exp_dir) if rank0 else QuietSaver(),
                     use_wandb=args.wandb and rank0)
    history, reward_hist = [], []
    times = {"rollout_ms": [], "update_ms": []}
    reward_png = os.path.join(args.exp_dir, "ppo_reward.png")
    for epoch in range(cfg.num_songs):
        song = epoch % x.shape[0]
        _sync(device)
        t0 = time.perf_counter()
        agent_ts, expert_ts = ppo.rollout_song(state, cfgs, x[song], y[song], mask[song],
                                               episodes=cfg.episodes, n_states=cfg.n_states,
                                               n_actions=cfg.n_actions, mesh=mesh)
        returns = ppo.calculate_returns(agent_ts["reward"][:, 0], cfg.discount,
                                        compat_forward=cfg.compat_forward_returns)
        adv = ppo.calculate_advantages(returns, agent_ts["value"])
        # the learned reward model's mean score of the rollout: the learning
        # curve (ppo_train.py:516-527)
        mean_reward = agent_ts["reward"].mean()
        if mesh is not None:
            agent_ts, expert_ts, adv, returns = pmesh.shard_batch(
                mesh, (agent_ts, expert_ts, adv, returns))
        _sync(device)
        t1 = time.perf_counter()
        state, metrics = ppo.update_policy(state, cfgs, cfg, txs, agent_ts, expert_ts, adv,
                                           returns, mesh)
        # one host read per song: the metrics and the mean reward together
        vals = torch.stack([*metrics.values(), mean_reward]).tolist()
        times["rollout_ms"].append((t1 - t0) * 1e3)
        times["update_ms"].append((time.perf_counter() - t1) * 1e3)
        metrics = {**dict(zip(metrics, vals)), "mean_reward": vals[-1]}
        reward_hist.append(vals[-1])
        history.append(metrics)
        bus.log(metrics)
        print(f"Epoch {epoch}/{cfg.num_songs} | actor {metrics['actor_loss']:.4f} | critic "
              f"{metrics['value_loss']:.4f} | reward {metrics['mean_reward']:.4f}")
        if epoch % 5 == 0:
            actor_w, _ = _whole(mesh, state.actor_params)
            if rank0:
                save_checkpoint(os.path.join(args.ckpt_dir, "ppo_best.ckpt"), actor_w, None,
                                epoch)
                plotting.curve_plot({"mean reward": reward_hist}, reward_png,
                                    ylabel="Learned reward (rollout mean)")
    if reward_hist and rank0:
        plotting.curve_plot({"mean reward": reward_hist}, reward_png,
                            ylabel="Learned reward (rollout mean)")
    bus.saver.close()
    mean = lambda v: sum(v) / len(v) if v else float("nan")
    ranks = "" if mesh is None else f", {mesh.dp} x {mesh.tp} ranks (dp x tp)"
    print(f"done: {cfg.num_songs} songs on {device}{ranks}; {mean(times['rollout_ms']):.1f} ms "
          f"per rollout song ({cfg.episodes} episodes), {mean(times['update_ms']):.1f} ms per "
          f"update_policy ({cfg.ppo_steps} steps)")
    return {"songs": cfg.num_songs, "metrics": history, **times,
            "final": {"actor": state.actor_params, "critic": state.critic_params,
                      "reward": state.reward_params}}


def cmd_inference(args) -> dict:
    """PPO-style fixed-token generation (ppo_policy/inference.py:78-161):
    the actor samples ``--tokens`` tokens from a zero seed token, plain
    categorical over all six fields, through the plain per-step decode (as
    the JAX command, which leaves ``fused`` off), decoded to a tuple-event
    MIDI file.  Returns {"tokens", "notes", "path", "seconds"}."""
    e2w, w2e = tokenizer.construct_tuple_dict()
    vocab = tuple(tokenizer.n_classes(e2w))
    mcfg = C.actor_config(vocab, n_layer=args.layers)
    device = torch.device(args.device)
    if args.ckpt:
        template = lt.init_params(mcfg, seed=0, device="cpu")
        params = load_jax_checkpoint(args.ckpt, template, device=device)
    else:
        params = lt.init_params(mcfg, seed=args.seed, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed)
    settings = tuple(smp.FieldSampling(1.0, None) for _ in range(mcfg.n_fields))
    _sync(device)
    t0 = time.perf_counter()
    res = sampler.generate_tokens(params, mcfg,
                                  torch.zeros((1, 1, mcfg.n_fields), dtype=torch.int32,
                                              device=device),
                                  generator=generator, max_tokens=args.tokens,
                                  token_count=args.tokens, settings=settings)
    toks = res.tokens[0][res.valid[0]][1:].cpu().numpy()
    elapsed = time.perf_counter() - t0
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    midi = tokenizer.tuple_events_to_midi(tokenizer.words_to_tuple_events(toks, w2e), args.out)
    print(f"{len(toks)} tokens -> {args.out} ({elapsed:.2f}s on {device})")
    return {"tokens": len(toks), "notes": sum(len(i.notes) for i in midi.instruments),
            "path": args.out, "seconds": elapsed}


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
                   help="run once, on seed + 1, before timing (builds the kernels)")
    d.add_argument("--prompt", default=None,
                   help="MIDI file to continue from (its CP rows seed every song)")
    d.add_argument("--prompt-tokens", type=int, default=None,
                   help="keep the prompt's first N rows")
    d.add_argument("--continuous", action="store_true",
                   help="continuous batching: a slot refills the moment its song completes "
                        "(serving mode; right for --songs >> batch)")
    d.add_argument("--continuous-batch", type=int, default=None,
                   help="slot count for --continuous (default min(songs, 8))")
    d.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks, one process each, started here (gloo with "
                        "--device cpu, else NCCL with a card a rank); each decodes its share "
                        "of the songs")
    d.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks a dp index (Megatron: each holds 1/tp of the "
                        "heads, FFN, embeddings and output heads); dp x tp processes in all, "
                        "started as for --dp; not with --continuous")
    d.add_argument("--dtype", default="bfloat16", choices=tuple(_DTYPES),
                   help="decode weight dtype (bf16 halves the weight stream)")
    d.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions of the kernels")
    d.set_defaults(fn=cmd_generate)

    d = sub.add_parser("serve", help="generation daemon over a JSONL request file "
                                     "(continuous batching)")
    d.add_argument("--requests", required=True,
                   help='JSONL file to tail: {"id", "songs", "bars", "seed", "prompt"}; '
                        '{"cmd": "shutdown"} stops')
    d.add_argument("--out-dir", default="served")
    d.add_argument("--batch", type=int, default=8)
    d.add_argument("--layers", type=int, default=12)
    d.add_argument("--ckpt", default=None, help="params of a JAX or port checkpoint")
    d.add_argument("--dtype", default="float32", choices=tuple(_DTYPES),
                   help="decode weight dtype (float32, as the JAX serve; generate's is bfloat16)")
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--poll", type=float, default=0.5)
    d.add_argument("--max-tokens", type=int, default=4096)
    d.add_argument("--max-requests", type=int, default=None)
    d.add_argument("--idle-timeout", type=float, default=None)
    d.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions of the kernels")
    d.set_defaults(fn=cmd_serve)

    d = sub.add_parser("prepare-data", help="MIDI -> worded data + dictionary")
    d.add_argument("--midi-folder", required=True)
    d.add_argument("--save-folder", default="./dataset")
    d.add_argument("--scheme", choices=("tuple", "cp"), default="tuple",
                   help="tuple: ppo pipeline files; cp: DQN-side train_data_linear.npz + "
                        "dictionary.pkl")
    d.add_argument("--cp-seq-len", type=int, default=3584)
    d.add_argument("--workers", type=int, default=None,
                   help="process-pool width for encoding (default: all CPUs)")
    d.set_defaults(fn=cmd_prepare_data)

    d = sub.add_parser("preprocess", help="worded data -> packed dataset")
    d.add_argument("--worded-data", default="./dataset/worded_data.pickle")
    d.add_argument("--out", default="./dataset/our_dataset.pickle")
    d.add_argument("--max-seq-len", type=int, default=1200)
    d.set_defaults(fn=cmd_preprocess)

    d = sub.add_parser("split-data", help="90/10 train/test split of a worded-data pickle")
    d.add_argument("--worded-data", default="./dataset/worded_data.pickle")
    d.add_argument("--seed", type=int, default=0)
    d.set_defaults(fn=cmd_split_data)

    d = sub.add_parser("data-midi", help="decode a dataset row to MIDI")
    d.add_argument("--dataset", default="./dataset/our_dataset.pickle")
    d.add_argument("--dictionary", default="./dataset/dictionary.pickle")
    d.add_argument("--row", type=int, default=10)
    d.add_argument("--out", default="./gen_midi/111.mid")
    d.set_defaults(fn=cmd_data_midi)

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
    d.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks, one process each, started here (gloo with "
                        "--device cpu, else NCCL with a card a rank); each takes 1/dp of "
                        "every batch")
    d.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks a dp index (Megatron: each holds 1/tp of the "
                        "heads, FFN, embeddings and output heads); dp x tp processes in all, "
                        "started as for --dp")
    d.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages (layer slabs over a 'pp' mesh axis, "
                        "microbatched GPipe schedule; n_layer must divide by pp, batch by "
                        "dp*2*pp; composes with --dp and --tp into dp x pp x tp ranks, started "
                        "as for --dp)")
    d.add_argument("--save-on-interrupt", action="store_true",
                   help="SIGTERM/SIGINT checkpoints to interrupt.ckpt and returns")
    d.add_argument("--ckpt-backend", choices=("pickle", "orbax"), default="pickle",
                   help="orbax is not ported yet (raises, ROADMAP Queue 1 item 9(e))")
    d.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches per optimizer step")
    d.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: Adam's moments sliced over the dp ranks (optimizer memory / "
                        "dp; one all-gather of the updates a step); needs --dp > 1")
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

    d = sub.add_parser(
        "dqn-train", help="DQN + AIRL fine-tune",
        description="DQN + AIRL fine-tuning with the flags of the JAX package's dqn-train "
                    "(--scan-unroll left out; --lr, --epochs, --max-steps and --seed are read "
                    "and not used, as there: DQNConfig sets the DQN's lr and seed).")
    _train_common(d)
    d.add_argument("--songs", type=int, default=1500)
    d.add_argument("--episodes", type=int, default=50)
    d.add_argument("--buffer-size", type=int, default=20000)
    d.add_argument("--n-states", type=int, default=50)
    d.add_argument("--n-actions", type=int, default=25)
    d.add_argument("--pretrain-ckpt", default=None,
                   help="agent params of a JAX or port checkpoint")
    d.add_argument("--retrain-disc", action="store_true",
                   help="train the discriminator before every update, not only the first")
    d.add_argument("--max-updates", type=int, default=None)
    d.add_argument("--disc-epochs", type=int, default=5,
                   help="AIRL discriminator epochs per training pass")
    d.add_argument("--disc-lr", type=float, default=0.001,
                   help="discriminator Adam lr (the reference's 1e-3, AIRL.py:170)")
    d.add_argument("--disc-lr-step", type=int, default=10,
                   help="discriminator StepLR period in minibatches (AIRL.py:176)")
    d.add_argument("--ckpt-epoch-gate", type=int, default=410,
                   help="first epoch eligible for dqn_best.ckpt and agent_info.pickle "
                        "(IRL_dqn_train.py:362)")
    d.add_argument("--score-batch-size", type=int, default=100,
                   help="buffer re-scoring batch; it sets the reward values, not only the "
                        "speed (train-mode BatchNorm with per-batch statistics)")
    d.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks, one process each, started here (gloo with "
                        "--device cpu, else NCCL with a card a rank); each takes 1/dp of every "
                        "DQN update batch; the rollouts and AIRL passes run on every rank")
    d.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks a dp index (Megatron: each holds 1/tp of the "
                        "agent's and the discriminator's heads, FFN, embeddings and output "
                        "heads); dp x tp processes in all, started as for --dp")
    d.set_defaults(fn=cmd_dqn_train)

    d = sub.add_parser(
        "ppo-train", help="PPO fine-tune",
        description="PPO fine-tuning with the flags of the JAX package's ppo-train "
                    "(--scan-unroll left out; --lr, --epochs, --max-steps, --batch-size and "
                    "--seed are read and not used, as there: PPOConfig sets the lr and seed).")
    _train_common(d)
    d.add_argument("--songs", type=int, default=1000)
    d.add_argument("--episodes", type=int, default=30)
    d.add_argument("--n-states", type=int, default=50)
    d.add_argument("--n-actions", type=int, default=25)
    d.add_argument("--ppo-steps", type=int, default=10)
    d.add_argument("--pretrain-actor", default=None,
                   help="actor params of a my-pretrain checkpoint (JAX or port)")
    d.add_argument("--pretrain-reward", default=None,
                   help="reward-model params of a my-pretrain --reward-pretrain checkpoint")
    d.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks, one process each, started here (gloo with "
                        "--device cpu, else NCCL with a card a rank); each takes 1/dp of every "
                        "rollout's transitions in the updates; the rollouts run on every rank")
    d.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks a dp index (Megatron: each holds 1/tp of the "
                        "actor's, critic's and reward model's heads, FFN, embeddings and "
                        "output heads); dp x tp processes in all, started as for --dp")
    d.add_argument("--compat-forward-returns", action="store_true",
                   help="the reference's forward-order reward discounting "
                        "(ppo_train.py:348-357)")
    d.set_defaults(fn=cmd_ppo_train)

    d = sub.add_parser("inference", help="PPO-style fixed-token generation")
    d.add_argument("--tokens", type=int, default=150)
    d.add_argument("--layers", type=int, default=12)
    d.add_argument("--ckpt", default=None,
                   help="actor params of a JAX or port checkpoint")
    d.add_argument("--out", default="gen_midi/pretrain_actor.mid")
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions of the kernels")
    d.set_defaults(fn=cmd_inference)
    return ap


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
