#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training steps, on one GPU.

    python3 scripts/profile_torch_train.py [--model agent|discrim|dqn|ppo] [--route NAME|all]
                                           [--dtype float32|bfloat16] [--out build/profile]

``--model agent`` (the default): the flagship ``config.agent_config``, B=32 x
S=512, two ``train.pretrain.agent_train_step`` calls per route: ``kernel``
is the default route on a card (kernels C and D in every layer), ``plain``
the PyTorch composition (RLMG_FFN_BACKEND=xla, RLMG_ATTN_BACKEND=xla).
``--model discrim``: the discriminator LM (``config.discrim_lm_config``
with the six fields of ``cli discrim-pretrain``), B=4 x S=3584, two
``train.pretrain.longformer_lm_step`` calls per route: ``kernel`` is the
default route (kernel D in every layer, the plain band attention),
``window`` RLMG_WINDOW_BACKEND=pallas (kernel E in every layer, the plain
tail), ``plain`` RLMG_FFN_BACKEND=xla.  ``--model dqn``: the DQN agent at
``agent_config``'s width, two windows per route: one rollout song (50
episodes, each a (1, 50)-row forward, ``rl.env.dqn_rollout_song``) and one
``rl.dqn.update`` at B=30 x S=50 (``DQNConfig``'s batch); ``default`` is the
plain composition (the JAX rule at 1500 rows), ``kernel``
RLMG_ATTN_BACKEND=pallas (kernel F in every layer).  ``--model ppo``: the
PPO actor and critic at ``actor_config`` / ``critic_config`` (12 layers),
the reward model ``ppo_reward_config`` at 10, two windows per route: one
rollout song (``rl.ppo.rollout_song``, 30 episodes of an actor, a critic
and a reward forward on one 50-row state) and one ``rl.ppo.update_policy``
(10 steps at B=30 x S=50); ``default`` is the plain composition, ``kernel``
RLMG_FFN_BACKEND=pallas (kernel G in every actor and critic layer).  Random
weights from a seed, synthetic CP rows (seed 0), dropout 0.1 as the CLIs
train (PPO's forwards are deterministic, as in the reference).
``--dtype bfloat16`` (agent and discrim) trains as ``cli pretrain --dtype
bfloat16`` does: bf16 compute, f32 master weights.

Each window runs once untraced first (kernels built, allocator warm), then
under torch.profiler.  For each it prints the wall time, the summed device
time of all kernels, the device busy share (device time over wall time)
and the kernels that took most of it, then one JSON line with the same
numbers.  Chrome traces go to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from reinforcement_learning_in_music_generation_torch import config as C  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import dataset  # noqa: E402
from reinforcement_learning_in_music_generation_torch.models import (  # noqa: E402
    linear_transformer as lt, longformer as lf)
from reinforcement_learning_in_music_generation_torch.ops import _build  # noqa: E402
from reinforcement_learning_in_music_generation_torch.rl import dqn, env, ppo  # noqa: E402
from reinforcement_learning_in_music_generation_torch.train import (  # noqa: E402
    optim, pretrain)

KNOBS = ("RLMG_FFN_BACKEND", "RLMG_ATTN_BACKEND", "RLMG_WINDOW_BACKEND")
DISCRIM_VOCAB = (56, 135, 18, 87, 18, 25)
MODELS = {
    "agent": dict(batch=32, seq=512, cfg=C.agent_config, init=lt.init_params,
                  step=pretrain.agent_train_step,
                  routes={"kernel": {},
                          "plain": {"RLMG_FFN_BACKEND": "xla", "RLMG_ATTN_BACKEND": "xla"}}),
    "discrim": dict(batch=4, seq=3584,
                    cfg=lambda: C.discrim_lm_config(DISCRIM_VOCAB,
                                                    emb_sizes=(128, 256, 64, 512, 256, 128)),
                    init=lf.init_params, step=pretrain.longformer_lm_step,
                    routes={"kernel": {}, "window": {"RLMG_WINDOW_BACKEND": "pallas"},
                            "plain": {"RLMG_FFN_BACKEND": "xla"}}),
    "dqn": dict(batch=30, seq=50, cfg=lambda: C.agent_config(DISCRIM_VOCAB),
                routes={"default": {}, "kernel": {"RLMG_ATTN_BACKEND": "pallas"}}),
    "ppo": dict(batch=30, seq=50, cfg=C.actor_config,
                routes={"default": {}, "kernel": {"RLMG_FFN_BACKEND": "pallas"}}),
}
STEPS = 2


def profile(name, fn, out_dir, tokens, top=12, steps=STEPS):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}.json"))
    kernels = {ev.key: (ev.count, ev.self_device_time_total / 1e3)   # us -> ms
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA}
    dev_ms = sum(v[1] for v in kernels.values())
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    launches = sum(v[0] for v in kernels.values())
    print(f"[{name}] wall {wall * 1e3:.3f} ms for {steps} steps, device {dev_ms:.3f} ms, "
          f"busy {dev_ms / (wall * 1e3):.1%}, {launches} launches")
    for kname, (n, ms) in rows:
        print(f"    {ms:10.3f} ms {ms / dev_ms:6.1%} {n:6d}x  {kname[:100]}")
    return {"window": name, "steps": steps, "wall_ms": wall * 1e3, "device_ms": dev_ms,
            "busy": dev_ms / (wall * 1e3) if wall else None, "launches": launches,
            "tokens_per_s": steps * tokens / wall,
            "top": [{"kernel": k[:100], "n": n, "ms": ms, "share": ms / dev_ms}
                    for k, (n, ms) in rows]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="agent", choices=tuple(MODELS))
    ap.add_argument("--route", default="all",
                    help="a route of the model (agent: kernel, plain; discrim: kernel, "
                         "window, plain; dqn and ppo: default, kernel) or all")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="compute dtype of the agent and discrim steps")
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    model = MODELS[args.model]
    routes = tuple(model["routes"]) if args.route == "all" else (args.route,)
    if any(r not in model["routes"] for r in routes):
        ap.error(f"--route {args.route}: {args.model} has {sorted(model['routes'])}")
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(f"card: {card}")
    _build.build_all()
    cfg = model["cfg"]()
    if args.model in ("agent", "discrim"):
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    b, s = model["batch"], model["seq"]
    dev = torch.device("cuda")
    song_len = 512 if args.model in ("dqn", "ppo") else s   # a rollout slides over a song
    x, y, m = (torch.from_numpy(a).to(dev) for a in
               dataset.synthetic_cp_dataset(b, song_len, n_class=cfg.vocab_sizes, seed=0))
    res = []
    for route in routes:
        for k in KNOBS:
            os.environ.pop(k, None)
        os.environ.update(model["routes"][route])
        if args.model in ("dqn", "ppo"):
            fn = profile_dqn if args.model == "dqn" else profile_ppo
            res += fn(route, cfg, x, y, m, b, s, args.out)
            continue
        params = model["init"](cfg, seed=0, device=dev)
        tx = optim.adam(1e-4, grad_clip=3.0)
        state = [tx.init(params)]
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)

        def steps():
            p, st = params, state[0]
            for _ in range(STEPS):
                p, st, _ = model["step"](p, st, cfg, tx, x, y, m, gen)
            state[0] = st

        res.append(profile(f"{args.model}_{route}_{args.dtype}_B{b}_S{s}", steps, args.out,
                           b * s))
        del params, state
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "model": args.model, "windows": res}))


def profile_dqn(route, cfg, x, y, m, b, s, out_dir):
    """One rollout song and one DQN update on the current route."""
    dcfg = C.DQNConfig()
    state = [dqn.init_state(cfg, dcfg, seed=0, device=x.device)]
    tx = dqn.make_optimizer(dcfg)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(0)

    def rollout():
        return env.dqn_rollout_song(state[0].eval_params, cfg, x[0], y[0], m[0],
                                    episodes=dcfg.episodes, n_states=s, n_actions=dcfg.n_actions)

    out = [profile(f"dqn_{route}_rollout_song", rollout, out_dir, dcfg.episodes * s, steps=1)]
    agent_t, expert_t = rollout()
    batch = {k: v[:b] for k, v in agent_t.items()}
    ebatch = {k: expert_t[k][:b] for k in ("state", "next_state", "mask_next_state")}

    def update():
        state[0], _ = dqn.update(state[0], cfg, dcfg, tx, batch, ebatch, gen)

    out.append(profile(f"dqn_{route}_update_B{b}_S{s}", update, out_dir, b * s, steps=1))
    del state[0]
    torch.cuda.empty_cache()
    return out


def profile_ppo(route, acfg, x, y, m, b, s, out_dir):
    """One PPO rollout song and one update_policy on the current route."""
    pcfg = C.PPOConfig()
    cfgs = (acfg, C.critic_config(acfg.vocab_sizes),
            C.ppo_reward_config(acfg.vocab_sizes, n_layer=10))
    state = [ppo.init_state(*cfgs, pcfg, seed=0, device=x.device)]
    txs = ppo.make_optimizers(pcfg)

    def rollout():
        return ppo.rollout_song(state[0], cfgs, x[0], y[0], m[0], episodes=pcfg.episodes,
                                n_states=s, n_actions=pcfg.n_actions)

    out = [profile(f"ppo_{route}_rollout_song", rollout, out_dir, pcfg.episodes * s, steps=1)]
    agent_t, expert_t = rollout()
    returns = ppo.calculate_returns(agent_t["reward"][:, 0], pcfg.discount)
    adv = ppo.calculate_advantages(returns, agent_t["value"])

    def update():
        state[0], _ = ppo.update_policy(state[0], cfgs, pcfg, txs, agent_t, expert_t, adv,
                                        returns)

    out.append(profile(f"ppo_{route}_update_policy_B{b}_S{s}", update, out_dir,
                       pcfg.ppo_steps * b * s, steps=pcfg.ppo_steps))
    del state[0]
    torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
