"""Rank functions for tests/test_torch_rl_parallel.py.

``parallel.launch`` starts each rank in a fresh interpreter that imports
this module by name, so it imports only torch, numpy and the port (and the
helpers of tests/torch_dp_workers.py, which import no jax either): never
jax, the JAX package or tests/conftest.py.  Each function runs on every
rank of a gloo group on the CPU, on one intra-op thread, and returns numpy
arrays and plain values; trees of tp shards come back whole
(``parallel.gather_params``), so the test holds them against the JAX
package's mesh and against one process.

Configs: tests/test_rl.py's TINY and TINY_W (d_model 16, one layer, two
heads, FFN 32, embeddings 8; the window transformer with window 8, both
heads) and its DQN config, at dropout 0; the PPO actor is TINY with the
value head.  The inputs (JAX-initialised weights as numpy trees, JAX
rollouts, buffers) come from the test.
"""

import contextlib
import hashlib
import os
import sys
import warnings

import numpy as np
import torch

import torch_dp_workers as DW
from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.apps import cli as tcli
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.models import longformer as tlf
from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
from reinforcement_learning_in_music_generation_torch.parallel import sharding as psh
from reinforcement_learning_in_music_generation_torch.rl import airl as tairl
from reinforcement_learning_in_music_generation_torch.rl import buffers as tbuf
from reinforcement_learning_in_music_generation_torch.rl import dqn as tdqn
from reinforcement_learning_in_music_generation_torch.rl import env as tenv
from reinforcement_learning_in_music_generation_torch.rl import ppo as tppo
from reinforcement_learning_in_music_generation_torch.train import optim as topt

VOCAB = (8,) * 6
LT_KW = dict(vocab_sizes=VOCAB, emb_sizes=(8,) * 6, d_model=16, n_layer=1, n_head=2,
             d_inner=32, dropout=0.0)
W_KW = dict(vocab_sizes=VOCAB, emb_sizes=(8,) * 6, d_model=16, n_layer=1, n_head=2,
            d_inner=32, max_pos=64, attention_window=8, with_score_head=True,
            with_eval_heads=True, dropout=0.0)
DQN_KW = dict(n_states=10, n_actions=5, episodes=4, buffer_size=16, batch_size=4,
              target_update=2)
AIRL_KW = dict(epochs=1, batch_size=4)
PPO_KW = dict(episodes=4, n_states=10, n_actions=5, ppo_steps=1)
TINY = TC.LinearTransformerConfig(**LT_KW)
TINY_DROP = TC.LinearTransformerConfig(**{**LT_KW, "dropout": 0.5})
ACFG = TC.LinearTransformerConfig(**LT_KW, with_value_head=True)
TINY_W = TC.WindowTransformerConfig(**W_KW)
TW_DROP = TC.WindowTransformerConfig(**{**W_KW, "dropout": 0.5})
DQN_CFG, AIRL_CFG = TC.DQNConfig(**DQN_KW), TC.AIRLConfig(**AIRL_KW)
PPO_CFG = TC.PPOConfig(**PPO_KW)
SEED = 3                # the CLI's generator: one stream on every rank


def t(tree):
    """numpy (trees) -> tensors."""
    if isinstance(tree, dict):
        return {k: t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def whole(mesh, tree):
    return DW.flat(tree if mesh is None else psh.gather_params(mesh, tree))


def _shards(mesh, jparams):
    """This rank's tp shards of JAX weights (rank 0's broadcast); the whole
    weights without a mesh (one process)."""
    p = tw.from_jax_params(jparams, device="cpu")
    return p if mesh is None else psh.shard_params(mesh, p)


def _rows(mesh, batch):
    """This rank's dp rows of a batch (every row without a mesh)."""
    return batch if mesh is None else pm.shard_batch(mesh, batch)


def _dqn_state(mesh, jparams):
    p = _shards(mesh, jparams)
    return tdqn.DQNState(p, topt.tree_map(torch.clone, p), tdqn.make_optimizer(DQN_CFG).init(p), 0)


def dqn_update(mesh, jparams, batch, ebatch, rank_local_mean=False, cfg=TINY):
    """One dqn.update on the whole ``batch`` / ``ebatch`` (the update keeps
    this rank's dp rows): the metrics, the gathered gradients (10 x Adam's
    first moment after one step), the rows the MSE's means read.
    ``rank_local_mean``: control (i), each rank's own MSE mean, summed over
    dp as the gradients are."""
    state = _dqn_state(mesh, jparams)
    keep, seen = tdqn.batch_mean, []
    mean = (lambda x, mesh_=None: torch.mean(x)) if rank_local_mean else keep
    tdqn.batch_mean = lambda x, mesh_=None: seen.append(x.shape[0]) or mean(x, mesh_)
    try:
        state1, m = tdqn.update(state, cfg, DQN_CFG, tdqn.make_optimizer(DQN_CFG), t(batch),
                                t(ebatch), torch.Generator().manual_seed(1), mesh)
    finally:
        tdqn.batch_mean = keep
    return {"metrics": {k: float(v) for k, v in m.items()}, "rows": sorted(set(seen)),
            "grads": {k: 10 * v for k, v in whole(mesh, state1.opt_state.mu).items()}}


def dropout_rows(mesh, jparams, x):
    """The composition's forward at dropout 0.5 on this rank's dp rows of
    ``x`` (each dp index's rows alike), its generator seeded alike on every
    rank: the hidden states and the generator's state after it."""
    gen = torch.Generator().manual_seed(5)
    rows = (0, 1) if mesh is None else pm.row_block(mesh, x.shape[0])
    h = tlt.forward_hidden(_shards(mesh, jparams), TINY_DROP, _rows(mesh, t(x)),
                           deterministic=False, generator=gen, dp_mesh=mesh, rows=rows)
    return {"h": h.numpy(), "generator": gen.get_state().numpy()}


def sampled_update(mesh, jparams, agent_data, expert_data, offset):
    """The CLI's sampling: both update batches drawn from the whole buffers
    with one generator, then split over dp, then the update.  ``offset``:
    control (ii), the generator seeded + 7919 dp index (the pretrain data
    path's rule) on each rank."""
    gen = torch.Generator().manual_seed(SEED + (7919 * mesh.dp_index if offset else 0))
    abuf = tbuf.ReplayBuffer(t(agent_data), DQN_CFG.buffer_size + 1)
    ebuf = tbuf.ReplayBuffer(t(expert_data), DQN_CFG.buffer_size + 1)
    batch = tbuf.buffer_sample(abuf, gen, DQN_CFG.batch_size)
    ebatch = tbuf.buffer_sample(ebuf, gen, DQN_CFG.batch_size)
    ebatch = {k: ebatch[k] for k in ("state", "next_state", "mask_next_state")}
    out = dqn_update(mesh, jparams, {k: v.numpy() for k, v in batch.items()},
                     {k: v.numpy() for k, v in ebatch.items()})
    out["generator"] = gen.get_state().numpy()
    return out


def airl_runs(mesh, jparams, bn, expert, agent, mask, gp_in):
    """disc_epoch on the whole buffers (two minibatches of 4), then from the
    initial state calculate_reward in batches of 4 and the gradient penalty
    with its gradient in every parameter (gathered)."""
    tx = tairl.make_optimizer(AIRL_CFG)
    p = _shards(mesh, jparams)
    st = tairl.AIRLState(p, t(bn), tx.init(p))
    st1, m = tairl.disc_epoch(st, TINY_W, tx, t(expert), t(mask), t(agent), None,
                              AIRL_CFG.batch_size, mesh)
    out = {"metrics": {k: float(v) for k, v in m.items()}, "params": whole(mesh, st1.params),
           "bn": {k: v.numpy() for k, v in st1.bn_state.items()}}
    p = _shards(mesh, jparams)
    st = tairl.AIRLState(p, t(bn), tx.init(p))
    out["reward"] = tairl.calculate_reward(st, TINY_W, t(agent), t(mask), 4, mesh).numpy()
    leaves = [v.detach().requires_grad_(True) for v in topt.tree_leaves(p)]
    st = st._replace(params=topt.tree_unflatten(p, leaves))
    ge, ga, gm, eta = (t(a) for a in gp_in)
    gp = tairl.gradient_penalty(st, TINY_W, ge, ga, gm, eta=eta, mesh=mesh)
    grads = torch.autograd.grad(gp, leaves, allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g for g, v in zip(grads, leaves)]
    out["gp"] = float(gp.detach())
    out["gp_grads"] = whole(mesh, topt.tree_unflatten(p, grads))
    return out


class _OwnCotangent(torch.autograd.Function):
    """The control of the split BatchNorm's all-reduce: the sum over dp
    forward, each rank's own cotangent backward (``reduce_from_tp``'s
    pair)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        y = x.clone()
        torch.distributed.all_reduce(y, group=mesh.group(axis))
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def airl_split(mesh, jparams, bn, expert, agent, mask):
    """disc_epoch with each minibatch of 4 split over dp (``dp_rows``): the
    metrics, the gathered parameters and Adam's first moment (two steps'
    gradients), the BatchNorm stats.  Also: the first minibatch alone
    ("first": its BatchNorm stats read no step's update); the same at
    dropout 0.5 from a
    generator seeded alike on every rank; minibatches of 3, which dp = 2
    does not divide, in the split mode and by default; and the two
    controls, each rank's own BatchNorm statistics ("own_bn") and the
    statistics' all-reduce with an identity backward ("own_cotangent").
    Without a mesh: one process's epoch."""
    def run(batch_size=AIRL_CFG.batch_size, dp_rows=True, cfg=TINY_W, generator=None, n=None):
        tx = tairl.make_optimizer(AIRL_CFG)
        p = _shards(mesh, jparams)
        st = tairl.AIRLState(p, t(bn), tx.init(p))
        st1, m = tairl.disc_epoch(st, cfg, tx, t(expert[:n]), t(mask[:n]), t(agent[:n]),
                                  generator, batch_size, mesh, dp_rows)
        return {"metrics": {k: float(v) for k, v in m.items()}, "params": whole(mesh, st1.params),
                "mu": whole(mesh, st1.opt_state.mu),
                "bn": {k: v.numpy() for k, v in st1.bn_state.items()}}

    out = {"split": run(), "first": run(n=AIRL_CFG.batch_size), "odd": run(3),
           "odd_default": run(3, dp_rows=False),
           "dropout": run(cfg=TW_DROP, generator=torch.Generator().manual_seed(11))}
    if mesh is not None:
        keep_head, keep_sum = tlf._score_head, tlf.sum_over
        tlf._score_head = lambda p_, s_, h, train, dp_mesh=None: keep_head(p_, s_, h, train)
        try:
            out["own_bn"] = run()
        finally:
            tlf._score_head = keep_head
        tlf.sum_over = lambda x, mesh_, axis: _OwnCotangent.apply(x, mesh_, axis)
        try:
            out["own_cotangent"] = run()
        finally:
            tlf.sum_over = keep_sum
    return out


def ppo_runs(mesh, jparams3, song, agent, expert, adv, returns):
    """ppo.rollout_song from the JAX weights (actions, log-probs, values,
    rewards), then one update_policy_step on JAX's transitions with the
    whole rollout's advantages and returns, split over dp: the metrics and
    both trees' gathered gradients."""
    atx, ctx = tppo.make_optimizers(PPO_CFG)
    actor, critic, reward = (_shards(mesh, j) for j in jparams3)
    state = tppo.PPOState(actor, critic, reward, atx.init(actor), ctx.init(critic))
    x, y, m = (t(a) for a in song)
    ra, _ = tppo.rollout_song(state, (ACFG, TINY, TINY_W), x, y, m, episodes=4, n_states=10,
                              n_actions=5, mesh=mesh)
    out = {"rollout": {k: ra[k].numpy() for k in ("action", "log_action", "value", "reward")}}
    a, e, ad, r = _rows(mesh, (t(agent), t(expert), t(adv), t(returns)))
    st1, mt = tppo.update_policy_step(state, (ACFG, TINY, TINY_W), PPO_CFG, (atx, ctx), a, e,
                                      ad, r, mesh)
    out["metrics"] = {k: float(v) for k, v in mt.items()}
    out["rows"] = int(a["state"].shape[0])
    out["actor_grads"] = {k: 10 * v for k, v in whole(mesh, st1.actor_opt.mu).items()}
    out["critic_grads"] = {k: 10 * v for k, v in whole(mesh, st1.critic_opt.mu).items()}
    out["params"] = {"actor": whole(mesh, st1.actor_params),
                     "critic": whole(mesh, st1.critic_params)}
    return out


def fused_tail_guard(mesh, jparams, x, mask):
    """Control (iii) at tp > 1 under RLMG_FFN_BACKEND=pallas-tail: the
    Longformer's guard takes the composition (with its warning), whose
    logits return; the route chosen without the mesh (the fused tail on the
    rank's shards) is recorded as the error it raises."""
    os.environ["RLMG_FFN_BACKEND"] = "pallas-tail"
    try:
        p = _shards(mesh, jparams)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            logits = tlf.token_logits(p, TINY_W, t(x), t(mask), mesh=mesh)
        out = {"logits": [lg.detach().numpy() for lg in logits],
               "warned": any("pallas-tail" in str(w.message) for w in caught)}
        keep = tlf._ffn_backend
        tlf._ffn_backend = lambda n_rows, device, mesh_=None: keep(n_rows, device)
        try:
            tlf.token_logits(p, TINY_W, t(x), t(mask), mesh=mesh)
            out["unguarded"] = "ran"
        except RuntimeError as err:
            out["unguarded"] = f"RuntimeError: {str(err).splitlines()[0]}"
        finally:
            tlf._ffn_backend = keep
    finally:
        del os.environ["RLMG_FFN_BACKEND"]
    return out


def _digest(leaves) -> str:
    h = hashlib.sha1()
    for leaf in leaves:
        h.update(leaf.detach().numpy().tobytes())
    return h.hexdigest()


def cli_rank(argv):
    """One rank of an RL command on a gloo mesh of its --dp x --tp ranks:
    the command's result, with every rank's digest of each whole tree it
    ends with (gathered) and of its generator, in rank order."""
    torch.set_num_threads(1)
    args = tcli.build_parser().parse_args(argv)
    mesh = pm.make_mesh(args.dp, args.tp)
    with open(os.devnull, "w") as null, \
            contextlib.redirect_stdout(sys.stdout if mesh.rank == 0 else null):
        res = args.fn(args, mesh=mesh)
    leaves = {k: [v.get_state()] if isinstance(v, torch.Generator) else
              topt.tree_leaves(psh.gather_params(mesh, v)) for k, v in res.pop("final").items()}
    res["digests"] = {k: pm.all_gather_object(mesh, _digest(v), axis="world")
                      for k, v in leaves.items()}
    return res


def _header(mesh):
    return {"rank": mesh.rank, "dp_index": mesh.dp_index, "tp_index": mesh.tp_index,
            "modules": sorted(m for m in sys.modules if m.split(".")[0] in
                              ("jax", "reinforcement_learning_in_music_generation_tpu",
                               "conftest"))}


def run_mesh(mesh, inp):
    """Every scenario of the test file on this rank of ``mesh``."""
    out = _header(mesh)
    out["dqn"] = {k: dqn_update(mesh, inp["lt"], *inp["batches"][k]) for k in inp["batches"]}
    if mesh.dp > 1:
        out["dropout"] = {"h": dropout_rows(mesh, inp["lt"], inp["twins"]),
                          "dqn": dqn_update(mesh, inp["lt"], *inp["batches"]["even"],
                                            cfg=TINY_DROP)}
        out["control_i"] = dqn_update(mesh, inp["lt"], *inp["batches"]["even"],
                                      rank_local_mean=True)
        out["airl_split"] = airl_split(mesh, inp["lw"], inp["bn"], *inp["disc"])
        out["sampled"] = {flag: sampled_update(mesh, inp["lt"], *inp["buffers"], flag)
                          for flag in (False, True)}
    if mesh.tp > 1:
        x, y, m = (t(a) for a in inp["song"])
        ra, _ = tenv.dqn_rollout_song(_shards(mesh, inp["lt"]), TINY, x, y, m, episodes=4,
                                      n_states=10, n_actions=5, mesh=mesh)
        out["dqn_rollout"] = {k: ra[k].numpy() for k in ("state", "action", "next_state")}
        out["control_iii"] = fused_tail_guard(mesh, inp["lw"], inp["disc"][0], inp["disc"][2])
    out["airl"] = airl_runs(mesh, inp["lw"], inp["bn"], *inp["disc"], inp["gp"])
    out["ppo"] = ppo_runs(mesh, inp["ppo_params"], inp["song"], *inp["ppo_update"])
    return out


def ranks(shapes, inp):
    """The meshes ``shapes`` ((dp, tp) pairs, each of this group's size),
    one after another on this rank: {shape: run_mesh's readings}."""
    torch.set_num_threads(1)
    out = {}
    for dp, tp in shapes:
        mesh = pm.make_mesh(dp, tp)
        out[f"{dp}x{tp}"] = run_mesh(mesh, inp)
    return out

