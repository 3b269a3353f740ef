"""The port's RL commands on the (dp, tp) mesh against the JAX package's
``make_mesh(dp, tp)`` and against one process, on the CPU.

The port's ranks run in gloo process groups that ``parallel.launch``
spawns, one launch a group size: two ranks run dp = 2 x tp = 1 and then
dp = 1 x tp = 2, four ranks dp = 2 x tp = 2, each rank a fresh interpreter
running tests/torch_rl_workers.py, which imports no jax; trees of tp shards
come back whole.  The JAX side runs the same functions on the suite's 8
virtual CPU devices as one GSPMD program, as JAX's CLI does
(``apps/cli.py:299-351``, ``:452-484``): the weights Megatron-sharded
(``shard_params``), the DQN and PPO update batches split over dp
(``shard_batch``: a batch dp does not divide stays whole), the AIRL
buffers whole, and for the port's split discriminator epoch
(``disc_epoch(dp_rows=True)``) split over dp, JAX's library
configuration.  Configs: JAX tests/test_rl.py's TINY / TINY_W and its DQN
config at dropout 0; inputs from JAX rollouts and numpy seeds.

Tolerances: DQN losses rtol 1e-5, gathered gradients (10 x Adam's first
moment after one step) rtol 1e-4 / atol 1e-6; the AIRL epoch's and the PPO
step's losses rtol 2e-4 (JAX's own, tests/test_rl.py:236-299), the
rewards rtol 1e-4 / atol 1e-5, the gradient penalty rtol 1e-4; rollout
actions equal.  At dropout 0.5 the dp ranks' dropout masks are one
process's draw at their rows (hidden states rtol 1e-5 / atol 1e-6).
The split discriminator epoch (``_split_failures``): losses rtol 2e-4,
parameters within 2e-4 of their leaf's magnitude, Adam's first moment
(two steps' gradients) within 1e-5 of its leaf's magnitude (JAX's and the
port's arithmetic differ by up to 4.2e-6 there), the
BatchNorm variance rtol 2e-4, and its mean after the first minibatch; the
two leaves whose gradient is 0 in exact arithmetic (the key bias, the
score's first bias under train-mode BatchNorm) hold rounding noise, which
Adam's step amplifies, so their parameters (and the BatchNorm mean, which
reads the second) are left out and their moments must stay below 1e-6 of
the largest.  Five controls, each a fault the gates must catch, fall
outside them: (i) each rank's own MSE mean, summed over dp; (ii) the
update batches drawn from a generator offset by the dp index; (iii) the
Longformer's fused tail chosen without the mesh under
RLMG_FFN_BACKEND=pallas-tail at tp = 2; (iv) the split epoch's BatchNorm
on each rank's own rows; (v) its statistics' all-reduce with an identity
backward.
"""

import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rl_workers as W
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.models import longformer as tlf
from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
from reinforcement_learning_in_music_generation_torch.rl import buffers as tbuf
from reinforcement_learning_in_music_generation_torch.rl import ppo as tppo
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import dataset
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as jlt
from reinforcement_learning_in_music_generation_tpu.parallel import make_mesh, shard_batch
from reinforcement_learning_in_music_generation_tpu.parallel import sharding as jsh
from reinforcement_learning_in_music_generation_tpu.rl import airl as jairl
from reinforcement_learning_in_music_generation_tpu.rl import dqn as jdqn
from reinforcement_learning_in_music_generation_tpu.rl import env as jenv
from reinforcement_learning_in_music_generation_tpu.rl import ppo as jppo
from reinforcement_learning_in_music_generation_tpu.utils import checkpoint as jck

TINY, ACFG = C.LinearTransformerConfig(**W.LT_KW), C.LinearTransformerConfig(
    **W.LT_KW, with_value_head=True)
TINY_W = C.WindowTransformerConfig(**W.W_KW)
DQN_CFG, AIRL_CFG, PPO_CFG = (C.DQNConfig(**W.DQN_KW), C.AIRLConfig(**W.AIRL_KW),
                              C.PPOConfig(**W.PPO_KW))
MESHES = [(2, 1), (1, 2), (2, 2)]
DP_MESHES = [m for m in MESHES if m[0] > 1]
TP_MESHES = [m for m in MESHES if m[1] > 1]
LAUNCH_S = 300
ROLL = dict(episodes=4, n_states=10, n_actions=5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {"".join(f"/{k.key}" for k in kp): np.asarray(v) for kp, v in leaves}


def _jax_adam_mu(opt_state):
    (found,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(
        x, "mu")) if hasattr(s, "mu")]
    return found.mu


def _grads_close(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(ours[k], r, rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def inputs():
    """The file's inputs as numpy: weights drawn from seeds (the port's
    ``init_params``: the JAX tree's paths, shapes and distributions), a JAX DQN
    rollout's batches (4 rows, and 5, which dp = 2 does not divide),
    buffers of 16 rows, discriminator minibatches, a PPO rollout's
    transitions with the whole rollout's returns and advantages."""
    x, y, mask = dataset.synthetic_cp_dataset(1, 128, n_class=W.VOCAB, seed=0)
    song = (x[0], y[0], mask[0])
    lt = tw.to_numpy(tlt.init_params(W.TINY, seed=0, device="cpu"))
    lw = tw.to_numpy(tlf.init_params(W.TINY_W, seed=1, device="cpu"))
    a, e = jenv.dqn_rollout_song(jax.tree_util.tree_map(jnp.asarray, lt), TINY,
                                 *(jnp.asarray(v) for v in song), **ROLL)
    batch = {k: np.array(v) for k, v in a.items()}
    batch["reward"] = np.linspace(0.1, 0.9, 4, dtype=np.float32)[:, None]
    batch["done"] = np.array([[0], [1], [0], [0]], np.int32)
    ebatch = {k: np.array(e[k]) for k in ("state", "next_state", "mask_next_state")}
    ebatch["mask_next_state"][0, 7:] = 0.0
    odd = tuple({k: np.concatenate([v, v[2:3]]) for k, v in b.items()} for b in (batch, ebatch))
    rng = np.random.default_rng(3)
    agent_buf = {k: np.concatenate([v] * 4) for k, v in batch.items()}
    agent_buf["reward"] = rng.random((16, 1)).astype(np.float32)
    expert_buf = {k: np.concatenate([np.asarray(v)] * 4) for k, v in e.items()}
    expert = rng.integers(0, 8, (8, 10, 6)).astype(np.int32)
    agent = rng.integers(0, 8, (8, 10, 6)).astype(np.int32)
    dmask = np.ones((8, 10), np.float32)
    dmask[1, 6:] = 0.0
    dmask[-1, 3:] = 0.0
    bn = {"bn_mean": np.linspace(-0.1, 0.1, 128).astype(np.float32),
          "bn_var": np.linspace(0.5, 1.5, 128).astype(np.float32)}
    eta = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (4, 1, 1)))
    ppo_params = tuple(tw.to_numpy(p) for p in tppo.init_state(
        W.ACFG, W.TINY, W.TINY_W, W.PPO_CFG, seed=2, device="cpu")[:3])
    atx, ctx = jppo.make_optimizers(PPO_CFG)
    jp = tuple(jax.tree_util.tree_map(jnp.asarray, p) for p in ppo_params)
    st = jppo.PPOState(*jp, atx.init(jp[0]), ctx.init(jp[1]))
    pa, pe = jppo.rollout_song(st, (ACFG, TINY, TINY_W), *(jnp.asarray(v) for v in song), **ROLL)
    returns = jppo.calculate_returns(pa["reward"][:, 0], PPO_CFG.discount)
    adv = jppo.calculate_advantages(returns, pa["value"])
    return {"lt": lt, "lw": lw, "song": song, "batches": {"even": (batch, ebatch), "odd": odd},
            "twins": np.concatenate([batch["state"][:2]] * 2),
            "buffers": (agent_buf, expert_buf), "disc": (expert, agent, dmask), "bn": bn,
            "gp": (expert[:4], agent[:4], dmask[:4], eta),
            "ppo_params": ppo_params,
            "ppo_update": (_np(pa), _np(pe), np.asarray(adv), np.asarray(returns))}


CLI_DQN = ["dqn-train", "--device", "cpu", "--synthetic", "--synthetic-songs", "2", "--seq-len",
           "128", "--layers", "1", "--songs", "3", "--episodes", "4", "--buffer-size", "8",
           "--batch-size", "4", "--n-states", "16", "--n-actions", "8", "--max-updates", "1",
           "--ckpt-epoch-gate", "0", "--disc-epochs", "1", "--dp", "2", "--tp", "2"]
CLI_PPO = ["ppo-train", "--device", "cpu", "--synthetic", "--synthetic-songs", "2", "--seq-len",
           "40", "--layers", "1", "--songs", "1", "--episodes", "4", "--n-states", "10",
           "--n-actions", "5", "--ppo-steps", "1", "--dp", "2", "--tp", "2"]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("rl_mesh"))


@pytest.fixture(scope="module")
def launched(inputs, work):
    """The file's launches and JAX's three meshes, started together in the
    background: two ranks (dp = 2 x 1, then 1 x 2), four ranks (2 x 2), and
    ``cli dqn-train`` / ``cli ppo-train`` with --dp 2 --tp 2 (four ranks
    each), one intra-op thread a rank; JAX's references in threads of
    this process."""
    d = lambda *p: os.path.join(work, *p)
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(4 + len(MESHES)) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")
        for dp, tp in MESHES:
            _JAX[dp, tp] = pool.submit(_jax_mesh, inputs, dp, tp)
        yield {"two": pool.submit(pm.launch, W.ranks, 2, ([(2, 1), (1, 2)], inputs),
                                  timeout_s=LAUNCH_S),
               "four": pool.submit(pm.launch, W.ranks, 4, ([(2, 2)], inputs),
                                   timeout_s=LAUNCH_S),
               "cli_dqn": pool.submit(pm.launch, W.cli_rank, 4, (CLI_DQN + [
                   "--ckpt-dir", d("dqn", "c"), "--exp-dir", d("dqn", "e")],),
                   timeout_s=LAUNCH_S),
               "cli_ppo": pool.submit(pm.launch, W.cli_rank, 4, (CLI_PPO + [
                   "--ckpt-dir", d("ppo", "c"), "--exp-dir", d("ppo", "e")],),
                   timeout_s=LAUNCH_S)}


def _ranks(launched, dp, tp):
    out = [r[f"{dp}x{tp}"] for r in launched["two" if dp * tp == 2 else "four"].result()]
    assert [(r["rank"], r["dp_index"], r["tp_index"]) for r in out] == \
        [(i, i // tp, i % tp) for i in range(dp * tp)]
    return out


_JAX = {}


def _jax(inputs, dp, tp):
    """JAX's readings on make_mesh(dp, tp), computed in the background
    (``launched``) or here, once for the file."""
    if (dp, tp) not in _JAX:
        _JAX[dp, tp] = _jax_mesh(inputs, dp, tp)
    ref = _JAX[dp, tp]
    return ref.result() if hasattr(ref, "result") else ref


def _jax_mesh(inputs, dp, tp):
    mesh = make_mesh(dp, tp)
    shard = lambda tree: jsh.shard_params(mesh, jax.tree_util.tree_map(jnp.asarray, tree))
    out = {"dqn": {}}
    tx = jdqn.make_optimizer(DQN_CFG)
    for name, (batch, ebatch) in inputs["batches"].items():
        if name == "odd" and dp == 1:
            continue
        p = shard(inputs["lt"])
        st = jdqn.DQNState(p, shard(inputs["lt"]), tx.init(p), 0)
        st1, m = jdqn.update(st, TINY, DQN_CFG, tx, shard_batch(mesh, batch),
                             shard_batch(mesh, ebatch), jax.random.PRNGKey(1))
        out["dqn"][name] = {"metrics": {k: float(v) for k, v in m.items()},
                            "grads": {k: 10 * v for k, v in _flat(_jax_adam_mu(
                                st1.opt_state)).items()}}
    # the CLI's sampling: the rows one generator seeded SEED draws
    gen = torch.Generator().manual_seed(W.SEED)
    rows = [tbuf.buffer_sample(tbuf.ReplayBuffer({"i": torch.arange(16)}, 17), gen,
                               DQN_CFG.batch_size)["i"].numpy() for _ in range(2)]
    abuf, ebuf = inputs["buffers"]
    batch = {k: v[rows[0]] for k, v in abuf.items()}
    ebatch = {k: ebuf[k][rows[1]] for k in ("state", "next_state", "mask_next_state")}
    p = shard(inputs["lt"])
    _, m = jdqn.update(jdqn.DQNState(p, shard(inputs["lt"]), tx.init(p), 0), TINY, DQN_CFG, tx,
                       shard_batch(mesh, batch), shard_batch(mesh, ebatch),
                       jax.random.PRNGKey(1))
    out["sampled"] = {k: float(v) for k, v in m.items()}
    # AIRL: the weights sharded, the buffers whole
    expert, agent, dmask = inputs["disc"]
    rtx = jairl.make_optimizer(AIRL_CFG)
    p = shard(inputs["lw"])
    st = jairl.AIRLState(p, inputs["bn"], rtx.init(p))
    _, m = jairl.disc_epoch(st, TINY_W, rtx, expert, dmask, agent, jax.random.PRNGKey(3),
                            AIRL_CFG.batch_size)
    out["airl"] = {k: float(v) for k, v in m.items()}
    out["reward"] = np.asarray(jairl.calculate_reward(st, TINY_W, agent, dmask, 4))
    if dp > 1:
        # JAX's library configuration: the buffers split over dp
        p = shard(inputs["lw"])
        st1, m = jairl.disc_epoch(jairl.AIRLState(p, inputs["bn"], rtx.init(p)), TINY_W, rtx,
                                  *shard_batch(mesh, (expert, dmask, agent)),
                                  jax.random.PRNGKey(3), AIRL_CFG.batch_size)
        out["airl_split"] = {"metrics": {k: float(v) for k, v in m.items()},
                             "params": _flat(st1.params), "mu": _flat(_jax_adam_mu(st1.opt_state)),
                             "bn": {k: np.asarray(v) for k, v in st1.bn_state.items()}}
    # PPO: the update on the transitions split over dp
    atx, ctx = jppo.make_optimizers(PPO_CFG)
    actor, critic, reward = (shard(p) for p in inputs["ppo_params"])
    pst = jppo.PPOState(actor, critic, reward, atx.init(actor), ctx.init(critic))
    a, e, adv, ret = inputs["ppo_update"]
    _, m = jppo.update_policy_step(pst, (ACFG, TINY, TINY_W), PPO_CFG, (atx, ctx),
                                   *shard_batch(mesh, (a, e, adv, ret)))
    out["ppo"] = {k: float(v) for k, v in m.items()}
    if tp > 1:
        # under tp: the penalty and both rollouts on the sharded weights
        ge, ga, gm, _ = inputs["gp"]
        out["gp"] = float(jairl.gradient_penalty(st, TINY_W, ge, ga, gm, jax.random.PRNGKey(7)))
        song = tuple(jnp.asarray(v) for v in inputs["song"])
        ra, _ = jppo.rollout_song(pst, (ACFG, TINY, TINY_W), *song, **ROLL)
        out["ppo_rollout"] = _np(ra)
        da, _ = jenv.dqn_rollout_song(shard(inputs["lt"]), TINY, *song, **ROLL)
        out["dqn_rollout"] = _np(da)
    return out


@pytest.fixture(scope="module")
def one(inputs):
    """The port in one process: the DQN update on both batches, the PPO
    step, the gradient penalty's gradients and the Longformer's logits."""
    out = {"dqn": {}}
    for name, (batch, ebatch) in inputs["batches"].items():
        out["dqn"][name] = W.dqn_update(None, inputs["lt"], batch, ebatch)
    out["dropout"] = {"h": W.dropout_rows(None, inputs["lt"], inputs["twins"]),
                      "dqn": W.dqn_update(None, inputs["lt"], *inputs["batches"]["even"],
                                          cfg=W.TINY_DROP)}
    out["airl"] = W.airl_runs(None, inputs["lw"], inputs["bn"], *inputs["disc"], inputs["gp"])
    out["airl_split"] = W.airl_split(None, inputs["lw"], inputs["bn"], *inputs["disc"])
    out["ppo"] = W.ppo_runs(None, inputs["ppo_params"], inputs["song"], *inputs["ppo_update"])
    expert, _, dmask = inputs["disc"]
    out["logits"] = [lg.detach().numpy() for lg in tlf.token_logits(
        tw.from_jax_params(inputs["lw"], device="cpu"), W.TINY_W, W.t(expert), W.t(dmask))]
    return out


@pytest.mark.parametrize("dp,tp,batch", [(2, 1, "even"), (2, 1, "odd"), (1, 2, "even"),
                                         (2, 2, "even"), (2, 2, "odd")])
def test_dqn_update_matches_jax_mesh_and_one_process(launched, inputs, one, dp, tp, batch):
    """One dqn.update with the batches split over dp (4 rows), or whole on
    every rank where dp does not divide them (5 rows): mse, ce and total
    equal JAX's on make_mesh(dp, tp) and one process's, and so do the
    gathered gradients; every rank holds the global metrics."""
    ref, solo = _jax(inputs, dp, tp)["dqn"][batch], one["dqn"][batch]
    n = 4 if batch == "even" else 5
    for r in _ranks(launched, dp, tp):
        got = r["dqn"][batch]
        assert got["rows"] == [n // dp if n % dp == 0 else n]
        for k in ("mse", "ce", "total"):
            np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(got["metrics"][k], solo["metrics"][k], rtol=1e-5,
                                       err_msg=k)
        _grads_close(got["grads"], ref["grads"])
        _grads_close(got["grads"], solo["grads"])


@pytest.mark.parametrize("dp,tp", DP_MESHES)
def test_dropout_masks_are_one_process_draw_at_the_ranks_rows(launched, one, dp, tp):
    """At dropout 0.5, the composition's masks on each dp rank are the
    whole batch's draw at its rows: the hidden states of twin rows (rows
    0-1 equal rows 2-3) equal one process's at the rank's rows, so the two
    dp indices' masks differ; the generator ends where one process's does;
    and dqn.update's CE with dropout equals one process's."""
    h_one, upd = one["dropout"]["h"]["h"], one["dropout"]["dqn"]
    assert np.abs(h_one[:2] - h_one[2:]).max() > 1e-2
    assert abs(upd["metrics"]["ce"] - one["dqn"]["even"]["metrics"]["ce"]) > 1e-3
    for r in _ranks(launched, dp, tp):
        got = r["dropout"]
        i = r["dp_index"]
        np.testing.assert_allclose(got["h"]["h"], h_one[2 * i:2 * i + 2], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got["h"]["generator"], one["dropout"]["h"]["generator"])
        for k in ("mse", "ce", "total"):
            np.testing.assert_allclose(got["dqn"]["metrics"][k], upd["metrics"][k], rtol=1e-5,
                                       err_msg=k)
        _grads_close(got["dqn"]["grads"], upd["grads"])


@pytest.mark.parametrize("dp,tp", MESHES)
def test_disc_epoch_on_whole_buffers_matches_jax(launched, inputs, dp, tp):
    """disc_epoch over the whole buffers on every dp rank (two minibatches):
    the epoch's losses equal JAX's on make_mesh(dp, tp) to 2e-4; every rank
    ends with the same parameters and BatchNorm stats, bit for bit."""
    ref = _jax(inputs, dp, tp)["airl"]
    ranks = _ranks(launched, dp, tp)
    for r in ranks:
        for k, v in ref.items():
            np.testing.assert_allclose(r["airl"]["metrics"][k], v, rtol=2e-4, err_msg=k)
        for k, v in ranks[0]["airl"]["params"].items():
            np.testing.assert_array_equal(r["airl"]["params"][k], v, err_msg=k)
        for k, v in ranks[0]["airl"]["bn"].items():
            np.testing.assert_array_equal(r["airl"]["bn"][k], v, err_msg=k)


# leaves whose gradient is 0 in exact arithmetic: the softmax removes the
# key bias, the train-mode BatchNorm the score's first bias
ZERO_GRADS = ("/layers/wk/b", "/score/l1/b")


def _split_failures(got, ref, first=None, ref_first=None):
    """The split discriminator epoch's gates (the module's docstring): the
    failures, each a line."""
    fails = []
    for k, v in ref["metrics"].items():
        if not abs(got["metrics"][k] - v) <= 2e-4 * abs(v):
            fails.append(f"loss {k}: {got['metrics'][k]} vs {v}")
    for k, v in ref["params"].items():
        if k not in ZERO_GRADS and not np.abs(got["params"][k] - v).max() <= 2e-4 * np.abs(v).max():
            fails.append(f"parameters {k}")
    top = max(float(np.abs(v).max()) for v in ref["mu"].values())
    for k, v in ref["mu"].items():
        if k in ZERO_GRADS:
            if not np.abs(got["mu"][k]).max() <= 1e-6 * top:
                fails.append(f"first moment {k}: {np.abs(got['mu'][k]).max():.3e} not noise")
        elif not np.abs(got["mu"][k] - v).max() <= 1e-5 * np.abs(v).max():
            fails.append(f"first moment {k}")
    if not np.allclose(got["bn"]["bn_var"], ref["bn"]["bn_var"], rtol=2e-4, atol=0):
        fails.append("BatchNorm variance")
    if first is not None:
        for k, v in ref_first["bn"].items():
            if not np.allclose(first["bn"][k], v, rtol=2e-4, atol=1e-7):
                fails.append(f"first minibatch's BatchNorm {k}")
    return fails


@pytest.mark.parametrize("dp,tp", DP_MESHES)
def test_disc_epoch_split_over_dp_matches_one_process_and_jax(launched, inputs, one, dp, tp):
    """disc_epoch(dp_rows=True): each minibatch of 4 split over dp, the
    BatchNorm statistics, BCE and CE means global.  Its losses, parameters,
    gradients and BatchNorm state hold one process's epoch and JAX's on
    make_mesh(dp, tp) with the buffers split over dp (``_split_failures``),
    also at dropout 0.5 (one process's masks at the rank's rows); every
    rank ends with the same parameters and BatchNorm state, bit for bit,
    without the broadcast of the default mode."""
    solo, ref = one["airl_split"], _jax(inputs, dp, tp)["airl_split"]
    ranks = _ranks(launched, dp, tp)
    for r in ranks:
        got = r["airl_split"]
        assert _split_failures(got["split"], solo["split"], got["first"], solo["first"]) == []
        assert _split_failures(got["split"], ref) == []
        assert _split_failures(got["dropout"], solo["dropout"]) == []
        assert abs(solo["dropout"]["metrics"]["global_loss"]
                   - solo["split"]["metrics"]["global_loss"]) > 1e-3
        for run in ("split", "dropout"):
            for part in ("params", "bn"):
                for k, v in ranks[0]["airl_split"][run][part].items():
                    np.testing.assert_array_equal(got[run][part][k], v, err_msg=k)


@pytest.mark.parametrize("dp,tp", DP_MESHES)
def test_disc_epoch_split_controls_fall_outside_the_gate(launched, one, dp, tp):
    """Controls (iv), the BatchNorm on each rank's own rows, and (v), the
    statistics' all-reduce with ``reduce_from_tp``'s identity backward,
    fail the split epoch's gates: (iv) at the losses, (v) at the
    gradients."""
    solo = one["airl_split"]
    for r in _ranks(launched, dp, tp):
        own_bn = _split_failures(r["airl_split"]["own_bn"], solo["split"])
        own_cot = _split_failures(r["airl_split"]["own_cotangent"], solo["split"])
        assert any(f.startswith("loss") for f in own_bn), own_bn
        assert any(f.startswith("first moment") for f in own_cot), own_cot


@pytest.mark.parametrize("dp,tp", DP_MESHES)
def test_disc_epoch_split_minibatch_dp_does_not_divide_runs_whole(launched, one, dp, tp):
    """Minibatches of 3, which dp = 2 does not divide: the split mode runs
    each whole on every rank, as the default mode does, bit for bit, and
    its losses are one process's."""
    for r in _ranks(launched, dp, tp):
        got, default = r["airl_split"]["odd"], r["airl_split"]["odd_default"]
        assert got["metrics"] == default["metrics"]
        for part in ("params", "mu", "bn"):
            for k, v in default[part].items():
                np.testing.assert_array_equal(got[part][k], v, err_msg=k)
        for k, v in one["airl_split"]["odd"]["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=2e-4, err_msg=k)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_calculate_reward_matches_jax(launched, inputs, dp, tp):
    """The buffer's re-scoring in batches of 4 (a ragged tail of 0 over 8
    rows, train-mode BatchNorm) on the sharded discriminator."""
    ref = _jax(inputs, dp, tp)["reward"]
    for r in _ranks(launched, dp, tp):
        np.testing.assert_allclose(r["airl"]["reward"], ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dp,tp", TP_MESHES)
def test_gradient_penalty_under_tp(launched, inputs, one, dp, tp):
    """The WGAN penalty on the gathered embeddings: its value equals JAX's
    on make_mesh(dp, tp) and one process's; its gradient in every
    parameter (a second derivative through the tp collectives) equals one
    process's."""
    ref = _jax(inputs, dp, tp)["gp"]
    for r in _ranks(launched, dp, tp):
        np.testing.assert_allclose(r["airl"]["gp"], ref, rtol=1e-4)
        np.testing.assert_allclose(r["airl"]["gp"], one["airl"]["gp"], rtol=1e-5)
        _grads_close(r["airl"]["gp_grads"], one["airl"]["gp_grads"])


@pytest.mark.parametrize("dp,tp", MESHES)
def test_ppo_update_policy_step_matches_jax(launched, inputs, one, dp, tp):
    """One update_policy_step on the rollout's transitions, the whole
    rollout's advantages and returns split over dp: the actor and value
    losses equal JAX's on make_mesh(dp, tp) to 2e-4, the gathered
    gradients one process's."""
    ref = _jax(inputs, dp, tp)["ppo"]
    for r in _ranks(launched, dp, tp):
        assert r["ppo"]["rows"] == W.PPO_CFG.episodes // dp
        for k in ("actor_loss", "value_loss", "policy_loss"):
            np.testing.assert_allclose(r["ppo"]["metrics"][k], ref[k], rtol=2e-4, err_msg=k)
        _grads_close(r["ppo"]["actor_grads"], one["ppo"]["actor_grads"])
        _grads_close(r["ppo"]["critic_grads"], one["ppo"]["critic_grads"])


@pytest.mark.parametrize("dp,tp", TP_MESHES)
def test_rollouts_under_tp_match_jax(launched, inputs, dp, tp):
    """ppo.rollout_song and dqn_rollout_song on every rank, eager under tp:
    the actions (and the DQN states) equal JAX's on make_mesh(dp, tp), the
    rewards within 1e-4, the log-probs and values as close."""
    ref = _jax(inputs, dp, tp)
    for r in _ranks(launched, dp, tp):
        got, want = r["ppo"]["rollout"], ref["ppo_rollout"]
        np.testing.assert_array_equal(got["action"], want["action"])
        for k in ("reward", "value", "log_action"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
        for k, v in r["dqn_rollout"].items():
            np.testing.assert_array_equal(v, ref["dqn_rollout"][k], err_msg=k)


@pytest.mark.parametrize("dp,tp", DP_MESHES)
def test_control_rank_local_mean_falls_outside_the_gate(launched, inputs, dp, tp):
    """Control (i): each rank's own MSE mean, summed over dp with the
    gradients, is dp times JAX's MSE; the gradients miss too."""
    ref = _jax(inputs, dp, tp)["dqn"]["even"]
    for r in _ranks(launched, dp, tp):
        c = r["control_i"]
        np.testing.assert_allclose(c["metrics"]["mse"], dp * ref["metrics"]["mse"], rtol=1e-5)
        with pytest.raises(AssertionError):
            _grads_close(c["grads"], ref["grads"])


@pytest.mark.parametrize("dp,tp", DP_MESHES)
def test_one_generator_stream_and_control_dp_offset(launched, inputs, dp, tp):
    """The CLI's update batches from one generator seeded alike on every
    rank: the update equals JAX's on the rows that stream draws, and the
    generator ends in one state on every rank.  Control (ii): seeded + 7919
    dp index, the dp ranks draw other rows and the update misses JAX's."""
    ref = _jax(inputs, dp, tp)["sampled"]
    ranks = _ranks(launched, dp, tp)
    for r in ranks:
        good, bad = r["sampled"][False], r["sampled"][True]
        for k, v in ref.items():
            np.testing.assert_allclose(good["metrics"][k], v, rtol=1e-5, err_msg=k)
        np.testing.assert_array_equal(good["generator"], ranks[0]["sampled"][False]["generator"])
        assert any(abs(bad["metrics"][k] - v) > 1e-3 * abs(v) for k, v in ref.items())
    states = {r["sampled"][True]["generator"].tobytes() for r in ranks}
    assert len(states) == dp


@pytest.mark.parametrize("dp,tp", TP_MESHES)
def test_longformer_fused_tail_guard_and_control(launched, inputs, one, dp, tp):
    """Under RLMG_FFN_BACKEND=pallas-tail at tp > 1 the Longformer takes the
    composition with the guard's warning, and its logits equal one
    process's.  Control (iii): the route chosen without the mesh sends the
    rank's shards to the fused tail, which cannot take them."""
    for r in _ranks(launched, dp, tp):
        c = r["control_iii"]
        assert c["warned"]
        for got, want in zip(c["logits"], one["logits"]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert c["unguarded"].startswith("RuntimeError")


def test_ranks_import_no_jax(launched):
    for dp, tp in MESHES:
        assert all(r["modules"] == [] for r in _ranks(launched, dp, tp))


def _ckpt(path, cfg):
    """JAX's load_checkpoint with the whole tree's shapes as the template."""
    template = jax.eval_shape(lambda: jlt.init_params(jax.random.PRNGKey(0), cfg))
    return jck.load_checkpoint(path, params_template=template)


def test_cli_dqn_train_dp2_tp2_cpu(launched, work):
    """cli dqn-train --dp 2 --tp 2 --device cpu: one update with finite
    losses; every rank ends with the same eval and discriminator trees and
    generator state; dqn_best.ckpt and dqn_last.ckpt hold the whole tree
    (JAX's load_checkpoint reads them at the one-process shapes), and
    agent_info.pickle the whole sampled batch's rewards."""
    res = launched["cli_dqn"].result()[0]
    assert res["updates"] == 1
    assert all(np.isfinite(v) for v in res["metrics"][0].values())
    for k in ("eval", "disc", "generator"):
        assert len(set(res["digests"][k])) == 1, k
    for name in ("dqn_best.ckpt", "dqn_last.ckpt"):
        ck = _ckpt(os.path.join(work, "dqn", "c", name), C.agent_config(n_layer=1))
        assert ck["params"]["layers"]["ffn1"]["w"].shape == (1, 512, 2048)
    with open(os.path.join(work, "dqn", "c", "agent_info.pickle"), "rb") as f:
        record = pickle.load(f)
    assert record["Agent"].shape == (4, 1) and len(record["first_loss"]) == 1


def test_cli_ppo_train_dp2_tp2_cpu(launched, work):
    """cli ppo-train --dp 2 --tp 2 --device cpu: finite losses, the three
    trees equal on every rank, ppo_best.ckpt the whole actor."""
    res = launched["cli_ppo"].result()[0]
    assert res["songs"] == 1 and all(np.isfinite(v) for v in res["metrics"][0].values())
    for k in ("actor", "critic", "reward"):
        assert len(set(res["digests"][k])) == 1, k
    ck = _ckpt(os.path.join(work, "ppo", "c", "ppo_best.ckpt"), C.actor_config(n_layer=1))
    assert ck["params"]["heads"]["pitch"]["w"].shape == (512, 89)
