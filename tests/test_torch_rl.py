"""The port's RL layer (replay buffers, DQN rollout and update, AIRL
discriminator step, reward scoring, gradient penalty) against the JAX
package's ``rl``, on the CPU.

The configs are tests/test_rl.py's (TINY, TINY_W, DQN_CFG) with two layers,
so the layer loop runs, and dropout 0 wherever two results are compared.
Weights come from the JAX ``init_params`` through ``from_jax_params``,
songs from the JAX ``synthetic_cp_dataset`` (numpy, seeded).  Integer
transitions agree exactly; losses to 1e-5 relative; parameters after an
optimizer step per leaf at tests/test_torch_pretrain.py's tolerances."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.rl import airl as tairl
from reinforcement_learning_in_music_generation_torch.rl import buffers as tbuf
from reinforcement_learning_in_music_generation_torch.rl import dqn as tdqn
from reinforcement_learning_in_music_generation_torch.rl import env as tenv
from reinforcement_learning_in_music_generation_torch.rl import episode_graph as teg
from reinforcement_learning_in_music_generation_torch.train import optim as topt
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import dataset
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as jlt
from reinforcement_learning_in_music_generation_tpu.models import longformer as jlf
from reinforcement_learning_in_music_generation_tpu.rl import airl as jairl
from reinforcement_learning_in_music_generation_tpu.rl import buffers as jbuf
from reinforcement_learning_in_music_generation_tpu.rl import dqn as jdqn
from reinforcement_learning_in_music_generation_tpu.rl import env as jenv

VOCAB = (8, 8, 8, 8, 8, 8)
LT_KW = dict(vocab_sizes=VOCAB, emb_sizes=(8,) * 6, d_model=16, n_layer=2, n_head=2,
             d_inner=32, dropout=0.0)
W_KW = dict(vocab_sizes=VOCAB, emb_sizes=(8,) * 6, d_model=16, n_layer=2, n_head=2,
            d_inner=32, max_pos=64, attention_window=8, with_score_head=True,
            with_eval_heads=True, dropout=0.0)
TINY, TTINY = C.LinearTransformerConfig(**LT_KW), TC.LinearTransformerConfig(**LT_KW)
TINY_W, TTINY_W = C.WindowTransformerConfig(**W_KW), TC.WindowTransformerConfig(**W_KW)
DQN_KW = dict(n_states=10, n_actions=5, episodes=4, buffer_size=16, batch_size=4,
              target_update=2)
DQN_CFG, TDQN_CFG = C.DQNConfig(**DQN_KW), TC.DQNConfig(**DQN_KW)


def _song(seed=0, length=128):
    x, y, mask = dataset.synthetic_cp_dataset(1, length, n_class=VOCAB, seed=seed)
    return x[0], y[0], mask[0]


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach().numpy() if torch.is_tensor(tree) else tree)}


def _assert_params_close(tp, jp, floor=0.0):
    """Every leaf within 1e-5 of its own magnitude (tests/test_torch_pretrain.py),
    with an absolute ``floor`` where the caller names one."""
    ours, ref = _flat(tp), _flat(jp)
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-6)
        np.testing.assert_allclose(ours[k], r, rtol=1e-5, atol=max(1e-5 * scale, floor),
                                   err_msg=k)


@pytest.fixture(scope="module")
def lt_params():
    return jax.tree_util.tree_map(np.asarray, jlt.init_params(jax.random.PRNGKey(0), TINY))


@pytest.fixture(scope="module")
def lf_params():
    return jax.tree_util.tree_map(np.asarray, jlf.init_params(jax.random.PRNGKey(1), TINY_W))


# -- buffers ------------------------------------------------------------------

def test_buffer_ring_semantics_match_jax():
    specs_j, specs_t = jbuf.agent_field_specs(3, 2, 6), tbuf.agent_field_specs(3, 2, 6)
    jb, tb = jbuf.buffer_init(4, specs_j), tbuf.buffer_init(4, specs_t, device="cpu")
    for i in range(6):
        t = {"state": np.full((3, 6), i, np.int32), "action": np.full((2, 6), -i, np.int32),
             "reward": np.array([float(i)], np.float32),
             "next_state": np.full((3, 6), 2 * i, np.int32), "done": np.zeros((1,), np.int32)}
        jb = jbuf.buffer_store(jb, {k: jnp.asarray(v) for k, v in t.items()})
        tb = tbuf.buffer_store(tb, {k: _t(v) for k, v in t.items()})
    assert tb.counter == int(jb.counter) == 6
    assert tbuf.buffer_size(tb) == jbuf.buffer_size(jb) == 4
    for k, v in jbuf.buffer_get(jb).items():
        assert str(tb.data[k].dtype) == f"torch.{v.dtype}"
        np.testing.assert_array_equal(tbuf.buffer_get(tb)[k].numpy(), np.asarray(v), err_msg=k)
    # ring wrapped: slots hold entries 4, 5, 2, 3
    np.testing.assert_array_equal(tb.data["reward"][:, 0].numpy(), [4, 5, 2, 3])


def test_buffer_store_batch_matches_jax():
    jb = jbuf.buffer_init(8, {"reward": ((1,), jnp.float32), "state": ((2,), jnp.int32)})
    tb = tbuf.buffer_init(8, {"reward": ((1,), torch.float32), "state": ((2,), torch.int32)},
                          device="cpu")
    for n in (5, 5, 9):
        batch = {"reward": np.arange(n, dtype=np.float32)[:, None] + 10 * n,
                 "state": np.stack([np.arange(n), -np.arange(n)], 1).astype(np.int64)}
        jb = jbuf.buffer_store_batch(jb, {k: jnp.asarray(v) for k, v in batch.items()})
        tb = tbuf.buffer_store_batch(tb, {k: _t(v) for k, v in batch.items()})
        assert tb.counter == int(jb.counter)
        for k in batch:
            np.testing.assert_array_equal(tb.data[k].numpy(), np.asarray(jb.data[k]), err_msg=k)
    assert tb.data["state"].dtype == torch.int32


def test_buffer_sample_is_uniform_over_the_capacity():
    tb = tbuf.buffer_init(7, tbuf.expert_field_specs(3, 2, 6), device="cpu")
    tb = tbuf.buffer_store_batch(tb, {"state": torch.arange(3 * 18).reshape(3, 3, 6),
                                      "reward": torch.ones((3, 1))})
    gen = torch.Generator().manual_seed(5)
    twin = torch.Generator().manual_seed(5)
    batch = tbuf.buffer_sample(tb, gen, 400)
    idx = torch.randint(0, 7, (400,), generator=twin)
    assert set(idx.tolist()) == set(range(7))       # the unwritten slots too, as in JAX
    for k, v in tb.data.items():
        assert batch[k].shape == (400,) + v.shape[1:]
        torch.testing.assert_close(batch[k], v[idx], rtol=0, atol=0)


# -- DQN ------------------------------------------------------------------------

def test_choose_action_and_rollout_match_jax(lt_params):
    tp = tw.from_jax_params(lt_params, device="cpu")
    x, y, mask = _song()
    for s in (x[None, :10], np.stack([x[:10], y[5:15]])):
        ref = jdqn.choose_action(lt_params, TINY, jnp.asarray(s), n_actions=5)
        ours = tdqn.choose_action(tp, TTINY, _t(s), n_actions=5)
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    ja, je = jenv.dqn_rollout_song(lt_params, TINY, jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(mask), episodes=4, n_states=10, n_actions=5)
    ta, te = tenv.dqn_rollout_song(tp, TTINY, _t(x), _t(y), _t(mask), episodes=4, n_states=10,
                                   n_actions=5)
    for ours, ref in ((ta, ja), (te, je)):
        assert sorted(ours) == sorted(ref)
        for k, v in ref.items():
            assert ours[k].shape == v.shape, k
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    # the reference's quirk: next_state = concat(state[:n_actions], action)
    np.testing.assert_array_equal(ta["next_state"][:, :5].numpy(), ta["state"][:, :5].numpy())
    np.testing.assert_array_equal(ta["state"][1:].numpy(), ta["next_state"][:-1].numpy())


@pytest.mark.parametrize("knob", teg.ROUTE_VARS)
def test_rollout_graph_cache_key_follows_routes_and_storage(monkeypatch, lt_params, knob):
    """The cached episode loop is keyed on the weights' tensors and their
    storage and on the routes read at capture: each backend knob and a new
    storage for one parameter give a new entry; an in-place update keeps
    it; freeing the weights drops it."""
    tp = tw.from_jax_params(lt_params, device="cpu")
    built = []

    def build():
        built.append(object())
        return built[-1]

    key = ("dqn", TTINY, 4)
    first = teg.cached(key, (tp,), build)
    assert teg.cached(key, (tp,), build) is first and len(built) == 1
    with torch.no_grad():                         # an optimizer step: in place
        tp["layers"]["wq"]["w"].add_(0.5)
    assert teg.cached(key, (tp,), build) is first and len(built) == 1
    before = os.environ.get(knob)
    monkeypatch.setenv(knob, "pallas" if knob != "RLMG_FFN_MIN_ROWS" else "1")
    assert teg.cached(key, (tp,), build) is not first and len(built) == 2
    if before is None:
        monkeypatch.delenv(knob)
    else:
        monkeypatch.setenv(knob, before)
    assert teg.cached(key, (tp,), build) is first
    tp["final_ln"]["scale"] = tp["final_ln"]["scale"].clone()    # a new storage
    assert teg.cached(key, (tp,), build) is not first and len(built) == 3
    n = len(teg._LOOPS)
    del tp
    import gc
    gc.collect()
    assert len(teg._LOOPS) < n


def test_rollouts_on_the_cpu_never_capture(monkeypatch, lt_params):
    """On CPU tensors the episode body runs eagerly: no graph is captured,
    nothing is cached, and the result equals the forced eager loop's."""
    def no_graph(*a, **k):
        raise AssertionError("a CUDA graph was made on the CPU path")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    tp = tw.from_jax_params(lt_params, device="cpu")
    x, y, mask = _song()
    c0, n0 = teg.EpisodeLoop.captures, len(teg._LOOPS)
    kw = dict(episodes=4, n_states=10, n_actions=5)
    ta, te = tenv.dqn_rollout_song(tp, TTINY, _t(x), _t(y), _t(mask), **kw)
    fa, fe = tenv.dqn_rollout_song(tp, TTINY, _t(x), _t(y), _t(mask), graph=False, **kw)
    assert teg.EpisodeLoop.captures == c0 and len(teg._LOOPS) == n0
    for k in ta:
        torch.testing.assert_close(ta[k], fa[k], rtol=0, atol=0)


def _rollout_batches(params):
    x, y, mask = _song()
    agent_ts, expert_ts = jenv.dqn_rollout_song(params, TINY, jnp.asarray(x), jnp.asarray(y),
                                                jnp.asarray(mask), episodes=4, n_states=10,
                                                n_actions=5)
    batch = {k: np.asarray(v) for k, v in agent_ts.items()}
    batch["reward"] = np.linspace(0.1, 0.9, 4, dtype=np.float32)[:, None]
    batch["done"] = np.array([[0], [1], [0], [0]], np.int32)
    ebatch = {k: np.array(expert_ts[k]) for k in ("state", "next_state", "mask_next_state")}
    ebatch["mask_next_state"][0, 7:] = 0.0
    return batch, ebatch


def test_dqn_update_matches_jax_and_syncs_the_target_only_at_a_sync(lt_params):
    """Two updates (target_update 2): losses to 1e-5 relative, parameters
    per leaf to 1e-5 of their magnitude.  The first update syncs the target
    to the eval params before updating them, the second does not; the target
    never aliases the eval tree (the port's optimizer adds in place)."""
    batch, ebatch = _rollout_batches(lt_params)
    jstate = jdqn.init_state(jax.random.PRNGKey(0), TINY, DQN_CFG,
                             jax.tree_util.tree_map(jnp.asarray, lt_params))
    jtx = jdqn.make_optimizer(DQN_CFG)
    # a target that differs from eval, so the sync is visible
    start = tw.from_jax_params(lt_params, device="cpu")
    tstate = tdqn.init_state(TTINY, TDQN_CFG, start)
    tstate.target_params["final_ln"]["bias"].add_(1.0)
    ttx = tdqn.make_optimizer(TDQN_CFG)
    assert not any(a.data_ptr() == b.data_ptr() for a, b in zip(
        topt.tree_leaves(tstate.eval_params), topt.tree_leaves(tstate.target_params)))
    before = {k: np.array(v) for k, v in _flat(tstate.eval_params).items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    je = {k: jnp.asarray(v) for k, v in ebatch.items()}
    for step in range(2):
        jstate, jm = jdqn.update(jstate, TINY, DQN_CFG, jtx, jb, je, jax.random.PRNGKey(step))
        tstate, tm = tdqn.update(tstate, TTINY, TDQN_CFG, ttx, {k: _t(v) for k, v in batch.items()},
                                 {k: _t(v) for k, v in ebatch.items()},
                                 torch.Generator().manual_seed(step))
        for k in ("mse", "ce", "total"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        assert tstate.target_count == int(jstate.target_count) == step + 1
        _assert_params_close(tstate.eval_params, jax.tree_util.tree_map(np.asarray,
                                                                        jstate.eval_params))
        _assert_params_close(tstate.target_params, jax.tree_util.tree_map(
            np.asarray, jstate.target_params))
        # synced at count 0 to the eval params before the update, untouched at count 1
        for k, v in _flat(tstate.target_params).items():
            np.testing.assert_array_equal(v, before[k], err_msg=k)
        assert not np.allclose(_flat(tstate.eval_params)["/in_linear/w"], before["/in_linear/w"])
    assert tstate.opt_state.count == 2


def test_dqn_update_takes_no_backward_through_the_target(monkeypatch, lt_params):
    """Under RLMG_ATTN_BACKEND=pallas every layer calls kernel F's wrapper
    (its plain twin on the CPU): 3 forwards and 2 backwards per layer per
    update (eval, target and CE; eval and CE), as the card's counters read."""
    from reinforcement_learning_in_music_generation_torch.ops import linear_attention_kernel as tlk
    batch, ebatch = _rollout_batches(lt_params)
    tstate = tdqn.init_state(TTINY, TDQN_CFG, tw.from_jax_params(lt_params, device="cpu"))
    calls = {"fwd": 0, "bwd": 0}
    real = tlk.causal_product_plain

    class Counted(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            return a.view_as(a)

        @staticmethod
        def backward(ctx, g):
            calls["bwd"] += 1
            return g

    def counted(pq, pk, v, eps, chunk):
        calls["fwd"] += 1
        out, den = real(pq, pk, v, eps, chunk)
        return Counted.apply(out), den

    monkeypatch.setenv("RLMG_ATTN_BACKEND", "pallas")
    monkeypatch.setattr(tlk, "causal_product_plain", counted)
    tdqn.update(tstate, TTINY, TDQN_CFG, tdqn.make_optimizer(TDQN_CFG),
                {k: _t(v) for k, v in batch.items()}, {k: _t(v) for k, v in ebatch.items()}, None)
    assert calls == {"fwd": 3 * TINY.n_layer, "bwd": 2 * TINY.n_layer}


# -- AIRL -----------------------------------------------------------------------

def _disc_batch(n=8, s=10, seed=3):
    rng = np.random.default_rng(seed)
    expert = rng.integers(0, 8, (n, s, 6)).astype(np.int32)
    agent = rng.integers(0, 8, (n, s, 6)).astype(np.int32)
    mask = np.ones((n, s), np.float32)
    mask[1, 6:] = 0.0
    mask[-1, 3:] = 0.0
    return expert, agent, mask


def _jax_adam_mu(opt_state):
    """The first moments of the JAX package's optax Adam state."""
    (found,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(
        x, "mu")) if hasattr(s, "mu")]
    return found.mu


def _states(lf_params, acfg, tacfg, bn=None):
    bn = bn or jax.tree_util.tree_map(np.asarray, jlf.init_state(TINY_W))
    jst = jairl.AIRLState(jax.tree_util.tree_map(jnp.asarray, lf_params), bn,
                          jairl.make_optimizer(acfg).init(lf_params))
    tp = tw.from_jax_params(lf_params, device="cpu")
    tst = tairl.AIRLState(tp, {k: _t(v) for k, v in bn.items()},
                          tairl.make_optimizer(tacfg).init(tp))
    return jst, tst


# gradient 0 in exact arithmetic: the softmax removes a bias added to a whole
# row of scores, the train-mode BatchNorm one added to a whole column
ZERO_GRAD = ("/layers/wk/b", "/score/l1/b")


def test_disc_step_matches_jax(lf_params):
    """One minibatch step (dropout 0): the four losses to 1e-5 relative, the
    BatchNorm running stats threaded expert -> agent -> out to 1e-5, the
    gradients (Adam's first moments, 0.1 g after one step) per leaf to 1e-5
    of the leaf's largest, and the parameters.  Two leaves have gradient 0
    in exact arithmetic (ZERO_GRAD): both sides hold rounding noise below
    1e-6 of the step's largest gradient there.  Adam's first step moves a
    parameter by lr g / (|g| + eps), so where |g| is near rounding its
    direction is noise: parameters are held to 1e-5 of their magnitude
    wherever |g| exceeds 1e-3 of the leaf's largest (so no sign is left to
    rounding, as chip_smoke.py's check_step holds them), and elsewhere to
    Adam's bound, a move of at most lr.  A second step's losses agree to
    1e-5 too."""
    acfg, tacfg = C.AIRLConfig(epochs=1, batch_size=4), TC.AIRLConfig(epochs=1, batch_size=4)
    expert, agent, mask = _disc_batch()
    jst, tst = _states(lf_params, acfg, tacfg)
    jtx, ttx = jairl.make_optimizer(acfg), tairl.make_optimizer(tacfg)
    for i in range(2):
        sl = slice(4 * i, 4 * i + 4)
        jst, jm = jairl.disc_step(jst, TINY_W, jtx, expert[sl], mask[sl], agent[sl],
                                  jax.random.PRNGKey(i))
        tst, tm = tairl.disc_step(tst, TTINY_W, ttx, _t(expert[sl]), _t(mask[sl]),
                                  _t(agent[sl]), None)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        if i == 1:
            break
        for k, v in jst.bn_state.items():
            assert not tst.bn_state[k].requires_grad
            np.testing.assert_allclose(tst.bn_state[k].numpy(), np.asarray(v), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        tmu, jmu = _flat(tst.opt_state.mu), _flat(jax.tree_util.tree_map(np.asarray,
                                                                         _jax_adam_mu(jst.opt_state)))
        tpp, jpp = _flat(tst.params), _flat(jax.tree_util.tree_map(np.asarray, jst.params))
        p0 = _flat(lf_params)
        g_top = max(float(np.abs(v).max()) for v in jmu.values())
        for k, g in jmu.items():
            top = float(np.abs(g).max())
            if k in ZERO_GRAD:
                assert max(top, float(np.abs(tmu[k]).max())) <= 1e-6 * g_top, k
            else:
                np.testing.assert_allclose(tmu[k], g, rtol=0, atol=1e-5 * top, err_msg=k)
            settled = np.abs(g) > 1e-3 * top if k not in ZERO_GRAD else np.zeros(g.shape, bool)
            scale = max(float(np.abs(jpp[k]).max()), 1e-6)
            np.testing.assert_allclose(tpp[k][settled], jpp[k][settled], rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=k)
            for moved in (tpp[k], jpp[k]):
                assert np.abs(moved - p0[k])[~settled].max(initial=0.0) <= acfg.lr * 1.001, k
    assert tst.opt_state.count == 2


def test_calculate_reward_matches_jax(lf_params):
    """Both buffers' rows scored in batches of 4 over 10 rows (a ragged tail
    of 2, scored as its own batch) in train-mode BatchNorm, the running
    stats thrown away: scores to 1e-5.  Batches of 3 give other scores (per-
    batch statistics), on both sides alike."""
    expert, agent, mask = _disc_batch(n=10, seed=4)
    bn = {"bn_mean": np.linspace(-0.1, 0.1, 128).astype(np.float32),
          "bn_var": np.linspace(0.5, 1.5, 128).astype(np.float32)}
    jst, tst = _states(lf_params, C.AIRLConfig(), TC.AIRLConfig(), bn)
    by_bs = {}
    for bs in (4, 3):
        ref = jairl.calculate_reward(jst, TINY_W, agent, mask, bs)
        ours = tairl.calculate_reward(tst, TTINY_W, _t(agent), _t(mask), bs)
        assert ours.shape == (10, 1) and not ours.requires_grad
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        by_bs[bs] = ours
    assert not torch.allclose(by_bs[3], by_bs[4])
    for k, v in bn.items():
        np.testing.assert_array_equal(tst.bn_state[k].numpy(), v)


def test_update_disc_matches_jax(lf_params):
    """update_disc: one training epoch of two minibatches (the epoch's mean
    losses to 1e-5 relative, scores in (0, 1)), and with train=False the
    re-scoring of both buffers with the expert buffer's masks, to 1e-5."""
    acfg = C.AIRLConfig(epochs=1, batch_size=4, score_batch_size=4)
    tacfg = TC.AIRLConfig(epochs=1, batch_size=4, score_batch_size=4)
    expert, agent, mask = _disc_batch(n=10, seed=4)
    jbufs = ({"state": agent}, {"state": expert, "mask_state": mask})
    tbufs = ({"state": _t(agent)}, {"state": _t(expert), "mask_state": _t(mask)})
    for train in (True, False):
        jst, tst = _states(lf_params, acfg, tacfg)
        _, jar, jer, jh = jairl.update_disc(jst, TINY_W, acfg, jairl.make_optimizer(acfg),
                                            *jbufs, jax.random.PRNGKey(2), train=train)
        tst2, tar, ter, th = tairl.update_disc(tst, TTINY_W, tacfg, tairl.make_optimizer(tacfg),
                                               *tbufs, None, train=train)
        assert len(th) == len(jh) == int(train)
        for ours, ref in zip(th, jh):
            for k, v in ref.items():
                np.testing.assert_allclose(ours[k], v, rtol=1e-5, err_msg=k)
        assert tar.shape == ter.shape == (10, 1)
        assert bool(((tar > 0) & (tar < 1)).all() and ((ter > 0) & (ter < 1)).all())
        if not train:
            np.testing.assert_allclose(tar.numpy(), np.asarray(jar), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(ter.numpy(), np.asarray(jer), rtol=1e-5, atol=1e-5)


def test_gradient_penalty_matches_jax(lf_params):
    expert, agent, mask = _disc_batch(n=4, seed=6)
    bn = {"bn_mean": np.linspace(-0.1, 0.1, 128).astype(np.float32),
          "bn_var": np.linspace(0.5, 1.5, 128).astype(np.float32)}
    jst, tst = _states(lf_params, C.AIRLConfig(), TC.AIRLConfig(), bn)
    key = jax.random.PRNGKey(7)
    ref = jairl.gradient_penalty(jst, TINY_W, expert, agent, mask, key)
    eta = np.asarray(jax.random.uniform(key, (4, 1, 1)))      # JAX's draw, handed over
    ours = tairl.gradient_penalty(tst, TTINY_W, _t(expert), _t(agent), _t(mask), eta=_t(eta))
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=1e-4)
    # differentiable in the parameters, as the JAX function is under jax.grad
    leaf = next(iter(tst.params["emb"].values()))
    leaf.requires_grad_(True)
    gp = tairl.gradient_penalty(tst, TTINY_W, _t(expert), _t(agent), _t(mask), eta=_t(eta))
    (g,) = torch.autograd.grad(gp, leaf)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
