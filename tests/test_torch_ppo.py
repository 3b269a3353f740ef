"""The port's PPO slice (``models/critic.py``, ``rl/ppo.py``, the actor's
``value_head``) against the JAX package's, on the CPU.

Tiny configs as tests/test_rl.py's PPO test, at two layers so the layer
loop runs: actor and critic d_model 32, FFN 64, the reward model a 2-layer
window transformer with eval heads; PPOConfig(episodes=3, n_states=10,
n_actions=5, ppo_steps=2); dropout 0.  One JAX PPOState (``init_state``),
carried across with ``from_jax_params``, drives both packages.  Every port
function runs on the default route and under RLMG_FFN_BACKEND=pallas
(kernel G's wrapper in every actor and critic layer, its plain twin on CPU
tensors); at dropout 0 the JAX package's two routes compute one function
(tests/test_torch_ffn_block.py holds the port's pallas route against JAX's
Pallas ffn_block), so one JAX reference serves both.  Actions agree
exactly, log-probs, values and rewards to 1e-5, losses to 1e-5 relative,
gradients (Adam's first moment, 0.1 g after one step) to 1e-5 of their
leaf's largest, and parameters as tests/test_torch_rl.py holds a step at
lr 0.01 (PPOConfig's): where the gradient's sign is settled."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.models import critic as tcritic
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.ops import ffn_block as tfb
from reinforcement_learning_in_music_generation_torch.rl import buffers as tbuf
from reinforcement_learning_in_music_generation_torch.rl import ppo as tppo
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import dataset
from reinforcement_learning_in_music_generation_tpu.models import critic as jcritic
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as jlt
from reinforcement_learning_in_music_generation_tpu.rl import buffers as jbuf
from reinforcement_learning_in_music_generation_tpu.rl import ppo as jppo

VOCAB = (8, 8, 8, 8, 8, 8)
LT_KW = dict(vocab_sizes=VOCAB, emb_sizes=(8,) * 6, d_model=32, n_layer=2, n_head=2,
             d_inner=64, dropout=0.0)
W_KW = dict(vocab_sizes=VOCAB, emb_sizes=(8,) * 6, d_model=16, n_layer=2, n_head=2,
            d_inner=32, max_pos=64, attention_window=8, with_score_head=False,
            with_eval_heads=True, dropout=0.0)
ACFG, TACFG = (C.LinearTransformerConfig(**LT_KW, with_value_head=True),
               TC.LinearTransformerConfig(**LT_KW, with_value_head=True))
CCFG, TCCFG = C.LinearTransformerConfig(**LT_KW), TC.LinearTransformerConfig(**LT_KW)
WCFG, TWCFG = C.WindowTransformerConfig(**W_KW), TC.WindowTransformerConfig(**W_KW)
PPO_KW = dict(episodes=3, n_states=10, n_actions=5, ppo_steps=2)
CFG, TCFG_PPO = C.PPOConfig(**PPO_KW), TC.PPOConfig(**PPO_KW)
CFGS, TCFGS = (ACFG, CCFG, WCFG), (TACFG, TCCFG, TWCFG)
# song lengths: 64, and 16 < episodes + 2 n_states = 23, where the expert
# and mask windows clamp into the song
LONG, SHORT = 64, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach().numpy() if torch.is_tensor(tree) else tree)}


def _jax_adam_mu(opt_state):
    """The first moments of the JAX package's optax Adam state."""
    (found,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(
        x, "mu")) if hasattr(s, "mu")]
    return found.mu


def _song(length, seed=0):
    x, y, mask = dataset.synthetic_cp_dataset(1, length, n_class=VOCAB, seed=seed)
    mask = mask[0].copy()
    mask[length - 5:] = 0.0                     # a padded tail the masks must carry
    return x[0], y[0], mask


@pytest.fixture(scope="module")
def ref():
    """The JAX side, computed once: the initial state (as numpy trees), the
    rollouts of a long and a short song, one update step and update_policy's
    two-step means from the long song's transitions."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("RLMG_FFN_BACKEND", raising=False)
        return _reference()


def _reference():
    st = jppo.init_state(jax.random.PRNGKey(0), ACFG, CCFG, WCFG, CFG)
    out = {"params": [_np(p) for p in st[:3]], "rollout": {}}
    for length in (LONG, SHORT):
        x, y, mask = _song(length)
        a, e = jppo.rollout_song(st, CFGS, x, y, mask, episodes=3, n_states=10, n_actions=5)
        out["rollout"][length] = ((x, y, mask), _np(a), _np(e))
    _, a, e = out["rollout"][LONG]
    returns = jppo.calculate_returns(jnp.asarray(a["reward"][:, 0]), CFG.discount)
    adv = jppo.calculate_advantages(returns, jnp.asarray(a["value"]))
    out["ret_adv"] = (np.asarray(returns), np.asarray(adv))
    txs = jppo.make_optimizers(CFG)
    st1, m1 = jppo.update_policy_step(st, CFGS, CFG, txs, a, e, adv, returns)
    out["step"] = (_np(st1.actor_params), _np(st1.critic_params),
                   _np(_jax_adam_mu(st1.actor_opt)), _np(_jax_adam_mu(st1.critic_opt)),
                   {k: float(v) for k, v in m1.items()})
    _, means = jppo.update_policy(st, CFGS, CFG, txs, a, e, adv, returns, jax.random.PRNGKey(1))
    out["means"] = {k: float(v) for k, v in means.items()}
    return out


def _port_state(ref):
    """A fresh port PPOState from the JAX initial state (the optimizer adds
    in place, so each test takes its own)."""
    actor, critic, reward = (tw.from_jax_params(p, device="cpu") for p in ref["params"])
    atx, ctx = tppo.make_optimizers(TCFG_PPO)
    return tppo.PPOState(actor, critic, reward, atx.init(actor), ctx.init(critic))


@pytest.fixture(params=["default", "pallas"])
def route(request, monkeypatch):
    """The port's route; counts kernel G's wrapper calls under "pallas",
    where a JAX call made in the test takes its Pallas ffn_block (interpret
    mode) unless jit has a trace of it already."""
    calls = []
    if request.param == "pallas":
        monkeypatch.setenv("RLMG_FFN_BACKEND", "pallas")
        monkeypatch.setenv("RLMG_FFN_INTERPRET", "1")
        real = tfb.ffn_block_plain
        monkeypatch.setattr(tfb, "ffn_block_plain", lambda *a: calls.append(1) or real(*a))
    else:
        monkeypatch.delenv("RLMG_FFN_BACKEND", raising=False)
    return request.param, calls


def test_ppo_state_crosses_from_jax(ref):
    """The JAX PPOState's trees (the critic's value_heads, the actor's
    value_head) convert leaf for leaf, with no code of their own, and the
    port's init_params makes the same trees."""
    st = _port_state(ref)
    for ours, theirs in zip(st[:3], ref["params"]):
        o, t = _flat(ours), _flat(theirs)
        assert sorted(o) == sorted(t)
        for k in t:
            np.testing.assert_array_equal(o[k], t[k], err_msg=k)
    assert "/value_head/l2/w" in _flat(st.actor_params)
    assert {"/value_heads/tempo/w", "/value_heads/velocity/b"} <= set(_flat(st.critic_params))
    made = tppo.init_state(TACFG, TCCFG, TWCFG, TCFG_PPO, device="cpu")
    for ours, theirs in zip(made[:3], ref["params"]):
        assert {k: v.shape for k, v in _flat(ours).items()} == \
            {k: v.shape for k, v in _flat(theirs).items()}
    # no two trees share storage: the optimizer updates them in place
    ptrs = [t.data_ptr() for tree in made[:3] for t in _flat_tensors(tree)]
    assert len(ptrs) == len(set(ptrs))


def _flat_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat_tensors(v)]
    return [tree]


def test_value_head_and_value_produce_match_jax(ref, route):
    actor, critic, _ = ref["params"]
    st = _port_state(ref)
    x = np.random.default_rng(1).integers(0, 8, (3, 10, 6)).astype(np.int32)
    h = np.random.default_rng(2).standard_normal((3, 10, 32)).astype(np.float32)
    ours = tlt.value_head(st.actor_params, _t(h))
    assert ours.shape == (3, 10)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jlt.value_head(actor, jnp.asarray(h))),
                               rtol=1e-5, atol=1e-6)
    v = tcritic.value_produce(st.critic_params, TCCFG, _t(x))
    assert v.shape == (3,)
    np.testing.assert_allclose(v.detach().numpy(),
                               np.asarray(jcritic.value_produce(critic, CCFG, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    assert len(route[1]) == (CCFG.n_layer if route[0] == "pallas" else 0)


@pytest.mark.parametrize("compat_forward", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_returns_and_advantages_match_jax(compat_forward, normalize):
    """Both orders, normalised and not, on the device loop's arithmetic:
    to 1e-6.  Normalising uses the population std (jnp.std, ddof 0)."""
    r = np.random.default_rng(3).random(7).astype(np.float32)
    values = np.random.default_rng(4).standard_normal((7, 1)).astype(np.float32)
    ref_r = jppo.calculate_returns(jnp.asarray(r), 0.9, normalize=normalize,
                                   compat_forward=compat_forward)
    ours = tppo.calculate_returns(_t(r), 0.9, normalize=normalize, compat_forward=compat_forward)
    assert ours.shape == (7, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref_r), rtol=1e-6, atol=1e-6)
    ref_a = jppo.calculate_advantages(ref_r, jnp.asarray(values), normalize=normalize)
    ours_a = tppo.calculate_advantages(ours, _t(values), normalize=normalize)
    np.testing.assert_allclose(ours_a.numpy(), np.asarray(ref_a), rtol=1e-6, atol=1e-6)
    if normalize:
        # the unbiased std (torch's default) would give other values
        raw = tppo.calculate_returns(_t(r), 0.9, normalize=False, compat_forward=compat_forward)
        unbiased = (raw - raw.mean()) / (raw.std() + 1e-8)
        assert not torch.allclose(unbiased, ours, rtol=1e-4, atol=1e-4)


def test_returns_of_the_reference_example():
    """tests/test_rl.py's example: reverse accumulation puts the reward at
    t = 0 only; the reference's forward order discounts the first most."""
    r = torch.tensor([1.0, 0.0, 0.0, 0.0])
    np.testing.assert_allclose(tppo.calculate_returns(r, 0.5, normalize=False)[:, 0].numpy(),
                               [1.0, 0.0, 0.0, 0.0])
    np.testing.assert_allclose(tppo.calculate_returns(r, 0.5, normalize=False,
                                                      compat_forward=True)[:, 0].numpy(),
                               [0.125, 0.25, 0.5, 1.0])


def test_choose_action_matches_jax(ref, route):
    actor = ref["params"][0]
    st = _port_state(ref)
    s = np.random.default_rng(5).integers(0, 8, (4, 10, 6)).astype(np.int32)
    ref_a, ref_lp = jppo.choose_action(actor, ACFG, jnp.asarray(s), n_actions=5)
    act, lp = tppo.choose_action(st.actor_params, TACFG, _t(s), n_actions=5)
    assert act.dtype == torch.int32 and act.shape == lp.shape == (4, 5, 6)
    np.testing.assert_array_equal(act.numpy(), np.asarray(ref_a))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), rtol=1e-5, atol=1e-5)
    assert len(route[1]) == (ACFG.n_layer if route[0] == "pallas" else 0)


@pytest.mark.parametrize("length", [LONG, SHORT])
def test_rollout_song_matches_jax(ref, route, length):
    """Every transition field: integer ones exactly, log-probs, values and
    rewards to 1e-5; the fields and dtypes of ppo_field_specs; the stored
    state is the post-step state, as in the reference."""
    (x, y, mask), ja, je = ref["rollout"][length]
    st = _port_state(ref)
    ta, te = tppo.rollout_song(st, TCFGS, _t(x), _t(y), _t(mask), episodes=3, n_states=10,
                               n_actions=5)
    for ours, theirs in ((ta, ja), (te, je)):
        assert sorted(ours) == sorted(theirs)
        for k, v in theirs.items():
            assert ours[k].shape == v.shape and not ours[k].requires_grad, k
            if v.dtype.kind == "i":
                np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
            else:
                np.testing.assert_allclose(ours[k].numpy(), v, rtol=1e-5, atol=1e-5, err_msg=k)
    for k, (shape, dtype) in tbuf.ppo_field_specs(10, 5, 6).items():
        assert ta[k].shape[1:] == shape and ta[k].dtype == dtype, k
    assert sorted(tbuf.ppo_field_specs(10, 5, 6)) == sorted(jbuf.ppo_field_specs(10, 5, 6))
    np.testing.assert_array_equal(ta["state"].numpy(), ta["next_state"].numpy())
    np.testing.assert_array_equal(ta["state"][1:, :5].numpy(), ta["state"][:-1, :5].numpy())
    # an actor and a critic forward per episode through kernel G's wrapper
    assert len(route[1]) == (3 * (ACFG.n_layer + CCFG.n_layer) if route[0] == "pallas" else 0)


def _transitions(ref):
    _, a, e = ref["rollout"][LONG]
    returns, adv = ref["ret_adv"]
    return ({k: _t(v) for k, v in a.items()}, {k: _t(v) for k, v in e.items()}, _t(adv),
            _t(returns))


def test_update_policy_step_matches_jax(ref, route):
    """One step from the same state and transitions: the three losses to
    1e-5 relative; both trees' gradients (Adam's first moment) to 1e-5 of
    their leaf's largest; parameters to 1e-5 of their magnitude where the
    gradient's sign is settled (|g| above 1e-3 of the leaf's largest), and
    elsewhere moved by at most lr, Adam's bound.  The actor's value head is
    not in the actor's loss: gradient 0 and no move on both sides.  The
    rollout's tensors come out untouched (the losses read them detached)."""
    st = _port_state(ref)
    agent, expert, adv, returns = _transitions(ref)
    before = {k: v.clone() for k, v in agent.items()}
    st1, m = tppo.update_policy_step(st, TCFGS, TCFG_PPO, tppo.make_optimizers(TCFG_PPO), agent,
                                     expert, adv, returns)
    j_actor, j_critic, j_amu, j_cmu, jm = ref["step"]
    assert sorted(m) == sorted(jm)
    for k in jm:
        assert m[k].shape == () and not m[k].requires_grad
        np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-5, err_msg=k)
    for ours_p, ours_mu, jp, jmu, p0 in ((st1.actor_params, st1.actor_opt.mu, j_actor, j_amu,
                                          ref["params"][0]),
                                         (st1.critic_params, st1.critic_opt.mu, j_critic, j_cmu,
                                          ref["params"][1])):
        tmu, tpp, jmu_f, jpp, p0 = _flat(ours_mu), _flat(ours_p), _flat(jmu), _flat(jp), _flat(p0)
        assert sorted(tmu) == sorted(jmu_f)
        for k, g in jmu_f.items():
            top = float(np.abs(g).max())
            np.testing.assert_allclose(tmu[k], g, rtol=0, atol=1e-5 * max(top, 1e-12), err_msg=k)
            settled = np.abs(g) > 1e-3 * top
            scale = max(float(np.abs(jpp[k]).max()), 1e-6)
            np.testing.assert_allclose(tpp[k][settled], jpp[k][settled], rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=k)
            for moved in (tpp[k], jpp[k]):
                assert np.abs(moved - p0[k])[~settled].max(initial=0.0) <= CFG.lr * 1.001, k
    assert not np.any(_flat(st1.actor_opt.mu)["/value_head/l1/w"])
    np.testing.assert_array_equal(_flat(st1.actor_params)["/value_head/l1/w"],
                                  _flat(ref["params"][0])["/value_head/l1/w"])
    assert st1.actor_opt.count == st1.critic_opt.count == 1
    for k, v in before.items():
        assert torch.equal(agent[k], v), k
    # two actor forwards (policy and CE) and a critic forward, each with its backward
    calls = route[1]
    assert len(calls) == (2 * ACFG.n_layer + CCFG.n_layer if route[0] == "pallas" else 0)


def test_update_policy_metric_means_match_jax(ref, route):
    st = _port_state(ref)
    st2, means = tppo.update_policy(st, TCFGS, TCFG_PPO, tppo.make_optimizers(TCFG_PPO),
                                    *_transitions(ref))
    assert sorted(means) == sorted(ref["means"])
    for k, v in ref["means"].items():
        np.testing.assert_allclose(float(means[k]), v, rtol=1e-5, err_msg=k)
    assert st2.actor_opt.count == st2.critic_opt.count == CFG.ppo_steps
