"""The port's Longformer family and its LM pretraining against the JAX
package, on the CPU.

Small configs (2 layers, d_model 32, 2 heads of 16, FFN 64), weights from
the JAX ``init_params`` through ``weights.from_jax_params``, batches from a
numpy seed.  The forward and every head (``token_logits``, ``token_ce``,
``score_forward`` in train and eval mode with the BatchNorm state,
``score_from_embeddings``, ``eval_score``) agree to 1e-5 relative, on the
plain route, the fused-tail route (RLMG_FFN_BACKEND=pallas-tail; JAX runs
its kernel in interpret mode, the port's wrapper its plain version on CPU
tensors) and the window-kernel route (RLMG_WINDOW_BACKEND=pallas at S =
1152, where the dispatch takes the kernel).  One ``longformer_lm_step``
matches JAX's (loss 1e-6, gradients and parameters per leaf at the
tolerances of tests/test_torch_pretrain.py); accumulation, the loop and
``discrim-pretrain`` / ``my-pretrain`` run on the CPU and write
checkpoints the JAX package reads."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.apps import cli as tcli
from reinforcement_learning_in_music_generation_torch.models import longformer as tlf
from reinforcement_learning_in_music_generation_torch.ops import window_attention_kernel as twk
from reinforcement_learning_in_music_generation_torch.train import optim as topt
from reinforcement_learning_in_music_generation_torch.train import pretrain as tpre
from reinforcement_learning_in_music_generation_torch.utils import checkpoint as tck
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import dataset as jds
from reinforcement_learning_in_music_generation_tpu.models import longformer as jlf
from reinforcement_learning_in_music_generation_tpu.ops import window_attention_kernel as jwk
from reinforcement_learning_in_music_generation_tpu.ops.losses import fields_cross_entropy
from reinforcement_learning_in_music_generation_tpu.train import optim as jopt
from reinforcement_learning_in_music_generation_tpu.train import pretrain as jpre
from reinforcement_learning_in_music_generation_tpu.utils import checkpoint as jck

VOCAB = (56, 135, 18, 87, 18, 25)
KW = dict(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=32, n_layer=2, n_head=2, d_inner=64,
          attention_window=16, max_pos=1200, dropout=0.0, with_score_head=True,
          with_eval_heads=True)
B, S = 3, 48
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**over):
    kw = {**KW, **over}
    return C.WindowTransformerConfig(**kw), TC.WindowTransformerConfig(**kw)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach().numpy() if torch.is_tensor(tree) else tree)}


def _jparams(cfg, seed=3):
    return jax.tree_util.tree_map(np.asarray, jlf.init_params(jax.random.PRNGKey(seed), cfg))


def _batch(b=B, s=S, seed=4):
    return jds.synthetic_cp_dataset(b, s, n_class=VOCAB, seed=seed)


def test_configs_and_presets_match_jax():
    for name in ("discrim_lm_config", "ppo_reward_config", "airl_discriminator_config",
                 "actor_config"):
        ours, ref = getattr(TC, name)(), getattr(C, name)()
        for field in type(ours).__dataclass_fields__:
            assert getattr(ours, field) == getattr(ref, field), (name, field)
        assert ours.d_head == ref.d_head and ours.n_fields == ref.n_fields
    assert TC.discrim_lm_config(n_layer=3).n_layer == 3


@pytest.mark.parametrize("pos", ["absolute", "relative_key"])
def test_init_params_has_the_jax_tree(pos):
    cfg, tcfg = _cfgs(position_embedding_type=pos)
    ours = tlf.init_params(tcfg, seed=0, device="cpu")
    ref = _flat(_jparams(cfg))
    assert {k: v.shape for k, v in _flat(ours).items()} == {k: v.shape for k, v in ref.items()}
    assert {k: tuple(v.shape) for k, v in tlf.init_state(tcfg, device="cpu").items()} == \
        {k: v.shape for k, v in jlf.init_state(cfg).items()}


@pytest.mark.parametrize("pos", ["absolute", "relative_key"])
def test_forward_and_heads_match_jax(pos):
    cfg, tcfg = _cfgs(position_embedding_type=pos)
    jp = _jparams(cfg)
    tp = tw.from_jax_params(jp, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    x, y, m = _batch()
    state = {"bn_mean": np.linspace(-0.1, 0.1, 128).astype(np.float32),
             "bn_var": np.linspace(0.5, 1.5, 128).astype(np.float32)}
    tstate = tw.from_jax_params(state, device="cpu")
    X, M = _t(x), _t(m)
    np.testing.assert_allclose(tlf.forward(tp, tcfg, X, M).numpy(),
                               np.asarray(jlf.forward(jp, cfg, x, m)), **TOL)
    for a, r in zip(tlf.token_logits(tp, tcfg, X, M), jlf.token_logits(jp, cfg, x, m)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(float(tlf.token_ce(tp, tcfg, X, _t(y), M)),
                               float(jlf.token_ce(jp, cfg, x, y, m)), rtol=1e-5)
    for train in (True, False):
        sc, ns = tlf.score_forward(tp, tcfg, X, M, tstate, train=train)
        rsc, rns = jlf.score_forward(jp, cfg, x, m, state, train=train)
        np.testing.assert_allclose(sc.numpy(), np.asarray(rsc), **TOL)
        for k in rns:
            np.testing.assert_allclose(ns[k].numpy(), np.asarray(rns[k]), err_msg=k, **TOL)
    embs = np.random.default_rng(5).standard_normal((B, S, sum(cfg.emb_sizes))).astype(
        np.float32)
    sc, ns = tlf.score_from_embeddings(tp, tcfg, _t(embs), M, tstate, train=True)
    rsc, rns = jlf.score_from_embeddings(jp, cfg, embs, m, state, train=True)
    np.testing.assert_allclose(sc.numpy(), np.asarray(rsc), **TOL)
    np.testing.assert_allclose(ns["bn_var"].numpy(), np.asarray(rns["bn_var"]), **TOL)
    np.testing.assert_allclose(tlf.eval_score(tp, tcfg, X, M).numpy(),
                               np.asarray(jlf.eval_score(jp, cfg, x, m)), **TOL)


def test_fused_tail_route_matches_jax(monkeypatch):
    """RLMG_FFN_BACKEND=pallas-tail: window_attention_bshe plus kernel D's
    function with mid_drop=False, on both sides."""
    monkeypatch.setenv("RLMG_FFN_BACKEND", "pallas-tail")
    monkeypatch.setenv("RLMG_FFN_INTERPRET", "1")
    monkeypatch.delenv("RLMG_WINDOW_BACKEND", raising=False)
    calls = []
    real = tlf.attn_tail_block
    monkeypatch.setattr(tlf, "attn_tail_block",
                        lambda *a, **kw: calls.append(kw.get("mid_drop")) or real(*a, **kw))
    cfg, tcfg = _cfgs()
    jp = _jparams(cfg)
    tp = tw.from_jax_params(jp, device="cpu")
    x, y, m = _batch()
    np.testing.assert_allclose(tlf.forward(tp, tcfg, _t(x), _t(m)).numpy(),
                               np.asarray(jlf.forward(jp, cfg, x, m)), **TOL)
    assert calls == [False] * cfg.n_layer
    np.testing.assert_allclose(float(tlf.token_ce(tp, tcfg, _t(x), _t(y), _t(m))),
                               float(jlf.token_ce(jp, cfg, x, y, m)), rtol=1e-5)


def test_window_kernel_route_matches_jax(monkeypatch):
    """RLMG_WINDOW_BACKEND=pallas at S = 1152 > 1024: every layer goes
    through kernel E's wrapper (its plain twin on CPU tensors) on the port
    and through window_attention_pallas on JAX (interpret mode).  The rows
    that see a kept key agree; the LM's loss ignores the others."""
    monkeypatch.setenv("RLMG_WINDOW_BACKEND", "pallas")
    pallas = jwk.window_attention_pallas            # the JAX dispatch, in interpret mode
    monkeypatch.setattr(jwk, "window_attention_pallas",
                        lambda q, k, v, m, window, block, interpret, block_kv:
                        pallas(q, k, v, m, window, block, True, block_kv))
    calls = []
    real = twk.window_attention_band
    monkeypatch.setattr(twk, "window_attention_band",
                        lambda *a: calls.append(a[4]) or real(*a))
    cfg, tcfg = _cfgs()
    jp = _jparams(cfg)
    tp = tw.from_jax_params(jp, device="cpu")
    x, y, m = _batch(b=1, s=1152, seed=6)
    assert m.min() == 0.0                         # padding past the window's reach
    ref = jlf.forward(jp, cfg, x, m)
    ref_ce = jlf.token_ce(jp, cfg, x, y, m)
    valid = m[..., None] > 0
    ours = tlf.forward(tp, tcfg, _t(x), _t(m)).numpy()
    np.testing.assert_allclose(ours * valid, np.asarray(ref) * valid, **TOL)
    np.testing.assert_allclose(float(tlf.token_ce(tp, tcfg, _t(x), _t(y), _t(m))),
                               float(ref_ce), rtol=1e-5)
    assert calls == [cfg.attention_window] * (2 * cfg.n_layer)


def _assert_close_per_leaf(ours, ref, rtol, frac, floor=0.0):
    """Every leaf within rtol, and frac of the leaf's magnitude (at least
    ``floor``)."""
    ours, ref = _flat(ours), _flat(ref)
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-6)
        np.testing.assert_allclose(ours[k], r, rtol=rtol, atol=max(frac * scale, floor),
                                   err_msg=k)


def test_lm_step_matches_jax():
    """One longformer_lm_step at dropout 0 (lr 1e-4, clip 3): the loss to
    1e-6, the gradients to 1e-4 per leaf (with an absolute floor of 1e-7:
    the key bias cannot move a softmax, so its gradient is rounding noise
    of about 1e-10 on both sides), the parameters after Adam to 1e-5 of
    their magnitude."""
    cfg, tcfg = _cfgs(with_score_head=False, with_eval_heads=False)
    jp = _jparams(cfg)
    x, y, m = _batch()
    tp = tw.from_jax_params(jp, device="cpu")
    grads, (tl, tls) = tpre.longformer_grad_step(tp, tcfg, _t(x), _t(y), _t(m), None)

    def loss_fn(p):
        losses = fields_cross_entropy(jlf.token_logits(p, cfg, x, m), y, m)
        return jnp.mean(losses)

    jl, jg = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, jp))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    _assert_close_per_leaf(grads, jax.tree_util.tree_map(np.asarray, jg), 1e-4, 1e-5, 1e-7)

    tx_j, tx_t = jopt.adam(1e-4, grad_clip=3.0), topt.adam(1e-4, grad_clip=3.0)
    jpp = jax.tree_util.tree_map(jnp.asarray, jp)
    jpp, _, (jl2, jls) = jpre.longformer_lm_step(jpp, tx_j.init(jpp), cfg, tx_j, x, y, m,
                                                 jax.random.PRNGKey(0))
    tp, ts, (tl2, tls2) = tpre.longformer_lm_step(tp, tx_t.init(tp), tcfg, tx_t, _t(x), _t(y),
                                                  _t(m), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(tl2), float(jl2), rtol=1e-6)
    np.testing.assert_allclose(tls2.numpy(), np.asarray(jls), rtol=1e-5)
    assert ts.count == 1
    _assert_close_per_leaf(tp, jax.tree_util.tree_map(np.asarray, jpp), 1e-5, 1e-5)


def test_grad_accumulation_is_the_mean_gradient_and_the_loop_takes_the_lm_step(tmp_path):
    cfg, tcfg = _cfgs(with_score_head=False, with_eval_heads=False)
    jp = _jparams(cfg)
    x, y, m = _batch(b=4, seed=8)
    m[:] = 1.0
    tp = tw.from_jax_params(jp, device="cpu")
    whole, _ = tpre.longformer_grad_step(tp, tcfg, _t(x), _t(y), _t(m), None)
    g1, _ = tpre.longformer_grad_step(tp, tcfg, _t(x[:2]), _t(y[:2]), _t(m[:2]), None,
                                      scale=0.5)
    g2, _ = tpre.longformer_grad_step(tp, tcfg, _t(x[2:]), _t(y[2:]), _t(m[2:]), None,
                                      scale=0.5)
    summed = _flat(topt.tree_map(torch.add, g1, g2))
    for k, r in _flat(whole).items():
        np.testing.assert_allclose(summed[k], r, rtol=1e-4, atol=1e-6, err_msg=k)
    # the loop: two micro-batches per optimizer step with the LM step
    pcfg = TC.PretrainConfig(n_epoch=1, batch_size=1, grad_accum=2, log_every=1,
                             ckpt_dir=str(tmp_path / "ck"), exp_dir=str(tmp_path / "exp"))
    _, state, hist = tpre.pretrain(tp, tcfg, x, y, m, pcfg, step_fn=tpre.longformer_lm_step)
    assert state.count == 2 and len(hist) == 1 and np.isfinite(hist[0])
    with pytest.raises(ValueError, match="step_fn"):
        tpre.pretrain(tp, tcfg, x, y, m, pcfg, step_fn=lambda *a: None)


def test_longformer_trees_cross_both_ways(tmp_path):
    """A JAX Longformer checkpoint (params with score and eval heads, rel_emb)
    loads in the port with a port template, the BatchNorm state converts
    unchanged, and a port checkpoint loads in JAX with a JAX template."""
    cfg, tcfg = _cfgs(position_embedding_type="relative_key")
    jp = _jparams(cfg)
    path = str(tmp_path / "jax.ckpt")
    jck.save_checkpoint(path, jp, None, step=3)
    ours = tw.load_jax_checkpoint(path, tlf.init_params(tcfg, device="cpu"), device="cpu")
    for k, v in _flat(jp).items():
        np.testing.assert_array_equal(_flat(ours)[k], v, err_msg=k)
    state = jax.tree_util.tree_map(np.asarray, jlf.init_state(cfg))
    for k, v in _flat(tw.from_jax_params(state, device="cpu")).items():
        np.testing.assert_array_equal(v, _flat(state)[k])
    port_path = str(tmp_path / "port.ckpt")
    tck.save_checkpoint(port_path, ours, step=4, extra={"epoch": 0})
    ck = jck.load_checkpoint(port_path, params_template=jlf.init_params(jax.random.PRNGKey(1),
                                                                        cfg))
    for k, v in _flat(jp).items():
        np.testing.assert_array_equal(_flat(ck["params"])[k], v, err_msg=k)


def test_cli_discrim_pretrain_on_cpu_writes_a_checkpoint_jax_reads(tmp_path):
    """discrim-pretrain at discrim_lm_config's full width (--layers is read
    and unused, as in JAX), one step of one epoch, so the epoch-end
    checkpoint is written; JAX reads it with a Longformer template."""
    res = tcli.main(["discrim-pretrain", "--device", "cpu", "--seq-len", "24",
                     "--synthetic-songs", "2", "--batch-size", "2", "--epochs", "1",
                     "--layers", "2", "--exp-dir", str(tmp_path / "exp"),
                     "--ckpt-dir", str(tmp_path / "ck")])
    assert res["steps"] == 1 and all(np.isfinite(res["batch_losses"] + res["history"]))
    (name,) = os.listdir(tmp_path / "ck")
    mcfg = C.discrim_lm_config(VOCAB, emb_sizes=(128, 256, 64, 512, 256, 128))
    template = jax.eval_shape(lambda: jlf.init_params(jax.random.PRNGKey(0), mcfg))
    ck = jck.load_checkpoint(str(tmp_path / "ck" / name), params_template=template)
    assert ck["params"]["layers"]["wq"]["w"].shape == (12, 512, 512)
    assert ck["params"]["pos_emb"].shape == (4096, 512)
    assert "params amount" in (tmp_path / "exp" / "log.txt").read_text()


@pytest.mark.parametrize("reward", [False, True])
def test_cli_my_pretrain_on_cpu(monkeypatch, tmp_path, reward):
    monkeypatch.chdir(tmp_path)
    flags = ["my-pretrain", "--device", "cpu", "--seq-len", "16", "--synthetic-songs", "2",
             "--batch-size", "2", "--epochs", "1", "--layers", "2", "--reward-layers", "2"]
    res = tcli.main(flags + (["--reward-pretrain"] if reward else []))
    assert res["steps"] == 1 and np.isfinite(res["history"][0])
    root = tmp_path / res["exp_root"]
    assert len(os.listdir(root / "model")) == 1
    assert "params amount" in (root / "log" / "log.txt").read_text()
