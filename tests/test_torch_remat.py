"""``LinearTransformerConfig.remat``: each layer under
``torch.utils.checkpoint`` (JAX ``models/linear_transformer.py``:
``jax.checkpoint`` around each layer), on the CPU.

Remat changes only what the backward keeps, so with the same generator a
step gives the same loss bit for bit, the same gradients to f32 rounding
(rtol 1e-4, atol 1e-6: JAX's own test_remat_train_step_matches_nonremat
tolerance), and leaves the generator in the same state: the recompute
replays the layer's dropout masks and kernel seeds.  Held at dropout 0 and
0.1, at f32 and bf16, on the plain route and on the C + D kernel route
(their plain twins on CPU tensors), and against JAX's remat step at
dropout 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.train import optim as topt
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import dataset as jds
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as jlt

VOCAB = (56, 135, 18, 87, 18, 25)
KW = dict(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=32, n_layer=2, n_head=2,
          d_inner=64, attn_chunk=8)
ROUTES = {"xla": {"RLMG_FFN_BACKEND": "xla", "RLMG_ATTN_BACKEND": "xla"},
          "kernels": {"RLMG_FFN_BACKEND": "pallas-tail", "RLMG_ATTN_BACKEND": "pallas-qkv"}}


def _batch():
    return tuple(torch.from_numpy(a) for a in jds.synthetic_cp_dataset(2, 32, n_class=VOCAB,
                                                                       seed=4))


def _step(params, cfg, batch, generator, dtype):
    """(loss, {leaf: grad}, generator state after the step) of the mean
    per-field CE, the params cast to ``dtype`` for the forward."""
    ps = topt.tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    loss = tlt.train_losses(tlt.cast_params(ps, dtype), cfg, *batch, deterministic=False,
                            generator=generator).mean()
    loss.backward()
    return loss.detach(), tw._flat(topt.tree_map(lambda t: t.grad, ps)), generator.get_state()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_remat_step_equals_the_step_without_it(monkeypatch, route, dropout, dtype):
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    runs = []
    real = tlt._layer_forward
    monkeypatch.setattr(tlt, "_layer_forward", lambda *a: runs.append(1) or real(*a))
    params = tlt.init_params(TC.LinearTransformerConfig(**KW), seed=0, device="cpu")
    batch = _batch()
    out = {}
    for remat in (False, True):
        cfg = TC.LinearTransformerConfig(**KW, dropout=dropout, remat=remat)
        runs.clear()
        out[remat] = _step(params, cfg, batch, torch.Generator().manual_seed(7), dtype)
        # the backward ran every layer again, from its input
        assert len(runs) == cfg.n_layer * (2 if remat else 1), (remat, len(runs))
    (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
    assert torch.equal(l0, l1), (l0, l1)
    assert torch.equal(s0, s1)
    assert sorted(g0) == sorted(g1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-4, atol=1e-6, msg=k)


def test_a_recompute_that_draws_new_masks_is_seen(monkeypatch):
    """The check above can fail: a checkpoint whose recompute draws from the
    caller's generator (new masks, the naive port) gives other gradients at
    dropout 0.1 and leaves the generator elsewhere."""
    for k, v in ROUTES["xla"].items():
        monkeypatch.setenv(k, v)
    params = tlt.init_params(TC.LinearTransformerConfig(**KW), seed=0, device="cpu")
    batch = _batch()
    cfg = TC.LinearTransformerConfig(**KW, dropout=0.1, remat=True)
    _, g_ok, s_ok = _step(params, cfg, batch, torch.Generator().manual_seed(7), torch.float32)
    layer = tlt._layer_forward

    def naive(cfg_, h, lp, generator, deterministic, attn_backend, dp_mesh=None, rows=(0, 1)):
        return torch.utils.checkpoint.checkpoint(
            lambda h_, lp_: layer(cfg_, h_, lp_, generator, deterministic, attn_backend,
                                  dp_mesh, rows), h, lp, use_reentrant=False)

    monkeypatch.setattr(tlt, "_remat_layer", naive)
    _, g_bad, s_bad = _step(params, cfg, batch, torch.Generator().manual_seed(7), torch.float32)
    assert not torch.equal(s_bad, s_ok)
    assert any(not torch.allclose(g_bad[k], g_ok[k], rtol=1e-4, atol=1e-6) for k in g_ok)


def test_remat_step_matches_jax_remat_step():
    """Dropout 0: the port's remat step and JAX's (``jax.checkpoint`` per
    layer) agree: per-field losses to 1e-5 relative, every gradient within
    rtol 1e-4 and 1e-6 of its leaf's largest."""
    kw = dict(KW, dropout=0.0, remat=True)
    cfg, tcfg = C.LinearTransformerConfig(**kw), TC.LinearTransformerConfig(**kw)
    jp = jax.tree_util.tree_map(np.asarray, jlt.init_params(jax.random.PRNGKey(3), cfg))
    x, y, m = jds.synthetic_cp_dataset(2, 32, n_class=VOCAB, seed=4)
    tp = tw.from_jax_params(jp, device="cpu")
    ps = topt.tree_map(lambda t: t.requires_grad_(True), tp)
    losses = tlt.train_losses(ps, tcfg, *(torch.from_numpy(a) for a in (x, y, m)),
                              deterministic=True)
    losses.mean().backward()

    def loss_fn(p):
        ls = jlt.train_losses(p, cfg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                              deterministic=True)
        return jnp.mean(ls), ls

    (_, jls), jg = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jp))
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(jls), rtol=1e-5)
    ours = tw._flat(topt.tree_map(lambda t: t.grad, ps))
    for key, ref in tw._flat(jax.tree_util.tree_map(np.asarray, jg)).items():
        np.testing.assert_allclose(ours[key].numpy(), ref, rtol=1e-4,
                                   atol=1e-6 * max(float(np.abs(ref).max()), 1.0), err_msg=key)
