"""The port's training slice against the JAX package, on the CPU: the
parallel forward on both routes, the losses, Adam with clipping, three
train steps, the data, the loop's helpers, checkpoints and the CLI.

Small config (d_model 32, 2 layers, 2 heads, FFN 64, chunk 8, B 2, S 32).
The routes are forced with the JAX package's own knobs: RLMG_FFN_BACKEND=
pallas-tail with RLMG_ATTN_BACKEND=pallas-qkv runs the JAX Pallas kernels
in interpret mode (RLMG_*_INTERPRET=1) and the port's kernel wrappers,
which on CPU tensors run their plain versions; RLMG_FFN_BACKEND=xla runs
both compositions.  Forward values agree to 1e-4 (the bound
tests/test_torch_parity.py holds), three Adam steps to 1e-5 relative."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.apps import cli as tcli
from reinforcement_learning_in_music_generation_torch.data import dataset as tds
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.ops import losses as tloss
from reinforcement_learning_in_music_generation_torch.parallel.mesh import Mesh
from reinforcement_learning_in_music_generation_torch.train import data_pipeline as tdp
from reinforcement_learning_in_music_generation_torch.train import optim as topt
from reinforcement_learning_in_music_generation_torch.train import pretrain as tpre
from reinforcement_learning_in_music_generation_torch.utils import checkpoint as tck
from reinforcement_learning_in_music_generation_torch.utils import saver as tsv
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import dataset as jds
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as lt
from reinforcement_learning_in_music_generation_tpu.ops import losses as jloss
from reinforcement_learning_in_music_generation_tpu.train import optim as jopt
from reinforcement_learning_in_music_generation_tpu.train import pretrain as jpre
from reinforcement_learning_in_music_generation_tpu.train.data_pipeline import prefetch_batches
from reinforcement_learning_in_music_generation_tpu.utils import checkpoint as jck
from reinforcement_learning_in_music_generation_tpu.utils import saver as jsv

VOCAB = (56, 135, 18, 87, 18, 25)
KW = dict(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=32, n_layer=2, n_head=2,
          d_inner=64, attn_chunk=8, dropout=0.0)
CFG, TCFG = C.LinearTransformerConfig(**KW), TC.LinearTransformerConfig(**KW)
B, S = 2, 32

ROUTES = {
    "xla": {"RLMG_FFN_BACKEND": "xla", "RLMG_ATTN_BACKEND": "xla"},
    "kernels": {"RLMG_FFN_BACKEND": "pallas-tail", "RLMG_ATTN_BACKEND": "pallas-qkv",
                "RLMG_FFN_INTERPRET": "1", "RLMG_ATTN_INTERPRET": "1"},
}


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(np.asarray, lt.init_params(jax.random.PRNGKey(3), CFG))


@pytest.fixture(scope="module")
def batch():
    x, y, m = jds.synthetic_cp_dataset(B, S, n_class=VOCAB, seed=4)
    return x, y, m


def _route(monkeypatch, name):
    for k, v in ROUTES[name].items():
        monkeypatch.setenv(k, v)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach().numpy() if torch.is_tensor(tree) else tree)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_forward_hidden_and_train_losses_match_jax(monkeypatch, jparams, batch, route):
    _route(monkeypatch, route)
    x, y, m = batch
    tp = tw.from_jax_params(jparams, device="cpu")
    ours = tlt.forward_hidden(tp, TCFG, _t(x))
    ref = lt.forward_hidden(jparams, CFG, jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    ours_l = tlt.train_losses(tp, TCFG, _t(x), _t(y), _t(m), deterministic=True)
    ref_l = lt.train_losses(jparams, CFG, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                            deterministic=True)
    np.testing.assert_allclose(ours_l.numpy(), np.asarray(ref_l), rtol=1e-4, atol=1e-4)


def test_routes_pick_the_kernels_by_device_and_rows(monkeypatch):
    monkeypatch.delenv("RLMG_FFN_BACKEND", raising=False)
    monkeypatch.delenv("RLMG_FFN_MIN_ROWS", raising=False)
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert tlt._ffn_backend(8192, cuda) == "pallas-tail"
    assert tlt._ffn_backend(8191, cuda) == "xla"
    assert tlt._ffn_backend(16384, cpu) == "xla"
    monkeypatch.setenv("RLMG_FFN_MIN_ROWS", "64")
    assert tlt._ffn_backend(64, cuda) == "pallas-tail"
    monkeypatch.setenv("RLMG_FFN_BACKEND", "xla")
    assert tlt._ffn_backend(16384, cuda) == "xla"
    monkeypatch.setenv("RLMG_FFN_BACKEND", "fused")
    with pytest.raises(ValueError, match="RLMG_FFN_BACKEND"):
        tlt._ffn_backend(16384, cuda)


def test_qkv_route_follows_the_jax_rule_only(monkeypatch):
    """Kernel C is refused for the JAX rule's reasons alone (odd head
    count, ragged chunk); a head width the CUDA kernel does not take goes
    to the kernel's wrapper, which raises on a card, and not quietly to
    the composition."""
    calls = []
    monkeypatch.setattr(tlt, "qkv_attention_block",
                        lambda h, w, b, n_seq, n_head, **kw: calls.append(n_head) or h)
    for d, n_head, s, taken in ((144, 2, 16, True), (96, 3, 16, False),
                                (32, 2, 12, False), (32, 2, 16, True)):
        cfg = TC.LinearTransformerConfig(**{**KW, "d_model": d, "n_head": n_head})
        lp = {n: {"w": torch.zeros((d, d)), "b": torch.zeros(d)} for n in ("wq", "wk", "wv")}
        out = tlt._qkv_attention_call(cfg, lp, torch.zeros((2, s, d)))
        assert (out is not None) == taken, (d, n_head, s)
    assert calls == [2, 2]


def test_unported_options_raise(monkeypatch, jparams, batch):
    x, y, m = batch
    tp = tw.from_jax_params(jparams, device="cpu")
    # RLMG_FFN_BACKEND=pallas is ported (kernel G; its plain twin on CPU
    # tensors): the JAX ffn_block route, run in interpret mode, to 1e-4
    monkeypatch.setenv("RLMG_FFN_BACKEND", "pallas")
    monkeypatch.setenv("RLMG_FFN_INTERPRET", "1")
    monkeypatch.setenv("RLMG_ATTN_BACKEND", "xla")
    np.testing.assert_allclose(tlt.forward_hidden(tp, TCFG, _t(x)).numpy(),
                               np.asarray(lt.forward_hidden(jparams, CFG, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)
    # RLMG_ATTN_BACKEND=pallas is ported (kernel F; its plain twin on CPU
    # tensors, the same chunked core as xla)
    monkeypatch.setenv("RLMG_FFN_BACKEND", "xla")
    plain = tlt.forward_hidden(tp, TCFG, _t(x))
    monkeypatch.setenv("RLMG_ATTN_BACKEND", "pallas")
    torch.testing.assert_close(tlt.forward_hidden(tp, TCFG, _t(x)), plain, rtol=0, atol=0)
    # remat is ported (each layer under torch.utils.checkpoint, which keeps
    # only the layer's input): the forward is the same, bit for bit
    # (tests/test_torch_remat.py holds its step)
    torch.testing.assert_close(
        tlt.forward_hidden(tp, TC.LinearTransformerConfig(**KW, remat=True), _t(x)), plain,
        rtol=0, atol=0)
    # data, tensor and pipeline parallelism, ZeRO-1 and the sharded
    # checkpoint are ported (tests/test_torch_parallel.py,
    # tests/test_torch_tensor_parallel.py, tests/test_torch_pipeline_parallel.py,
    # tests/test_torch_checkpoint.py): a checkpoint backend neither "pickle"
    # nor "orbax" raises, ZeRO-1 without a dp > 1 mesh and ZeRO-1 on a mesh
    # with a pp axis raise JAX's ValueErrors
    pp_mesh = Mesh({"dp": 2, "pp": 2, "tp": 1}, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="ckpt_backend='msgpack'"):
        tpre.pretrain(tp, TCFG, x, y, m, TC.PretrainConfig(ckpt_backend="msgpack"))
    with pytest.raises(ValueError, match="pipeline mesh"):
        tpre.pretrain(tp, TCFG, x, y, m, TC.PretrainConfig(zero1=True), mesh=pp_mesh)
    with pytest.raises(ValueError, match="dp>1"):
        tpre.pretrain(tp, TCFG, x, y, m, TC.PretrainConfig(zero1=True))
    with pytest.raises(SystemExit):
        tcli.main(["pretrain", "--device", "cpu", "--synthetic", "--pp", "2",
                   "--ckpt-backend", "msgpack"])


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
    tgt = rng.integers(0, 11, (2, 7))
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        tloss.masked_cross_entropy(_t(logits), _t(tgt), _t(mask)).numpy(),
        np.asarray(jloss.masked_cross_entropy(logits, tgt, mask)), rtol=1e-6)
    np.testing.assert_allclose(
        tloss.masked_cross_entropy(_t(logits), _t(tgt), torch.zeros(2, 7)).numpy(), 0.0)
    pred = rng.random(13).astype(np.float32)
    pred[0], pred[1] = 0.0, 1.0
    t = (rng.random(13) > 0.5).astype(np.float32)
    np.testing.assert_allclose(tloss.binary_cross_entropy(_t(pred), _t(t)).numpy(),
                               np.asarray(jloss.binary_cross_entropy(pred, t)), rtol=1e-5)


def test_schedules_match_optax():
    ours, ref = topt.multistep_lr(0.1, (3, 7, 7)), jopt.multistep_lr(0.1, (3, 7, 7))
    ours_s, ref_s = topt.step_lr(0.1, 4, 0.5), jopt.step_lr(0.1, 4, 0.5)
    for count in range(12):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6)
        np.testing.assert_allclose(ours_s(count), float(ref_s(count)), rtol=1e-6)


def _assert_params_close(tp, jp):
    """Every leaf within 1e-5 of its own magnitude."""
    ours, ref = _flat(tp), _flat(jp)
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-6)
        np.testing.assert_allclose(ours[k], r, rtol=1e-5, atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_three_train_steps_match_jax(monkeypatch, jparams, batch, route):
    """Losses and every parameter after 3 Adam steps (lr 1e-4, clip 3,
    dropout 0) agree with JAX's agent_train_step to 1e-5 relative."""
    _route(monkeypatch, route)
    x, y, m = batch
    tx_j = jopt.adam(1e-4, grad_clip=3.0)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    js = tx_j.init(jp)
    tp = tw.from_jax_params(jparams, device="cpu")
    tx_t = topt.adam(1e-4, grad_clip=3.0)
    ts = tx_t.init(tp)
    gen = torch.Generator().manual_seed(0)
    for step in range(3):
        jp, js, (jl, jls) = jpre.agent_train_step(jp, js, CFG, tx_j, jnp.asarray(x),
                                                  jnp.asarray(y), jnp.asarray(m),
                                                  jax.random.PRNGKey(step))
        tp, ts, (tl, tls) = tpre.agent_train_step(tp, ts, TCFG, tx_t, _t(x), _t(y), _t(m), gen)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        np.testing.assert_allclose(tls.numpy(), np.asarray(jls), rtol=1e-5)
    assert ts.count == 3
    _assert_params_close(tp, jax.tree_util.tree_map(np.asarray, jp))


def test_clipping_engages_as_in_optax(monkeypatch, jparams, batch):
    """With a tiny max_norm the gradients are rescaled every step; the
    result still follows JAX's optax chain."""
    _route(monkeypatch, "xla")
    x, y, m = batch
    tx_j = jopt.adam(1e-3, grad_clip=1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    js = tx_j.init(jp)
    tp = tw.from_jax_params(jparams, device="cpu")
    tx_t = topt.adam(1e-3, grad_clip=1e-3)
    ts = tx_t.init(tp)
    grads, _ = tpre.agent_grad_step(tp, TCFG, _t(x), _t(y), _t(m), None)
    g_norm = float(torch.sqrt(sum((g * g).sum() for g in topt.tree_leaves(grads))))
    assert g_norm > 1e-3                      # so the clip rescales
    for step in range(2):
        jp, js, _ = jpre.agent_train_step(jp, js, CFG, tx_j, jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(m), jax.random.PRNGKey(step))
        tp, ts, _ = tpre.agent_train_step(tp, ts, TCFG, tx_t, _t(x), _t(y), _t(m), None)
    _assert_params_close(tp, jax.tree_util.tree_map(np.asarray, jp))


def test_grad_accumulation_is_the_mean_gradient(monkeypatch, jparams):
    """Two half-scaled micro-gradients sum to the gradient of the batch of
    both (equal masks), as in the JAX loop."""
    _route(monkeypatch, "xla")
    x, y, m = jds.synthetic_cp_dataset(4, S, n_class=VOCAB, seed=8)
    m[:] = 1.0
    tp = tw.from_jax_params(jparams, device="cpu")
    whole, _ = tpre.agent_grad_step(tp, TCFG, _t(x), _t(y), _t(m), None)
    g1, _ = tpre.agent_grad_step(tp, TCFG, _t(x[:2]), _t(y[:2]), _t(m[:2]), None, scale=0.5)
    g2, _ = tpre.agent_grad_step(tp, TCFG, _t(x[2:]), _t(y[2:]), _t(m[2:]), None, scale=0.5)
    summed = topt.tree_map(torch.add, g1, g2)
    for k, r in _flat(whole).items():
        np.testing.assert_allclose(_flat(summed)[k], r, rtol=1e-4, atol=1e-6, err_msg=k)


def test_synthetic_dataset_is_bit_equal_to_jax():
    for n_class in (VOCAB, (56, 135, 18, 3, 87, 18, 25)):
        ours = tds.synthetic_cp_dataset(5, 48, n_class=n_class, seed=11)
        ref = jds.synthetic_cp_dataset(5, 48, n_class=n_class, seed=11)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_batches_order_matches_jax(depth):
    x, y, m = jds.synthetic_cp_dataset(7, 16, n_class=VOCAB, seed=2)
    ours = list(tdp.prefetch_batches(x, y, m, 2, "cpu", depth=depth))
    ref = list(prefetch_batches(x, y, m, 2, depth=depth))
    assert [i for i, _ in ours] == [i for i, _ in ref] == [0, 1, 2]
    for (_, tb), (_, jb) in zip(ours, ref):
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_loss_bucket_filenames_match_jax_at_the_edges():
    for loss in (0.0, 0.05, 0.0500001, 0.1, 0.399, 0.4, 0.4000001, 0.55, 0.8, 0.8000001,
                 1.5, 12.25):
        assert tsv.loss_bucket_filename(loss) == jsv.loss_bucket_filename(loss), loss


def test_port_checkpoint_loads_in_jax_and_resumes(tmp_path, jparams):
    tp = tw.from_jax_params(jparams, device="cpu")
    tx = topt.adam(1e-4, grad_clip=3.0)
    state = tx.init(tp)
    state = topt.AdamState(topt.tree_map(lambda t: t + 1.0, state.mu), state.nu, 7)
    path = str(tmp_path / "a.ckpt")
    tck.save_checkpoint(path, tp, state, step=9, extra={"epoch": 2})
    ck = jck.load_checkpoint(path, params_template=lt.init_params(jax.random.PRNGKey(0), CFG))
    for k, v in _flat(jparams).items():
        np.testing.assert_array_equal(_flat(ck["params"])[k], v, err_msg=k)
    assert ck["step"] == 9 and ck["extra"] == {"epoch": 2}
    back = tck.load_checkpoint(path, params_template=tp, opt_state_template=state,
                               device="cpu")
    assert back["opt_state"].count == 7
    for k, v in _flat(state.mu).items():
        np.testing.assert_array_equal(_flat(back["opt_state"].mu)[k], v, err_msg=k)
    same = tw.load_jax_checkpoint(path, tp, device="cpu")
    for k, v in _flat(jparams).items():
        np.testing.assert_array_equal(_flat(same)[k], v, err_msg=k)


def test_pretrain_loop_checkpoints_and_resumes(monkeypatch, tmp_path, jparams):
    _route(monkeypatch, "xla")
    x, y, m = jds.synthetic_cp_dataset(4, S, n_class=VOCAB, seed=1)
    pcfg = TC.PretrainConfig(n_epoch=1, batch_size=2, ckpt_dir=str(tmp_path / "ck"),
                             exp_dir=str(tmp_path / "exp"), log_every=1)
    tp = tw.from_jax_params(jparams, device="cpu")
    _, state, hist = tpre.pretrain(tp, TCFG, x, y, m, pcfg)
    assert len(hist) == 1 and state.count == 2
    ckpts = sorted(os.listdir(tmp_path / "ck"))
    assert ckpts == [jsv.loss_bucket_filename(hist[0]) + ".ckpt"]
    pcfg2 = TC.PretrainConfig(n_epoch=2, batch_size=2, ckpt_dir=str(tmp_path / "ck"),
                              exp_dir=str(tmp_path / "exp2"))
    _, state2, hist2 = tpre.pretrain(tw.from_jax_params(jparams, device="cpu"), TCFG, x, y, m,
                                     pcfg2, resume_from=str(tmp_path / "ck" / ckpts[0]))
    assert len(hist2) == 1 and state2.count == 4       # epoch 1 only, on top of 2 steps
    log = (tmp_path / "exp" / "log.txt").read_text()
    assert "batch loss" in log and "epoch loss" in log and "params amount" in log


def test_cli_pretrain_on_cpu_writes_its_log(tmp_path):
    res = tcli.main(["pretrain", "--device", "cpu", "--synthetic", "--layers", "2",
                     "--max-steps", "2", "--synthetic-songs", "4", "--batch-size", "2",
                     "--seq-len", "32", "--exp-dir", str(tmp_path / "exp"),
                     "--ckpt-dir", str(tmp_path / "ck")])
    assert res["steps"] == 2 and len(res["batch_losses"]) == 1
    assert all(np.isfinite(res["batch_losses"]))
    log = (tmp_path / "exp" / "log.txt").read_text()
    assert "params amount" in log and "batch loss" in log


def test_embedding_backward_is_an_embedding_lookup(jparams, batch):
    """The field embeddings go through an embedding lookup, whose backward
    reduces repeated ids in segments; the backward of ``table[ids]`` walks
    each run of repeated ids serially and took 16% of a train step on the
    card (PERF.md, PR 2).  Gradients still match JAX's."""
    from reinforcement_learning_in_music_generation_torch.models import common as tcm
    from reinforcement_learning_in_music_generation_tpu.models import common as jcm
    x = batch[0]
    tp = tw.from_jax_params(jparams, device="cpu")
    emb = {k: v.requires_grad_(True) for k, v in tp["emb"].items()}
    out = tcm.embed_fields(emb, _t(x))
    nodes, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and type(fn).__name__ not in nodes:
            nodes.add(type(fn).__name__)
            todo += [f for f, _ in fn.next_functions]
    assert "EmbeddingBackward0" in nodes and "IndexBackward0" not in nodes, nodes
    w = np.random.default_rng(0).standard_normal(out.shape).astype(np.float32)
    (out * _t(w)).sum().backward()
    ref = jax.grad(lambda e: jnp.sum(jcm.embed_fields(e, jnp.asarray(x)) * w))(
        jparams["emb"])
    for k in emb:
        np.testing.assert_allclose(emb[k].grad.numpy(), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
