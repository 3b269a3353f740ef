"""The port's tensor parallelism against the JAX package's (dp, tp) mesh and
against one process, on the CPU.

The port's ranks run in gloo process groups that ``parallel.launch``
spawns: dp = 1 x tp = 2 (two ranks) and dp = 2 x tp = 2 (four ranks), each
rank a fresh interpreter running a function of tests/torch_tp_workers.py,
which imports no jax; every tree of tp shards comes back whole
(``parallel.gather_params``).  The JAX side runs ``make_mesh(dp, tp)`` on
the suite's 8 virtual CPU devices as one GSPMD program.  Small config of
tests/test_torch_parallel.py (d_model 32, 2 layers, 2 heads, FFN 64,
embeddings 8, dropout 0), B 8 x S 16 with unequal mask sums over dp, Adam
with a clip at ``W.CLIP`` below the first gradient's norm, so that it
engages; generation at JAX's TINY (tests/test_sharded_generation.py).

Tolerances: losses rtol 1e-5, every gathered gradient (and clipped
gradient) rtol 1e-4 / atol 1e-6, gathered parameters within 1e-5 of each
leaf's magnitude; ZeRO-1 bit for bit against plain Adam on the same mesh;
greedy tokens equal.  Three controls, each a fault the gates must catch,
fall outside them: the mask sum all-reduced over the world, the clip by a
rank's local norm, and ``torch.distributed.nn.functional.all_reduce`` in
place of ``reduce_from_tp``.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_tp_workers as W
from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.apps import cli as tcli
from reinforcement_learning_in_music_generation_torch.generate import sampler as tsam
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.models import longformer as tlf
from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
from reinforcement_learning_in_music_generation_torch.train import optim as topt
from reinforcement_learning_in_music_generation_torch.train import pretrain as tpre
from reinforcement_learning_in_music_generation_torch.utils import checkpoint as tck
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import dataset as jds
from reinforcement_learning_in_music_generation_tpu.generate import sampler as jsam
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as jlt
from reinforcement_learning_in_music_generation_tpu.parallel import make_mesh, shard_batch
from reinforcement_learning_in_music_generation_tpu.parallel import sharding as jsh
from reinforcement_learning_in_music_generation_tpu.train import optim as jopt
from reinforcement_learning_in_music_generation_tpu.train import pretrain as jpre
from reinforcement_learning_in_music_generation_tpu.utils import checkpoint as jck

CFG = C.LinearTransformerConfig(**W.DW.KW)
TINY = C.LinearTransformerConfig(vocab_sizes=(8,) * 6, emb_sizes=(8,) * 6, d_model=16,
                                 n_layer=1, n_head=2, d_inner=32)
VOCAB = W.CFG.vocab_sizes
B, S = 8, 16
LAUNCH_S = 240
MESHES = [("tp2", 1, 2), ("dp2tp2", 2, 2)]


def _masked(x, y, m, valid_tail):
    m = np.ones_like(m, dtype=np.float32)
    m[len(m) // 2:, valid_tail:] = 0.0
    return x, y, m


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(np.asarray, jlt.init_params(jax.random.PRNGKey(0), CFG))


@pytest.fixture(scope="module")
def tiny_jparams():
    return jax.tree_util.tree_map(np.asarray, jlt.init_params(jax.random.PRNGKey(0), TINY))


@pytest.fixture(scope="module")
def batch():
    return _masked(*jds.synthetic_cp_dataset(B, S, n_class=VOCAB, seed=4), valid_tail=3)


@pytest.fixture(scope="module")
def data():
    return _masked(*jds.synthetic_cp_dataset(24, S, n_class=VOCAB, seed=6), valid_tail=7)


@pytest.fixture(scope="module")
def prompt():
    rows = np.random.default_rng(8).integers(0, 8, (20, 6))
    rows[0] = (0, 0, 1, 0, 0, 0)
    return rows


def _one_process_run(jparams, data, pcfg, resume=None):
    p = tw.from_jax_params(jparams, device="cpu")
    return tpre.pretrain(p, W.CFG, *data, pcfg, resume_from=resume)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tp"))


@pytest.fixture(scope="module")
def ckpt_tp1(jparams, data, work):
    """One epoch of 16 rows in one process: the checkpoint a tp = 2 run
    resumes from."""
    two = tuple(a[:16] for a in data)
    _one_process_run(jparams, two, W._mkcfg(work, "tp1", n_epoch=1))
    (name,) = os.listdir(os.path.join(work, "tp1", "ckpt"))
    return os.path.join(work, "tp1", "ckpt", name)


CLI_PRETRAIN = ["pretrain", "--device", "cpu", "--synthetic", "--layers", "1",
                "--synthetic-songs", "4", "--batch-size", "4", "--seq-len", "16", "--epochs", "1",
                "--tp", "2"]
CLI_GENERATE = ["generate", "--songs", "2", "--layers", "1", "--bars", "2", "--max-tokens",
                "8", "--device", "cpu", "--greedy", "--dtype", "float32"]


@pytest.fixture(scope="module")
def launched(jparams, batch, data, tiny_jparams, prompt, ckpt_tp1, work):
    """The file's launches, started together in the background so that
    their ranks run while the JAX references compute: the two meshes' rank
    functions, and ``cli pretrain --tp 2`` and ``cli generate --tp 2`` (two
    ranks each, one intra-op thread a rank)."""
    cli = lambda argv: tcli.main(argv)
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(4) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield {"tp2": pool.submit(pm.launch, W.tp2, 2,
                                  (jparams, batch, data, tiny_jparams, prompt, ckpt_tp1,
                                   os.path.join(work, "r2")), timeout_s=LAUNCH_S),
               "dp2tp2": pool.submit(pm.launch, W.dp2tp2, 4,
                                     (jparams, batch, data, tiny_jparams, prompt,
                                      os.path.join(work, "r4")), timeout_s=LAUNCH_S),
               "cli_pretrain": pool.submit(cli, CLI_PRETRAIN + [
                   "--exp-dir", os.path.join(work, "cli", "e"),
                   "--ckpt-dir", os.path.join(work, "cli", "c")]),
               "cli_generate": pool.submit(cli, CLI_GENERATE + [
                   "--tp", "2", "--out-dir", os.path.join(work, "cli", "g")])}


def _ranks(launched, key):
    out = launched[key].result()
    dp, tp = {"tp2": (1, 2), "dp2tp2": (2, 2)}[key]
    assert [(r["rank"], r["dp_index"], r["tp_index"]) for r in out] == \
        [(i, i // tp, i % tp) for i in range(dp * tp)]
    return out


@pytest.fixture(autouse=True)
def plain_route(monkeypatch):
    for k, v in W.ROUTES["xla"].items():
        monkeypatch.setenv(k, v)


def _flat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {"".join(f"/{k.key}" for k in kp): np.asarray(v) for kp, v in leaves}


def _grads_close(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(ours[k], r, rtol=1e-4, atol=1e-6, err_msg=k)


def _params_close(ours, ref):
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-6)
        np.testing.assert_allclose(ours[k], r, rtol=1e-5, atol=1e-5 * scale, err_msg=k)


_JAX = {}


def _jax_step(jparams, batch, dp, tp):
    """JAX's first gradient (whole and clipped) and one train step on
    make_mesh(dp, tp), cached for the file."""
    if (dp, tp) not in _JAX:
        mesh = make_mesh(dp, tp)
        jp = jsh.shard_params(mesh, jax.tree_util.tree_map(jnp.asarray, jparams))
        x, y, m = shard_batch(mesh, (jnp.asarray(batch[0]), jnp.asarray(batch[1]),
                                     jnp.asarray(batch[2], jnp.float32)))
        grads, (loss0, fields0) = jpre.agent_grad_step(jp, CFG, x, y, m, jax.random.PRNGKey(0),
                                                       dp_mesh=mesh)
        clip = optax.clip_by_global_norm(W.CLIP)
        clipped, _ = clip.update(grads, clip.init(grads))
        tx = jopt.adam(1e-4, grad_clip=W.CLIP)
        p1, _, _ = jpre.agent_train_step(jp, tx.init(jp), CFG, tx, x, y, m,
                                         jax.random.PRNGKey(0), dp_mesh=mesh)
        _JAX[dp, tp] = {"loss0": float(loss0), "fields0": np.asarray(fields0),
                        "grads": _flat(grads), "clipped": _flat(clipped),
                        "norm": float(optax.global_norm(grads)), "params": _flat(p1)}
    return _JAX[dp, tp]


@pytest.fixture(scope="module")
def one(jparams, batch):
    """The same gradient and step in one process of the port, on each
    route."""
    out = {}
    x, y, m = (torch.from_numpy(a) for a in batch)
    for route, env in W.ROUTES.items():
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            p = tw.from_jax_params(jparams, device="cpu")
            grads, (loss0, fields0) = tpre.agent_grad_step(p, W.CFG, x.long(), y.long(), m,
                                                           None)
            tx = topt.adam(1e-4, grad_clip=W.CLIP)
            clipped = tx.clip(grads)
            p1, st, _ = tpre.agent_train_step(p, tx.init(p), W.CFG, tx, x.long(), y.long(), m,
                                              None)
        out[route] = {"loss0": float(loss0), "fields0": fields0.numpy(),
                      "grads": W.DW.flat(grads), "clipped": W.DW.flat(clipped),
                      "params": W.DW.flat(p1), "mu": W.DW.flat(st.mu)}
    return out


def _held(r, ref, mu=None):
    np.testing.assert_allclose(r["loss0"], ref["loss0"], rtol=1e-5)
    np.testing.assert_allclose(r["fields0"], ref["fields0"], rtol=1e-5)
    _grads_close(r["grads"], ref["grads"])
    _grads_close(r["clipped"], ref["clipped"])
    _params_close(r["params"], ref["params"])
    if mu is not None:
        _grads_close(r["mu"], mu)


@pytest.mark.parametrize("key,dp,tp", MESHES)
def test_tp_step_matches_jax_mesh_and_one_process(launched, jparams, batch, one, key, dp, tp):
    """One agent step on the plain route at tp = 2 and dp = 2 x tp = 2: the
    loss, every gathered gradient, the clipped gradient and the parameters
    after Adam equal JAX's on make_mesh(dp, tp) and one process's; the clip
    engaged (the norm is above it, the same on every rank); C, D, G and F
    ran no time."""
    ref, one = _jax_step(jparams, batch, dp, tp), one["xla"]
    assert ref["norm"] > 2 * W.CLIP
    for r in _ranks(launched, key):
        assert r["xla"]["rows"] == B // dp
        np.testing.assert_allclose(r["xla"]["norm"], ref["norm"], rtol=1e-5)
        _held(r["xla"], ref)
        _held(r["xla"], one, mu=one["mu"])
        assert r["xla"]["calls"] == {"C": 0, "D": 0, "G": 0, "F": 0}


@pytest.mark.parametrize("key,dp,tp", MESHES)
def test_tp_step_on_kernel_f_route(launched, jparams, batch, one, key, dp, tp):
    """The same step under RLMG_ATTN_BACKEND=pallas: every layer's attention
    went through kernel F's wrapper on the rank's n_head / tp heads (its
    plain twin on CPU tensors, held against JAX's Pallas kernel by
    tests/test_torch_causal_product.py), once a layer; the results equal
    JAX's mesh step (the same function) and one process on the F route."""
    ref, one = _jax_step(jparams, batch, dp, tp), one["f"]
    for r in _ranks(launched, key):
        _held(r["f"], ref)
        _held(r["f"], one, mu=one["mu"])
        assert r["f"]["calls"] == {"C": 0, "D": 0, "G": 0, "F": CFG.n_layer}


@pytest.mark.parametrize("key,dp,tp", MESHES)
def test_ranks_hold_only_their_shards(launched, jparams, key, dp, tp):
    """Each rank's parameters: every leaf JAX's spec splits over "tp" has
    1/tp of the whole along that dimension, every other leaf is whole."""
    specs = jax.tree_util.tree_leaves_with_path(
        jsh.param_specs(jax.tree_util.tree_map(jnp.asarray, jparams)),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    specs = {"".join(f"/{k.key}" for k in kp): tuple(v) for kp, v in specs}
    whole = _flat(jparams)
    n_split = sum("tp" in v for v in specs.values())
    assert n_split >= 20
    split = 0
    for r in _ranks(launched, key):
        assert sorted(r["shapes"]) == sorted(whole)
        for k, v in whole.items():
            want = list(v.shape)
            if "tp" in specs[k]:
                want[specs[k].index("tp")] //= tp
                split += 1
            assert tuple(r["shapes"][k]) == tuple(want), k
    assert split == dp * tp * n_split


def test_ranks_import_no_jax(launched):
    for key in ("tp2", "dp2tp2"):
        assert all(r["modules"] == [] for r in _ranks(launched, key))


def test_pretrain_loop_dp2_tp2_matches_jax_loop(launched, jparams, data, tmp_path):
    """pretrain(mesh=...) for two epochs of 8-row batches at dp = 2 x tp = 2
    (the case of tests/test_train_generate.py's tp loop): the epoch losses
    and the parameters equal JAX's loop on make_mesh(2, 2)."""
    pcfg = C.PretrainConfig(n_epoch=2, batch_size=8, grad_clip=W.CLIP,
                            ckpt_dir=str(tmp_path / "c"), exp_dir=str(tmp_path / "e"))
    jp, _, hist = jpre.pretrain(jax.tree_util.tree_map(jnp.asarray, jparams), CFG,
                                *data, pcfg, mesh=make_mesh(2, 2))
    for r in _ranks(launched, "dp2tp2"):
        np.testing.assert_allclose(r["loop"]["history"], hist, rtol=1e-5)
        _params_close(r["loop"]["params"], _flat(jp))


def test_zero1_under_dp2_tp2_is_bit_equal_to_adam(launched, jparams):
    """Three loop steps with ZeRO-1 at dp = 2 x tp = 2 end on the same
    parameters, bit for bit, as plain Adam on the same mesh; each rank holds
    its tp shard of ffn1's moments, halved along the axis JAX's zero1_specs
    gives "dp"."""
    spec = tuple(jsh.zero1_specs(make_mesh(2, 2), jax.tree_util.tree_map(
        jnp.asarray, jparams))["layers"]["ffn1"]["w"])
    want = list(jparams["layers"]["ffn1"]["w"].shape)
    want[spec.index("dp")] //= 2
    want[spec.index("tp")] //= 2
    for r in _ranks(launched, "dp2tp2"):
        z = r["zero1"]
        for k, v in z["plain"].items():
            np.testing.assert_array_equal(z["zero1"][k], v, err_msg=k)
        assert z["mu_ffn1"] == tuple(want)


def test_remat_under_tp2_equals_the_step_without_it(launched):
    """cfg.remat at tp = 2, dropout 0.1, the same generator seed: the loss
    bit for bit and the gathered gradients to f32 rounding (the recompute
    runs the layer's collectives again)."""
    for r in _ranks(launched, "tp2"):
        a, b = r["remat"][True], r["remat"][False]
        assert a["loss"] == b["loss"]
        _grads_close(a["grads"], b["grads"])


def test_tp2_dropout_draws_one_process_masks(launched, jparams, batch):
    """dp = 1 x tp = 2 at dropout 0.1 from one generator seed: the hidden
    states and the loss equal one process's from the same seed (the FFN's
    column-sharded mask is the rank's columns of the whole draw), and the
    two ranks' h are bit-equal (masks on replicated activations agree)."""
    cfg = dataclasses.replace(W.CFG, dropout=0.1)
    p = tw.from_jax_params(jparams, device="cpu")
    x, y, m = (torch.from_numpy(a) for a in batch)
    h = tlt.forward_hidden(p, cfg, x.long(), deterministic=False,
                           generator=torch.Generator().manual_seed(11)).detach().numpy()
    _, (loss, _) = tpre.agent_grad_step(p, cfg, x.long(), y.long(), m,
                                        torch.Generator().manual_seed(11))
    h0 = tlt.forward_hidden(p, cfg, x.long()).detach().numpy()
    assert np.abs(h - h0).max() > 0.1
    ranks = _ranks(launched, "tp2")
    np.testing.assert_array_equal(ranks[0]["dropout"]["h"], ranks[1]["dropout"]["h"])
    for r in ranks:
        np.testing.assert_allclose(r["dropout"]["h"], h, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["dropout"]["loss"], float(loss), rtol=1e-5)


def test_tp_checkpoint_reads_in_jax_and_resumes_at_another_tp(launched, jparams, data, work):
    """A tp = 2 run's checkpoint (one epoch) holds the whole tree: JAX's
    load_checkpoint reads it, equal bit for bit to the ranks' gathered
    parameters; one process resumes from it for epoch 2 and ends where two
    epochs at tp = 2 end.  A tp = 2 run resumed from a one-process
    checkpoint ends where two epochs in one process end."""
    two = tuple(a[:16] for a in data)
    ranks = _ranks(launched, "tp2")
    (path,) = ranks[0]["ckpt"]["paths"]
    ck = jck.load_checkpoint(path, params_template=jax.tree_util.tree_map(jnp.asarray,
                                                                          jparams))
    assert ck["extra"]["epoch"] == 0
    for k, v in _flat(ck["params"]).items():
        np.testing.assert_array_equal(ranks[0]["ckpt"]["params"][k], v, err_msg=k)
    p_res, _, h_res = _one_process_run(jparams, two, W._mkcfg(work, "one_res", n_epoch=2),
                                       resume=path)
    p_str, _, h_str = _one_process_run(jparams, two, W._mkcfg(work, "one_str", n_epoch=2))
    for r in ranks:
        c = r["ckpt"]
        _params_close(W.DW.flat(p_res), c["straight"])
        np.testing.assert_allclose(h_res, c["straight_history"][1:], rtol=1e-5)
        _params_close(c["resumed"], W.DW.flat(p_str))
        np.testing.assert_allclose(c["resumed_history"], h_str[1:], rtol=1e-5)


@pytest.mark.parametrize("key,dp,tp,b", [("tp2", 1, 2, 4), ("dp2tp2", 2, 2, 8)])
def test_greedy_generate_songs_under_tp(launched, tiny_jparams, prompt, key, dp, tp, b):
    """Greedy songs at JAX's TINY, from the CP seed and from a 5-row prompt:
    every rank returns the songs of JAX's generate_songs on make_mesh(dp,
    tp), token for token, and one process's.  At dp = 1 a stochastic run
    from the 20-row prompt (the parallel prefill under tp) equals one
    process's from the same seed."""
    gcfg = C.GenerateConfig(batch_size=b, max_tokens=12, bar_production=10 ** 9, greedy=True)
    jp = jax.tree_util.tree_map(jnp.asarray, tiny_jparams)
    ref = {"greedy": jsam.generate_songs(jp, TINY, gcfg, mesh=make_mesh(dp, tp)),
           "prompt": jsam.generate_songs(jp, TINY, gcfg, init=prompt[:5],
                                         mesh=make_mesh(dp, tp))}
    p = tw.from_jax_params(tiny_jparams, device="cpu")
    tcfg = TC.GenerateConfig(batch_size=b, max_tokens=12, bar_production=10 ** 9, greedy=True)
    one = {"greedy": tsam.generate_songs(p, W.TINY, tcfg),
           "prompt": tsam.generate_songs(p, W.TINY, tcfg, init=prompt[:5])}
    for r in _ranks(launched, key):
        for name in ("greedy", "prompt"):
            assert len(r["generate"][name]) == b
            for a, j, o in zip(r["generate"][name], ref[name], one[name]):
                np.testing.assert_array_equal(a, np.asarray(j))
                np.testing.assert_array_equal(a, o)
        if dp == 1:
            stoch = tsam.generate_songs(p, W.TINY, dataclasses.replace(tcfg, greedy=False,
                                                                       seed=3), init=prompt)
            for a, o in zip(r["generate"]["stochastic_prefill"], stoch):
                assert len(a) > len(prompt)
                np.testing.assert_array_equal(a, o)


def test_controls_fall_outside_the_gates(launched, jparams, batch):
    """At dp = 2 x tp = 2: the mask sum all-reduced over the world (each dp
    shard counted tp times) misses JAX's loss and gradients; a clip by each
    rank's local norm misses JAX's clipped gradient (the ranks' norms
    differ); torch.distributed.nn.functional.all_reduce in place of
    reduce_from_tp keeps the loss but misses the gradients (its backward
    sums the replicated gradient again)."""
    ref = _jax_step(jparams, batch, 2, 2)
    for r in _ranks(launched, "dp2tp2"):
        c = r["controls"]
        assert abs(c["world_mask_sum"]["loss0"] - ref["loss0"]) / ref["loss0"] > 1e-5
        with pytest.raises(AssertionError):
            _grads_close(c["world_mask_sum"]["grads"], ref["grads"])
        assert len(set(c["local_clip"]["norms"])) > 1
        with pytest.raises(AssertionError):
            _grads_close(c["local_clip"]["clipped"], ref["clipped"])
        np.testing.assert_allclose(c["dist_nn_all_reduce"]["loss0"], ref["loss0"], rtol=1e-5)
        with pytest.raises(AssertionError):
            _grads_close(c["dist_nn_all_reduce"]["grads"], ref["grads"])


def test_cli_pretrain_tp2_cpu(launched, work):
    """cli pretrain --tp 2 --device cpu: two ranks, rank 0's result; one
    epoch writes rank 0's checkpoint, which holds the whole tree."""
    res = launched["cli_pretrain"].result()
    assert res["steps"] == 1 and len(res["history"]) == 1 and np.isfinite(res["history"][0])
    (name,) = os.listdir(os.path.join(work, "cli", "c"))
    ck = tck.load_checkpoint(os.path.join(work, "cli", "c", name), device="cpu")
    cfg = TC.agent_config(n_layer=1)
    assert ck["params"]["in_linear"]["w"].shape == (sum(cfg.emb_sizes), cfg.d_model)
    assert ck["params"]["layers"]["ffn1"]["w"].shape == (1, cfg.d_model, cfg.d_inner)
    assert os.listdir(os.path.join(work, "cli", "e")) == ["log.txt"]


def test_cli_generate_tp2_cpu(launched, work, tmp_path):
    """cli generate --tp 2 --device cpu --greedy: the MIDI files written once
    (rank 0), the same token count as one process."""
    res = launched["cli_generate"].result()
    one = tcli.main(CLI_GENERATE + ["--out-dir", str(tmp_path / "g1")])
    assert res["songs"] == 2 and res["tokens"] == one["tokens"] >= 2
    assert sorted(os.listdir(os.path.join(work, "cli", "g"))) == ["get_0.mid", "get_1.mid"]


def test_tp_refusals(monkeypatch):
    """A tp that does not divide the heads, d_inner, d_model or an embedding
    raises ValueError before any collective (a mesh object with no group);
    the Longformer checks its own config the same way; the fused decode
    refuses tp; the CLI refuses a --pp that does not divide the layers;
    --continuous refuses --tp; the orbax checkpoint raises (9(e))."""
    fake = pm.Mesh({"dp": 1, "tp": 3}, 0, torch.device("cpu"), "gloo")
    params = tlt.init_params(W.CFG, device="cpu")
    x, y, m = (torch.from_numpy(a) for a in jds.synthetic_cp_dataset(2, S, n_class=VOCAB))
    with pytest.raises(ValueError, match="n_head"):
        tlt.forward_hidden(params, W.CFG, x.long(), dp_mesh=fake)
    with pytest.raises(ValueError, match="tp=3"):
        tpre.pretrain(params, W.CFG, x.numpy(), y.numpy(), m.numpy(), TC.PretrainConfig(),
                      mesh=fake)
    with pytest.raises(ValueError, match="d_inner"):
        tsam.generate_songs(params, W.CFG, TC.GenerateConfig(batch_size=2), mesh=fake)
    with pytest.raises(ValueError, match="emb_sizes"):
        tlt.check_tp(dataclasses.replace(W.CFG, emb_sizes=(8, 8, 8, 8, 8, 6), n_head=4,
                                         d_inner=64), 4)
    wcfg = TC.WindowTransformerConfig(vocab_sizes=VOCAB, emb_sizes=(8,) * 6, d_model=16,
                                      n_layer=1, n_head=2, d_inner=32, max_pos=64,
                                      attention_window=8)
    with pytest.raises(ValueError, match="n_head"):
        tlf.forward(tlf.init_params(wcfg, device="cpu"), wcfg, x.long(), mesh=fake)
    two = pm.Mesh({"dp": 1, "tp": 2}, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="fused"):
        tsam.generate_tokens(params, W.CFG, torch.zeros((1, 1, 6), dtype=torch.int32),
                             max_tokens=2, fused=True, mesh=two)
    with pytest.raises(ValueError, match="not divisible by pp=5"):
        tcli.main(["pretrain", "--pp", "5", "--tp", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--continuous"):
        tcli.main(["generate", "--continuous", "--tp", "2", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match=r"9\(e\)"):
        tpre.pretrain(params, W.CFG, x.numpy(), y.numpy(), m.numpy(),
                      TC.PretrainConfig(ckpt_backend="orbax"))
