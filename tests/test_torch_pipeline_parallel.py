"""The port's GPipe pipeline against the JAX package's and against one
process, on the CPU.

The port's ranks run in gloo process groups that ``parallel.launch``
spawns: dp = 1 x pp = 2 (two ranks), dp = 2 x pp = 2 and dp = 1 x pp = 2 x
tp = 2 (four each), and ``cli pretrain --pp 2`` (two), all started together
in one module fixture; each rank a fresh interpreter running a function of
tests/torch_pp_workers.py, which imports no jax; trees of shards come back
whole (``parallel.gather_params``).  The JAX side: its
``pipeline_forward_hidden`` on ``make_pp_mesh`` over the suite's virtual
CPU devices, and its single-device ``lt.train_losses`` (whose equality with
its pipeline's JAX's slow tests show) and ``agent_train_step``.  Configs of
JAX's tests/test_pipeline_parallel.py: d_model 64, 4 layers, 4 heads, FFN
128, embeddings 16, B 8 x S 32 with unequal mask sums over dp; d_model 32,
2 layers for the grad step and the loop; dropout 0.

Tolerances: the forward 1e-5 (JAX's), the loss 1e-5 relative, every
gathered gradient (the replicated leaves' too) and clipped gradient within
1e-5 of its leaf's magnitude, the parameters after Adam (the clip at
``W.CLIP`` engages) within 1e-5 of each leaf's magnitude; the halves'
gradients 1e-6 (JAX's).  Two controls, each a fault the gates must catch,
fall outside them: the heads' and ``final_ln``'s gradients summed over the
stages as if every stage had run the heads, and the clip by a rank's own
norm.  The 8-rank dp = 2 x pp = 2 x tp = 2 case is marked slow.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_pp_workers as W
from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.apps import cli as tcli
from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
from reinforcement_learning_in_music_generation_torch.parallel import pipeline as ppl
from reinforcement_learning_in_music_generation_torch.train import pretrain as tpre
from reinforcement_learning_in_music_generation_torch.utils import checkpoint as tck
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import dataset as jds
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as jlt
from reinforcement_learning_in_music_generation_tpu.parallel import pipeline as jpl
from reinforcement_learning_in_music_generation_tpu.train import optim as jopt
from reinforcement_learning_in_music_generation_tpu.train import pretrain as jpre

CFG, SMALL = C.LinearTransformerConfig(**W.KW), C.LinearTransformerConfig(**W.SMALL_KW)
B, S = 8, 32
LAUNCH_S = 300
MESHES = {"pp2": (1, 2, 1), "dp2pp2": (2, 2, 1), "pp2tp2": (1, 2, 2)}
CLI_PRETRAIN = ["pretrain", "--device", "cpu", "--synthetic", "--layers", "2",
                "--synthetic-songs", "4", "--batch-size", "4", "--seq-len", "16"]


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(np.asarray, jlt.init_params(jax.random.PRNGKey(0), CFG))


@pytest.fixture(scope="module")
def jparams_small():
    return jax.tree_util.tree_map(np.asarray, jlt.init_params(jax.random.PRNGKey(0), SMALL))


@pytest.fixture(scope="module")
def batch():
    x, y, m = jds.synthetic_cp_dataset(B, S, n_class=CFG.vocab_sizes, seed=4)
    m = np.ones_like(m, dtype=np.float32)
    m[B // 2:, 9:] = 0.0
    return x, y, m


@pytest.fixture(scope="module")
def small_batch():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 8, (4, 16, 6))
    return x, np.roll(x, -1, axis=1), np.ones((4, 16), np.float32)


@pytest.fixture(scope="module")
def data():
    x, y, m = jds.synthetic_cp_dataset(8, S, n_class=SMALL.vocab_sizes, seed=6)
    return x, y, np.ones_like(m, dtype=np.float32)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("pp"))


@pytest.fixture(scope="module")
def launched(jparams, batch, jparams_small, small_batch, data, work):
    """The file's launches, started together in the background so that
    their ranks run while the JAX references compute."""
    cli = lambda argv: tcli.main(argv)
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(4) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield {"pp2": pool.submit(pm.launch, W.pp2, 2,
                                  (jparams, batch, jparams_small, small_batch, data,
                                   os.path.join(work, "r2")), timeout_s=LAUNCH_S),
               "dp2pp2": pool.submit(pm.launch, W.dp2pp2, 4,
                                     (jparams, batch, jparams_small, data,
                                      os.path.join(work, "r4")), timeout_s=LAUNCH_S),
               "pp2tp2": pool.submit(pm.launch, W.pp2tp2, 4, (jparams, batch),
                                     timeout_s=LAUNCH_S),
               "cli": pool.submit(cli, CLI_PRETRAIN + [
                   "--epochs", "1", "--pp", "2", "--exp-dir", os.path.join(work, "cli", "e"),
                   "--ckpt-dir", os.path.join(work, "cli", "c")])}


def _ranks(launched, key):
    out = launched[key].result()
    dp, pp, tp = MESHES[key]
    assert [(r["rank"], r["index"]) for r in out] == [
        (i, {"dp": i // (pp * tp), "pp": (i // tp) % pp, "tp": i % tp})
        for i in range(dp * pp * tp)]
    return out


@pytest.fixture(autouse=True)
def plain_route(monkeypatch):
    for k, v in W.ROUTES["xla"].items():
        monkeypatch.setenv(k, v)


def _flat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {"".join(f"/{k.key}" for k in kp): np.asarray(v) for kp, v in leaves}


def _leaves_close(ours, ref, tol=1e-5):
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-30)
        np.testing.assert_allclose(ours[k], r, rtol=tol, atol=tol * scale, err_msg=k)


_JAX = {}


def _jax_ref(jparams, batch):
    """JAX's single-device loss, gradient (the mean of lt.train_losses),
    clipped gradient and one agent_train_step, cached for the file."""
    if not _JAX:
        p = jax.tree_util.tree_map(jnp.asarray, jparams)
        x, y, m = (jnp.asarray(a) for a in batch)
        loss_fn = lambda q: jnp.mean(jlt.train_losses(q, CFG, x, y, m, deterministic=True))
        loss, grads = jax.value_and_grad(loss_fn)(p)
        clip = optax.clip_by_global_norm(W.CLIP)
        clipped, _ = clip.update(grads, clip.init(grads))
        tx = jopt.adam(1e-4, grad_clip=W.CLIP)
        p1, _, _ = jpre.agent_train_step(p, tx.init(p), CFG, tx, x, y, m, jax.random.PRNGKey(0))
        _JAX.update(loss=float(loss), grads=_flat(grads), clipped=_flat(clipped),
                    norm=float(optax.global_norm(grads)), params=_flat(p1))
    return _JAX


@pytest.mark.parametrize("key", ["pp2", "dp2pp2"])
def test_pipeline_forward_matches_jax_pipeline(launched, jparams, batch, key):
    """pipeline_forward_hidden on every rank equals JAX's on
    make_pp_mesh(pp=2, dp) (the default microbatches, 2 pp)."""
    dp, pp, _ = MESHES[key]
    mesh = jpl.make_pp_mesh(pp=pp, dp=dp)
    p = jpl.shard_params_pp(mesh, jax.tree_util.tree_map(jnp.asarray, jparams))
    ref = np.asarray(jpl.pipeline_forward_hidden(p, CFG, jnp.asarray(batch[0]), mesh))
    for r in _ranks(launched, key):
        np.testing.assert_allclose(r["xla"]["h"], ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", sorted(MESHES))
def test_pipeline_loss_and_grads_match_jax(launched, jparams, batch, key):
    """The loss, every gathered gradient (the replicated leaves' included:
    the sum over pp counts each once) and the clip's norm equal JAX's
    single-device step, on every rank."""
    ref = _jax_ref(jparams, batch)
    for r in _ranks(launched, key):
        s = r["xla"]
        np.testing.assert_allclose(s["loss"], ref["loss"], rtol=1e-5)
        _leaves_close(s["grads"], ref["grads"])
        np.testing.assert_allclose(s["norm"], ref["norm"], rtol=1e-5)
        assert s["calls"] == {"D": 0, "G": 0}


@pytest.mark.parametrize("key", sorted(MESHES))
def test_pipeline_adam_step_matches_jax(launched, jparams, batch, key):
    """One Adam step with the clip engaged: the clipped gradient and the
    parameters after it equal JAX's agent_train_step's."""
    ref = _jax_ref(jparams, batch)
    assert ref["norm"] > 2 * W.CLIP
    for r in _ranks(launched, key):
        _leaves_close(r["xla"]["clipped"], ref["clipped"])
        _leaves_close(r["xla"]["params"], ref["params"])


def _fails(fn):
    try:
        fn()
    except AssertionError:
        return True
    return False


@pytest.mark.parametrize("key", sorted(MESHES))
def test_pipeline_controls_fall_outside_the_gates(launched, jparams, batch, key):
    """A head gradient every stage computed, summed over pp, and a clip by
    the rank's own norm each fail the gates the step holds."""
    ref = _jax_ref(jparams, batch)
    for r in _ranks(launched, key):
        c = r["xla"]["controls"]
        assert _fails(lambda: _leaves_close(c["double_counted_heads"], ref["grads"]))
        assert _fails(lambda: _leaves_close(c["local_norm"], ref["clipped"]))


@pytest.mark.parametrize("route,kernel", [("d", "D"), ("g", "G")])
def test_stage_runs_kernel_route_on_each_microbatch(launched, jparams, batch, route, kernel):
    """Under RLMG_FFN_BACKEND=pallas-tail (pallas) each stage runs kernel
    D's (G's) wrapper, its plain twin here, on each of its layers for each
    microbatch, forward; the step equals one process's on the same route."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in W.ROUTES[route].items():
            mp.setenv(k, v)
        p = tw.from_jax_params(jparams, device="cpu")
        x, y, m = W._tensors(batch)
        grads, (loss, _) = tpre.agent_grad_step(p, W.CFG, x, y, m, None)
    m_ = min(2 * 2, B)
    for r in _ranks(launched, "pp2"):
        s = r[route]
        assert s["calls"] == {"D": 0, "G": 0, kernel: CFG.n_layer // 2 * m_}
        np.testing.assert_allclose(s["loss"], float(loss), rtol=1e-5)
        _leaves_close(s["grads"], W.DW.flat(grads))


def test_grad_step_halves_sum_to_the_whole_batch(launched):
    """agent_pp_grad_step on two halves at scale 0.5 sums to the whole
    batch's gradient (JAX tests/test_pipeline_parallel.py:238-262)."""
    for r in _ranks(launched, "pp2"):
        h = r["halves"]
        assert max(float(np.abs(h["full"][k] - h["sum"][k]).max()) for k in h["full"]) < 1e-6


def test_pretrain_loop_on_pp_mesh_matches_one_process(launched, jparams_small, data, tmp_path):
    """pretrain(mesh=make_pp_mesh(2[, dp=2])) for two epochs of 4-row
    batches: the epoch losses and the parameters equal one process's loop;
    rank 0 wrote whole checkpoints; gradient accumulation of two 2-row
    halves follows the unaccumulated loop (JAX :219-236)."""
    p = tw.from_jax_params(jparams_small, device="cpu")
    pcfg = TC.PretrainConfig(n_epoch=2, batch_size=4, lr=1e-3, ckpt_dir=str(tmp_path / "c"),
                             exp_dir=str(tmp_path / "e"))
    p_one, _, hist = tpre.pretrain(p, W.SMALL, *data, pcfg)
    flat_one = W.DW.flat(p_one)
    for key in ("pp2", "dp2pp2"):
        for r in _ranks(launched, key):
            np.testing.assert_allclose(r["loop"]["history"], hist, rtol=1e-5)
            _leaves_close(r["loop"]["params"], flat_one, tol=1e-4)
    r0 = _ranks(launched, "pp2")[0]
    assert r0["ckpt"]
    ck = tck.load_checkpoint(r0["ckpt"][-1], params_template=p_one, device="cpu")
    assert {k: v.shape for k, v in W.DW.flat(ck["params"]).items()} == {
        k: v.shape for k, v in flat_one.items()}
    for r in _ranks(launched, "pp2"):
        np.testing.assert_allclose(r["accum"]["history"], r["loop"]["history"], rtol=1e-4,
                                   atol=1e-5)


def test_dropout_masks_differ_by_microbatch_and_match_on_tp_ranks(launched):
    """Dropout 0.5 on one row repeated: on the last stage the microbatches'
    hidden states differ (their masks do), and the stage's two tp ranks hold
    the same ones, bit for bit; the first stage returns none."""
    ranks = _ranks(launched, "pp2tp2")
    assert ranks[0]["masks"] is None and ranks[1]["masks"] is None
    a, b = ranks[2]["masks"], ranks[3]["masks"]
    np.testing.assert_array_equal(a, b)
    mb = a.shape[0] // 4
    for i in range(1, 4):
        assert not np.allclose(a[:mb], a[i * mb:(i + 1) * mb])


def test_ranks_hold_their_stage_slab(launched, jparams):
    """Each stage holds L/pp of every layer leaf and the other leaves
    whole."""
    whole = _flat(jparams)
    for r in _ranks(launched, "pp2"):
        for k, v in whole.items():
            want = (v.shape[0] // 2,) + v.shape[1:] if k.startswith("/layers") else v.shape
            assert tuple(r["shapes"][k]) == want, k


def test_pipeline_rejects_bad_shapes():
    """JAX's ValueErrors, before any collective: pp not dividing the
    layers, tp not dividing the heads, dp x m not dividing the batch; and
    ZeRO-1 on a pipeline mesh (in the loop and on the CLI)."""
    fake = lambda **s: pm.Mesh({"dp": 1, "pp": 1, "tp": 1, **s}, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="not divisible by pp"):
        ppl.n_microbatches(CFG, fake(pp=3), 6)
    with pytest.raises(ValueError, match="must divide n_head"):
        ppl.n_microbatches(CFG, fake(pp=2, tp=3), 6, 2)
    with pytest.raises(ValueError, match="not divisible by dp"):
        ppl.n_microbatches(CFG, fake(pp=2, dp=2), 6, 4)
    assert ppl.n_microbatches(CFG, fake(pp=2, dp=2), 8) == 4
    p = tw.from_jax_params(jax.tree_util.tree_map(np.asarray, jlt.init_params(
        jax.random.PRNGKey(0), SMALL)), device="cpu")
    x, y, m = jds.synthetic_cp_dataset(4, 16, n_class=SMALL.vocab_sizes)
    with pytest.raises(ValueError, match="pipeline mesh"):
        tpre.pretrain(p, W.SMALL, x, y, m, TC.PretrainConfig(zero1=True),
                      mesh=fake(pp=2, dp=2))
    with pytest.raises(ValueError, match="pipeline mesh"):
        tcli.main(CLI_PRETRAIN + ["--pp", "2", "--dp", "2", "--zero1"])
    with pytest.raises(ValueError, match="not divisible by pp"):
        tcli.main(CLI_PRETRAIN + ["--pp", "3"])


def test_cli_pretrain_pp2_and_resume_at_pp1(launched, work):
    """cli pretrain --pp 2 on the CPU (two gloo ranks): finite losses and a
    whole-tree checkpoint from rank 0; cli pretrain without --pp resumes
    from it and runs the second epoch."""
    res = launched["cli"].result()
    assert res["steps"] == 1 and all(np.isfinite(res["history"]))
    (name,) = os.listdir(os.path.join(work, "cli", "c"))
    ckpt = os.path.join(work, "cli", "c", name)
    out = tcli.main(CLI_PRETRAIN + ["--epochs", "2", "--resume", ckpt,
                                    "--exp-dir", os.path.join(work, "res", "e"),
                                    "--ckpt-dir", os.path.join(work, "res", "c")])
    assert out["steps"] == 1 and len(out["history"]) == 1 and np.isfinite(out["history"][0])


def test_ranks_import_no_jax(launched):
    for key in MESHES:
        assert all(r["modules"] == [] for r in _ranks(launched, key))


@pytest.mark.slow
def test_pipeline_dp2_pp2_tp2_matches_jax(jparams, batch):
    """dp = 2 x pp = 2 x tp = 2 on eight ranks: the loss, the gradients and
    one Adam step against JAX's single-device step."""
    ref = _jax_ref(jparams, batch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ranks = pm.launch(W.dp2pp2tp2, 8, (jparams, batch), timeout_s=LAUNCH_S)
    for r in ranks:
        np.testing.assert_allclose(r["xla"]["loss"], ref["loss"], rtol=1e-5)
        _leaves_close(r["xla"]["grads"], ref["grads"])
        _leaves_close(r["xla"]["params"], ref["params"])
