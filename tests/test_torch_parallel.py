"""The port's data parallelism against the JAX package's mesh, on the CPU.

The port's ranks run in gloo process groups that ``parallel.launch``
spawns (two ranks; one rank for the dp = 1 check), each rank a fresh
interpreter running a function of tests/torch_dp_workers.py, which imports
no jax.  The JAX side runs ``make_mesh(2, 1)`` on the suite's 8 virtual CPU
devices (tests/conftest.py) as one program over the global batch.  Small
config of tests/test_ffn_block.py's dp test (d_model 32, 2 layers, 2
heads, vocab 8 a field), B 8 x S 16, dropout 0.  The batch's two halves
have unequal mask sums (64 and 12 valid tokens), where the mean of the
ranks' own means is another loss; the tests show that it misses the
tolerances the port's global CE meets.

Tolerances: losses rtol 1e-5 (tests/test_torch_pretrain.py:215),
gradients rtol 1e-4 / atol 1e-6 (:254), parameters 1e-5 of each leaf's
magnitude; ZeRO-1, dp = 1 and resume are held bit for bit.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers as W
from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch.apps import cli as tcli
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
from reinforcement_learning_in_music_generation_torch.parallel import sharding as psh
from reinforcement_learning_in_music_generation_torch.train import pretrain as tpre
from reinforcement_learning_in_music_generation_torch.utils import checkpoint as tck
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import dataset as jds
from reinforcement_learning_in_music_generation_tpu.generate import sampler as jsam
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as lt
from reinforcement_learning_in_music_generation_tpu.parallel import make_mesh, shard_batch
from reinforcement_learning_in_music_generation_tpu.parallel import sharding as jsh
from reinforcement_learning_in_music_generation_tpu.train import optim as jopt
from reinforcement_learning_in_music_generation_tpu.train import pretrain as jpre
from reinforcement_learning_in_music_generation_tpu.utils import checkpoint as jck

CFG = C.LinearTransformerConfig(**W.KW)
VOCAB = W.KW["vocab_sizes"]
B, S = 8, 16
LAUNCH_S = 240          # a hung group fails the test instead of the suite's limit
JAX_ROUTES = {"xla": {"RLMG_FFN_BACKEND": "xla", "RLMG_ATTN_BACKEND": "xla"},
              "kernels": {"RLMG_FFN_BACKEND": "pallas-tail", "RLMG_ATTN_BACKEND": "pallas-qkv",
                          "RLMG_FFN_INTERPRET": "1", "RLMG_ATTN_INTERPRET": "1",
                          "RLMG_FFN_BLOCK": "32"}}


def _masked(x, y, m, valid_tail):
    """The batch with rows of the second half keeping only their first
    ``valid_tail`` positions: unequal mask sums across the two ranks."""
    m = np.ones_like(m, dtype=np.float32)
    m[len(m) // 2:, valid_tail:] = 0.0
    return x, y, m


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(np.asarray, lt.init_params(jax.random.PRNGKey(0), CFG))


@pytest.fixture(scope="module")
def batch():
    return _masked(*jds.synthetic_cp_dataset(B, S, n_class=VOCAB, seed=4), valid_tail=3)


@pytest.fixture(scope="module")
def whole_batch():
    return _masked(*jds.synthetic_cp_dataset(3, S, n_class=VOCAB, seed=5), valid_tail=5)


@pytest.fixture(scope="module")
def data():
    return _masked(*jds.synthetic_cp_dataset(24, S, n_class=VOCAB, seed=6), valid_tail=7)


@pytest.fixture(scope="module")
def launched(jparams, batch, whole_batch, data, tmp_path_factory):
    """The file's two launches, started together in the background so that
    their ranks run while the JAX references compute: every dp = 2 scenario
    (one launch), and the dp = 1 check."""
    tmp = str(tmp_path_factory.mktemp("dp2"))
    with ThreadPoolExecutor(2) as pool:
        yield {"dp2": pool.submit(pm.launch, W.dp2, 2, (jparams, batch, whole_batch, data, tmp),
                                  timeout_s=LAUNCH_S),
               "dp1": pool.submit(pm.launch, W.dp1, 1, (jparams, batch), timeout_s=LAUNCH_S)}


def _ranks(launched):
    out = launched["dp2"].result()
    assert [r["rank"] for r in out] == [0, 1]
    return out


@pytest.fixture(scope="module")
def ranks(launched):
    """Both ranks' results of every dp = 2 scenario."""
    return _ranks(launched)


def _jax_route(monkeypatch, name):
    for k in ("RLMG_FFN_INTERPRET", "RLMG_ATTN_INTERPRET", "RLMG_FFN_BLOCK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in JAX_ROUTES[name].items():
        monkeypatch.setenv(k, v)


@pytest.fixture
def kernel_route(monkeypatch):
    """JAX's kernel route; the jitted steps read the route when they trace,
    so their caches are cleared on the way in and out."""
    _jax_route(monkeypatch, "kernels")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _jax_on_mesh(jparams, batch, dp=2):
    mesh = make_mesh(dp, 1)
    jp = jsh.shard_params(mesh, jax.tree_util.tree_map(jnp.asarray, jparams))
    x, y, m = shard_batch(mesh, (jnp.asarray(batch[0]), jnp.asarray(batch[1]),
                                 jnp.asarray(batch[2], jnp.float32)))
    return mesh, jp, (x, y, m)


def _jax_steps(jparams, batch, n=3):
    """JAX's first gradient and ``n`` steps on a make_mesh(2, 1) mesh."""
    mesh, jp, (x, y, m) = _jax_on_mesh(jparams, batch)
    grads, (loss0, _) = jpre.agent_grad_step(jp, CFG, x, y, m, jax.random.PRNGKey(0),
                                             dp_mesh=mesh)
    tx = jopt.adam(1e-4, grad_clip=3.0)
    js = tx.init(jp)
    losses, fields = [], []
    for step in range(n):
        jp, js, (loss, ls) = jpre.agent_train_step(jp, js, CFG, tx, x, y, m,
                                                   jax.random.PRNGKey(step), dp_mesh=mesh)
        losses.append(float(loss))
        fields.append(np.asarray(ls))
    return {"loss0": float(loss0), "grads": _flat(grads), "losses": losses, "fields": fields,
            "params": _flat(jp)}


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


def _naive_misses(ranks, key, ref):
    """The mean of the ranks' own means (DDP-style averaging) against JAX's
    global loss and gradient: both must miss the tolerances."""
    naive = np.mean([r[key]["local_loss"] for r in ranks])
    assert abs(naive - ref["loss0"]) / abs(ref["loss0"]) > 1e-5
    naive_g = {k: np.mean([r[key]["local_grads"][k] for r in ranks], axis=0)
               for k in ref["grads"]}
    with pytest.raises(AssertionError):
        _grads_close(naive_g, ref["grads"])


def _held_to_jax(ranks, key, ref):
    for r in ranks:
        assert r[key]["rows"] == B // 2
        np.testing.assert_allclose(r[key]["loss0"], ref["loss0"], rtol=1e-5)
        np.testing.assert_allclose(r[key]["losses"], ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(np.stack(r[key]["per_field"]), np.stack(ref["fields"]),
                                   rtol=1e-5)
        _grads_close(r[key]["grads"], ref["grads"])
        _params_close(r[key]["params"], ref["params"])


def test_dp2_steps_match_jax_mesh_on_unequal_masks(launched, jparams, batch, monkeypatch):
    """Three dp = 2 steps on the plain route: the global masked CE and the
    all-reduced gradient equal JAX's on make_mesh(2, 1); the naive mean of
    the ranks' means misses."""
    _jax_route(monkeypatch, "xla")
    ref = _jax_steps(jparams, batch)
    ranks = _ranks(launched)
    _held_to_jax(ranks, "xla", ref)
    _naive_misses(ranks, "xla", ref)
    for r in ranks:
        assert r["xla"]["c_calls"] == r["xla"]["d_calls"] == 0


def test_ranks_import_no_jax(ranks):
    assert [r["modules"] for r in ranks] == [[], []]


def test_dp2_kernel_route_runs_c_and_d_per_rank(ranks, jparams, batch, monkeypatch,
                                                kernel_route):
    """The C + D route (the kernels' plain versions on CPU tensors) on each
    rank's rows, against JAX's shard_map routes with its Pallas kernels in
    interpret mode; each rank's layers called C and D once each.  The route
    rule reads the rank's rows: at RLMG_FFN_MIN_ROWS = B S it holds for one
    process and fails for a rank of dp = 2, as JAX's rule on its mesh."""
    ref = _jax_steps(jparams, batch)
    _held_to_jax(ranks, "kernels", ref)
    _naive_misses(ranks, "kernels", ref)
    for r in ranks:
        assert r["kernels"]["c_calls"] == r["kernels"]["d_calls"] == CFG.n_layer
    monkeypatch.delenv("RLMG_FFN_BACKEND")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    cuda, mesh2 = torch.device("cuda"), pm.Mesh({"dp": 2, "tp": 1}, 0, torch.device("cpu"),
                                                "gloo")
    rank_rows = ranks[0]["kernels"]["rows"] * S
    for min_rows, want in ((B * S, "xla"), (B * S // 2, "pallas-tail")):
        monkeypatch.setenv("RLMG_FFN_MIN_ROWS", str(min_rows))
        assert tlt._ffn_backend(B * S, cuda) == "pallas-tail"
        assert tlt._ffn_backend(rank_rows, cuda, mesh2) == want
        assert lt._ffn_backend(B * S, make_mesh(2, 1)) == want


def test_dp2_grad_accum_matches_jax_mean_gradient(ranks, jparams, data, monkeypatch):
    """grad_accum = 2 over dp = 2: the summed half-scaled micro-gradients
    equal JAX's on the mesh, and the loop's optimizer step equals JAX's
    apply_grads of them."""
    _jax_route(monkeypatch, "xla")
    acc = None
    for k in range(2):
        rows = slice(8 * k, 8 * (k + 1))
        mesh, jp, (x, y, m) = _jax_on_mesh(jparams, tuple(a[rows] for a in data))
        g, _ = jpre.agent_grad_step(jp, CFG, x, y, m, jax.random.PRNGKey(k), dp_mesh=mesh,
                                    scale=0.5)
        acc = g if acc is None else jax.tree_util.tree_map(jnp.add, acc, g)
    tx = jopt.adam(1e-4, grad_clip=3.0)
    jp_new, _ = jpre.apply_grads(jp, tx.init(jp), tx, acc)
    for r in ranks:
        _grads_close(r["accum"]["grads"], _flat(acc))
        _params_close(r["accum"]["params"], _flat(jp_new))


def test_zero1_specs_match_jax_at_dp4_tp2():
    """The agent's parameters at agent_config's shapes: the port's ZeRO-1
    specs (axis tuples from the axis sizes, no process group) equal JAX's on
    a (4, 2) mesh; the Megatron specs too."""
    shapes = jax.eval_shape(lambda: lt.init_params(jax.random.PRNGKey(0), C.agent_config()))
    meta = jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), shapes)
    ours_z = _port_specs(psh.zero1_specs({"dp": 4, "tp": 2}, meta))
    assert ours_z == _jax_specs(jsh.zero1_specs(make_mesh(4, 2), shapes))
    assert _port_specs(psh.param_specs(meta)) == _jax_specs(jsh.param_specs(shapes))
    assert sum(1 for v in ours_z.values() if "dp" in v) >= 20


def _jax_specs(specs):
    leaves = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return {"".join(f"/{k.key}" for k in kp): tuple(v) for kp, v in leaves}


def _port_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_zero1_run_is_bit_equal_to_plain_dp(ranks, jparams):
    """Three dp = 2 loop steps with ZeRO-1 end on the same parameters, bit
    for bit, as without it; each rank holds half of ffn1's moments, along
    the axis JAX's zero1_specs gives it."""
    spec = jsh.zero1_specs(make_mesh(2, 1), jax.tree_util.tree_map(jnp.asarray, jparams))
    axis = tuple(spec["layers"]["ffn1"]["w"]).index("dp")
    full = list(jparams["layers"]["ffn1"]["w"].shape)
    full[axis] //= 2
    for r in ranks:
        z = r["zero1"]
        for k, v in z["plain"].items():
            np.testing.assert_array_equal(z["zero1"][k], v, err_msg=k)
        assert z["mu_ffn1"] == tuple(full)


def test_pretrain_mesh_checkpoint_reads_in_jax_and_resumes(ranks, jparams):
    """pretrain(mesh=...) with ZeRO-1 for one epoch: rank 0 wrote one
    checkpoint, whose params the JAX loader reads as the ranks hold them and
    whose moments are whole; resuming from it for a second epoch ends where
    two epochs straight through end, bit for bit."""
    paths = ranks[0]["ckpt"]["paths"]
    assert len(paths) == 1 and ranks[1]["ckpt"]["paths"] == paths
    ck = jck.load_checkpoint(paths[0], params_template=jax.tree_util.tree_map(jnp.asarray,
                                                                              jparams))
    ours = tck.load_checkpoint(paths[0], device="cpu")
    assert ours["opt_state"].mu["layers"]["ffn1"]["w"].shape == \
        jparams["layers"]["ffn1"]["w"].shape
    assert ours["opt_state"].count == 2 and ck["extra"]["epoch"] == 0
    for r in ranks:
        for k, v in _flat(ck["params"]).items():
            np.testing.assert_array_equal(r["ckpt"]["params"][k], v, err_msg=k)
        for k, v in r["ckpt"]["straight"].items():
            np.testing.assert_array_equal(r["ckpt"]["resumed"][k], v, err_msg=k)
    assert ranks[0]["ckpt"]["straight_history"] == ranks[1]["ckpt"]["straight_history"]
    assert ranks[0]["ckpt"]["history"] == ranks[0]["ckpt"]["straight_history"][:1]


def test_interrupt_stops_every_rank_at_the_same_batch(ranks):
    """save_on_interrupt with the flag set on rank 1 alone (at its first
    batch): the flag is all-reduced, so both ranks stop after that batch
    (a rank left running would wait in its next all-reduce) and rank 0
    writes interrupt.ckpt."""
    assert [r["interrupt"]["steps"] for r in ranks] == [1, 1]
    assert ranks[0]["interrupt"]["files"] == ["interrupt.ckpt"]


def test_indivisible_batch_kept_whole(ranks, jparams, whole_batch, monkeypatch):
    """A batch of 3 rows on dp = 2 is whole on both ranks (JAX's
    shard_batch replicates it); the step's loss and gradient are JAX's, and
    3 songs are decoded whole on each rank, the same list on both."""
    _jax_route(monkeypatch, "xla")
    ref = _jax_steps(jparams, whole_batch, n=1)
    for r in ranks:
        assert r["whole"]["rows"] == 3
        np.testing.assert_allclose(r["whole"]["losses"], ref["losses"], rtol=1e-5)
        _grads_close(r["whole"]["grads"], ref["grads"])
    whole = [r["generate"]["whole"] for r in ranks]
    assert len(whole[0]) == 3
    for a, b in zip(*whole):
        np.testing.assert_array_equal(a, b)


def test_dp_mesh_of_one_is_bit_equal_to_no_mesh(launched):
    """A one-rank mesh: two steps and a forward with dropout on the D route
    equal, bit for bit, the same without a mesh."""
    (out,) = launched["dp1"].result()
    a, b = out["mesh"], out["none"]
    assert a["losses"] == b["losses"]
    np.testing.assert_array_equal(a["h"], b["h"])
    for k, v in b["params"].items():
        np.testing.assert_array_equal(a["params"][k], v, err_msg=k)


def test_ranks_draw_different_dropout_masks(ranks):
    """The same generator state gives rank r D's seed + 7919 r, so the
    ranks' masks differ; a D-route forward of the same rows from the same
    generator seed differs between the ranks under the mesh and is equal
    without it."""
    m0, m1 = ranks[0]["masks"], ranks[1]["masks"]
    assert m1["seed"] - m0["seed"] == 7919
    assert (m0["mask"] != m1["mask"]).mean() > 0.05
    assert not np.array_equal(m0["out_mesh"], m1["out_mesh"])
    np.testing.assert_array_equal(m0["out_none"], m1["out_none"])


def test_generate_songs_on_mesh(ranks, jparams):
    """Greedy: the songs equal JAX's generate_songs on make_mesh(2, 1) token
    for token, the same list on both ranks.  Stochastic: 4 songs, 2 a rank,
    the same list on both ranks, no rank's songs a copy of the other's."""
    gcfg = C.GenerateConfig(batch_size=4, max_tokens=12, bar_production=10 ** 9, greedy=True)
    ref = jsam.generate_songs(jax.tree_util.tree_map(jnp.asarray, jparams), CFG, gcfg,
                              mesh=make_mesh(2, 1))
    for r in ranks:
        assert len(r["generate"]["greedy"]) == 4
        for a, b in zip(r["generate"]["greedy"], ref):
            np.testing.assert_array_equal(a, np.asarray(b))
    s0, s1 = (r["generate"]["stochastic"] for r in ranks)
    assert len(s0) == 4
    for a, b in zip(s0, s1):
        np.testing.assert_array_equal(a, b)
    for i in range(2):
        for j in range(2, 4):
            assert not np.array_equal(s0[i], s0[j])


def test_cli_pretrain_dp2_cpu(tmp_path, monkeypatch):
    """cli pretrain --dp 2 --device cpu with --zero1: two ranks, rank 0's
    result; one epoch writes rank 0's checkpoint and log."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(tmp_path)
    res = tcli.main(["pretrain", "--device", "cpu", "--synthetic", "--layers", "1",
                     "--synthetic-songs", "4", "--batch-size", "4", "--seq-len", "16",
                     "--epochs", "1", "--dp", "2", "--zero1", "--exp-dir", "e",
                     "--ckpt-dir", "c"])
    assert res["steps"] == 1 and len(res["history"]) == 1 and np.isfinite(res["history"][0])
    assert len(os.listdir("c")) == 1 and os.listdir("e") == ["log.txt"]


def test_cli_generate_dp2_cpu(tmp_path, monkeypatch):
    """cli generate --dp 2 --device cpu --greedy: 2 songs, one a rank, the
    MIDI files written once (rank 0)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = tcli.main(["generate", "--songs", "2", "--layers", "1", "--bars", "2",
                     "--max-tokens", "8", "--device", "cpu", "--greedy", "--dtype", "float32",
                     "--dp", "2", "--out-dir", str(tmp_path / "g")])
    assert res["songs"] == 2 and res["tokens"] >= 2
    assert sorted(os.listdir(tmp_path / "g")) == ["get_0.mid", "get_1.mid"]


def test_mesh_refusals(monkeypatch, tmp_path):
    """make_mesh without a group raises, at any tp; the CLI refuses to
    resume from a JAX orbax directory, naming the port's format (dp, tp and
    pp, and the sharded checkpoint, are ported for every command that takes
    them: tests/test_torch_tensor_parallel.py, tests/test_torch_rl_parallel.py,
    tests/test_torch_pipeline_parallel.py, tests/test_torch_checkpoint.py);
    ZeRO-1 needs dp > 1, as in JAX."""
    for dp, tp in ((2, 2), (2, 1)):
        with pytest.raises(RuntimeError, match="process group"):
            pm.make_mesh(dp, tp)
    jdir = str(tmp_path / "jax.ckpt")
    jck.save_checkpoint_orbax(jdir, {"w": jnp.ones((2, 2))}, step=1, wait=True)
    with pytest.raises(ValueError, match="not a checkpoint of this port"):
        tcli.main(["pretrain", "--device", "cpu", "--synthetic", "--layers", "1",
                   "--synthetic-songs", "2", "--batch-size", "2", "--seq-len", "16",
                   "--ckpt-backend", "orbax", "--resume", jdir, "--exp-dir", str(tmp_path / "e"),
                   "--ckpt-dir", str(tmp_path / "c")])
    params = tlt.init_params(TC.LinearTransformerConfig(**W.KW), device="cpu")
    x, y, m = jds.synthetic_cp_dataset(4, S, n_class=VOCAB)
    for mesh in (None, pm.Mesh({"dp": 1, "tp": 1}, 0, torch.device("cpu"), "gloo")):
        with pytest.raises(ValueError, match="dp>1"):
            tpre.pretrain(params, W.CFG, x, y, m, TC.PretrainConfig(zero1=True), mesh=mesh)
