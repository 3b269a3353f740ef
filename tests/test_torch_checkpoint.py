"""The port's sharded, asynchronous checkpoint (``utils/checkpoint.py
save_checkpoint_orbax``, ``wait_for_checkpoints``, ``load_checkpoint_orbax``:
JAX's names, the port's own format) against the pickle checkpoint and the
JAX package's orbax backend, on the CPU.

One process: a round trip of f32 and bf16 leaves, Adam's count, step and
extra, bit for bit; the ``.meta.json`` sidecar byte-equal to the one JAX's
``save_checkpoint_orbax`` writes; the snapshot taken before the save
returns (the control, a saver that writes the live tensors, is caught);
a save over an earlier checkpoint of another layout, or over a pickle,
leaves nothing of it readable; a JAX orbax directory refused with the
port's message; ``pretrain(ckpt_backend="orbax")`` resumed from its newest
directory continues an uninterrupted run's losses and JAX's orbax run's
(JAX tests/test_resume.py:111's rtol 1e-4 / atol 1e-5).

On four gloo ranks (``parallel.launch``, tests/torch_ckpt_workers.py, which
imports no jax), one launch: dp = 2 x tp = 2 with ZeRO-1 saves, dp = 2 x
pp = 2 resumes from it and saves, pp = 2 x tp = 2 resumes from that, each
with both backends.  Each rank writes only its own shards; every read of a
directory, on another mesh or in one process, equals the pickle the same
run writes, bit for bit; the resumed runs' losses equal the pickle runs'.
Controls: a rank's files in another rank's slot, a data file swapped, a
manifest missing.
"""

import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ckpt_workers as W
from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.apps import cli as tcli
from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
from reinforcement_learning_in_music_generation_torch.train import optim as topt
from reinforcement_learning_in_music_generation_torch.train import pretrain as tpre
from reinforcement_learning_in_music_generation_torch.utils import checkpoint as tck
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import dataset as jds
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as jlt
from reinforcement_learning_in_music_generation_tpu.train import pretrain as jpre
from reinforcement_learning_in_music_generation_tpu.utils import checkpoint as jck

LAUNCH_S = 300


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(np.asarray, jlt.init_params(jax.random.PRNGKey(0),
                                                              C.LinearTransformerConfig(**W.KW)))


@pytest.fixture(scope="module")
def data():
    x, y, m = jds.synthetic_cp_dataset(16, 16, n_class=W.KW["vocab_sizes"], seed=6)
    return x, y, np.ones_like(m, dtype=np.float32)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module", autouse=True)
def launched(jparams, data, work):
    """The four ranks, started with the module's first test, in the
    background, so that they run while the one-process tests do."""
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(1) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield pool.submit(pm.launch, W.ckpt_ranks, 4, (jparams, data, os.path.join(work, "r")),
                          timeout_s=LAUNCH_S)


@pytest.fixture(autouse=True)
def plain_route(monkeypatch):
    monkeypatch.setenv("RLMG_FFN_BACKEND", "xla")
    monkeypatch.setenv("RLMG_ATTN_BACKEND", "xla")


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"emb": {"pitch": torch.randn(8, 4, generator=g)},
              "layers": {"wq": {"w": torch.randn(2, 4, 6, generator=g),
                                "b": torch.randn(2, 6, generator=g).bfloat16()}},
              "heads": {"pitch": {"w": torch.randn(6, 8, generator=g).bfloat16()}}}
    state = topt.AdamState(topt.tree_map(lambda t: torch.randn(t.shape, generator=g), params),
                           topt.tree_map(lambda t: torch.rand(t.shape, generator=g), params), 11)
    return params, state


def _equal_trees(a, b):
    fa, fb = tw._flat(a), tw._flat(b)
    assert sorted(fa) == sorted(fb)
    for k, v in fb.items():
        assert fa[k].dtype == v.dtype, k
        assert torch.equal(fa[k], v), k


def test_round_trip_is_bit_equal(tmp_path):
    """f32 and bf16 leaves, both moments, Adam's count (an int), step and
    extra come back as they were saved."""
    params, state = _tree()
    path = str(tmp_path / "a.ckpt")
    assert tck.save_checkpoint_orbax(path, params, state, step=5,
                                     extra={"epoch": 2, "loss": 1.5}) == path
    tck.wait_for_checkpoints()
    out = tck.load_checkpoint_orbax(path, params_template=params, opt_state_template=state,
                                    device="cpu")
    _equal_trees(out["params"], params)
    _equal_trees(out["opt_state"].mu, state.mu)
    _equal_trees(out["opt_state"].nu, state.nu)
    assert out["opt_state"].count == 11 and isinstance(out["opt_state"].count, int)
    assert (out["step"], out["extra"]) == (5, {"epoch": 2, "loss": 1.5})
    names = sorted(os.listdir(path))
    assert names[0] == "index.json" and len(names) == 3        # one writer: data, manifest
    index = json.loads((tmp_path / "a.ckpt" / "index.json").read_text())
    assert index["count"] == 11 and index["mesh"] == {} and index["writers"] == [0]
    assert {(leaf["tree"], leaf["path"], leaf["dtype"]) for leaf in index["leaves"]} >= {
        ("params", "['layers']['wq']['b']", "bfloat16"), ("nu", "['emb']['pitch']", "float32")}
    bad = dict(params, extra=params["emb"])
    with pytest.raises(KeyError, match="extra"):
        tck.load_checkpoint_orbax(path, params_template=bad, device="cpu")
    # params alone: no moments
    tck.save_checkpoint_orbax(path, params, wait=True)
    assert tck.load_checkpoint_orbax(path, device="cpu")["opt_state"] is None


def test_sidecar_is_byte_equal_to_jax(tmp_path):
    """``path + ".meta.json"`` holds {"step", "extra"} as JAX writes it."""
    extra = {"epoch": 3, "loss": 0.25, "interrupted": True}
    jck.save_checkpoint_orbax(str(tmp_path / "jax.ckpt"), {"w": jnp.ones(4)}, step=12,
                              extra=extra, wait=True)
    tck.save_checkpoint_orbax(str(tmp_path / "port.ckpt"), {"w": torch.ones(4)}, step=12,
                              extra=extra, wait=True)
    assert ((tmp_path / "port.ckpt.meta.json").read_bytes()
            == (tmp_path / "jax.ckpt.meta.json").read_bytes())


def _held_save(monkeypatch, path, params, state):
    """A save whose writer waits until the caller has updated ``params``
    in place: returns the event that lets it go."""
    go = threading.Event()
    writer = tck._writer
    monkeypatch.setattr(tck, "_writer", lambda *a: (go.wait(5), writer(*a)))
    tck.save_checkpoint_orbax(path, params, state)
    return go


class _Live:
    """The control's snapshot: the live tensors, read when written."""

    def __init__(self, pieces):
        self.pieces = pieces

    def numpy(self):
        return torch.cat(self.pieces).numpy()


def test_in_place_update_after_the_save_returns_is_not_saved(monkeypatch, tmp_path):
    """The steps update params and the moments in place: the save's
    snapshot is taken before it returns, so an update made while the
    writer runs does not reach the files.  Control: a saver that writes
    the live tensors saves the updated values, and the check catches it."""
    found = {}
    for name, snapshot in (("copy", tck._snapshot), ("live", _Live)):
        monkeypatch.setattr(tck, "_snapshot", snapshot)
        params, state = _tree()
        before = topt.tree_map(torch.clone, params), topt.tree_map(torch.clone, state.mu)
        go = _held_save(monkeypatch, str(tmp_path / name), params, state)
        topt.tree_map(lambda t: t.add_(1.0), params)
        topt.tree_map(lambda t: t.mul_(2.0), state.mu)
        go.set()
        out = tck.load_checkpoint_orbax(str(tmp_path / name), device="cpu")
        found[name] = all(torch.equal(a, b) for a, b in zip(
            topt.tree_leaves(out["params"]) + topt.tree_leaves(out["opt_state"].mu),
            topt.tree_leaves(before[0]) + topt.tree_leaves(before[1])))
        monkeypatch.undo()
    assert found == {"copy": True, "live": False}


def test_a_save_replaces_an_earlier_one(launched, tmp_path):
    """Saves to one path, as the loss buckets and trainloss_final reuse
    names: one process's save over the four-rank directory of the mesh
    run, and over a pickle file, leaves only its own files; loading gives
    its tree; the earlier manifests, were they left, would not match."""
    src = _r0(launched)["A"]["orbax"][1]
    path = str(tmp_path / "trainloss_final.ckpt")
    shutil.copytree(src, path)
    old = json.loads(open(os.path.join(path, "index.json")).read())
    assert len(old["writers"]) == 4
    params, state = _tree(1)
    tck.save_checkpoint_orbax(path, params, state, wait=True)
    new = json.loads(open(os.path.join(path, "index.json")).read())
    assert new["token"] != old["token"] and new["writers"] == [0]
    assert all(new["token"] in n for n in os.listdir(path) if n != "index.json")
    assert len(os.listdir(path)) == 3
    _equal_trees(tck.load_checkpoint_orbax(path, device="cpu")["params"], params)
    # the earlier token's rank-0 manifest put back beside the new save's
    # files is not read as part of it
    shutil.copy(os.path.join(src, tck._names(old["token"], 0)[1]), path)
    _equal_trees(tck.load_checkpoint_orbax(path, device="cpu")["params"], params)
    pickled = str(tmp_path / "p.ckpt")
    tck.save_checkpoint(pickled, params, state)
    tck.save_checkpoint_orbax(pickled, params, state, wait=True)
    assert os.path.isdir(pickled)
    _equal_trees(tck.load_checkpoint_orbax(pickled, device="cpu")["params"], params)


def test_a_jax_orbax_directory_is_refused(tmp_path, jparams):
    """JAX's orbax (OCDBT) directory is not read: the port says so."""
    path = str(tmp_path / "jax.ckpt")
    p = jax.tree_util.tree_map(jnp.asarray, {"w": np.ones((2, 3), np.float32)})
    jck.save_checkpoint_orbax(path, p, opt_state={"mu": p}, step=1, wait=True)
    assert os.listdir(path)
    with pytest.raises(tck.NotAPortCheckpoint, match="not a checkpoint of this port"):
        tck.load_checkpoint_orbax(path, device="cpu")
    with pytest.raises(tck.NotAPortCheckpoint, match="not a checkpoint of this port"):
        tpre.pretrain(tw.from_jax_params(jparams, device="cpu"), W.CFG,
                      *jds.synthetic_cp_dataset(2, 16, n_class=W.KW["vocab_sizes"]),
                      TC.PretrainConfig(batch_size=2), resume_from=path)


def test_pretrain_orbax_backend_resumes_like_an_uninterrupted_run_and_jax(tmp_path, jparams,
                                                                          data):
    """JAX tests/test_resume.py:111 on the port: two epochs with the
    directory backend, resumed from the newest directory for two more,
    give the losses of four uninterrupted epochs, and JAX's orbax run from
    the same weights (dropout 0) gives them too; no pickle is written."""
    x, y, m = data
    cfg = C.LinearTransformerConfig(**W.KW)
    pc = lambda cls, d, n, **kw: cls(n_epoch=n, batch_size=8, lr=1e-3, ckpt_dir=str(tmp_path / d),
                                     exp_dir=str(tmp_path / (d + "e")), **kw)
    port = lambda: tw.from_jax_params(jparams, device="cpu")
    _, _, ref = tpre.pretrain(port(), W.CFG, x, y, m, pc(TC.PretrainConfig, "ref", 4))
    _, _, h1 = tpre.pretrain(port(), W.CFG, x, y, m,
                             pc(TC.PretrainConfig, "orb", 2, ckpt_backend="orbax"))
    names = os.listdir(tmp_path / "orb")
    assert names and all(os.path.isdir(tmp_path / "orb" / n) for n in names
                         if not n.endswith(".meta.json"))
    latest = W.newest(str(tmp_path / "orb"))
    _, st2, h2 = tpre.pretrain(port(), W.CFG, x, y, m,
                               pc(TC.PretrainConfig, "orb2", 4, ckpt_backend="orbax"),
                               resume_from=latest)
    np.testing.assert_allclose(h1 + h2, ref, rtol=1e-4, atol=1e-5)
    assert st2.count == 8
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    _, _, j1 = jpre.pretrain(jp, cfg, x, y, m, pc(C.PretrainConfig, "jorb", 2, ckpt_backend="orbax"))
    jnames = [n for n in os.listdir(tmp_path / "jorb") if not n.endswith(".json")]
    jlatest = max(jnames, key=lambda n: json.loads(
        (tmp_path / "jorb" / (n + ".meta.json")).read_text())["extra"]["epoch"])
    _, _, j2 = jpre.pretrain(jp, cfg, x, y, m, pc(C.PretrainConfig, "jorb2", 4,
                                                  ckpt_backend="orbax"),
                             resume_from=str(tmp_path / "jorb" / jlatest))
    np.testing.assert_allclose(h1 + h2, j1 + j2, rtol=1e-4, atol=1e-5)


def test_cli_pretrain_writes_directories(tmp_path):
    """``cli pretrain --ckpt-backend orbax``: directories, no pickle;
    ``--resume`` takes one."""
    argv = ["pretrain", "--device", "cpu", "--synthetic", "--layers", "1", "--synthetic-songs",
            "4", "--batch-size", "2", "--seq-len", "16", "--ckpt-backend", "orbax"]
    tcli.main(argv + ["--epochs", "1", "--exp-dir", str(tmp_path / "e"),
                      "--ckpt-dir", str(tmp_path / "c")])
    (name,) = [n for n in os.listdir(tmp_path / "c") if not n.endswith(".meta.json")]
    assert os.path.isfile(tmp_path / "c" / name / "index.json")
    res = tcli.main(argv + ["--epochs", "2", "--resume", str(tmp_path / "c" / name),
                            "--exp-dir", str(tmp_path / "e2"), "--ckpt-dir", str(tmp_path / "c2")])
    assert len(res["history"]) == 1 and np.isfinite(res["history"][0])


# -- the four ranks ------------------------------------------------------------

def _r0(launched):
    out = launched.result()
    assert [r["rank"] for r in out] == [0, 1, 2, 3]
    return out[0]


def _index(path):
    with open(os.path.join(path, "index.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("tag,writers", [("A", [0, 1, 2, 3]), ("B", [0, 1]), ("C", [0, 1, 2, 3])])
def test_each_rank_writes_only_its_own_shards(launched, tag, writers):
    """A: dp = 2 x tp = 2 with ZeRO-1, every rank writes (the moments'
    dp slices); B: dp = 2 x pp = 2, dp index 0's two stages; C: pp = 2 x
    tp = 2, every rank.  The shards tile every leaf once: their bytes add
    up to the whole tree's, nothing replicated, nothing gathered."""
    path = _r0(launched)[tag]["orbax"][1]
    index = _index(path)
    assert index["writers"] == writers
    assert index["mesh"] == W.MESHES[tag]
    whole = sum(int(np.prod(leaf["shape"])) * 4 for leaf in index["leaves"])
    assert sum(s["nbytes"] for s in index["shards"]) == whole
    for r in writers:
        data, manifest = tck._names(index["token"], r)
        size = os.path.getsize(os.path.join(path, data))
        assert size == sum(s["nbytes"] for s in index["shards"] if s["rank"] == r)
        assert os.path.isfile(os.path.join(path, manifest))
    sliced = {leaf["dp_dim"] is not None for leaf in index["leaves"] if leaf["tree"] != "params"}
    assert (True in sliced) == (tag == "A")


@pytest.mark.parametrize("tag", ["B", "C"])
def test_a_read_on_another_mesh_equals_the_pickle(launched, tag):
    """The previous mesh's directory read on this one (its shards put
    together, this mesh's cut, gathered back) equals its pickle read the
    same way: parameters and both moments bit for bit, Adam's count."""
    read = _r0(launched)[tag]["read"]
    for part in ("params", "mu", "nu"):
        assert sorted(read["orbax"][part]) == sorted(read["pickle"][part])
        for k, v in read["pickle"][part].items():
            np.testing.assert_array_equal(read["orbax"][part][k], v, err_msg=f"{part} {k}")
    assert read["orbax"]["count"] == read["pickle"]["count"] > 0


@pytest.mark.parametrize("tag", ["A", "B", "C"])
def test_one_process_read_equals_the_pickle(launched, tag):
    """Each mesh's directory read in one process equals its pickle."""
    orbax, pickle_path = (_r0(launched)[tag][b][1] for b in ("orbax", "pickle"))
    a = tck.load_checkpoint_orbax(orbax, device="cpu")
    b = tck.load_checkpoint(pickle_path, device="cpu")
    _equal_trees(a["params"], b["params"])
    _equal_trees(a["opt_state"].mu, b["opt_state"].mu)
    _equal_trees(a["opt_state"].nu, b["opt_state"].nu)
    assert (a["opt_state"].count, a["step"], a["extra"]) == (
        b["opt_state"].count, b["step"], b["extra"])


def test_resumed_runs_equal_the_pickle_runs(launched, jparams, data, tmp_path):
    """Each mesh's run on the directories gives the pickle run's losses
    (A from the weights, B resumed from A's, C from B's), and C's
    directory resumed in one process gives the pickle's."""
    r0 = _r0(launched)
    for tag in ("A", "B", "C"):
        assert len(r0[tag]["orbax"][0]) == 1
        np.testing.assert_array_equal(r0[tag]["orbax"][0], r0[tag]["pickle"][0], err_msg=tag)
    hist = {}
    for b in ("orbax", "pickle"):
        pcfg = TC.PretrainConfig(n_epoch=4, batch_size=W.BATCH, lr=1e-3,
                                 ckpt_dir=str(tmp_path / b), exp_dir=str(tmp_path / (b + "e")))
        hist[b] = tpre.pretrain(tw.from_jax_params(jparams, device="cpu"), W.CFG, *data, pcfg,
                                resume_from=r0["C"][b][1])[2]
    assert len(hist["orbax"]) == 1
    np.testing.assert_array_equal(hist["orbax"], hist["pickle"])


def test_a_rank_in_another_ranks_slot_is_refused(launched, tmp_path):
    """Controls: rank 1's data and manifest written into rank 0's slot; a
    data file swapped for another rank's, its manifest kept; a manifest
    missing (the save not complete)."""
    src = _r0(launched)["A"]["orbax"][1]
    index = _index(src)
    token = index["token"]
    cases = {}
    for case in ("slot", "data", "missing"):
        path = str(tmp_path / case)
        shutil.copytree(src, path)
        d0, m0 = (os.path.join(path, n) for n in tck._names(token, 0))
        d1, m1 = (os.path.join(path, n) for n in tck._names(token, 1))
        if case == "slot":
            shutil.copy(d1, d0)
            shutil.copy(m1, m0)
        elif case == "data":
            shutil.copy(d1, d0)
        else:
            os.remove(os.path.join(path, tck._names(token, 3)[1]))
        with pytest.raises(RuntimeError) as err:
            tck.load_checkpoint_orbax(path, device="cpu")
        cases[case] = str(err.value)
    assert "rank 1's" in cases["slot"] and "in rank 0's slot" in cases["slot"]
    assert "not the data rank 0 committed" in cases["data"]
    assert "not complete" in cases["missing"]
    tck.load_checkpoint_orbax(src, device="cpu")        # the untouched directory reads


def test_ranks_import_no_jax(launched):
    assert all(r["modules"] == [] for r in launched.result())
