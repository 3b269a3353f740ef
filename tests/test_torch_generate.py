"""The port's generation path (``generate/sampler.py``, ``apps/cli.py
generate``) against the JAX package, on the CPU, where every kernel wrapper
takes its plain version."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.apps import cli
from reinforcement_learning_in_music_generation_torch.data import tokenizer as ttok
from reinforcement_learning_in_music_generation_torch.generate import sampler as tsam
from reinforcement_learning_in_music_generation_torch.ops import sampling as tsmp
from reinforcement_learning_in_music_generation_torch.parallel.mesh import Mesh
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import tokenizer as jtok
from reinforcement_learning_in_music_generation_tpu.generate import sampler as jsam
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as lt
from reinforcement_learning_in_music_generation_tpu.utils.checkpoint import save_checkpoint

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_greedy_tokens.json")
VOCAB = (56, 135, 18, 87, 18, 25)
# the config of tests/test_golden_decode.py
CFG = C.LinearTransformerConfig(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=32,
                                n_layer=2, n_head=2, d_inner=64)
TCFG = TC.LinearTransformerConfig(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=32,
                                  n_layer=2, n_head=2, d_inner=64)


@pytest.fixture(scope="module")
def golden_params():
    """The golden stream's weights, JAX init_params(PRNGKey(42)), as torch."""
    jp = lt.init_params(jax.random.PRNGKey(42), CFG)
    return tw.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def _init(b):
    return torch.tensor([[tsam.CP_SEED]], dtype=torch.int32).expand(b, 1, 6).contiguous()


@pytest.mark.parametrize("path", ["plain", "fused", "chunked"])
def test_greedy_reproduces_golden_stream(path, golden_params, golden, monkeypatch):
    """Every decode path of the port, greedy with an f32 state, emits the
    JAX package's pinned 32-step greedy stream for all 5 songs."""
    monkeypatch.setenv("RLMG_DECODE_STATE_DTYPE", "float32")
    kw = dict(max_tokens=32, greedy=True, settings=tsmp.GREEDY)
    if path == "chunked":
        res = tsam.generate_tokens_persistent(golden_params, TCFG, _init(5), **kw)
    else:
        res = tsam.generate_tokens(golden_params, TCFG, _init(5), fused=path == "fused", **kw)
    assert res.tokens.shape == (5, 33, 6) and bool(res.valid.all())
    for i in range(5):
        assert res.tokens[i].tolist() == golden, f"song {i}"


def test_generate_songs_greedy_pins_plain_path(golden_params, golden, monkeypatch):
    """Greedy never takes a kernel path unless an env var opts in, whatever
    the dispatch predicates say (the JAX greedy pin)."""
    for var in ("RLMG_PERSISTENT_DECODE", "RLMG_FUSED_DECODE", "RLMG_FUSED_SAMPLING"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(tsam, "use_persistent_decode", lambda *a, **k: True)
    monkeypatch.setattr(tsam, "use_fused_decode", lambda *a: True)
    called = []
    real = tsam.generate_tokens
    monkeypatch.setattr(tsam, "generate_tokens", lambda *a, **k: called.append(k) or real(*a, **k))
    gcfg = TC.GenerateConfig(batch_size=5, max_tokens=32, bar_production=10 ** 9, greedy=True)
    songs = tsam.generate_songs(golden_params, TCFG, gcfg)
    assert len(songs) == 5 and all(s.tolist() == golden for s in songs)
    assert called[0]["fused"] is False and called[0]["fused_sampling"] is False


def test_bar_stop_matches_jax_semantics(golden_params):
    """Stochastic decode with a bar-count stop: tokens after a song's last
    bar are zero and invalid, the bar that completes it is kept, and the
    JAX post-hoc assembly of the same stream gives the same mask."""
    gen = torch.Generator().manual_seed(3)
    res = tsam.generate_tokens(golden_params, TCFG, _init(6), generator=gen, max_tokens=200,
                               bar_cond=3, fused_sampling=True)
    toks, valid = res.tokens[:, 1:].numpy(), res.valid[:, 1:].numpy()
    is_bar = toks[..., 2] == 1
    before = 1 + np.cumsum(is_bar, 1) - is_bar             # the seed row is a bar
    np.testing.assert_array_equal(valid, before < 3)
    assert (toks[~valid] == 0).all()
    np.testing.assert_array_equal(res.n_bars.numpy(), np.minimum(1 + is_bar.sum(1), 3))
    ref = jsam._persistent_assemble_fn(3, None, 2, 1, 6, 1, 1)(
        jnp.asarray(_init(6).numpy()), jnp.ones((6,), jnp.int32),
        (jnp.asarray(toks.transpose(1, 2, 0)),))
    ours = tsam._assemble(_init(6), torch.ones(6, dtype=torch.int32), torch.from_numpy(toks),
                          3, None, 2, 1)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_chunked_path_assembles_like_jax(golden_params):
    """The chunked path with a bar stop and a token budget: its result is
    the JAX assembly of its own raw stream."""
    gen = torch.Generator().manual_seed(4)
    res = tsam.generate_tokens_persistent(golden_params, TCFG, _init(3), generator=gen,
                                          max_tokens=40, bar_cond=4, token_count=30,
                                          chunk=16)
    toks = res.tokens[:, 1:].numpy()
    assert res.tokens.shape[1] - 1 in (16, 32, 40)
    ref = jsam._persistent_assemble_fn(4, 30, 2, 1, 3, 1, 1)(
        jnp.asarray(_init(3).numpy()), jnp.ones((3,), jnp.int32),
        (jnp.asarray(toks.transpose(1, 2, 0)),))
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(res.n_bars.numpy(), np.asarray(ref.n_bars))


def test_midi_of_golden_stream_matches_jax_bytes(golden, tmp_path):
    _, w2e = ttok.drop_type(ttok.construct_cp_dict())
    ours, ref = str(tmp_path / "ours.mid"), str(tmp_path / "ref.mid")
    ttok.write_midi_cp(np.asarray(golden), ours, w2e)
    jtok.write_midi_cp(np.asarray(golden), ref, w2e)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_dispatch_predicates(monkeypatch):
    for var in ("RLMG_FUSED_DECODE", "RLMG_PERSISTENT_DECODE", "RLMG_PERSISTENT_MIN_BATCH",
                "RLMG_FUSED_SAMPLING"):
        monkeypatch.delenv(var, raising=False)
    assert tsam.use_fused_decode("cuda") and not tsam.use_fused_decode("cpu")
    assert tsam.persistent_min_batch() == jsam.persistent_min_batch() == 65
    assert tsam.use_persistent_decode("cuda", batch=65)
    assert not tsam.use_persistent_decode("cuda", batch=64)
    assert not tsam.use_persistent_decode("cpu", batch=128)
    assert tsam.use_fused_sampling()
    monkeypatch.setenv("RLMG_PERSISTENT_DECODE", "1")
    monkeypatch.setenv("RLMG_FUSED_DECODE", "0")
    assert tsam.use_persistent_decode("cpu", batch=1) and not tsam.use_fused_decode("cuda")


def test_unported_paths_raise(golden_params, monkeypatch):
    """A mesh whose tp does not divide the heads raises before any collective
    (dp and tp meshes are ported: tests/test_torch_parallel.py,
    tests/test_torch_tensor_parallel.py); the latency path and the parallel
    prompt prefill, unported until the latency slice, now run."""
    gcfg = TC.GenerateConfig(batch_size=2, max_tokens=4, bar_production=10 ** 9)
    tp_mesh = Mesh({"dp": 1, "tp": 3}, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="n_head"):
        tsam.generate_songs(golden_params, TCFG, gcfg, mesh=tp_mesh)
    songs = tsam.generate_songs(golden_params, TCFG, gcfg, init=[tsam.CP_SEED] * 16)
    assert [s.shape for s in songs] == [(20, 6)] * 2
    with pytest.raises(ValueError, match="init"):
        tsam.generate_songs(golden_params, TCFG, gcfg, init=(0, 0, 1, 0, 0, 99))
    monkeypatch.setenv("RLMG_LATENCY_DECODE", "1")
    assert [s.shape for s in tsam.generate_songs(golden_params, TCFG, gcfg)] == [(5, 6)] * 2


def test_cli_generate_writes_midis(tmp_path):
    out = tmp_path / "midis"
    res = cli.main(["generate", "--songs", "2", "--layers", "1", "--bars", "2",
                    "--max-tokens", "24", "--device", "cpu", "--out-dir", str(out)])
    assert res["songs"] == 2 and res["tokens"] >= 2
    for i in range(2):
        with open(out / f"get_{i}.mid", "rb") as f:
            assert f.read(4) == b"MThd"
    with open(tmp_path / "runtime_stats.json") as f:     # beside --out-dir, as in JAX
        stats = json.load(f)
    assert sum(stats["words_len_list"]) == res["tokens"] and len(stats["song_time"]) == 2


def test_cli_reads_jax_checkpoint(tmp_path):
    """--ckpt loads a JAX save_checkpoint file: greedy output equals the
    port's own generation from the converted weights."""
    cfg = C.agent_config(VOCAB, n_layer=1)
    jp = lt.init_params(jax.random.PRNGKey(5), cfg)
    path = str(tmp_path / "agent.pkl")
    save_checkpoint(path, jp)
    out = tmp_path / "out"
    cli.main(["generate", "--songs", "1", "--layers", "1", "--greedy", "--max-tokens", "8",
              "--bars", "1000", "--device", "cpu", "--ckpt", path, "--out-dir", str(out),
              "--dtype", "float32"])
    tp = tw.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    gcfg = TC.GenerateConfig(batch_size=1, max_tokens=8, bar_production=1000, greedy=True)
    song = tsam.generate_songs(tp, TC.agent_config(VOCAB, n_layer=1), gcfg)[0]
    _, w2e = ttok.drop_type(ttok.construct_cp_dict())
    ttok.write_midi_cp(song, str(tmp_path / "ref.mid"), w2e)
    with open(out / "get_0.mid", "rb") as a, open(tmp_path / "ref.mid", "rb") as b:
        assert a.read() == b.read()


def test_cache_holds_its_tensors_weakly_and_builds_again_after_an_update():
    """sampler._cached (the token graphs' and the packed weights' cache): a
    hit while the params' tensors live unchanged; a new build after an
    in-place update or a replaced tensor; the entry gone once a tensor is
    freed, since it holds none of them; the oldest entry evicted past its
    size."""
    import collections
    import gc
    cache = collections.OrderedDict()
    builds = []

    def get(p, key="k"):
        return tsam._cached(cache, 2, key, p, lambda: builds.append(key) or len(builds))

    p = {"a": torch.zeros(3), "b": {"c": torch.ones(2)}}
    assert get(p) == 1 and get(p) == 1
    p["b"]["c"].add_(1)                             # updated in place
    assert get(p) == 2 and get(p) == 2
    p["b"]["c"] = torch.ones(2)                     # replaced: the old tensor is freed
    assert "k" not in cache
    assert get(p) == 3
    del p
    gc.collect()
    assert not cache
    q = [{"a": torch.zeros(1)} for _ in range(3)]
    for i, qi in enumerate(q):
        get(qi, i)
    assert list(cache) == [1, 2] and builds[-3:] == [0, 1, 2]
