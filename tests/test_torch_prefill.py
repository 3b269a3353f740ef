"""The port's parallel prompt prefill (``models/linear_transformer.py
forward_prefill``, ``prefill_bucket``) and its use in ``generate/sampler.py``
against the JAX package and against the port's own per-token seeding, on
the CPU (the JAX package's ``tests/test_prefill.py`` at the port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.generate import sampler as tsam
from reinforcement_learning_in_music_generation_torch.models import common as tcm
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as lt

VOCAB = (8, 10, 6, 12, 6, 7)
KW = dict(vocab_sizes=VOCAB, emb_sizes=(8,) * 6, d_model=32, n_head=2, n_layer=2,
          d_inner=64, dropout=0.0, max_len=128, attn_chunk=16)
CFG = C.LinearTransformerConfig(**KW, dtype="float32")
TCFG = TC.LinearTransformerConfig(**KW)


@pytest.fixture(scope="module")
def both():
    jp = lt.init_params(jax.random.PRNGKey(0), CFG)
    return jp, tw.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _prompt(seed, b, t):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, v, size=(b, t)) for v in VOCAB], -1).astype(np.int32)


def test_prefill_bucket_matches_jax():
    for t in (1, 16, 20, 63, 64, 65, 200):
        assert tlt.prefill_bucket(t) == lt.prefill_bucket(t)


@pytest.mark.parametrize("attn", ["xla", "pallas"])
@pytest.mark.parametrize("padded", [False, True])
def test_forward_prefill_matches_jax(both, attn, padded, monkeypatch):
    """h_last and the state within 1e-4 of JAX's, on an exact-length prompt
    and on one bucket-padded with n_valid; under RLMG_ATTN_BACKEND=pallas the
    port's attention takes kernel F's route (its plain twin on the CPU)."""
    monkeypatch.setenv("RLMG_ATTN_BACKEND", attn)
    jp, tp = both
    x = _prompt(3, 2, 20)
    n_valid = None
    if padded:
        x = np.pad(x, ((0, 0), (0, tlt.prefill_bucket(20) - 20), (0, 0)))
        n_valid = 20
    jh, js = lt.forward_prefill(jp, CFG, jnp.asarray(x),
                                None if n_valid is None else jnp.int32(n_valid))
    th, ts = tlt.forward_prefill(tp, TCFG, torch.from_numpy(x), n_valid)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.s.numpy(), np.asarray(js.s), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.z.numpy(), np.asarray(js.z), rtol=1e-4, atol=1e-4)
    assert ts.step == int(js.step) == 20


def test_prefill_state_matches_scan_seeding(both, monkeypatch):
    """The port's _seed_state with the prefill (20 tokens >= 16) against the
    per-token scan (RLMG_PREFILL=0), exact and bucket-padded with n_valid."""
    _, tp = both
    x = torch.from_numpy(_prompt(4, 3, 20))
    pe = tcm.sinusoidal_table(TCFG.max_len, TCFG.d_model, torch.float32, "cpu")
    fresh = lambda: tlt.init_decode_state(TCFG, 3, device="cpu")
    monkeypatch.setenv("RLMG_PREFILL", "0")
    ref = tsam._seed_state(tp, TCFG, x, fresh(), pe)
    monkeypatch.delenv("RLMG_PREFILL")
    xp = torch.nn.functional.pad(x, (0, 0, 0, tlt.prefill_bucket(20) - 20))
    for got in (tsam._seed_state(tp, TCFG, x, fresh(), pe),
                tsam._seed_state(tp, TCFG, xp, fresh(), pe, n_valid=20)):
        np.testing.assert_allclose(got.s.numpy(), ref.s.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.z.numpy(), ref.z.numpy(), rtol=1e-4, atol=1e-4)
        assert got.step == ref.step == 20


@pytest.mark.parametrize("path", ["per-step", "chunked", "latency"])
def test_generate_songs_prefill_prompt_matches_scan_seeding(both, path, monkeypatch):
    """A 20-token non-greedy prompt takes the prefill (bucket-padded to 64)
    and no longer raises: the songs equal those of the per-token seeding
    (RLMG_PREFILL=0) with the same seed, and each holds the whole prompt and
    no pad rows (JAX tests/test_prefill.py:122-143)."""
    _, tp = both
    for var in ("RLMG_PERSISTENT_DECODE", "RLMG_LATENCY_DECODE", "RLMG_PREFILL"):
        monkeypatch.delenv(var, raising=False)
    if path == "chunked":
        monkeypatch.setenv("RLMG_PERSISTENT_DECODE", "1")
    if path == "latency":
        monkeypatch.setenv("RLMG_LATENCY_DECODE", "1")
    prompt = _prompt(7, 1, 20)[0]
    gcfg = TC.GenerateConfig(n_songs=2, bar_production=None, token_count=12, max_tokens=12,
                             greedy=False, batch_size=2, seed=11)
    monkeypatch.setenv("RLMG_PREFILL", "0")
    ref = tsam.generate_songs(tp, TCFG, gcfg, init=prompt)
    monkeypatch.delenv("RLMG_PREFILL")
    got = tsam.generate_songs(tp, TCFG, gcfg, init=prompt)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (32, 6)
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g[:20], prompt)
