"""The port's continuous batcher and serving daemon (``generate/serving.py``)
against the JAX package's, on the CPU, at the small config of
``tests/test_serving.py``.

The sampled streams cannot share JAX's RNG, so the port's own counterparts
of the JAX tests hold it to its own ``generate_tokens``; with the fused
sampler replaced by greedy argmax in both packages (monkeypatched here, not
in either package) the songs, ``steps`` and ``songs_done`` must equal
JAX's; the host assembly and the daemon are held to JAX's on the same
inputs through stubs."""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.generate import sampler as tsam
from reinforcement_learning_in_music_generation_torch.generate import serving as tsrv
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.ops import sampling as tsmp
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.generate import serving as jsrv
from reinforcement_learning_in_music_generation_tpu.models import common as jcm
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as jlt
from reinforcement_learning_in_music_generation_tpu.ops import sampling as jsmp

KW = dict(vocab_sizes=(8, 16, 4, 12, 4, 6), emb_sizes=(8,) * 6, d_model=32, n_layer=2,
          n_head=2, d_inner=64)
CFG = C.LinearTransformerConfig(**KW)
TCFG = TC.LinearTransformerConfig(**KW)


@pytest.fixture(scope="module")
def jparams():
    return jlt.init_params(jax.random.PRNGKey(0), CFG)


@pytest.fixture(scope="module")
def params(jparams):
    return tw.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _bars(song, bar_token_id=1):
    return int((song[:, 2] == bar_token_id).sum())


# -- the port's own counterparts of the JAX tests ----------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_continuous_serving_completes_exact_bar_counts(params, fused):
    res = tsrv.generate_songs_continuous(params, TCFG, _gen(42), n_songs=10, bar_cond=3,
                                         batch=4, max_tokens_per_song=128, fused=fused)
    assert len(res.songs) == 10 and res.songs_done >= 10
    for s in res.songs:
        assert s.ndim == 2 and s.shape[1] == TCFG.n_fields
        assert _bars(s) == 3
        np.testing.assert_array_equal(s[0], tsam.CP_SEED)


def test_continuous_first_songs_match_generate_tokens(params):
    """Before its first refill each slot draws what ``generate_tokens``'
    fused-sampling loop draws from the same generator: the first song of
    every slot is among the served songs (enough songs that each slot
    finishes its first)."""
    res = tsrv.generate_songs_continuous(params, TCFG, _gen(42), n_songs=16, bar_cond=3,
                                         batch=4, max_tokens_per_song=128)
    init = torch.tensor([[tsam.CP_SEED]], dtype=torch.int32).expand(4, 1, 6).contiguous()
    gt = tsam.generate_tokens(params, TCFG, init, generator=_gen(42),
                              max_tokens=max(res.steps, 8), bar_cond=3,
                              settings=tsmp.CP_SAMPLING, fused_sampling=True)
    served = {tuple(map(tuple, s)) for s in res.songs}
    for k in range(4):
        ref = gt.tokens[k][gt.valid[k]].numpy()
        assert tuple(map(tuple, ref)) in served, f"slot {k} first song"


def test_stop_check_interval_changes_nothing(params, monkeypatch):
    """The host checks the stop every STOP_CHECK_EVERY steps and the loop
    runs past it; steps, songs_done and the songs are those of a loop that
    checks after every step (the JAX loop's exact stop)."""
    kw = dict(n_songs=7, bar_cond=2, batch=3, max_tokens_per_song=64)
    base = tsrv.generate_songs_continuous(params, TCFG, _gen(5), **kw)
    ran = tsrv.generate_songs_continuous.steps_run
    monkeypatch.setattr(tsam, "STOP_CHECK_EVERY", 1)
    exact = tsrv.generate_songs_continuous(params, TCFG, _gen(5), **kw)
    assert tsrv.generate_songs_continuous.steps_run - ran == exact.steps
    assert (base.steps, base.songs_done) == (exact.steps, exact.songs_done)
    for a, b in zip(base.songs, exact.songs):
        np.testing.assert_array_equal(a, b)


def test_budget_exhaustion_returns_the_completed_songs(params):
    res = tsrv.generate_songs_continuous(params, TCFG, _gen(3), n_songs=50, bar_cond=30,
                                         batch=2, max_tokens_per_song=16)
    assert res.steps == (25 + 1) * 16 and len(res.songs) <= 50
    for s in res.songs:
        assert _bars(s) == 30


# -- greedy: the JAX package's songs, steps and songs_done -------------------------

def _greedy(monkeypatch):
    """Greedy argmax in place of the fused sampler, in both packages."""
    jorig, torig = jsmp.sample_fields_fused, tsmp.sample_fields_fused
    monkeypatch.setattr(jsmp, "sample_fields_fused",
                        lambda rng, logits, vocab, settings, greedy=False:
                        jorig(rng, logits, vocab, settings, greedy=True))
    monkeypatch.setattr(tsmp, "sample_fields_fused",
                        lambda gen, logits, vocab, settings, greedy=False:
                        torig(gen, logits, vocab, settings, greedy=True))
    jsrv._serve_loop.clear_cache()


# (bar_token_id, bar_cond, n_songs): slots that finish at different steps
GREEDY_CASES = [(0, 3, 8), (0, 2, 8), (1, 3, 8), (0, 1, 9)]


@pytest.mark.parametrize("bar_token_id,bar_cond,n_songs", GREEDY_CASES)
def test_greedy_continuous_matches_jax(jparams, params, monkeypatch, bar_token_id, bar_cond,
                                       n_songs):
    _greedy(monkeypatch)
    rng = np.random.default_rng(1)
    init = np.stack([rng.integers(0, v, size=4) for v in CFG.vocab_sizes],
                    -1).astype(np.int32)[:, None]
    assert len({tuple(r) for r in init[:, 0]}) == 4           # a different row a slot
    flags = []
    loop = tsrv._serve_loop

    def recording(*a, **k):
        out = loop(*a, **k)
        flags.append(out[1][:out[2]])
        return out
    monkeypatch.setattr(tsrv, "_serve_loop", recording)
    kw = dict(n_songs=n_songs, bar_cond=bar_cond, batch=4, max_tokens_per_song=32,
              init_token=init, bar_token_id=bar_token_id)
    ref = jsrv.generate_songs_continuous(jparams, CFG, jax.random.PRNGKey(0), fused=False, **kw)
    ours = tsrv.generate_songs_continuous(params, TCFG, _gen(0), fused=False, **kw)
    jsrv._serve_loop.clear_cache()
    assert (ours.steps, ours.songs_done) == (ref.steps, ref.songs_done)
    assert len(ours.songs) == len(ref.songs) == n_songs
    for a, b in zip(ours.songs, ref.songs):
        np.testing.assert_array_equal(a, np.asarray(b))
    fin = flags[0]
    # a refill while another slot is mid-song
    assert np.any(fin.any(1) & ~fin.all(1))


# -- the host assembly against JAX's, on the same (toks, fin) -----------------------

@pytest.mark.parametrize("n_songs,steps", [(5, 9), (3, 12), (20, 12)])
def test_host_assembly_matches_jax(jparams, params, monkeypatch, n_songs, steps):
    rng = np.random.default_rng(n_songs)
    b, T = 3, 16
    toks = rng.integers(0, 4, size=(T, b, 6)).astype(np.int32)
    fin = rng.random((T, b)) < 0.3
    done = int(fin[:steps].sum())
    monkeypatch.setattr(jsrv, "_serve_loop", lambda *a, **k: (jnp.asarray(toks),
                                                              jnp.asarray(fin), steps, done))
    monkeypatch.setattr(tsrv, "_serve_loop", lambda *a, **k: (toks, fin, steps, done))
    init = rng.integers(0, 4, size=(b, 1, 6)).astype(np.int32)
    kw = dict(n_songs=n_songs, bar_cond=2, batch=b, init_token=init)
    ref = jsrv.generate_songs_continuous(jparams, CFG, jax.random.PRNGKey(0), **kw)
    ours = tsrv.generate_songs_continuous(params, TCFG, _gen(0), **kw)
    assert (ours.steps, ours.songs_done) == (ref.steps, ref.songs_done)
    assert len(ours.songs) == len(ref.songs) == min(n_songs, done)
    for a, b_ in zip(ours.songs, ref.songs):
        np.testing.assert_array_equal(a, b_)


@pytest.mark.parametrize("n_songs,budget", [(4, 40), (0, 40), (100, 13)])
def test_exact_stop_is_the_jax_loops(n_songs, budget):
    """``_exact_stop`` on flags of a loop that ran past its stop: the step
    after the first at which the running total of finishes reaches n_songs
    (or the budget), and the finishes up to there."""
    fin = np.random.default_rng(2).random((40, 3)) < 0.25
    t = done = 0
    while t < budget and done < n_songs:        # the JAX while_loop
        done += int(fin[t].sum())
        t += 1
    assert tsrv._exact_stop(fin[:max(t, min(budget, 40))], n_songs, budget) == (t, done)


# -- embed_input and decode_step at a position per slot ------------------------------

def test_embed_input_takes_a_step_per_slot(jparams, params):
    rng = np.random.default_rng(4)
    tok = np.stack([rng.integers(0, v, size=5) for v in CFG.vocab_sizes], -1).astype(np.int32)
    step = np.array([0, 7, 3, 19999, 42])
    pe = jcm.sinusoidal_table(CFG.max_len, CFG.d_model, jnp.float32)
    ref = jcm.linear(jparams["in_linear"], jcm.embed_fields(jparams["emb"], jnp.asarray(tok)))
    ref = ref + pe[jnp.asarray(step)]
    tpe = torch.tensor(np.asarray(pe))          # one table: the gather is what is compared
    ours = tlt.embed_input(params, TCFG, torch.as_tensor(tok), torch.as_tensor(step), tpe)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # each slot gets its own row of the table, added as an int step adds it
    h = tlt.embed_input(params, TCFG, torch.as_tensor(tok), 0, torch.zeros_like(tpe))
    torch.testing.assert_close(ours, h + tpe[torch.as_tensor(step)], rtol=0, atol=0)
    for k in range(5):
        one = tlt.embed_input(params, TCFG, torch.as_tensor(tok), int(step[k]), tpe)
        torch.testing.assert_close(ours[k], one[k], rtol=0, atol=0)


def test_decode_step_takes_a_step_per_slot(jparams, params):
    rng = np.random.default_rng(5)
    st = jlt.init_decode_state(CFG, 4)
    jst = jlt.DecodeState(st.s, st.z, jnp.asarray([0, 3, 9, 1], jnp.int32))
    tst = tlt.init_decode_state(TCFG, 4, device="cpu")
    tst = tlt.DecodeState(tst.s, tst.z, torch.tensor([0, 3, 9, 1]))
    for _ in range(3):
        tok = np.stack([rng.integers(0, v, size=4) for v in CFG.vocab_sizes], -1)
        jh, jst = jlt.decode_step(jparams, CFG, jnp.asarray(tok, jnp.int32), jst)
        th, tst = tlt.decode_step(params, TCFG, torch.as_tensor(tok, dtype=torch.int32), tst)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tst.step.numpy(), np.asarray(jst.step))
    np.testing.assert_allclose(tst.s.numpy(), np.asarray(jst.s), rtol=1e-4, atol=1e-5)


# -- the daemon ----------------------------------------------------------------------

def test_serve_requests_tail_follow_and_shutdown(params, tmp_path):
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text('{"id": "a", "songs": 2, "bars": 2, "seed": 1}\n')
    results = {}

    def later():
        time.sleep(1.0)
        with open(reqs, "a") as f:
            f.write('{"id": "b", "songs": 1, "bars": 3, "seed": 2}\n')
            f.write('{"cmd": "shutdown"}\n')
    t = threading.Thread(target=later, daemon=True)
    t.start()
    n = tsrv.serve_requests(params, TCFG, str(reqs),
                            lambda req, res: results.update({req["id"]: res}),
                            batch=2, poll_s=0.1, max_tokens_per_song=64)
    t.join()
    assert n == 2 and len(results["a"].songs) == 2 and len(results["b"].songs) == 1
    assert all(_bars(s) == 2 for s in results["a"].songs)
    assert all(_bars(s) == 3 for s in results["b"].songs)


def test_serve_requests_prompt_routing(params, tmp_path):
    prompt = np.asarray([[0, 0, 1, 0, 0, 0], [1, 2, 0, 3, 1, 2], [0, 1, 2, 5, 2, 1]], np.int32)
    reqs = tmp_path / "r.jsonl"
    reqs.write_text('{"id": "p", "songs": 2, "bars": 3, "prompt": "x.mid", "seed": 4}\n')
    got = {}
    tsrv.serve_requests(params, TCFG, str(reqs), lambda req, res: got.update({req["id"]: res}),
                        batch=2, poll_s=0.1, max_requests=1, max_tokens_per_song=64,
                        prompt_loader=lambda _: prompt)
    res = got["p"]
    assert len(res.songs) == 2
    for s in res.songs:
        np.testing.assert_array_equal(s[:3], prompt)
        assert _bars(s) == 3


def test_serve_requests_crash_restart_dedup(params, tmp_path):
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text('{"id": "a", "songs": 1, "bars": 2, "seed": 1}\n'
                    '{"songs": 1, "bars": 2, "seed": 2}\n')
    served = []

    def on_result(req, res):
        served.append(req.get("id", "anon"))
    kw = dict(batch=2, poll_s=0.05, max_tokens_per_song=64)
    assert tsrv.serve_requests(params, TCFG, str(reqs), on_result, max_requests=2, **kw) == 2
    assert served == ["a", "anon"]
    journal = (tmp_path / "reqs.jsonl.journal").read_text().splitlines()
    assert journal[0] == "a" and journal[1].startswith("@")
    assert tsrv.serve_requests(params, TCFG, str(reqs), on_result, idle_timeout_s=0.3,
                               **kw) == 0
    with open(reqs, "a") as f:
        f.write('{"id": "c", "songs": 1, "bars": 2, "seed": 3}\n')
    assert tsrv.serve_requests(params, TCFG, str(reqs), on_result, max_requests=1, **kw) == 1
    assert served == ["a", "anon", "c"]


def test_serve_requests_restart_after_shutdown_serves_new_work(params, tmp_path):
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text('{"id": "a", "songs": 1, "bars": 2, "seed": 1}\n{"cmd": "shutdown"}\n')
    served = []
    kw = dict(batch=2, poll_s=0.05, max_tokens_per_song=64)
    on_result = lambda req, res: served.append(req["id"])  # noqa: E731
    assert tsrv.serve_requests(params, TCFG, str(reqs), on_result, **kw) == 1
    with open(reqs, "a") as f:
        f.write('{"id": "b", "songs": 1, "bars": 2, "seed": 2}\n')
    assert tsrv.serve_requests(params, TCFG, str(reqs), on_result, max_requests=1, **kw) == 1
    assert served == ["a", "b"]


def test_serve_requests_byte_cursor_multibyte_and_hostile_ids(params, tmp_path):
    reqs = tmp_path / "reqs.jsonl"
    first = '{"id": "café", "songs": 1, "bars": 2, "seed": 1}\n'
    second = '{"id": "x\\nb", "songs": 1, "bars": 2, "seed": 2}\n'
    reqs.write_text(first + second + '{"songs": 1, "bars": 2, "seed": 3}\n'
                    '{"id": "b", "songs": 1, "bars": 2, "seed": 4}\n', encoding="utf-8")
    served = []
    on_result = lambda req, res: served.append(req.get("id", "anon"))  # noqa: E731
    kw = dict(batch=2, poll_s=0.05, max_tokens_per_song=64)
    assert tsrv.serve_requests(params, TCFG, str(reqs), on_result, max_requests=4, **kw) == 4
    assert served == ["café", "x\nb", "anon", "b"]
    journal = (tmp_path / "reqs.jsonl.journal").read_text(encoding="utf-8").splitlines()
    assert journal == ["café", "x\\nb", "@" + str(len(first.encode()) + len(second)), "b"]
    assert tsrv.serve_requests(params, TCFG, str(reqs), on_result, idle_timeout_s=0.3,
                               **kw) == 0
    assert len(served) == 4


_HEAD = ('{"id": "a", "songs": 2, "bars": 3, "seed": 1}\n'
         'not json\n')
# the anonymous request's synthetic id is "@<byte offset of its line>"; the
# explicit id after it is that same string, which JAX's daemon keeps in one
# namespace with the synthetic ones (generate/serving.py:357-358): it skips
# the second as already served, and the port copies that
COLLIDING = f"@{len(_HEAD.encode())}"
REQUESTS = (_HEAD +
            '{"songs": 1, "bars": 2}\n'
            f'{{"id": "{COLLIDING}", "songs": 4, "bars": 1}}\n'
            '{"id": "caf\\u00e9 \\u00fc", "songs": 1}\n'
            '{"id": "x\\nb\\\\r", "songs": 3, "bars": 1, "seed": 9}\n'
            '{"id": "p", "songs": 2, "bars": 4, "prompt": "x.mid", "seed": 2}\n'
            '{"id": "a", "songs": 5}\n'
            '{"id": 7, "songs": 1}\n'
            '{"cmd": "shutdown"}\n'
            '{"id": "after", "songs": 1}\n')


def _fake_result(res_type, n_songs, bar_cond, tag):
    songs = [np.full((bar_cond + k, 6), k, np.int32) for k in range(n_songs)]
    return res_type(songs=songs, steps=n_songs * 10 + bar_cond + tag, songs_done=n_songs)


@pytest.mark.parametrize("prompt", [True, False])
def test_serve_requests_journal_and_order_match_jax(jparams, params, monkeypatch, tmp_path,
                                                    prompt):
    """Both daemons on one request file, with the same deterministic stand-
    in for the loop and for the prompt path: byte-equal journals, the same
    on_result calls in the same order, the same count served, and the same
    on a restart after the shutdown line."""
    for mod in (jsrv, tsrv):
        monkeypatch.setattr(mod, "generate_songs_continuous",
                            lambda p, c, r, *, n_songs, bar_cond, batch, max_tokens_per_song,
                            _m=mod: _fake_result(_m.ServeResult, n_songs, bar_cond, 0))
        monkeypatch.setattr(mod, "_prompt_request_result",
                            lambda p, c, r, rows, n, bars, mt, _m=mod:
                            _fake_result(_m.ServeResult, n, bars + len(rows), 1))
    out = {}
    for name, mod, prm, cfg in (("jax", jsrv, jparams, CFG), ("torch", tsrv, params, TCFG)):
        d = tmp_path / name
        d.mkdir()
        (d / "r.jsonl").write_text(REQUESTS, encoding="utf-8")
        calls = []

        def on_result(req, res):
            calls.append((json.dumps(req, sort_keys=True), res.steps, res.songs_done,
                          [s.tolist() for s in res.songs]))
        loader = (lambda p: np.zeros((3, 6), np.int32)) if prompt else None
        n1 = mod.serve_requests(prm, cfg, str(d / "r.jsonl"), on_result, poll_s=0.01,
                                prompt_loader=loader)
        n2 = mod.serve_requests(prm, cfg, str(d / "r.jsonl"), on_result, poll_s=0.01,
                                idle_timeout_s=0.2, prompt_loader=loader)
        out[name] = (n1, n2, calls, (d / "r.jsonl.journal").read_bytes())
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == (6, 1)
    assert not any(COLLIDING in req for req, *_ in out["torch"][2])
    assert out["torch"][3].decode().splitlines().count(COLLIDING) == 1


# -- the CLI on the CPU (agent_config's width, one layer) -------------------------------

def _cli_songs(monkeypatch):
    """Records the songs the CLI writes as MIDI files."""
    from reinforcement_learning_in_music_generation_torch.apps import cli
    written, write = [], cli.tokenizer.write_midi_cp

    def recording(song, path, w2e):
        written.append((np.asarray(song).copy(), path))
        return write(song, path, w2e)
    monkeypatch.setattr(cli.tokenizer, "write_midi_cp", recording)
    return cli, written


def test_cli_generate_continuous(monkeypatch, tmp_path):
    cli, written = _cli_songs(monkeypatch)
    out = cli.main(["generate", "--continuous", "--songs", "5", "--continuous-batch", "2",
                    "--bars", "2", "--max-tokens", "48", "--layers", "1", "--device", "cpu",
                    "--seed", "3", "--out-dir", str(tmp_path / "g")])
    assert out["songs"] == 5 and out["steps"] > 0
    assert [p for _, p in written] == [str(tmp_path / "g" / f"get_{i}.mid") for i in range(5)]
    # the command's songs are the batcher's on the command's weights and seed
    mcfg = TC.agent_config(TCFG_VOCAB, n_layer=1)
    params = tlt.cast_params(tlt.init_params(mcfg, seed=3, device="cpu"), torch.bfloat16)
    ref = tsrv.generate_songs_continuous(params, mcfg, _gen(3), n_songs=5, bar_cond=2, batch=2,
                                         max_tokens_per_song=48)
    assert out["steps"] == ref.steps
    for (song, _), want in zip(written, ref.songs):
        np.testing.assert_array_equal(song, want)
        assert _bars(song) == 2


def test_cli_generate_prompt(monkeypatch, tmp_path):
    cli, written = _cli_songs(monkeypatch)
    cli.main(["generate", "--songs", "1", "--bars", "3", "--max-tokens", "40", "--layers", "1",
              "--device", "cpu", "--out-dir", str(tmp_path / "a")])
    prompt = written[0][1]
    rows = cli._prompt_rows(prompt)
    out = cli.main(["generate", "--songs", "2", "--bars", "5", "--max-tokens", "40",
                    "--layers", "1", "--device", "cpu", "--prompt", prompt,
                    "--prompt-tokens", "4", "--out-dir", str(tmp_path / "b")])
    assert out["songs"] == 2
    for song, _ in written[1:]:
        np.testing.assert_array_equal(song[:4], rows[:4])
        assert len(song) > 4


def test_cli_serve_answers_journals_and_restarts(monkeypatch, tmp_path):
    cli, written = _cli_songs(monkeypatch)
    cli.main(["generate", "--songs", "1", "--bars", "2", "--max-tokens", "24", "--layers", "1",
              "--device", "cpu", "--out-dir", str(tmp_path / "p")])
    prompt = written[0][1]
    reqs = tmp_path / "req.jsonl"
    reqs.write_text(json.dumps({"id": "u", "songs": 2, "bars": 2, "seed": 1}) + "\n"
                    + json.dumps({"id": "p", "songs": 2, "bars": 3, "prompt": prompt}) + "\n"
                    + json.dumps({"songs": 1, "bars": 1}) + "\n" + '{"cmd": "shutdown"}\n')
    args = ["serve", "--requests", str(reqs), "--out-dir", str(tmp_path / "s"), "--layers", "1",
            "--device", "cpu", "--max-tokens", "32", "--poll", "0.05", "--batch", "2"]
    assert cli.main(args)["served"] == 3
    lines = [json.loads(x) for x in (tmp_path / "s" / "responses.jsonl").read_text().split("\n")
             if x]
    assert [(x["id"], x["songs"]) for x in lines] == [("u", 2), ("p", 2), ("req", 1)]
    for x in lines:
        assert all(tmf_ok(f) for f in x["files"])
    journal = (tmp_path / "req.jsonl.journal").read_text().splitlines()
    assert journal[:2] == ["u", "p"] and journal[2].startswith("@") and len(journal) == 4
    with open(reqs, "a") as f:
        f.write(json.dumps({"id": "late", "songs": 1, "bars": 2}) + "\n")
    assert cli.main(args + ["--idle-timeout", "0.2"])["served"] == 1
    lines = (tmp_path / "s" / "responses.jsonl").read_text().split("\n")
    assert json.loads(lines[3])["id"] == "late" and not lines[4]


TCFG_VOCAB = (56, 135, 18, 87, 18, 25)


def tmf_ok(path):
    from reinforcement_learning_in_music_generation_torch.data import midifile
    return midifile.MidiFile(path).ticks_per_beat == 480
