"""The port's ``ppo-train`` and ``inference`` on the CPU, and the tuple-event
data they use, against the JAX package.

``ppo-train`` runs at the actor's full width with one layer (the critic one,
the reward model one), on the default route and under
RLMG_FFN_BACKEND=pallas (kernel G's wrapper, its plain twin on CPU tensors):
the losses and rewards are finite and ``ppo_best.ckpt`` loads in the JAX
package with the actor template.  ``--pretrain-actor`` / ``--pretrain-reward``
take the port's ``my-pretrain`` checkpoints; ``inference`` writes a tuple-
event MIDI file; the port's tuple dictionary and MIDI writer equal the JAX
package's byte for byte."""

import glob
import os

import jax
import numpy as np
import pytest

from reinforcement_learning_in_music_generation_torch.apps import cli as tcli
from reinforcement_learning_in_music_generation_torch.data import tokenizer as ttok
from reinforcement_learning_in_music_generation_torch.ops import ffn_block as tfb
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import tokenizer as jtok
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as jlt
from reinforcement_learning_in_music_generation_tpu.utils import checkpoint as jck

VOCAB = (49, 19, 19, 89, 67, 25)


def _flags(tmp_path, *extra):
    return ["ppo-train", "--device", "cpu", "--synthetic", "--synthetic-songs", "2",
            "--seq-len", "40", "--layers", "1", "--songs", "2", "--episodes", "3",
            "--n-states", "10", "--n-actions", "5", "--ppo-steps", "2",
            "--ckpt-dir", str(tmp_path / "ck"), "--exp-dir", str(tmp_path / "exp"), *extra]


def _actor_template(n_layer):
    return jax.eval_shape(lambda: jlt.init_params(jax.random.PRNGKey(0),
                                                  C.actor_config(VOCAB, n_layer=n_layer)))


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_ppo_train_on_cpu_writes_what_jax_reads(monkeypatch, tmp_path, route):
    monkeypatch.setenv("RLMG_FFN_BACKEND", route)
    calls = []
    real = tfb.ffn_block_plain
    monkeypatch.setattr(tfb, "ffn_block_plain", lambda *a: calls.append(1) or real(*a))
    res = tcli.main(_flags(tmp_path))
    assert res["songs"] == 2 and len(res["metrics"]) == 2
    assert len(res["rollout_ms"]) == len(res["update_ms"]) == 2
    for m in res["metrics"]:
        assert sorted(m) == ["actor_loss", "mean_reward", "policy_loss", "value_loss"]
        assert all(np.isfinite(v) for v in m.values())
        assert 0.0 < m["mean_reward"] < 1.0
    # per song: 3 episodes x (actor + critic) forwards, then 2 steps x (2
    # actor + 1 critic) forwards, one layer each
    assert len(calls) == (2 * (3 * 2 + 2 * 3) if route == "pallas" else 0)
    ck = jck.load_checkpoint(str(tmp_path / "ck" / "ppo_best.ckpt"),
                             params_template=_actor_template(1))
    assert ck["params"]["value_head"]["l1"]["w"].shape == (512, 128)
    assert all(np.isfinite(np.asarray(v)).all() for v in jax.tree_util.tree_leaves(ck["params"]))
    assert "mean_reward" in (tmp_path / "exp" / "log.txt").read_text()


def _my_pretrain(monkeypatch, run_dir, *extra):
    """The port's my-pretrain for one epoch of one batch (so it writes a
    checkpoint) into run_dir/Exp-Pretrain/<ts>/model; returns its path.
    Each run gets its own directory: the timestamp has whole seconds."""
    run_dir.mkdir()
    monkeypatch.chdir(run_dir)
    res = tcli.main(["my-pretrain", "--device", "cpu", "--synthetic-songs", "2",
                     "--batch-size", "2", "--seq-len", "16", "--epochs", "1", *extra])
    (path,) = glob.glob(os.path.join(res["exp_root"], "model", "*.ckpt"))
    return os.path.abspath(path)


def test_ppo_train_and_inference_read_my_pretrain_checkpoints(monkeypatch, tmp_path):
    """A 2-layer actor and a 1-layer reward model from the port's
    my-pretrain go in through --pretrain-actor / --pretrain-reward; the
    actor keeps its checkpoint's depth (ppo_best.ckpt holds 2 layers, read
    by the JAX package), as the JAX layer scan runs the checkpoint's layers.
    inference --ckpt reads the same actor checkpoint (ppo-train under --dp /
    --tp: tests/test_torch_rl_parallel.py)."""
    actor = _my_pretrain(monkeypatch, tmp_path / "actor", "--layers", "2")
    reward = _my_pretrain(monkeypatch, tmp_path / "reward", "--reward-pretrain",
                          "--reward-layers", "1")
    res = tcli.main(_flags(tmp_path, "--songs", "1", "--pretrain-actor", actor,
                           "--pretrain-reward", reward))
    assert all(np.isfinite(v) for v in res["metrics"][0].values())
    ck = jck.load_checkpoint(str(tmp_path / "ck" / "ppo_best.ckpt"),
                             params_template=_actor_template(2))
    assert ck["params"]["layers"]["wq"]["w"].shape == (2, 512, 512)
    out = tmp_path / "gen" / "actor.mid"
    inf = tcli.main(["inference", "--device", "cpu", "--layers", "2", "--tokens", "12",
                     "--ckpt", actor, "--out", str(out)])
    assert inf["tokens"] == inf["notes"] == 12
    assert out.read_bytes()[:4] == b"MThd"


def test_inference_on_cpu_writes_its_midi(tmp_path):
    out = tmp_path / "gen_midi" / "a.mid"
    res = tcli.main(["inference", "--device", "cpu", "--layers", "1", "--tokens", "20",
                     "--out", str(out)])
    assert res["tokens"] == res["notes"] == 20 and res["path"] == str(out)
    assert out.read_bytes()[:4] == b"MThd"


def test_tuple_dictionary_matches_jax():
    assert ttok.construct_tuple_dict() == jtok.construct_tuple_dict()
    e2w, _ = ttok.construct_tuple_dict()
    assert tuple(ttok.n_classes(e2w)) == VOCAB


def test_tuple_event_midi_bytes_match_jax(tmp_path):
    """The same token rows (every id of every field, the BOS/EOS/PAD ids
    too) decode to equal events and to byte-equal MIDI files."""
    _, w2e = ttok.construct_tuple_dict()
    rng = np.random.default_rng(8)
    rows = np.stack([rng.integers(0, v, 300) for v in VOCAB], axis=1)
    rows[:3] = np.array(VOCAB) - 1 - np.arange(3)[:, None]
    ours = ttok.words_to_tuple_events(rows, w2e)
    ref = jtok.words_to_tuple_events(rows, jtok.construct_tuple_dict()[1])
    assert [tuple(e) for e in ours] == [tuple(e) for e in ref]
    ttok.tuple_events_to_midi(ours, str(tmp_path / "port.mid"))
    jtok.tuple_events_to_midi(ref, str(tmp_path / "jax.mid"))
    port, jx = (tmp_path / "port.mid").read_bytes(), (tmp_path / "jax.mid").read_bytes()
    assert port[:4] == b"MThd" and port == jx
