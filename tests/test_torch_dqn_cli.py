"""The port's ``dqn-train`` on the CPU, with tests/test_cli_rl_smoke.py's
flags (the agent at ``agent_config``'s width with one layer, the
discriminator at one), on the default route and under
RLMG_ATTN_BACKEND=pallas (kernel F's wrapper, its plain twin on CPU
tensors).  The checkpoints it writes load in the JAX package with the
agent template, ``agent_info.pickle`` carries the reference's four keys, and
``--pretrain-ckpt`` reads a JAX checkpoint."""

import pickle

import jax
import numpy as np
import pytest

from reinforcement_learning_in_music_generation_torch.apps import cli as tcli
from reinforcement_learning_in_music_generation_torch.ops import linear_attention_kernel as tlk
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as jlt
from reinforcement_learning_in_music_generation_tpu.utils import checkpoint as jck

VOCAB = (56, 135, 18, 87, 18, 25)


def _flags(tmp_path, *extra):
    return ["dqn-train", "--device", "cpu", "--synthetic", "--synthetic-songs", "2",
            "--seq-len", "128", "--layers", "1", "--songs", "3", "--episodes", "4",
            "--buffer-size", "8", "--batch-size", "4", "--n-states", "16", "--n-actions", "8",
            "--max-updates", "1", "--ckpt-epoch-gate", "0",
            "--ckpt-dir", str(tmp_path / "ck"), "--exp-dir", str(tmp_path / "exp"), *extra]


def _template():
    return jax.eval_shape(lambda: jlt.init_params(jax.random.PRNGKey(0),
                                                  C.agent_config(VOCAB, n_layer=1)))


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_dqn_train_on_cpu_writes_what_jax_reads(monkeypatch, tmp_path, route):
    monkeypatch.setenv("RLMG_ATTN_BACKEND", route)
    calls = []
    real = tlk.causal_product
    monkeypatch.setattr(tlk, "causal_product", lambda *a: calls.append(1) or real(*a))
    res = tcli.main(_flags(tmp_path))
    assert res["updates"] == 1
    # kernel F's wrapper in every layer of every forward on the pallas route:
    # 3 songs x 4 episodes of rollouts, 3 forwards in the update
    assert len(calls) == (3 * 4 + 3 if route == "pallas" else 0)
    (m,) = res["metrics"]
    assert all(np.isfinite(v) for v in m.values())
    assert 0.0 < m["agent_score"] < 1.0 and 0.0 < m["expert_score"] < 1.0
    assert len(res["rollout_ms"]) == 3 and len(res["update_ms"]) == len(res["airl_ms"]) == 1
    assert (tmp_path / "ck" / "dqn_best.ckpt").exists()
    ck = jck.load_checkpoint(str(tmp_path / "ck" / "dqn_last.ckpt"), params_template=_template())
    assert ck["params"]["layers"]["wq"]["w"].shape == (1, 512, 512)
    assert all(np.isfinite(np.asarray(v)).all() for v in jax.tree_util.tree_leaves(ck["params"]))
    with open(tmp_path / "ck" / "agent_info.pickle", "rb") as f:
        record = pickle.load(f)
    assert set(record) == {"Agent", "first_loss", "sec_loss", " global_loss"}
    assert record["first_loss"] == [m["mse"]] and record[" global_loss"] == [m["total"]]
    assert record["Agent"].shape == (4, 1)
    assert "agent_score" in (tmp_path / "exp" / "log.txt").read_text()


def test_dqn_train_reads_a_jax_pretrain_checkpoint(tmp_path):
    """A JAX checkpoint of agent params goes in through --pretrain-ckpt; with
    one song (the buffer never fills, no update) dqn_last.ckpt holds those
    params unchanged (under --dp / --tp: tests/test_torch_rl_parallel.py)."""
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.02).astype(np.float32), _template())
    path = str(tmp_path / "pre.ckpt")
    jck.save_checkpoint(path, params, None, step=0)
    res = tcli.main(_flags(tmp_path, "--pretrain-ckpt", path, "--songs", "1"))
    assert res["updates"] == 0
    back = jck.load_checkpoint(str(tmp_path / "ck" / "dqn_last.ckpt"),
                               params_template=_template())["params"]
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
