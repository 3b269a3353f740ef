"""The PyTorch port's weights, config, host data code and model building
blocks against the JAX package, on the CPU.

Weights cross exactly (same key paths, ``w`` stored (in, out), per-layer
leaves stacked), so every comparison here runs the JAX function and its
port on the same converted parameters and inputs made with numpy."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reinforcement_learning_in_music_generation_torch import FIELDS
from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.data import tokenizer as ttok
from reinforcement_learning_in_music_generation_torch.models import common as tcm
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.ops import linear_attention as tla
from reinforcement_learning_in_music_generation_tpu import FIELDS as JFIELDS
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import tokenizer as jtok
from reinforcement_learning_in_music_generation_tpu.models import common as jcm
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as lt
from reinforcement_learning_in_music_generation_tpu.ops import linear_attention as jla
from reinforcement_learning_in_music_generation_tpu.utils.checkpoint import save_checkpoint

CFG = C.LinearTransformerConfig(
    vocab_sizes=(56, 135, 18, 87, 18, 25), emb_sizes=(16,) * 6,
    d_model=32, n_layer=2, n_head=2, d_inner=64)
TCFG = TC.LinearTransformerConfig(
    vocab_sizes=CFG.vocab_sizes, emb_sizes=CFG.emb_sizes,
    d_model=32, n_layer=2, n_head=2, d_inner=64)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(np.asarray, lt.init_params(jax.random.PRNGKey(0), CFG))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_fields_and_configs_match():
    assert FIELDS == JFIELDS
    for name in TC.LinearTransformerConfig.__dataclass_fields__:
        assert getattr(TC.agent_config(), name) == getattr(C.agent_config(), name), name
    assert TC.GenerateConfig() == TC.GenerateConfig(**{
        k: getattr(C.GenerateConfig(), k) for k in TC.GenerateConfig.__dataclass_fields__})


def test_params_round_trip_is_exact(jparams):
    tp = tw.from_jax_params(jparams, device="cpu")
    back = _flat(tw.to_numpy(tp))
    ref = _flat(jparams)
    assert sorted(back) == sorted(ref)
    for k, v in ref.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_bf16_params_cross_bit_for_bit(jparams):
    jb = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), jparams)
    tp = tw.from_jax_params(jb, device="cpu")
    for k, v in _flat(jb).items():
        t = _flat(tp)[k]
        assert t.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(t.float().numpy(), v.astype(np.float32), err_msg=k)


def test_init_params_shapes_match_jax(jparams):
    ours = _flat(tlt.init_params(TCFG, seed=3, device="cpu"))
    ref = _flat(jparams)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == v.shape, k
    # the distributions: U(+-1/sqrt(fan_in)) linears, N(0,1) embeddings
    assert ours["/layers/ffn2/w"].abs().max() <= 1 / np.sqrt(CFG.d_inner)
    assert 0.8 < ours["/emb/chord"].std() < 1.2


def test_jax_checkpoint_reads_without_jax(tmp_path, jparams):
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    opt_state = optax.adam(1e-3).init(params)
    path = str(tmp_path / "agent.pkl")
    save_checkpoint(path, params, opt_state=opt_state, step=7)
    template = tlt.init_params(TCFG, seed=0, device="cpu")
    got = _flat(tw.load_jax_checkpoint(path, template, device="cpu"))
    for k, v in _flat(jparams).items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_jax_checkpoint_mismatch_raises(tmp_path, jparams):
    path = str(tmp_path / "agent.pkl")
    save_checkpoint(path, jax.tree_util.tree_map(jnp.asarray, jparams))
    wide = TC.LinearTransformerConfig(vocab_sizes=CFG.vocab_sizes, emb_sizes=CFG.emb_sizes,
                                      d_model=32, n_layer=2, n_head=2, d_inner=128)
    with pytest.raises(ValueError, match="shape mismatch"):
        tw.load_jax_checkpoint(path, tlt.init_params(wide, device="cpu"), device="cpu")
    valued = TC.LinearTransformerConfig(vocab_sizes=CFG.vocab_sizes, emb_sizes=CFG.emb_sizes,
                                        d_model=32, n_layer=2, n_head=2, d_inner=64,
                                        with_value_head=True)
    with pytest.raises(KeyError, match="value_head"):
        tw.load_jax_checkpoint(path, tlt.init_params(valued, device="cpu"), device="cpu")


@pytest.mark.parametrize("name", ["sinusoidal_table", "layernorm", "embed_fields",
                                  "apply_field_heads", "fused_head_params"])
def test_common_blocks_match_jax(name, jparams):
    rng = np.random.default_rng(0)
    tp = tw.from_jax_params(jparams, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    if name == "sinusoidal_table":
        ours = tcm.sinusoidal_table(300, 32, device="cpu").numpy()
        ref = np.asarray(jcm.sinusoidal_table(300, 32))
    elif name == "layernorm":
        x, scale, bias = (rng.normal(size=(4, 32)).astype(np.float32) for _ in range(3))
        ours = tcm.layernorm({"scale": _t(scale), "bias": _t(bias)}, _t(x)).numpy()
        ref = np.asarray(jcm.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                       jnp.asarray(x)))
    elif name == "embed_fields":
        ids = np.stack([rng.integers(0, v, size=(3, 5)) for v in CFG.vocab_sizes], -1)
        ours = tcm.embed_fields(tp["emb"], _t(ids)).numpy()
        ref = np.asarray(jcm.embed_fields(jp["emb"], jnp.asarray(ids)))
    elif name == "apply_field_heads":
        h = rng.normal(size=(3, 32)).astype(np.float32)
        ours = np.concatenate([o.numpy() for o in tcm.apply_field_heads(tp["heads"], _t(h), 6)], -1)
        ref = np.concatenate([np.asarray(o) for o in jcm.apply_field_heads(
            jp["heads"], jnp.asarray(h), 6)], -1)
    else:
        ours = np.concatenate([t.numpy().ravel() for t in tcm.fused_head_params(tp["heads"], 6)])
        ref = np.concatenate([np.asarray(t).ravel() for t in jcm.fused_head_params(
            jp["heads"], 6)])
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_linear_attention_step_matches_jax():
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, 3, 8)).astype(np.float32) for _ in range(3))
    s0 = rng.random(size=(2, 3, 8, 8)).astype(np.float32)
    z0 = rng.random(size=(2, 3, 8)).astype(np.float32)
    out, (s, z) = tla.linear_attention_step(_t(q), _t(k), _t(v), (_t(s0), _t(z0)))
    rout, (rs, rz) = jla.linear_attention_step(*map(jnp.asarray, (q, k, v)),
                                               (jnp.asarray(s0), jnp.asarray(z0)))
    for a, b in ((out, rout), (s, rs), (z, rz)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    x = rng.normal(size=64).astype(np.float32) * 4
    np.testing.assert_allclose(tla.feature_map(_t(x)).numpy(),
                               np.asarray(jla.feature_map(jnp.asarray(x))), rtol=1e-6)
    s_init, z_init = tla.init_attention_state(2, 3, 8, device="cpu")
    assert s_init.shape == (2, 3, 8, 8) and z_init.shape == (2, 3, 8)


def test_cp_dictionary_matches_jax():
    ours = ttok.drop_type(ttok.construct_cp_dict())
    ref = jtok.drop_type(jtok.construct_cp_dict())
    assert ours == ref
    assert ttok.construct_cp_dict() == jtok.construct_cp_dict()
    assert ttok.n_classes(ours[0]) == jtok.n_classes(ref[0]) == list(CFG.vocab_sizes)


def test_write_midi_cp_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    _, w2e = ttok.drop_type(ttok.construct_cp_dict())
    words = np.stack([rng.integers(0, v, size=400) for v in CFG.vocab_sizes], -1)
    words[::17, 2] = 1                                   # some bars
    ours, ref = str(tmp_path / "ours.mid"), str(tmp_path / "ref.mid")
    ttok.write_midi_cp(words, ours, w2e)
    jtok.write_midi_cp(words, ref, w2e)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        ob, rb = a.read(), b.read()
    assert ob[:4] == b"MThd" and ob == rb


def test_port_imports_no_jax():
    """No module of the port (nor the GPU smoke test, the NCCL script, nor
    the rank functions that tests/test_torch_parallel.py,
    tests/test_torch_tensor_parallel.py, tests/test_torch_rl_parallel.py,
    tests/test_torch_sequence_parallel.py and
    tests/test_torch_pipeline_parallel.py spawn) imports jax or the JAX
    package, at the top or inside a function."""
    import re
    root = os.path.join(os.path.dirname(__file__), "..")
    pat = re.compile(r"(import|from) +(jax|reinforcement_learning_in_music_generation_tpu)\b")
    files = [os.path.join(root, "chip_smoke.py"),
             os.path.join(root, "tests", "torch_dp_workers.py"),
             os.path.join(root, "tests", "torch_tp_workers.py"),
             os.path.join(root, "tests", "torch_rl_workers.py"),
             os.path.join(root, "tests", "torch_pp_workers.py"),
             os.path.join(root, "scripts", "dp_nccl.py")]
    pkg = os.path.join(root, "reinforcement_learning_in_music_generation_torch")
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    rel = {os.path.relpath(f, pkg) for f in files}
    # the RL modules and kernels of the later slices are among those walked
    assert {"rl/ppo.py", "rl/dqn.py", "models/critic.py", "data/events.py",
            "ops/ffn_block.py", "ops/linear_attention_kernel.py",
            "parallel/mesh.py", "parallel/sharding.py", "parallel/tensor.py",
            "parallel/pipeline.py"} <= rel
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pat.search(line), f"{path}:{i}: {line.strip()}"
