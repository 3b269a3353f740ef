"""The port's sequence-parallel linear attention against the JAX package's,
on the CPU.

``ops/linear_attention.py``: ``_CoreWithDen`` (JAX ``_core_with_den``,
out and den both differentiable) on one process, and
``causal_linear_attention_sp`` on the ranks of an sp mesh of gloo
processes that ``parallel.launch`` spawns (one module-scoped launch a world
size, sp = 2 and 4, started together; rank functions in
tests/torch_pp_workers.py, which import no jax).  The JAX side runs its
``causal_linear_attention_sp`` under ``shard_map`` on a mesh of the same
size over the suite's virtual CPU devices, and ``jax.grad`` of its
single-device ``causal_linear_attention`` (JAX's own sp-gradient test,
tests/test_sequence_parallel.py:48, is slow, so the gradients are held
against the single-device function, which it shows equal).

Tolerances: the VJP and the sp forward 1e-5, the sp gradients 1e-4 (of the
tensor's magnitude, and relative).  Two controls, each a fault the gates
must catch, fall outside them: an inclusive prefix (``<=`` in place of
``<``), and a gather whose backward keeps each rank's own cotangent
without the sum over the ranks.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_pp_workers as W
from reinforcement_learning_in_music_generation_torch.ops import linear_attention as tla
from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
from reinforcement_learning_in_music_generation_tpu.ops import linear_attention as jla

B, H, S, E = 2, 2, 64, 8
CHUNK = 8
SIZES = (2, 4)
LAUNCH_S = 180


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal((B, H, S, E)).astype(np.float32) for _ in range(3))


@pytest.fixture(scope="module")
def launched(qkv):
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(len(SIZES)) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield {n: pool.submit(pm.launch, W.sp, n, (*qkv, CHUNK), timeout_s=LAUNCH_S)
               for n in SIZES}


def _ranks(launched, n):
    out = launched[n].result()
    assert [r["index"]["sp"] for r in out] == list(range(n))
    return out


def _whole(ranks, key):
    """The ranks' shards of out and of the three gradients, put back along
    the sequence."""
    out = np.concatenate([r[key]["out"] for r in ranks], axis=2)
    grads = [np.concatenate([r[key]["grads"][j] for r in ranks], axis=2) for j in range(3)]
    return out, grads


def _jax_sp(qkv, n):
    mesh = Mesh(np.array(jax.devices()[:n]), axis_names=("sp",))
    spec = P(None, None, "sp", None)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)
    def f(q, k, v):
        return jla.causal_linear_attention_sp(q, k, v, "sp", chunk=CHUNK, backend="xla")
    return np.asarray(f(*(jnp.asarray(t) for t in qkv)))


@pytest.fixture(scope="module")
def jax_grads(qkv):
    """jax.grad of sum(out^2) through JAX's single-device attention."""
    loss = lambda q, k, v: jnp.sum(jla.causal_linear_attention(q, k, v, chunk=CHUNK,
                                                               backend="xla") ** 2)
    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in qkv))]


def _close(ours, ref, tol):
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * float(np.abs(ref).max()))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_core_with_den_vjp_matches_jax(backend):
    """(out, den) and the VJP of both cotangents: the port's
    ``_CoreWithDen`` on the chunked core and on kernel F's route (its plain
    twin here) against ``jax.vjp`` of JAX's ``_core_with_den``."""
    rng = np.random.default_rng(1)
    pq, pk, v = (np.abs(rng.standard_normal((B, H, S, E))).astype(np.float32) + 0.1
                 for _ in range(3))
    g, g_den = (rng.standard_normal(s).astype(np.float32) for s in ((B, H, S, E), (B, H, S)))
    (out_j, den_j), vjp = jax.vjp(
        lambda a, b, c: jla._core_with_den(a, b, c, 1e-6, CHUNK, "xla"),
        *(jnp.asarray(t) for t in (pq, pk, v)))
    grads_j = vjp((jnp.asarray(g), jnp.asarray(g_den)))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (pq, pk, v)]
    out, den = tla.core_with_den(*ts, 1e-6, CHUNK, backend)
    torch.autograd.backward((out, den), (torch.from_numpy(g), torch.from_numpy(g_den)))
    _close(out.detach().numpy(), np.asarray(out_j), 1e-5)
    _close(den.detach().numpy(), np.asarray(den_j), 1e-5)
    for t, r in zip(ts, grads_j):
        _close(t.grad.numpy(), np.asarray(r), 1e-5)
    # den's cotangent moves d phi(q) and d phi(k): the terms are there
    ts2 = [torch.from_numpy(t).requires_grad_(True) for t in (pq, pk, v)]
    out2, _ = tla.core_with_den(*ts2, 1e-6, CHUNK, backend)
    out2.backward(torch.from_numpy(g))
    assert not np.allclose(ts2[0].grad.numpy(), ts[0].grad.numpy(), rtol=1e-3)
    assert not np.allclose(ts2[1].grad.numpy(), ts[1].grad.numpy(), rtol=1e-3)


@pytest.mark.parametrize("n", SIZES)
def test_sp_forward_matches_jax_shard_map(launched, qkv, n):
    """The ranks' outputs, put back along the sequence, equal JAX's
    ``causal_linear_attention_sp`` under ``shard_map`` on an sp mesh of n
    devices, on the chunked core and on kernel F's route; each rank ran F's
    twin once forward and once backward."""
    ref = _jax_sp(qkv, n)
    ranks = _ranks(launched, n)
    for key in ("xla", "pallas"):
        _close(_whole(ranks, key)[0], ref, 1e-5)
    assert all(r["pallas"]["calls"] == (1, 1) for r in ranks)


@pytest.mark.parametrize("n", SIZES)
def test_sp_gradients_match_jax_single_device(launched, jax_grads, n):
    """d sum(out^2) / d (q, k, v) on the ranks' shards, put back, equal
    ``jax.grad`` of JAX's single-device attention, on both routes."""
    ranks = _ranks(launched, n)
    for key in ("xla", "pallas"):
        for ours, ref in zip(_whole(ranks, key)[1], jax_grads):
            _close(ours, ref, 1e-4)


def _fails(fn):
    try:
        fn()
    except AssertionError:
        return True
    return False


@pytest.mark.parametrize("n", SIZES)
def test_sp_controls_fall_outside_the_gates(launched, qkv, jax_grads, n):
    """An inclusive prefix moves every shard but the first's output off
    JAX's; a gather whose backward keeps the rank's own cotangent leaves
    the out right and dk, dv wrong on every rank but the last."""
    ref = _jax_sp(qkv, n)
    ranks = _ranks(launched, n)
    out, _ = _whole(ranks, "inclusive_prefix")
    assert _fails(lambda: _close(out, ref, 1e-5))
    out, grads = _whole(ranks, "no_reduce_scatter")
    _close(out, ref, 1e-5)
    assert _fails(lambda: _close(grads[1], jax_grads[1], 1e-4))
    assert _fails(lambda: _close(grads[2], jax_grads[2], 1e-4))
    s = S // n
    np.testing.assert_allclose(grads[2][:, :, -s:], jax_grads[2][:, :, -s:], rtol=1e-4,
                               atol=1e-4 * float(np.abs(jax_grads[2]).max()))


def test_ranks_import_no_jax(launched):
    for n in SIZES:
        assert all(r["modules"] == [] for r in _ranks(launched, n))
