"""The work counts of ``chip_smoke.py`` (the card's bounds in its kernels
line), checked on the CPU: the script's ``main`` runs only as a program, so
importing it runs nothing."""

import importlib.util
import os

import pytest

_PATH = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,d,di", [(16384, 512, 2048), (14336, 512, 1024), (50, 512, 2048)])
def test_backward_bounds_count_two_products_per_weight(smoke, n, d, di):
    """Kernels D and G: the gradients need two products per weight, 2x the
    forward's operations; the kernels' recomputed forward is their design's
    cost, not the function's."""
    for work in (smoke.attn_tail_work, smoke.ffn_work):
        (f_ops, _), (b_ops, _) = work(n, d, di)
        assert b_ops == 2 * f_ops
    (f_ops, _), _ = smoke.attn_tail_work(n, d, di)
    assert f_ops == 2 * n * (d * d + 2 * d * di)


def test_latency_bound_counts_weights_once_a_token(smoke):
    """A chunk of T tokens, the function v8 and v7 both compute: the weights
    once a token and the state once a chunk, for both kernels (v7 streaming
    it every token is its design's cost); operations 2 B (L (4 D^2 + 2 D DI)
    + D NF VF_PAD) a token."""
    L, d, di, e, h, b, T = 12, 512, 2048, 64, 8, 5, 32
    w = L * (4 * d * d + 2 * d * di)
    kw = dict(w_bytes=2, s_bytes=2)
    ops, nbytes = smoke.latency_work(b, T, L, d, di, h, **kw)
    ops1, nbytes1 = smoke.latency_work(b, 1, L, d, di, h, **kw)
    assert ops == T * ops1 == T * 2 * b * (w + d * 6 * 256)
    state = 2 * 2 * L * b * h * (e * e + e)              # read once and written once, bf16
    assert smoke.latency_state_bytes(b, L, d, h, s_bytes=2) == state
    assert nbytes > T * 2 * w and nbytes - state == T * (nbytes1 - state)
