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


def test_decode_token_bound_counts_weights_and_state_once(smoke):
    """One token of v3, v1/v2 (L = 1) or v5: the weight matrices once in
    their stored type (75.5 MB in bf16 at the flagship width), the f32
    state read and written once (1.6 MB a song each way at 12 layers and 8
    heads of 64, for v3's augmented layout and v5's batch-major one alike),
    2 B (L (4 D^2 + 2 D DI) + D NF VF_PAD) operations."""
    L, d, di, h, b = 12, 512, 2048, 8, 32
    w = L * (4 * d * d + 2 * d * di)
    assert 2 * w == 75_497_472
    aug = smoke.aug_state_bytes(b, L, d, h)
    assert aug == b * 2 * (12 * 8 * 64 * 65 * 4)
    assert smoke.v5_state_bytes(b, L, d, h) == b * 2 * (12 * (64 * 512 + 512) * 4)
    ops, nbytes = smoke.decode_token_work(b, L, d, di, w_bytes=2, state_bytes=aug)
    assert ops == 2 * b * w
    assert nbytes == 2 * w + 4 * L * (9 * d + di) + aug + 2 * 4 * b * d
    ops6, nbytes6 = smoke.decode_token_work(b, L, d, di, w_bytes=2, state_bytes=aug, nf=6)
    assert ops6 - ops == 2 * b * d * 6 * 256
    assert nbytes6 - nbytes == 2 * d * 6 * 256 + 4 * 6 * 256
    ops5, nbytes5 = smoke.decode_token_work(256, L, d, di, w_bytes=2, nf=6,
                                            state_bytes=smoke.v5_state_bytes(256, L, d, h))
    # v5's products take bf16 inputs: at the tensor cores' peak the bytes bind
    bound_ms, by = smoke.bound(nbytes5, ops5, smoke.BF16_FLOPS)
    assert by == "bytes" and 0.267 < bound_ms < 0.268
    # the same operations as f32 FMAs (the products of v3 and kernel A before
    # they moved to the tensor cores) would bind
    bound_ms, by = smoke.bound(nbytes5, ops5)
    assert by == "operations" and 0.29 < bound_ms < 0.30


@pytest.mark.parametrize("b,state,by", [(5, True, "bytes"), (128, True, "bytes"),
                                        (4096, False, "operations")])
def test_token_kernel_bound_charges_three_bf16_products(smoke, b, state, by):
    """Kernel A and v3 with bf16 weights form each product as three bf16
    products (the f32 activations in three planes): operations at a third
    of the bf16 peak; at the per-step path's batches the bytes bind (with
    v3's f32 state at any batch), the operations only for the weights alone
    at thousands of songs."""
    L, d, di, h = 12, 512, 2048, 8
    assert smoke.SPLIT3_BF16_FLOPS == smoke.BF16_FLOPS / 3
    ops, nbytes = smoke.decode_token_work(
        b, L, d, di, w_bytes=2, state_bytes=smoke.aug_state_bytes(b, L, d, h) if state else 0)
    bound_ms, got = smoke.bound(nbytes, ops, smoke.SPLIT3_BF16_FLOPS)
    assert got == by
    assert bound_ms == max(nbytes / smoke.HBM_BYTES_PER_S, ops / smoke.SPLIT3_BF16_FLOPS) * 1e3


@pytest.mark.parametrize("peak", ["F32_FLOPS", "BF16_FLOPS"])
def test_bound_charges_operations_at_the_peak_of_their_type(smoke, peak):
    """The bound is the larger of bytes over 3.35 TB/s and operations over
    the card's peak for their type (67 TFLOP/s in f32 outside the tensor
    cores, 989 TFLOP/s in bf16), in ms."""
    rate = getattr(smoke, peak)
    assert rate == {"F32_FLOPS": 67e12, "BF16_FLOPS": 989e12}[peak]
    assert smoke.bound(0, rate * 1e-3, rate) == (1.0, "operations")
    assert smoke.bound(3.35e9, rate * 1e-3, rate) == (1.0, "bytes")
    assert smoke.bound(2 * 3.35e9, rate * 1e-3, rate)[0] == 2.0


@pytest.mark.parametrize("w_bytes,peak,want_ms", [(4, "F32_FLOPS", 19.2312),
                                                  (4, "SPLIT_BF16_FLOPS", 7.8169),
                                                  (2, "BF16_FLOPS", 1.3028)])
def test_chunk_bound_at_the_main_path_shape(smoke, w_bytes, peak, want_ms):
    """Kernel B, a 128-token call at B=128, agent_config width, bf16 state:
    1.2885e12 operations (the products and the state update and read) bind,
    7.817 ms at 989/6 TFLOP/s (f32 weights: each product as six bf16
    products on the tensor cores), 19.231 ms at the f32 FMA rate (the bound
    printed beside it) and 1.3028 ms at the bf16 tensor-core rate (bf16
    weights, where v6 casts every product's input to the weights' type);
    streaming the weights and the state every token sets a floor of about
    10.76 ms with bf16 weights and 13.71 ms with f32 weights, above the
    f32 weights' operation bound."""
    vocab = (56, 135, 18, 87, 18, 25)
    ops, nbytes, floor = smoke.chunk_work(128, 128, 12, 512, 2048, 8, w_bytes=w_bytes,
                                          s_bytes=2, fold_rows=sum(vocab))
    assert ops == 1_288_490_188_800
    bound_ms, by = smoke.bound(nbytes, ops, getattr(smoke, peak))
    assert by == "operations" and abs(bound_ms - want_ms) < 1e-4
    floor_ms = floor / smoke.HBM_BYTES_PER_S * 1e3
    if w_bytes == 2:
        assert 282e6 < nbytes < 284e6
        assert abs(floor_ms - 10.7636) < 1e-3
    else:
        assert abs(floor_ms - 13.7144) < 1e-3
        assert floor_ms > bound_ms or peak == "F32_FLOPS"


def test_window_bound_at_the_discriminator_shape(smoke):
    """Kernel E at B=4, H=8, S=3584, E=64, w=256: 1,772,800 (query, key)
    pairs per (b, h); the forward's two products (14.52 GFLOP) and the
    backward's five (36.31 GFLOP) bind at 989/6 TFLOP/s (f32-grade products
    on the tensor cores: 0.0881 / 0.2203 ms), 0.2168 / 0.5419 ms at the f32
    FMA rate; a padding mask does not change the count."""
    import torch
    mask = torch.ones((4, 3584))
    mask[:, 3000:] = 0
    (f_ops, f_bytes), (b_ops, b_bytes), pairs, kept = smoke.window_work(4, 8, 3584, 64, 256, mask)
    assert pairs == 4 * 8 * 1_772_800 and kept < pairs
    assert abs(f_ops / 1e9 - 14.52) < 0.01 and abs(b_ops / 1e9 - 36.31) < 0.01
    assert b_ops * 2 == f_ops * 5
    for ops, nbytes, split, fma in ((f_ops, f_bytes, 0.0881, 0.2168),
                                    (b_ops, b_bytes, 0.2203, 0.5419)):
        got, by = smoke.bound(nbytes, ops, smoke.SPLIT_BF16_FLOPS)
        assert by == "operations" and abs(got - split) < 1e-4
        assert abs(smoke.bound(nbytes, ops)[0] - fma) < 1e-4


def test_mma_counts_reads_the_tensor_core_instructions_of_named_functions(smoke):
    """HMMA / HGMMA lines are counted per SASS function whose name holds the
    marker; other functions and other instructions are not."""
    sass = "\n".join([
        "        Function : _ZN4rlmg14tc_gemm_kernelILi0EEEvv",
        "        /*0100*/   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        "        /*0110*/   HMMA.16816.F32.BF16 R16, R8, R14, R16 ;",
        "        /*0120*/   LDSM.16.M88.4 R8, [R2] ;",
        "        Function : _ZN4rlmg13tc_ln_kernelEv",
        "        /*0100*/   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        "        Function : _ZN4rlmg14tc_gemm_kernelILi1EEEvv",
        "        /*0200*/   HGMMA.64x32x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "        Function : _ZN4rlmg14tc_gemm_kernelILi2EEEvv",
        "        /*0300*/   FFMA R1, R2, R3, R1 ;"])
    assert smoke.mma_counts(sass, "tc_gemm_kernel") == {
        "_ZN4rlmg14tc_gemm_kernelILi0EEEvv": 2, "_ZN4rlmg14tc_gemm_kernelILi1EEEvv": 1,
        "_ZN4rlmg14tc_gemm_kernelILi2EEEvv": 0}


@pytest.mark.parametrize("elem", [4, 2])
def test_qkv_attention_work_splits_projection_and_attention(smoke, elem):
    """Kernel C's work: the projection's 2 N D 3D operations, the parts
    adding up to the whole calls, and bf16 tensors moving half the bytes of
    f32 ones but for den (N H f32)."""
    n, d, h, n_seq = 16384, 512, 8, 32
    w = smoke.qkv_attention_work(n, d, h, n_seq, elem=elem)
    assert w["proj"][0] == 2 * n * d * 3 * d
    for part in (0, 1):
        assert w["fwd"][part] == w["proj"][part] + w["attn_fwd"][part]
        assert w["bwd"][part] > w["attn_bwd"][part]
    w32 = smoke.qkv_attention_work(n, d, h, n_seq)
    den = 4 * n * h
    assert w["attn_fwd"][1] - den == (w32["attn_fwd"][1] - den) * elem // 4
    assert w["proj"][1] == w32["proj"][1] * elem // 4


def _readings(kernel, control, finite=True, dtype=True):
    return {name: {"kernel": kernel, "control": control, "finite": finite, "dtype": dtype}
            for name in ("att", "dh", "dWqkv", "dbqkv")}


@pytest.mark.parametrize("kernel,control,finite,dtype,refused", [
    ((0.0, 0.0), (5e-3, 1e-3), True, True, False),        # rounding flips only: passes
    ((1e-2, 0.0), (5e-3, 1e-3), True, True, True),        # a max share above BF16_TOL
    ((1e-3, 1e-3), (5e-3, 1e-3), True, True, True),       # the fault's mean share
    ((0.0, 0.0), (5e-3, 1e-9), True, True, True),         # a control that sees nothing
    ((0.0, 0.0), (5e-3, 1e-3), False, True, True),        # not finite
    ((0.0, 0.0), (5e-3, 1e-3), True, False, True),        # not in the inputs' type
])
def test_qkv_bf16_gate_refuses_the_fault_and_a_blind_control(smoke, kernel, control, finite,
                                                              dtype, refused):
    """Kernel C's bf16 gate: every tensor within C_BF16_GATES, and the
    rounded-residual control above the mean limit, or the gate reports it
    (one message a tensor)."""
    bad = smoke.qkv_bf16_gate_failures(_readings(kernel, control, finite, dtype))
    assert len(bad) == (4 if refused else 0), bad
    for name, (g_max, g_mean) in smoke.C_BF16_GATES.items():
        assert g_max <= smoke.BF16_TOL and 0 < g_mean < 1e-3, name


@pytest.mark.parametrize("fused", [True, False])
def test_refilled_slot_check_sees_a_fresh_state_and_a_missed_refill(smoke, fused, monkeypatch):
    """Phase 31's slot check on the CPU: after the continuous batcher's loop
    (kernel A's plain twin, or the plain decode step), every refilled slot's
    rows equal its current song decoded from a zero state in the same row
    of a batch of the loop's size, bit for bit; a refill that leaves one
    finished slot's rows in place is caught."""
    import torch

    from reinforcement_learning_in_music_generation_torch import config as TC
    from reinforcement_learning_in_music_generation_torch.generate import serving
    from reinforcement_learning_in_music_generation_torch.models import common as cm
    from reinforcement_learning_in_music_generation_torch.models import linear_transformer as lt
    from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v4 as dk4
    from reinforcement_learning_in_music_generation_torch.ops import sampling as smp

    cfg = TC.LinearTransformerConfig(vocab_sizes=(8, 16, 4, 12, 4, 6), emb_sizes=(8,) * 6,
                                     d_model=32, n_layer=2, n_head=2, d_inner=64)
    params = lt.init_params(cfg, seed=0, device="cpu")
    dev = torch.device("cpu")
    init = torch.tensor([[0, 0, 1, 0, 0, 0]], dtype=torch.int32).expand(4, -1).contiguous()

    def run(loop):
        gen = torch.Generator()
        gen.manual_seed(9)
        return loop.run(init, 9, 256, 2, gen)
    if not fused:      # the plain step's f32 rows are held to kernel A's twin at f32
        monkeypatch.setenv("RLMG_DECODE_STATE_DTYPE", "float32")
    loop = serving._ServeLoop(params, cfg, 4, 256, smp.CP_SAMPLING, 2, 1, fused=fused,
                              graph=False)
    toks, fin = run(loop)
    errs = smoke.refilled_slot_errors(dk4, lt, cm, params, cfg, dev, loop, toks, fin)
    assert len(errs) == 4
    if fused:
        assert all(e[1] == 0 and e[2] for e in errs)
    else:
        assert max(e[1] for e in errs) < 1e-5

    class Leaky(serving._ServeLoop):            # forgets to zero slot 0's rows
        def refill(self, finished):
            keep = finished.clone()
            keep[0] = False
            self.s.masked_fill_(keep.view(1, -1, 1, 1, 1), 0)
            self.z.masked_fill_(keep.view(1, -1, 1, 1), 0)
            self.pos.masked_fill_(finished, 0)
            self.bars.copy_(torch.where(finished, self.bars0, self.bars))
            self.done.add_(finished.sum(dtype=torch.int32))
    leaky = Leaky(params, cfg, 4, 256, smp.CP_SAMPLING, 2, 1, fused=True, graph=False)
    toks, fin = run(leaky)
    errs = smoke.refilled_slot_errors(dk4, lt, cm, params, cfg, dev, leaky, toks, fin)
    assert errs[0][0] == 0 and errs[0][1] > 1e-2 and not errs[0][2]


def _bf16_readings(names, kernel, controls):
    return {n: {"kernel": kernel, "finite": True, "dtype": True, **controls} for n in names}


@pytest.mark.parametrize("gates", ["F_BF16_GATES", "E_BF16_GATES"])
@pytest.mark.parametrize("kernel,control,f32_route,refused", [
    ((1e-3, 1e-6), (5e-3, 2e-3), (4e-3, 2e-3), False),   # rounding flips only: passes
    ((1e-2, 1e-6), (5e-3, 2e-3), (4e-3, 2e-3), True),    # a max share above BF16_TOL
    ((1e-3, 1e-3), (5e-3, 2e-3), (4e-3, 2e-3), True),    # a fault's mean share
    ((1e-3, 1e-6), (5e-3, 1e-9), (4e-3, 2e-3), True),    # a control that sees nothing
    ((1e-3, 1e-6), (5e-3, 2e-3), (4e-3, 1e-9), True),    # F's f32 route that sees nothing
])
def test_f_and_e_bf16_gates_refuse_a_fault_and_a_blind_control(smoke, gates, kernel, control,
                                                               f32_route, refused):
    """Kernels F's and E's bf16 gates (phases 7 and 11): every tensor within
    its limits, each control above the mean limit, or the gate reports it;
    the limits no looser than BF16_TOL at the max and below the controls'
    card readings (1.1e-4 and up) at the mean."""
    g = getattr(smoke, gates)
    controls = {"control": control}
    if gates == "F_BF16_GATES":
        controls["control_f32_route"] = f32_route
    elif f32_route[1] < 1e-6:                 # E has no f32-route control
        refused = False
    bad = smoke.bf16_gate_failures(_bf16_readings(g, kernel, controls), g,
                                   {"control": "a", "control_f32_route": "b"})
    assert bool(bad) == refused, bad
    for name, (g_max, g_mean) in g.items():
        assert g_max <= smoke.BF16_TOL and 1e-6 < g_mean <= 2e-4, name


def test_band_rounded_control_is_the_twin_at_f32_and_off_it_at_bf16(smoke):
    """Phase 7's control on the CPU: with nothing to round (f32) it is the
    twin's function, forward and gradients (autograd of ``band_plain``),
    to f32 rounding; at bf16 (P and dS rounded) every tensor's mean share
    against the bf16 twin ends above E_BF16_GATES' mean limit."""
    import torch

    from reinforcement_learning_in_music_generation_torch.ops import (
        window_attention_kernel as twk)
    gen = torch.Generator().manual_seed(3)
    q, k, v, g = (torch.randn((2, 2, 300, 16), generator=gen) for _ in range(4))
    mask = torch.ones((2, 300))
    mask[0, 230:] = 0.0                      # a tail longer than w = 50
    g = g * mask[:, None, :, None]
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = twk.band_plain(*ts, mask, 100)[0]
    ref = (out, *torch.autograd.grad(out, ts, g))
    for x, y in zip(smoke.band_rounded_control(twk, q, k, v, mask, 100, g), ref):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    b16 = [t.bfloat16() for t in (q, k, v, g)]
    readings, _ = smoke.band_bf16_readings(twk, *b16[:3], mask, 100, b16[3])
    for name, r in readings.items():
        assert r["kernel"] == (0.0, 0.0), name          # the wrapper runs the twin on the CPU
        assert r["control"][1] > smoke.E_BF16_GATES[name][1], name


@pytest.mark.parametrize("kernel,control,refused", [
    (0, 7, False),         # bit-equal, the control seen: passes
    (1, 7, True),          # one element off the f32 route rounded
    (0, 0, True),          # a control the gate would pass: blind
])
def test_exact_gate_refuses_a_flipped_bit_and_a_blind_control(smoke, kernel, control, refused):
    """Phases 7 and 11's exact gate: no element of the kernel's differs from
    the f32 route rounded, and the dropped-plane control differs, or the
    gate reports it (one message a tensor)."""
    names = ("out", "dq", "dk", "dv")
    bad = smoke.exact_gate_failures({n: {"kernel": kernel, "control": control} for n in names})
    assert len(bad) == (4 if refused else 0), bad


def _band_route_twins(twk):
    """Kernel E's f32 route in the twin's arithmetic on the CPU, with
    forward_kernel / backward_kernel's signatures: the forward is
    ``band_plain``; the backward takes the stored out as the kernel does
    (autograd of ``band_plain`` with lse's cotangent moving dr onto it)."""
    import torch

    def fwd(q, k, v, mask, window):
        return twk.band_plain(q, k, v, mask, window)[0], None

    def bwd(q, k, v, mask, out, _stats, g, window):
        ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            o32, lse = twk.band_plain(*ins, mask, window)
            c = (g * (o32.detach() - out)).sum(-1)
            return torch.autograd.grad((o32, lse), ins, (g, c))
    return fwd, bwd


@pytest.mark.parametrize("which", ["F", "E"])
def test_exact_gate_passes_the_rounded_f32_route_and_refuses_a_dropped_plane(smoke, which):
    """Phases 7 and 11's exact gate on the twins (the wrappers run them on
    the CPU): the bf16 route equals the f32 route on the widened inputs,
    rounded, bit for bit (F: out and den; E: out and the gradients, the
    stored out handed to the backward); the control, the same arithmetic
    with a plane dropped from each f32 operand (F: A and the state; E: P
    and dS), differs in every tensor, and is itself refused as a kernel's
    result.  At f32 F's control is the twin's function, bit for bit."""
    import torch

    from reinforcement_learning_in_music_generation_torch.ops import (
        linear_attention as tla, linear_attention_kernel as tlk, window_attention_kernel as twk)
    gen = torch.Generator().manual_seed(4)
    if which == "F":
        x = [torch.randn((2, 300, 2, 16), generator=gen).transpose(1, 2) for _ in range(3)]
        pq, pk, v = tla.feature_map(x[0]), tla.feature_map(x[1]), x[2]
        fwd = lambda q_, k_, v_, eps: tlk._plain_fwd(q_, k_, v_, eps, 128)
        for a, b in zip(smoke.product_rounded_control(pq, pk, v, 1e-6, 128),
                        fwd(pq, pk, v, 1e-6)):
            assert smoke.bit_diffs(a, b) == 0
        b16 = [t.bfloat16() for t in (pq, pk, v)]
        got = tlk.causal_product(*b16, 1e-6)
        readings = smoke.product_exact_readings(fwd, *b16, 1e-6, got, 128)
        fault = smoke.product_rounded_control(*b16, 1e-6, 128)
        refault = smoke.product_exact_readings(fwd, *b16, 1e-6, fault, 128)
    else:
        q, k, v, g = (torch.randn((2, 2, 300, 16), generator=gen).bfloat16() for _ in range(4))
        mask = torch.ones((2, 300))
        mask[0, 230:] = 0.0
        g = (g.float() * mask[:, None, :, None]).bfloat16()
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = twk.window_attention_band(*ts, mask, 100)
        got = (out.detach(), *torch.autograd.grad(out, ts, g))
        fwd, bwd = _band_route_twins(twk)
        readings = smoke.band_exact_readings(twk, fwd, bwd, q, k, v, mask, 100, g, got)
        fault = smoke.band_rounded_control(twk, q, k, v, mask, 100, g)
        refault = smoke.band_exact_readings(twk, fwd, bwd, q, k, v, mask, 100, g, fault)
    assert not smoke.exact_gate_failures(readings), readings
    assert all(r["kernel"] == 0 and r["control"] > 0 for r in readings.values()), readings
    assert len(smoke.exact_gate_failures(refault)) == len(refault), refault


@pytest.mark.parametrize("shape", [(32, 8, 512, 64), (1, 8, 50, 64)])
def test_bf16_bounds_count_two_bytes_an_element(smoke, shape):
    """F's and E's bounds on bf16 tensors: the same operations, half the
    bytes of the tensors (E's mask and row LSE stay f32, F's den is bf16)."""
    import torch
    (f_ops, f_b), (b_ops, b_b) = smoke.causal_product_work(*shape)
    (f16_ops, f16_b), (b16_ops, b16_b) = smoke.causal_product_work(*shape, elem=2)
    assert (f16_ops, b16_ops) == (f_ops, b_ops) and (f16_b, b16_b) == (f_b // 2, b_b // 2)
    b, h, s, d = shape
    mask = torch.ones((b, s))
    (e_ops, e_b), (eb_ops, eb_b), _, _ = smoke.window_work(b, h, s, d, 25, mask)
    (e16_ops, e16_b), (eb16_ops, eb16_b), _, _ = smoke.window_work(b, h, s, d, 25, mask, elem=2)
    n, fixed = b * h * s * d, 4 * (b * s + b * h * s)
    assert (e16_ops, eb16_ops) == (e_ops, eb_ops)
    assert e_b - fixed == 16 * n and e16_b - fixed == 8 * n
    assert eb_b - fixed == 32 * n and eb16_b - fixed == 16 * n


def _rl_readings(control_loss, margin, flip=True, digests=("a", "a"), g_ran=False):
    """Two ranks' phase-39/40 readings (``rl_rank``'s layout): a DQN step
    within the gates, the control step with ``control_loss`` relative loss,
    a rollout whose actions part from one process's at one field where one
    process's top-2 margin is ``margin`` (or do not part); kernel G's runs
    those of F (``g_ran``) or none; kernel D's none."""
    ok = {"loss": 1e-7, "grads": (1e-6, "/w"), "params": (1e-6, "/w"),
          "params_leaf": (1e-6, "/w"), "updates": (1e-6, "/w"), "updates_seen": 1}
    bad = dict(ok, loss=control_loss, grads=(control_loss, "/w"))
    apart = {"at": (3, 1, 2), "margins": (([1, 2], 1e-6), ([2, 1], margin))} if flip else None
    runs = lambda f: f + [0, 0] + (f if g_ran else [0, 0]) + [0, 0]
    steps = {"dqn": {"runs": runs([36, 24]), "loss": 1.0, "errors": ok,
                     "digests": list(digests)},
             "control": {"runs": runs([36, 24]), "loss": 1.3, "errors": bad,
                         "digests": list(digests)},
             "rollout": {"runs": runs([600, 0]), "actions_equal": not flip, "apart": apart}}
    return [{"rank": r, "steps": steps} for r in range(2)]


@pytest.mark.parametrize("control_loss,margin,flip,digests,ffn,g_ran,n_fails", [
    (0.28, 1e-4, True, ("a", "a"), None, False, 0),   # the card's reading; a flip at a near-tie
    (0.28, 1e-4, False, ("a", "a"), None, False, 0),
    (1e-7, 1e-4, False, ("a", "a"), None, False, 1),  # a control inside the gates
    (0.28, 0.05, True, ("a", "a"), None, False, 2),   # a flip off a tie, on each rank
    (0.28, 1e-4, False, ("a", "b"), None, False, 1),  # the ranks' parameters apart
    (0.28, 1e-4, False, ("a", "a"), "pallas", True, 0),   # G wherever F ran (phase 40b)
    (0.28, 1e-4, False, ("a", "a"), "pallas", False, 6),  # G asked for and not run
    (0.28, 1e-4, False, ("a", "a"), None, True, 6)])      # G run where it was not asked for
def test_rl_gates_refuse_a_blind_control_a_flip_off_a_tie_and_ranks_apart(
        smoke, control_loss, margin, flip, digests, ffn, g_ran, n_fails):
    """Phases 39-40's gates (``rl_gate_failures``): the control (each rank's
    own MSE mean) must end outside the loss and gradient gates; an action
    apart from one process's passes only where one process's top-2 margin
    is under 1e-3; the ranks' parameters are bit-equal; under
    RLMG_FFN_BACKEND=pallas kernel G runs on every rank wherever F does,
    and otherwise nowhere."""
    fails = smoke.rl_gate_failures(_rl_readings(control_loss, margin, flip, digests, g_ran),
                                   {"n_layer": 12, "ffn": ffn})
    assert len(fails) == n_fails, fails


@pytest.mark.parametrize("control_loss,d_runs,digests,n_fails", [
    (0.28, 120, ("a", "a"), 0),       # D on every rank, the control outside the gates
    (1e-7, 120, ("a", "a"), 1),       # a control inside the gates
    (0.28, 0, ("a", "a"), 2),         # D not run, on each rank
    (0.28, 120, ("a", "b"), 1)])      # the ranks' parameters apart
def test_rl_gates_hold_the_split_disc_epoch(smoke, control_loss, d_runs, digests, n_fails):
    """Phase 40b's split discriminator epoch (``disc_split``): within the
    loss and gradient gates against one process, kernel D's launches
    3 x (n_layer - 2) x minibatches on every rank on its route, the ranks'
    parameters bit-equal without a broadcast, and the control (each rank's
    own BatchNorm statistics) outside the gates."""
    ok = {"loss": 1e-7, "grads": (1e-6, "/w"), "params": (1e-6, "/w"),
          "params_leaf": (1e-6, "/w"), "updates": (1e-6, "/w"), "updates_seen": 1}
    bad = dict(ok, loss=control_loss, grads=(control_loss, "/w"))
    step = {"runs": [0] * 6 + [d_runs, d_runs], "loss": 1.0, "errors": ok,
            "control_errors": bad, "digests": list(digests)}
    res = [{"rank": r, "steps": {"disc_split": step}} for r in range(2)]
    spec = {"n_layer": 12, "ffn": "pallas", "disc_route": smoke.DISC_SPLIT_D_ROUTE,
            "disc_control": True}
    assert 3 * 10 * smoke.DISC_SPLIT["minibatches"] == 120
    fails = smoke.rl_gate_failures(res, spec)
    assert len(fails) == n_fails, fails


def _sp_res(errors, controls, counts=((1, 1), (1, 1))):
    return [{"rank": i, "counts": list(c), "runs": list(c), "errors": errors,
             "controls": controls} for i, c in enumerate(counts)]


def test_sp_gates_refuse_a_blind_control_and_a_rank_without_f(smoke):
    """Phase 42's gates: they pass a result within SP_GATES with both
    controls outside, and refuse a result above a gate, a control inside
    them (a blind control) and a rank whose kernel F did not run."""
    ok = {"out": 1e-7, "dq": 1e-6, "dk": 1e-6, "dv": 1e-6}
    far = {"out": 0.5, "dq": 0.2, "dk": 0.5, "dv": 0.8}
    ctl = {"inclusive_prefix": far, "no_reduce_scatter": dict(ok, dk=0.1, dv=0.2)}
    spec = {"sp": 2}
    assert smoke.sp_gate_failures(_sp_res(ok, ctl), spec) == []
    assert smoke.sp_gate_failures(_sp_res(dict(ok, dk=2e-3), ctl), spec)
    assert smoke.sp_gate_failures(_sp_res(ok, dict(ctl, no_reduce_scatter=ok)), spec)
    assert smoke.sp_gate_failures(_sp_res(ok, ctl, ((1, 1), (0, 0))), spec)


def test_pp_gates_refuse_a_blind_control_missing_launches_and_ranks_apart(smoke):
    """Phase 43's gates: D (and, on G's route, G) (n_layer / pp) x m times
    forward and backward on every stage, equal losses and replicated leaves
    on the ranks, the step within STEP_GATES and the control outside them."""
    good = {"loss": 1e-7, "grads": (1e-6, "/x"), "params": (1e-7, "/x"),
            "params_leaf": (1e-7, "/x"), "updates": (1e-6, "/x"), "updates_seen": 1}
    bad = dict(good, grads=(1.0, "/heads/pitch/w"))
    spec = {"n_layer": 12, "pp": 2}

    def res(counts=(24, 24), errors=good, control=bad, digests=("a", "a"), losses=(1.0, 1.0),
            g_counts=(24, 24)):
        want = [0, 0, *counts] + [0] * 6
        g = {"counts": [0] * 8 + list(g_counts), "loss_ranks": [1.0, 1.0],
             "digests": ["c", "c"], "errors": good}
        r0 = {"rank": 0, "counts": want, "microbatches": 4, "loss_ranks": list(losses),
              "digests": list(digests), "errors": errors, "control_errors": control,
              "dropout": {"float32": [2.0, 2.0]}, "g": g}
        return [r0, dict(r0, rank=1)]
    assert smoke.pp_gate_failures(res(), spec) == []
    assert smoke.pp_gate_failures(res(g_counts=(24, 0)), spec)
    assert smoke.pp_gate_failures(res(counts=(0, 0)), spec)
    assert smoke.pp_gate_failures(res(errors=bad), spec)
    assert smoke.pp_gate_failures(res(control=good), spec)
    assert smoke.pp_gate_failures(res(digests=("a", "b")), spec)
    assert smoke.pp_gate_failures(res(losses=(1.0, float("nan"))), spec)


@pytest.mark.parametrize("kernel,control,refused", [
    (0.003, 3.8, 0),                # v2 within the gate, the exact-gelu control above it
    (1.2, 3.8, 1),                  # the fault: the kernel off the gate
    (0.003, 0.9, 1),                # a blind control
    (1.2, 0.9, 2),
    (float("nan"), 3.8, 1),         # not a number is no pass
])
def test_gelu_control_gate_refuses_the_fault_and_a_blind_control(smoke, kernel, control,
                                                                 refused):
    """Phase 27's v2 gate: the kernel within test_layer_kernels_match_plain's
    h gate and the exact-gelu control above it, or one message each."""
    assert len(smoke.control_gate_failures("v2", kernel, control)) == refused


def test_gate_excess_is_the_assert_close_measure(smoke):
    """gate_excess is at most 1 exactly where torch.testing.assert_close
    passes with the same rtol and atol."""
    import torch
    ref = torch.tensor([1.0, -2.0, 0.5, 0.0])
    for delta, passes in ((1e-4, True), (2.5e-4, True), (4e-4, False)):
        x = ref + torch.tensor([0.0, delta, 0.0, 0.0])
        ex = smoke.gate_excess(x, ref, 1e-4, 1e-4)
        try:
            torch.testing.assert_close(x, ref, rtol=1e-4, atol=1e-4)
            ok = True
        except AssertionError:
            ok = False
        assert ok == passes and (ex <= 1.0) == passes, (delta, ex)
