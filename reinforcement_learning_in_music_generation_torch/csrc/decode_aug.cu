// One decode token on the augmented state [S | z], (E, E + 1) f32 per
// (head, song), z the last column: the CUDA counterparts of
//   reinforcement_learning_in_music_generation_tpu/ops/decode_kernel_v3.py
//     fused_stack_step (v3, its Pallas body _step_kernel: grid (L, H, batch
//     blocks), every layer of a token, head-major weights, exact-erf gelu),
//   .../ops/experimental/decode_kernel.py fused_layer_step (v1, its body
//     _layer_kernel: one layer, the (D, 3D) [q | k | v] weight) and
//     fused_layer_step_v2 (v2, _layer_kernel_v2: one layer, head-major
//     weights); v1 and v2 use the tanh gelu.
//
// All three run kernel A's token kernel, decode_stack_tc.cuh's
// stack_tc_kernel, on the augmented state: one cooperative launch a call,
// four grid barriers a layer, every product on the tensor cores at f32
// grade (three bf16 products a product with bf16 weights, six with f32),
// the qkv columns head-major [q_h k_h v_h]; the state items update S[:, u]
// for u < E and column E (z) after the grid barrier, so every item reads
// the z of before the token.  That header's note gives the design and the
// bound.
//
// v3 (rlmg_v3_tc_step): every layer of a token, the exact gelu, LN1 of
// (h + att Wo) + bo.
//
// v2 (rlmg_v2_tc_step) is v3's layer with the tanh gelu: the token kernel
// for one layer (L = 1, TANH).  Its head-major weights, qkv (H, D, 3E) and
// Wo (H, E, D), are v3's qkv column order and the (D, D) Wo row for row;
// v2_pack_kernel (rlmg_v2_pack, one launch) packs a layer's leaves into the
// kernel's operands (the matrices in mma fragment order,
// ops/decode_kernel_v4.py pack_fragments; the vectors f32; the row-tile
// counters zeroed), which the wrapper keeps while the leaves keep their
// storage and version.  JAX's v2 casts the weights up to f32 (.astype(f32)),
// so with bf16 weights the kernel's three bf16 products of the f32
// activation planes are that arithmetic.
//
// v1 (rlmg_v1_tc_step) is v2's launch with the kernel's v1 field set: LN1 of
// h + (att Wo + bo), JAX v1's order, and its runs counted apart from v2's.
// It reads v2's packed operands: v1's (D, 3D) [q | k | v] weight is a
// column permutation of the head-major one (each output column its own dot
// product, so the permutation changes no sum) and its Wo is v2's row for
// row.
//
// Bound on the card.  Per token the weights are read once (37.7M values at
// the flagship width: 75.5 MB in bf16) and the state read and written once
// (L H B E (E + 1) f32 each way: 1.6 MB a song at 12 layers and 8 heads of
// 64); 2 B L (4 D^2 + 2 D DI) operations.  At B <= 128 in bf16 the bytes
// bind.

#include "decode_stack_tc.cuh"

namespace rlmg {

// v2's layer leaves, in this order: wq, wk, wv, wo (D, D), w1 (D, DI), w2
// (DI, D), bq, bk, bv, bo, LN1 scale and shift (D), b1 (DI), b2, LN2 scale
// and shift (D).
enum { V2_WQ, V2_WK, V2_WV, V2_WO, V2_W1, V2_W2, V2_BQ, V2_BK, V2_BV, V2_BO, V2_L1S, V2_L1B,
       V2_B1, V2_B2, V2_L2S, V2_L2B, V2_NSRC };

struct V2Pack {
  const void* src[V2_NSRC];
  unsigned int bf16_mask;     // bit i: src[i] holds bf16 (else f32)
  void* mats[4];              // Wqkv (D, 3D, head-major columns), Wo, W1, W2: packed, in TW
  float* vecs[SV_N];          // qkv bias (head-major), bo, LN1, b1, b2, LN2: f32
  unsigned int* cnt;          // the token kernel's row-tile counters, zeroed
  int ncnt, D, H, DI;
};

__device__ __forceinline__ float v2_src(const V2Pack& p, int i, size_t k) {
  return (p.bf16_mask >> i) & 1u ? __bfloat162float(((const __nv_bfloat16*)p.src[i])[k])
                                 : ((const float*)p.src[i])[k];
}

// A layer's leaves into the token kernel's operands, grid-stride.  The
// matrices in pack_fragments order: output element o of a (K, N) matrix
// is lane (o >> 3) & 31 = 4 g + t's value o & 7 = 4 s + 2 h + p of the
// 8-column tile j and the 32 depths c (o >> 8 = j Kp / 32 + c), W[32 c +
// 16 s + 8 h + 2 t + p][8 j + g], zero past K.  Column n of Wqkv is head
// n / 3E's q, k or v column (n / E mod 3), the head-major order.
template <typename TW>
__global__ void __launch_bounds__(256) v2_pack_kernel(const V2Pack p) {
  const size_t i0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x,
               step = (size_t)gridDim.x * blockDim.x;
  const int D = p.D, E = D / p.H, DI = p.DI;
  for (int mi = 0; mi < 4; ++mi) {
    const int K = mi == 3 ? DI : D, N = mi == 0 ? 3 * D : mi == 2 ? DI : D, C = pad32(K) / 32;
    TW* out = (TW*)p.mats[mi];
    for (size_t o = i0; o < (size_t)N * C * 32; o += step) {
      const int pr = o & 1, hh = (o >> 1) & 1, s = (o >> 2) & 1, t = (o >> 3) & 3,
                g = (o >> 5) & 7;
      const size_t cj = o >> 8;
      const int c = (int)(cj % C), n = 8 * (int)(cj / C) + g;
      const int k = 32 * c + 16 * s + 8 * hh + 2 * t + pr;
      float v = 0.f;
      if (k < K) {
        if (mi == 0)
          v = v2_src(p, V2_WQ + (n / E) % 3, (size_t)k * D + n / (3 * E) * E + n % E);
        else
          v = v2_src(p, mi == 1 ? V2_WO : mi == 2 ? V2_W1 : V2_W2, (size_t)k * N + n);
      }
      st(out + o, v);
    }
  }
  for (size_t i = i0; i < (size_t)3 * D; i += step) {
    const int n = (int)i;
    p.vecs[SV_BQKV][i] = v2_src(p, V2_BQ + (n / E) % 3, n / (3 * E) * E + n % E);
  }
  const int from[SV_N] = {0, V2_BO, V2_L1S, V2_L1B, V2_B1, V2_B2, V2_L2S, V2_L2B};
  for (int vi = 1; vi < SV_N; ++vi)
    for (size_t i = i0; i < (size_t)(vi == SV_B1 ? DI : D); i += step)
      p.vecs[vi][i] = v2_src(p, from[vi], i);
  for (size_t i = i0; i < (size_t)p.ncnt; i += step) p.cnt[i] = 0u;
}

}  // namespace rlmg

extern "C" {

// v2's packing, one launch: src the 16 leaves of one layer in V2_WQ..V2_L2B
// order (each f32 or bf16, bit i of bf16_mask set for bf16; contiguous);
// mats the four packed matrices (Wqkv with head-major columns, Wo, W1, W2)
// in bf16 (out_bf16) or f32, of (N / 8) (pad32(K) / 32) 256 values each;
// vecs the eight f32 vectors in the token kernel's order; cnt: ncnt ints
// to zero.  Returns 0 or a CUDA error code.
int rlmg_v2_pack(const void* const* src, int bf16_mask, void* const* mats, float* const* vecs,
                 unsigned int* cnt, int ncnt, int D, int H, int DI, int out_bf16,
                 void* stream) {
  if (H < 1 || D % H || D < 1 || DI < 1 || ncnt < 0) return (int)cudaErrorInvalidValue;
  rlmg::V2Pack p{};
  for (int i = 0; i < rlmg::V2_NSRC; ++i) p.src[i] = src[i];
  for (int i = 0; i < 4; ++i) p.mats[i] = mats[i];
  for (int i = 0; i < rlmg::SV_N; ++i) p.vecs[i] = vecs[i];
  p.bf16_mask = (unsigned int)bf16_mask;
  p.cnt = cnt;
  p.ncnt = ncnt;
  p.D = D;
  p.H = H;
  p.DI = DI;
  const cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    rlmg::v2_pack_kernel<__nv_bfloat16><<<264, 256, 0, st>>>(p);
  else
    rlmg::v2_pack_kernel<float><<<264, 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// v2 (v1 = 0) and v1 (v1 = 1): one layer of one token in one launch, the
// token kernel with the tanh gelu.  h_in (B, D) f32 is read, h_out (B, D)
// f32 gets LN2 of the layer's r2; w, v: rlmg_v2_pack's matrices (w_bf16:
// their type) and vectors; s_aug (H, B, E, E + 1) f32, updated in place;
// scratch: rlmg_v3_tc_scratch_floats(B, D, DI) floats; cnt: (B + 15) / 16
// zeroed ints, left zeroed.  *launched gets the CUDA launches issued.
static int layer_tc_step(const void* const* w, const void* const* v, float* s_aug,
                         const float* h_in, float* h_out, float* scratch, unsigned int* cnt,
                         int B, int D, int H, int DI, float eps, int w_bf16, int v1, void* stream,
                         int* launched) {
  *launched = 0;
  if (B < 1 || !rlmg::stack_tc_shape_ok(D, H, DI)) return (int)cudaErrorInvalidValue;
  const rlmg::StackTcArgs a = rlmg::stack_tc_args(w, v, s_aug, nullptr, h_in, h_out, scratch,
                                                  cnt, 1, B, D, H, DI, eps, 1, v1);
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = w_bf16 ? rlmg::stack_tc_launch<__nv_bfloat16, float, float, true, true>(a, st)
                        : rlmg::stack_tc_launch<float, float, float, true, true>(a, st);
  if (rc == 0) *launched = 1;
  return rc;
}

int rlmg_v2_tc_step(const void* const* w, const void* const* v, float* s_aug,
                    const float* h_in, float* h_out, float* scratch, unsigned int* cnt, int B,
                    int D, int H, int DI, float eps, int w_bf16, void* stream, int* launched) {
  return layer_tc_step(w, v, s_aug, h_in, h_out, scratch, cnt, B, D, H, DI, eps, w_bf16, 0,
                       stream, launched);
}

int rlmg_v1_tc_step(const void* const* w, const void* const* v, float* s_aug,
                    const float* h_in, float* h_out, float* scratch, unsigned int* cnt, int B,
                    int D, int H, int DI, float eps, int w_bf16, void* stream, int* launched) {
  return layer_tc_step(w, v, s_aug, h_in, h_out, scratch, cnt, B, D, H, DI, eps, w_bf16, 1,
                       stream, launched);
}

// v2's and v1's token-kernel runs since the last reset, as the kernel
// counts them, each apart.
long long rlmg_v2_tc_runs(int reset) { return rlmg::stack_tc_runs(reset, rlmg::SK_RUNS_V2); }
long long rlmg_v1_tc_runs(int reset) { return rlmg::stack_tc_runs(reset, rlmg::SK_RUNS_V1); }

// v3's token kernel: the f32 scratch floats a call needs at batch B, whether
// it takes (D, H, DI) (1 or 0), and its runs since the last reset as the
// kernel counts them (decode_step.cu's entries of the same names, for v3).
long long rlmg_v3_tc_scratch_floats(int B, int D, int DI) {
  return rlmg::stack_tc_scratch_floats(B, D, DI);
}
int rlmg_v3_tc_shape_ok(int D, int H, int DI) { return rlmg::stack_tc_shape_ok(D, H, DI); }
long long rlmg_v3_tc_runs(int reset) { return rlmg::stack_tc_runs(reset); }

// v3: L layers of one token in one launch.  h_in (B, D) f32 is read, h_out
// (B, D) f32 gets the output; w: the four packed matrices (Wqkv with its
// columns head-major, Wo, W1, W2; ops/decode_kernel_v4.py pack_fragments)
// in one type (w_bf16); v: the eight stacked f32 vectors (qkv bias
// head-major, Wo bias, LN1 scale and shift, FFN1 bias, FFN2 bias, LN2 scale
// and shift); s_aug (L, H, B, E, E + 1) f32, updated in place; scratch:
// rlmg_v3_tc_scratch_floats(B, D, DI) floats; cnt: (B + 15) / 16 zeroed
// ints, left zeroed.  *launched gets the CUDA launches issued.  Returns 0
// or the first CUDA error code.
int rlmg_v3_tc_step(const void* const* w, const void* const* v, float* s_aug,
                    const float* h_in, float* h_out, float* scratch, unsigned int* cnt, int L,
                    int B, int D, int H, int DI, float eps, int w_bf16, void* stream,
                    int* launched) {
  *launched = 0;
  if (L < 1 || B < 1 || !rlmg::stack_tc_shape_ok(D, H, DI)) return (int)cudaErrorInvalidValue;
  const rlmg::StackTcArgs a = rlmg::stack_tc_args(w, v, s_aug, nullptr, h_in, h_out, scratch,
                                                  cnt, L, B, D, H, DI, eps, 1);
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = w_bf16 ? rlmg::stack_tc_launch<__nv_bfloat16, float, float, true>(a, st)
                        : rlmg::stack_tc_launch<float, float, float, true>(a, st);
  if (rc == 0) *launched = 1;
  return rc;
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
