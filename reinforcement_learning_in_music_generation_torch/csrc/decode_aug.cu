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
// v3 (rlmg_v3_tc_step) runs kernel A's token kernel, decode_stack_tc.cuh's
// stack_tc_kernel, on the augmented state: one cooperative launch a token,
// four grid barriers a layer, every product on the tensor cores at f32
// grade (three bf16 products a product with bf16 weights, six with f32),
// the qkv columns head-major [q_h k_h v_h] as the head-major weight packs
// them, LN1 of (h + att Wo) + bo; the state items update S[:, u] for u < E
// and column E (z) after the grid barrier, so every item reads the z of
// before the token.  That header's note gives the design and the bound.
//
// v2 (rlmg_v2_tc_step) is v3's layer with the tanh gelu: the same token
// kernel for one layer (L = 1, TANH), one cooperative launch a call.  Its
// head-major weights, qkv (H, D, 3E) and Wo (H, E, D), are v3's qkv column
// order and the (D, D) Wo row for row; v2_pack_kernel (rlmg_v2_pack, one
// launch) packs a layer's leaves into the kernel's operands (the matrices
// in mma fragment order, ops/decode_kernel_v4.py pack_fragments; the
// vectors f32; the row-tile counters zeroed), which the wrapper keeps while
// the leaves keep their storage and version.  JAX's v2 casts the weights
// up to f32 (.astype(f32)), so with bf16 weights the kernel's three bf16
// products of the f32 activation planes are that arithmetic.
//
// v1 (rlmg_decode_aug) keeps the per-layer passes below.
// Per layer (launches in brackets):
//   qkv      h @ Wqkv + b, phi on q and k: one K-split product over the
//            (D, 3D) weight into a (B, 3D) buffer [2]
//   state    aug_state_kernel [1], one block per (head, song, tile of 32
//            state columns).  Each block loops over the E rows, so its
//            columns need no sum across blocks: S[:, u] += k v[u], num[u] =
//            q . S[:, u].  Each block also forms column E, z + k, and the
//            denominator q . (z + k); the last block of a (head, song) to
//            finish writes column E back (an atomic counter picks it; the
//            value written is the same whichever block it is).  att =
//            num / (den + eps) into (B, D).  Any head width E.
//   Wo, LN1  K-split att @ Wo [1], then LN1 [1] of h + (att Wo + bo)
//   FFN      y = gelu(h1 W1 + b1) [2], h = LN2(h1 + (y W2 + b2)) [2]
// The products, the K-split reduction and the LN row are those of
// decode_layers.cuh.  Everything accumulates in f32; the weight matrices
// are read in their stored type (f32 or bf16), the biases and LN vectors
// are f32, the state is f32, as in the TPU kernels.
//
// Bound on the card.  Per token the weights are read once (37.7M values at
// the flagship width: 75.5 MB in bf16) and the state read and written once
// (L H B E (E + 1) f32 each way: 1.6 MB a song at 12 layers and 8 heads of
// 64); 2 B L (4 D^2 + 2 D DI) operations.  At B <= 128 in bf16 the bytes
// bind.

#include "decode_stack_tc.cuh"

namespace rlmg {

constexpr int AUG_TC = 32;                       // state columns a block
constexpr int AUG_THREADS = 256;
constexpr int AUG_RG = AUG_THREADS / AUG_TC;     // row groups a block: 8

// Grid: H B ceil(E / AUG_TC) blocks in (head, song, tile) order; 2 E floats
// of dynamic shared memory.  s_aug: the layer's (H, B, E, E + 1) state,
// updated in place.  done: H B ints, 0 on entry and on exit.
__global__ void __launch_bounds__(AUG_THREADS)
aug_state_kernel(const float* __restrict__ qkv, float* __restrict__ s_aug,
                 float* __restrict__ att, int* __restrict__ done, int B, int H, int E,
                 float eps) {
  extern __shared__ float qk[];                  // q (E), k (E)
  __shared__ float part[AUG_THREADS];
  __shared__ float red[32];
  __shared__ int last;
  const int n_ct = (E + AUG_TC - 1) / AUG_TC;
  const int ct = blockIdx.x % n_ct, hb = blockIdx.x / n_ct, h = hb / B, b = hb % B;
  const int tid = threadIdx.x, c = tid % AUG_TC, rg = tid / AUG_TC, u = ct * AUG_TC + c;
  const int D = H * E;
  const float* row = qkv + (size_t)b * 3 * D + (size_t)h * E;     // [q | k | v] columns
  float* qs = qk;
  float* ks = qk + E;
  for (int i = tid; i < E; i += AUG_THREADS) {
    qs[i] = row[i];
    ks[i] = row[D + i];
  }
  const float vu = u < E ? row[2 * D + u] : 0.f;
  __syncthreads();
  const int W = E + 1;
  float* sp = s_aug + (size_t)hb * E * W;
  float num = 0.f;
  if (u < E) {
    for (int j = rg; j < E; j += AUG_RG) {
      float* p = sp + (size_t)j * W + u;
      const float sv = fmaf(ks[j], vu, *p);
      *p = sv;
      num = fmaf(qs[j], sv, num);
    }
  }
  part[tid] = num;
  float dq = 0.f;                                 // column E: read here, written below
  for (int j = tid; j < E; j += AUG_THREADS) dq = fmaf(qs[j], sp[(size_t)j * W + E] + ks[j], dq);
  const float den = block_sum(dq, red) + eps;     // synchronises: part is complete
  if (rg == 0 && u < E) {
    float n = 0.f;
    for (int g = 0; g < AUG_RG; ++g) n += part[g * AUG_TC + c];
    att[(size_t)b * H * E + (size_t)h * E + u] = n / den;
  }
  if (tid == 0) {                                 // every block has read column E by now
    last = atomicAdd(done + hb, 1) == n_ct - 1;
    if (last) done[hb] = 0;
  }
  __syncthreads();
  if (last)
    for (int j = tid; j < E; j += AUG_THREADS) sp[(size_t)j * W + E] += ks[j];
}

// K-split partial sums of x (M, K) @ w (K, N) into part (s, M, N); *s gets
// the number of slices.
template <typename TW>
int partials(const float* x, const TW* w, float* part, int M, int K, int N, cudaStream_t st,
             int* s) {
  const Split sp = split_k(M, K, N);
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, sp.s);
  gemm_kernel<TW><<<grid, LIN_THREADS, 0, st>>>(x, w, (const TW*)nullptr, nullptr, part, M, K,
                                                N, sp.kchunk, ACT_NONE, 0);
  *s = sp.s;
  RLMG_CHECK();
  return 0;
}

// y (M, N) = act(sum of the s partial sums + bias), bias f32.
inline int reduce(const float* part, int s, const float* bias, float* y, int M, int N, int act,
                  int phi_cols, cudaStream_t st) {
  const size_t mn = (size_t)M * N;
  reduce_act_kernel<float><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(part, bias, y, M, N, s,
                                                                          act, phi_cols);
  RLMG_CHECK();
  return 0;
}

struct AugArgs {
  const void* w[N_WEIGHTS];   // decode_layers.cuh order, stacked over L: matrices in the
                              // weights' type, biases and LN vectors f32
  float* s;                   // (L, H, B, E, E + 1)
  float *h, *qkv, *att, *h1, *y1, *part;
  int* done;                  // (H, B)
  int L, B, D, H, DI;
  float eps;
};

inline size_t aug_scratch_floats(int B, int D, int DI) {
  size_t part = 0;
  const int shapes[4][2] = {{D, 3 * D}, {D, D}, {D, DI}, {DI, D}};
  for (auto& kn : shapes) {
    const Split sp = split_k(B, kn[0], kn[1]);
    const size_t n = (size_t)sp.s * B * kn[1];
    if (n > part) part = n;
  }
  return (size_t)B * (3 * D + D + D + DI) + part;
}

#define AUG_TRY(call)          \
  do {                         \
    const int rc_ = (call);    \
    if (rc_) return rc_;       \
  } while (0)

template <typename TW>
int aug_run(const AugArgs& a, cudaStream_t st, int* launched) {
  const int B = a.B, D = a.D, H = a.H, E = D / H, DI = a.DI;
  const TW* const* M = (const TW* const*)a.w;
  const float* const* V = (const float* const*)a.w;
  const size_t slice = (size_t)H * B * E * (E + 1);
  const int n_ct = (E + AUG_TC - 1) / AUG_TC;
  int s = 0;
  for (int l = 0; l < a.L; ++l) {
    const size_t dd = (size_t)l * D * D, d = (size_t)l * D;
    AUG_TRY(partials<TW>(a.h, M[W_QKV] + 3 * dd, a.part, B, D, 3 * D, st, &s));
    AUG_TRY(reduce(a.part, s, V[B_QKV] + 3 * d, a.qkv, B, 3 * D, ACT_PHI, 2 * D, st));
    aug_state_kernel<<<H * B * n_ct, AUG_THREADS, 2 * E * sizeof(float), st>>>(
        a.qkv, a.s + l * slice, a.att, a.done, B, H, E, a.eps);
    RLMG_CHECK();
    AUG_TRY(partials<TW>(a.att, M[W_O] + dd, a.part, B, D, D, st, &s));
    res_ln_kernel<float><<<B, LN_THREADS, 0, st>>>(a.part, s, V[B_O] + d, a.h, V[LN1_S] + d,
                                                   V[LN1_B] + d, a.h1, B, D, 1e-5f);
    RLMG_CHECK();
    AUG_TRY(partials<TW>(a.h1, M[W_F1] + (size_t)l * D * DI, a.part, B, D, DI, st, &s));
    AUG_TRY(reduce(a.part, s, V[B_F1] + (size_t)l * DI, a.y1, B, DI, ACT_GELU_TANH, 0, st));
    AUG_TRY(partials<TW>(a.y1, M[W_F2] + (size_t)l * DI * D, a.part, B, DI, D, st, &s));
    res_ln_kernel<float><<<B, LN_THREADS, 0, st>>>(a.part, s, V[B_F2] + d, a.h1, V[LN2_S] + d,
                                                   V[LN2_B] + d, a.h, B, D, 1e-5f);
    RLMG_CHECK();
    *launched += 9;
  }
  return 0;
}

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

// f32 scratch floats rlmg_decode_aug needs at batch B.
long long rlmg_aug_scratch_floats(int B, int D, int DI) {
  return (long long)rlmg::aug_scratch_floats(B, D, DI);
}

// v1: L layers of one token.  h (B, D) f32 is read as the input and
// overwritten with the output; w: 12 layer-stacked pointers in
// rlmg::W_QKV..LN2_B order (the qkv weight (L, D, 3D), Wo (L, D, D);
// matrices in one type, w_bf16; biases and LN vectors f32); s_aug (L, H,
// B, E, E + 1) f32, updated in place; done: H B zeroed ints (left zeroed);
// the tanh gelu; LN1 of h + (att Wo + bo).  *launched receives the number
// of kernel launches issued.  Returns 0 or the first CUDA error code.
int rlmg_decode_aug(float* h, const void* const* w, float* s_aug, float* scratch, int* done,
                    int L, int B, int D, int H, int DI, float eps, int w_bf16, void* stream,
                    int* launched) {
  *launched = 0;
  if (L < 1 || B < 1 || H < 1 || DI < 1 || D % H || D > rlmg::MAX_D)
    return (int)cudaErrorInvalidValue;
  rlmg::AugArgs a{};
  for (int i = 0; i < rlmg::N_WEIGHTS; ++i) a.w[i] = w[i];
  a.s = s_aug;
  a.h = h;
  a.qkv = scratch;
  a.att = a.qkv + (size_t)B * 3 * D;
  a.h1 = a.att + (size_t)B * D;
  a.y1 = a.h1 + (size_t)B * D;
  a.part = a.y1 + (size_t)B * DI;
  a.done = done;
  a.L = L;
  a.B = B;
  a.D = D;
  a.H = H;
  a.DI = DI;
  a.eps = eps;
  cudaStream_t st = (cudaStream_t)stream;
  return w_bf16 ? rlmg::aug_run<__nv_bfloat16>(a, st, launched)
                : rlmg::aug_run<float>(a, st, launched);
}

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

// v2: one layer of one token in one launch, the token kernel with the tanh
// gelu.  h_in (B, D) f32 is read, h_out (B, D) f32 gets LN2 of the layer's
// r2; w, v: rlmg_v2_pack's matrices (w_bf16: their type) and vectors;
// s_aug (H, B, E, E + 1) f32, updated in place; scratch:
// rlmg_v3_tc_scratch_floats(B, D, DI) floats; cnt: (B + 15) / 16 zeroed
// ints, left zeroed.  *launched gets the CUDA launches issued.
int rlmg_v2_tc_step(const void* const* w, const void* const* v, float* s_aug,
                    const float* h_in, float* h_out, float* scratch, unsigned int* cnt, int B,
                    int D, int H, int DI, float eps, int w_bf16, void* stream, int* launched) {
  *launched = 0;
  if (B < 1 || !rlmg::stack_tc_shape_ok(D, H, DI)) return (int)cudaErrorInvalidValue;
  const rlmg::StackTcArgs a = rlmg::stack_tc_args(w, v, s_aug, nullptr, h_in, h_out, scratch,
                                                  cnt, 1, B, D, H, DI, eps, 1);
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = w_bf16 ? rlmg::stack_tc_launch<__nv_bfloat16, float, float, true, true>(a, st)
                        : rlmg::stack_tc_launch<float, float, float, true, true>(a, st);
  if (rc == 0) *launched = 1;
  return rc;
}

// v2's token-kernel runs since the last reset, as the kernel counts them.
long long rlmg_v2_tc_runs(int reset) { return rlmg::stack_tc_runs(reset, true); }

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
