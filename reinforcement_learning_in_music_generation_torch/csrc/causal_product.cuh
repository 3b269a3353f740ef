// Causal linear-attention product of feature-mapped q and k, forward and
// backward: the passes of kernel F (causal_product.cu, the CUDA
// counterpart of
// reinforcement_learning_in_music_generation_tpu/ops/linear_attention.py
// _fwd_pallas / _bwd_pallas, which replaced fast_transformers'
// causal_product) and the attention half of kernel C (attention_block.cu,
// ops/attention_block.py qkv_attention_block's _fwd_kernel, _bwd_dq_kernel
// and _bwd_dkv_kernel): one recurrence for both.
//
//   out_i = phi(q_i) S_i / (phi(q_i) . z_i + eps),
//   S_i = sum_{j <= i} phi(k_j) v_j^T,  z_i = sum_{j <= i} phi(k_j),
// with den_i = phi(q_i) . z_i returned unclipped beside out, as _fwd_pallas
// returns it.  Every tensor is a (B, H, S, E) view (Bhse): base and batch /
// head / row strides in elements, multiples of 4, a unit last stride, so
// the (B, H, S, E) views of (B, S, H, E) projections (F) and the heads of
// kernel C's packed (N, 3D) rows [phi(q) | phi(k) | v] (strides (S 3D, E,
// 3D)) go in and come out without copies; den (B, H, S) contiguous (f32,
// or bf16 in F's bf16 instantiation).
// E <= 64, a multiple of 4.
//
// IO policy, Args<TI, TO>: phi(q), phi(k), v and the upstream gradient are
// read in TI, out is written (forward) and read (backward) in TO, the
// gradients written in TO; f32 tiles are copied by cp.async, bf16 ones
// loaded and converted to f32 as the tile is staged, so every product
// sees f32 values.  F: <float, float> and <bf16, bf16, bf16>.  C: forward <float, T> on the
// projection's unrounded f32 values (att rounded to h's type T on store),
// backward <T, T> on the stored residual, with fold set: d phi(q) and
// d phi(k) leave the pass that writes them times phi' = min(phi, 1) of
// the stored phi, as JAX's _qab_bwd folds them.  The third parameter TD
// is den's type: F's bf16 instantiation stores den rounded to bf16, as
// _fwd_pallas returns it, and then forms the backward's dnum = g / (den +
// eps) and dd = -sum(g out) / (den + eps) in bf16 arithmetic, as
// _bwd_pallas forms them outside its kernels (each product g out rounded,
// the sum taken in f32 and rounded, den + eps and each quotient rounded);
// with an f32 den (F's f32 instantiation, C) they are f32.
//
// What binds.  At a rollout episode (1, 8, 50, 64) the forward is 9 MFLOP
// and 0.4 MB: the launch and one round trip to memory bind, and a (head,
// sequence) grid gives 8 blocks.  At a DQN update (30, 8, 50, 64) the same
// in 30x.  At pretrain (32, 8, 512, 64) the forward is 4.3 GFLOP on 134 MB,
// the backward 12 GFLOP on 269 MB: bytes bind at the tensor cores' rate
// for f32-grade products (989/6 TFLOP/s), operations at f32-FMA rates.
//
// The design.
//  * Row tiles of T = 64, processed in parallel.  For S > T a state pass
//    writes each tile's increment k^T [v | 1] (its S and z, EP x KA f32;
//    the backward also q^T [dnum | dd], its G and gz) to a scratch slot,
//    every tile in its own block; the output pass (one block of 8 warps a
//    tile) sums the slots before its tile (prefix (S, z): the forward and
//    d phi(q)) or after it (suffix (G, gz): d phi(k), dv) in slot order,
//    with every slot's loads in flight at once, and adds the tile's own
//    causal part.  Blocks: B H ceil(S / T), not B H.  The backward's
//    output pass runs its two roles side by side.  No atomics in the
//    arithmetic: two runs are bit-equal.  dnum = g / (den + eps) and
//    dd = -sum(g out) / (den + eps) are formed in the passes that read
//    them.
//  * At S <= T (rollout, DQN update) there is no state pass and no dead
//    k^T v: one block of 4 warps a 16-row group, each warp one 16-row
//    chunk of the other side (keys for the forward and d phi(q), queries
//    for d phi(k), dv), the partial sums added in shared memory in warp
//    order: the rollout's 8 heads take 32 blocks, the DQN update's 960.
//  * Augmented columns carry the sums the TPU carried in S_aug: v gets a
//    ones column, so A [v | 1] gives num and rowsum(A), q [S | z] gives
//    q S and q.z; dnum gets the dd column, so [dnum | dd] [v | 1]^T is
//    dnum v^T + dd and [dnum | dd] [S | z]^T is dnum S^T + dd z^T.
//  * Every product on the tensor cores at f32 grade: mma.sync m16n8k16
//    over three bf16 planes of each f32 operand (x = hi + mid + lo), the
//    six products whose terms reach 2^-16 of a product, each depth of 16
//    summed afresh and added to the running sum in f32
//    (train_gemm_tc.cuh's arithmetic for kernels D and G).  The long
//    backward (S > T) splits each operand tile into its planes once, as
//    the block loads it, and reads fragments by ldmatrix (153 KB of shared
//    memory at E = 64, one block an SM); the other passes split f32 tiles
//    in registers, fragment by fragment (two blocks an SM or more).  The
//    score tile never leaves registers: its accumulator is the next
//    product's A operand.  The kernels are compiled for the model's head
//    width (E = 64: every loop unrolls without branches, so a tile's
//    independent products interleave) and for any other width.
//  * The last launch of a call counts the call's run on the card
//    (cp_runs, one counter a library), so graph replays are counted by the
//    kernel.
//  What holds it back (PERF.md): the long backward waits for its loads
//  at one block an SM, the other passes split planes in registers for each
//  fragment, and at S > T the backward's dk / dv role does twice the dq
//  role's products.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "tc_mma.cuh"

namespace rlmg {
namespace cpk {

constexpr int T = 64;            // rows a tile
constexpr int MAX_E = 64;
constexpr int PAD = 8;           // floats a shared-memory row is padded by

// Calls that ran to their end: [0] forward, [1] backward.
__device__ unsigned long long cp_runs[2];

using bf16 = __nv_bfloat16;

// A (B, H, S, E) tensor of X: base and strides in elements (batch, head, row).
template <typename X>
struct Bhse {
  const X* p;
  long long sb, sh, ss;
  __device__ __forceinline__ const X* at(int b, int h, int i, int e) const {
    return p + b * sb + h * sh + i * ss + e;
  }
  __device__ __forceinline__ X* mut(int b, int h, int i, int e) const {
    return const_cast<X*>(at(b, h, i, e));
  }
};

// A call's tensors and shape: q, k, v, g read in TI; out written
// (forward) or read (backward) in TO, dq, dk, dv written in TO; den in TD.
template <typename TI, typename TO, typename TD = float>
struct Args {
  using Den = TD;
  Bhse<TI> q, k, v, g;
  Bhse<TO> o, dq, dk, dv;
  TD* den;           // (B, H, S) contiguous
  float* scratch;    // S > T: per tile k^T [v|1] (and q^T [dnum|dd]), EP x KA each
  int H, S, E, EP, KA, NT;
  float eps;
  int fold;          // backward: dq, dk times min(q, 1), min(k, 1) of the inputs
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void st1(float* p, float x) { *p = x; }
__device__ __forceinline__ void st1(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
// x as the backward's dnum / dd arithmetic keeps it: rounded to bf16 where
// den is stored in bf16 (JAX's bf16 arithmetic outside _bwd_pallas'
// kernels), else as it is.
template <class A>
__device__ __forceinline__ float dna_round(float x) {
  if constexpr (std::is_same<typename A::Den, bf16>::value) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// -- fragments -----------------------------------------------------------------

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x, y) as three bf16 planes: hi = bf16(v), mid = bf16(v - hi), lo =
// bf16(v - hi - mid); each remainder is exact in f32.
__device__ __forceinline__ void split2(float x, float y, uint32_t& h, uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 bh = __floats2bfloat162_rn(x, y);
  const float2 fh = __bfloat1622float2(bh);
  x -= fh.x;
  y -= fh.y;
  const __nv_bfloat162 bm = __floats2bfloat162_rn(x, y);
  const float2 fm = __bfloat1622float2(bm);
  h = bits(bh);
  m = bits(bm);
  l = bits(__floats2bfloat162_rn(x - fm.x, y - fm.y));
}
__device__ __forceinline__ void split_a(uint32_t (&a)[3][4], int r, float x, float y) {
  split2(x, y, a[0][r], a[1][r], a[2][r]);
}
__device__ __forceinline__ void split_b(uint32_t (&b)[3][2], int r, float x, float y) {
  split2(x, y, b[0][r], b[1][r], b[2][r]);
}
__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A (16 x 16) = X[m][k0 + k], X row-major (ld floats a row) at row 0.
__device__ __forceinline__ void frag_a_rows(uint32_t (&a)[3][4], const float* X, int ld, int k0) {
  const int g = lane_g(), c = k0 + 2 * lane_t();
  const float2 v0 = *reinterpret_cast<const float2*>(X + g * ld + c);
  const float2 v1 = *reinterpret_cast<const float2*>(X + (g + 8) * ld + c);
  const float2 v2 = *reinterpret_cast<const float2*>(X + g * ld + c + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(X + (g + 8) * ld + c + 8);
  split_a(a, 0, v0.x, v0.y);
  split_a(a, 1, v1.x, v1.y);
  split_a(a, 2, v2.x, v2.y);
  split_a(a, 3, v3.x, v3.y);
}
// A (16 x 16) = X[k0 + k][m], X stored k-major, at column m0.
__device__ __forceinline__ void frag_a_cols(uint32_t (&a)[3][4], const float* X, int ld, int k0) {
  const int g = lane_g();
  const float* r0 = X + (k0 + 2 * lane_t()) * ld;
  const float* r8 = r0 + 8 * ld;
  split_a(a, 0, r0[g], r0[ld + g]);
  split_a(a, 1, r0[g + 8], r0[ld + g + 8]);
  split_a(a, 2, r8[g], r8[ld + g]);
  split_a(a, 3, r8[g + 8], r8[ld + g + 8]);
}
// A (16 x 16) from a product's two 16 x 8 accumulator tiles (its n is this k).
__device__ __forceinline__ void frag_a_acc(uint32_t (&a)[3][4], const float* c0,
                                           const float* c1) {
  split_a(a, 0, c0[0], c0[1]);
  split_a(a, 1, c0[2], c0[3]);
  split_a(a, 2, c1[0], c1[1]);
  split_a(a, 3, c1[2], c1[3]);
}
// B (16 x 8) = X[n][k0 + k], X stored n-major, at row n0.
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[3][2], const float* X, int ld, int k0) {
  const float* r = X + lane_g() * ld + k0 + 2 * lane_t();
  const float2 v0 = *reinterpret_cast<const float2*>(r);
  const float2 v1 = *reinterpret_cast<const float2*>(r + 8);
  split_b(b, 0, v0.x, v0.y);
  split_b(b, 1, v1.x, v1.y);
}
// B (16 x 8) = X[k0 + k][n], X stored k-major, at column n0.
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[3][2], const float* X, int ld, int k0) {
  const float* r = X + (k0 + 2 * lane_t()) * ld + lane_g();
  split_b(b, 0, r[0], r[ld]);
  split_b(b, 1, r[8 * ld], r[9 * ld]);
}
// acc (16 x 8) += a b at f32 grade: the six plane products, summed afresh.
__device__ __forceinline__ void mma6(float* acc, const uint32_t (&a)[3][4],
                                     const uint32_t (&b)[3][2]) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(c, a[2], b[0]);
  mma_bf16(c, a[0], b[2]);
  mma_bf16(c, a[1], b[1]);
  mma_bf16(c, a[1], b[0]);
  mma_bf16(c, a[0], b[1]);
  mma_bf16(c, a[0], b[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += c[i];
}
template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = 0.f;
}
// Keep an accumulator tile's (row, col) where keep(row, col); rows and
// columns are the tile's own (row = g or g + 8, col = n * 8 + 2t (+1)).
template <int N, class Keep>
__device__ __forceinline__ void mask(float (&c)[N][4], int nn, Keep keep) {
  const int g = lane_g(), t2 = 2 * lane_t();
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < nn)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (!keep(g + (i >> 1) * 8, n * 8 + t2 + (i & 1))) c[n][i] = 0.f;
}
// -- loads ---------------------------------------------------------------------

// Rows [row0, row0 + n) of t into X (ld floats a row), `width` columns;
// rows >= S and columns >= E are zeros.  f32: by cp.async; bf16: loaded
// four at a time (a batch of loads in flight) and converted as stored.
template <class A>
__device__ __forceinline__ void load_rows(float* X, int ld, const Bhse<float>& t, int b, int h,
                                          int row0, int n, int width, const A& a) {
  const int c4 = width / 4;
  for (int idx = threadIdx.x; idx < n * c4; idx += blockDim.x) {
    const int r = idx / c4, c = (idx % c4) * 4, i = row0 + r;
    const bool ok = i < a.S && c < a.E;
    cp_async16(X + r * ld + c, ok ? t.at(b, h, i, c) : t.p, ok);
  }
}
template <class A>
__device__ __forceinline__ void load_rows(float* X, int ld, const Bhse<bf16>& t, int b, int h,
                                          int row0, int n, int width, const A& a) {
  constexpr int U = 4;
  const int c4 = width / 4, total = n * c4;
  for (int base = threadIdx.x; base < total; base += U * blockDim.x) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * blockDim.x, r = idx / c4, c = (idx % c4) * 4, i = row0 + r;
      v[u] = idx < total && i < a.S && c < a.E ? ld4(t.at(b, h, i, c))
                                                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total)
        *reinterpret_cast<float4*>(X + (idx / c4) * ld + (idx % c4) * 4) = v[u];
    }
  }
}
// Slot t of the scratch: tile t's state increment, k^T [v | 1] (which 0)
// or q^T [dnum | dd] (which 1).
template <class A>
__device__ __forceinline__ float* slot(const A& a, int which, int b, int h, int t) {
  const size_t tile = (size_t)a.EP * a.KA;
  return a.scratch + ((((size_t)which * gridDim.z + b) * a.H + h) * a.NT + t) * tile;
}
// The ones column of [v | 1] for rows [row0, row0 + n) (after the copies landed).
template <class A>
__device__ __forceinline__ void set_ones(float* V, int ld, int row0, int n, const A& a) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) V[r * ld + a.E] = row0 + r < a.S ? 1.f : 0.f;
}
// Of rows [row0, row0 + n) (n a multiple of 16): dd_i = -sum_f g out /
// (den + eps) into dd[] and den + eps into dv[] (0 and 1 past S), from the
// tensors, two threads a row with all their loads in flight at once (runs
// while the copies fly).
template <class A>
__device__ __forceinline__ void form_dd(float* dd, float* dv, int b, int h, int row0, int n,
                                        const A& a) {
  for (int idx = threadIdx.x; idx < 2 * n; idx += blockDim.x) {
    const int r = idx >> 1, part = idx & 1, i = row0 + r;
    float s = 0.f;
    if (i < a.S) {
      const auto* gr = a.g.at(b, h, i, 0);
      const auto* orow = a.o.at(b, h, i, 0);
      float4 x[MAX_E / 8], y[MAX_E / 8];
#pragma unroll
      for (int c = 0; c < MAX_E / 8; ++c)
        if (2 * c + part < a.E / 4) {
          x[c] = ld4(gr + 4 * (2 * c + part));
          y[c] = ld4(orow + 4 * (2 * c + part));
        }
#pragma unroll
      for (int c = 0; c < MAX_E / 8; ++c) {
        if (2 * c + part >= a.E / 4) continue;
        if constexpr (std::is_same<typename A::Den, bf16>::value) {   // each g out rounded
          s += dna_round<A>(x[c].x * y[c].x);
          s += dna_round<A>(x[c].y * y[c].y);
          s += dna_round<A>(x[c].z * y[c].z);
          s += dna_round<A>(x[c].w * y[c].w);
        } else {
          s = fmaf(x[c].w, y[c].w, fmaf(x[c].z, y[c].z, fmaf(x[c].y, y[c].y,
                                                             fmaf(x[c].x, y[c].x, s))));
        }
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (part == 0) {
      const float d =
          i < a.S ? dna_round<A>(to_f(a.den[((size_t)b * a.H + h) * a.S + i]) + a.eps) : 1.f;
      dd[r] = dna_round<A>(-dna_round<A>(s) / d);
      dv[r] = d;
    }
  }
}
// [dnum | dd] in place over the upstream gradient's rows in DN (KA wide;
// after the copies landed): dnum = g / (den + eps), column E = dd.
template <class A>
__device__ __forceinline__ void form_dnum(float* DN, int ld, const float* dd, const float* dv,
                                          int row0, int n, const A& a) {
  const int c = a.E + 1;
  for (int idx = threadIdx.x; idx < n * c; idx += blockDim.x) {
    const int r = idx / c, f = idx % c;
    if (row0 + r >= a.S) continue;          // zeros already
    DN[r * ld + f] = f == a.E ? dd[r] : dna_round<A>(DN[r * ld + f] / dv[r]);
  }
}
__device__ __forceinline__ void count_run(int which) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0)
    atomicAdd(&cp_runs[which], 1ull);
}
// The warp's 16 x (8 nn) accumulator tiles into X (row-major at ld).
template <int N>
__device__ __forceinline__ void put_acc(float* X, int ld, const float (&c)[N][4], int nn) {
  const int g = lane_g(), t2 = 2 * lane_t();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (n >= nn) continue;
    *reinterpret_cast<float2*>(X + g * ld + n * 8 + t2) = make_float2(c[n][0], c[n][1]);
    *reinterpret_cast<float2*>(X + (g + 8) * ld + n * 8 + t2) = make_float2(c[n][2], c[n][3]);
  }
}

// The widths a kernel works at: compile-time for the model's head width
// (EC = 64: EP = 64, KA = 80), from the arguments otherwise (EC = 0).  With
// them known every loop below unrolls without branches, so the tile's
// independent products interleave.
template <int EC>
struct Dims {
  int EP, KA;
  template <class A>
  __device__ __forceinline__ explicit Dims(const A& a)
      : EP(EC ? round16(EC) : a.EP), KA(EC ? round16(EC + 1) : a.KA) {}
};
constexpr int NA_MAX = MAX_E / 8 + 2;      // 8-column tiles of KA, at most

// -- the state pass (S > T) ------------------------------------------------------

// Block (job, head, sequence), 8 warps: the state increment of one tile,
// k^T [v | 1] (which 0) or q^T [dnum | dd] (which 1, backward), into its
// scratch slot; warp w the e rows [16 (w % 4), +16) over half the tile's
// rows, [32 (w / 4), +32), the halves added in shared memory.  Forward:
// jobs = tiles 0 .. NT - 2 of which 0; backward: those, then tiles
// 1 .. NT - 1 of which 1.  Every tile in parallel: the prefix and suffix
// sums are taken by the output pass.
template <int EC, class A>
__global__ void __launch_bounds__(256, 2) cp_state_kernel(A a) {
  extern __shared__ __align__(16) float sm[];
  const Dims<EC> d(a);
  const int which = blockIdx.x / (a.NT - 1), t = blockIdx.x % (a.NT - 1) + which;
  const int h = blockIdx.y, b = blockIdx.z, w = threadIdx.x >> 5, e0 = 16 * (w & 3);
  const int hf = w >> 2, lde = d.EP + PAD, lda = d.KA + PAD, na = d.KA / 8, row0 = t * T;
  float* dd = sm;                     // 64, and den + eps 64 (which 1)
  float* Xs = dd + 2 * T;             // 64 x EP: k or q
  float* Ys = Xs + T * lde;           // 64 x KA: [v | 1] or [dnum | dd]
  float* red = Xs;                    // after the products: 2 x EP x KA
  load_rows(Xs, lde, which ? a.q : a.k, b, h, row0, T, d.EP, a);
  load_rows(Ys, lda, which ? a.g : a.v, b, h, row0, T, d.KA, a);
  cp_async_commit();
  if (which) form_dd(dd, dd + T, b, h, row0, T, a);
  cp_async_wait<0>();
  __syncthreads();
  if (which) {
    form_dnum(Ys, lda, dd, dd + T, row0, T, a);
  } else {
    set_ones(Ys, lda, row0, T, a);
  }
  __syncthreads();
  float acc[NA_MAX][4];
  zero(acc);
  if (e0 < d.EP) {
#pragma unroll
    for (int k0 = 0; k0 < 32; k0 += 16) {
      uint32_t af[3][4];
      frag_a_cols(af, Xs + e0, lde, 32 * hf + k0);
#pragma unroll
      for (int n = 0; n < NA_MAX; ++n) {
        if (n >= na) continue;
        uint32_t bf[3][2];
        frag_b_cols(bf, Ys + n * 8, lda, 32 * hf + k0);
        mma6(acc[n], af, bf);
      }
    }
  }
  __syncthreads();
  if (e0 < d.EP) put_acc(red + (hf * d.EP + e0) * d.KA, d.KA, acc, na);
  __syncthreads();
  float* dst = slot(a, which, b, h, t);
  const int n4 = d.EP * d.KA / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const float4 x = reinterpret_cast<const float4*>(red)[i];
    const float4 y = reinterpret_cast<const float4*>(red + d.EP * d.KA)[i];
    reinterpret_cast<float4*>(dst)[i] = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  }
}

// The sum of the scratch slots [ta, tb) of kind which, in slot order,
// handed to put(e, f, float4) a row e and four columns f of EP x KA at a
// time; every thread keeps its columns' loads of up to 16 slots in flight
// at once (runs while the block's copies fly).
template <class A, class Put>
__device__ __forceinline__ void sum_slots_to(Put put, int which, int b, int h, int ta, int tb,
                                             const A& a) {
  const float* base = slot(a, which, b, h, 0);
  const size_t tile = (size_t)a.EP * a.KA;
  const int c4 = a.KA / 4;
  for (int idx = threadIdx.x; idx < a.EP * c4; idx += blockDim.x) {
    const int e = idx / c4, f = (idx % c4) * 4;
    const float* p = base + e * a.KA + f;
    float4 x[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (ta + j < tb) x[j] = __ldcg(reinterpret_cast<const float4*>(p + (ta + j) * tile));
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (ta + j < tb) {
        s.x += x[j].x;
        s.y += x[j].y;
        s.z += x[j].z;
        s.w += x[j].w;
      }
    for (int t = ta + 16; t < tb; ++t) {
      const float4 y = __ldcg(reinterpret_cast<const float4*>(p + t * tile));
      s.x += y.x;
      s.y += y.y;
      s.z += y.z;
      s.w += y.w;
    }
    put(e, f, s);
  }
}
// The same into X (EP x KA f32 at ld).
template <class A>
__device__ __forceinline__ void sum_slots(float* X, int ld, int which, int b, int h, int ta,
                                          int tb, const A& a) {
  sum_slots_to([&](int e, int f, float4 v) { *reinterpret_cast<float4*>(X + e * ld + f) = v; },
               which, b, h, ta, tb, a);
}

// -- planes in shared memory (the long backward) -----------------------------------
//
// A tile of f32 values kept as its three bf16 planes, split once as the
// block loads it: plane p at P + p * ps, row r at r * ld (ld = width +
// BPAD bf16, an odd number of 16-byte units, so ldmatrix's eight rows of
// a matrix fall in distinct banks).  Fragments are read by ldmatrix (x4:
// an A tile, or the B tiles of two neighbouring n-tiles; .trans where the
// tile is stored k-major), the same bits split2 forms in registers.

constexpr int BPAD = 8;

// v (four values of a row) as three planes at p (plane stride ps).
__device__ __forceinline__ void st_planes4(bf16* p, int ps, float4 v) {
  uint32_t h0, m0, l0, h1, m1, l1;
  split2(v.x, v.y, h0, m0, l0);
  split2(v.z, v.w, h1, m1, l1);
  *reinterpret_cast<uint2*>(p) = make_uint2(h0, h1);
  *reinterpret_cast<uint2*>(p + ps) = make_uint2(m0, m1);
  *reinterpret_cast<uint2*>(p + 2 * ps) = make_uint2(l0, l1);
}
// One value x as three planes at p.
__device__ __forceinline__ void st_planes1(bf16* p, int ps, float x) {
  const bf16 hb = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(hb);
  const bf16 mb = __float2bfloat16_rn(r);
  p[0] = hb;
  p[ps] = mb;
  p[2 * ps] = __float2bfloat16_rn(r - __bfloat162float(mb));
}
// Rows [row0, row0 + T) of t, columns [0, width), as planes at P; rows >=
// S and columns >= E are zeros; each value divided by div[r] where div is
// given (the backward's dnum = g / (den + eps)).  Four loads in flight a
// thread.
template <class A, typename X>
__device__ __forceinline__ void load_planes(bf16* P, int ld, int ps, const Bhse<X>& t, int b,
                                            int h, int row0, int width, const float* div,
                                            const A& a) {
  constexpr int U = 4;
  const int c4 = width / 4, total = T * c4;
  for (int base = threadIdx.x; base < total; base += U * blockDim.x) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * blockDim.x, r = idx / c4, c = (idx % c4) * 4, i = row0 + r;
      v[u] = idx < total && i < a.S && c < a.E ? ld4(t.at(b, h, i, c))
                                                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * blockDim.x, r = idx / c4, c = (idx % c4) * 4;
      if (idx >= total) continue;
      if (div != nullptr) {
        const float q = div[r];
        v[u] = make_float4(dna_round<A>(v[u].x / q), dna_round<A>(v[u].y / q),
                           dna_round<A>(v[u].z / q), dna_round<A>(v[u].w / q));
      }
      st_planes4(P + r * ld + c, ps, v[u]);
    }
  }
}
// A (16 x 16) = X[m][k0 + k] of the planes at row 0.
__device__ __forceinline__ void pfrag_a(uint32_t (&a)[3][4], const bf16* P, int ld, int ps,
                                        int k0) {
  const int l = threadIdx.x & 31;
  const bf16* q = P + (l & 15) * ld + k0 + (l >> 4) * 8;
#pragma unroll
  for (int pl = 0; pl < 3; ++pl) ldmatrix_x4(a[pl], q + pl * ps);
}
// B (16 x 8) of n-tiles n0 and n0 + 8 = X[n][k0 + k], X stored n-major, at row n0.
__device__ __forceinline__ void pfrag_b_rows2(uint32_t (&b0)[3][2], uint32_t (&b1)[3][2],
                                              const bf16* P, int ld, int ps, int k0) {
  const int l = threadIdx.x & 31;
  const bf16* q = P + ((l & 7) + ((l >> 4) << 3)) * ld + k0 + ((l >> 3) & 1) * 8;
#pragma unroll
  for (int pl = 0; pl < 3; ++pl) {
    uint32_t r[4];
    ldmatrix_x4(r, q + pl * ps);
    b0[pl][0] = r[0];
    b0[pl][1] = r[1];
    b1[pl][0] = r[2];
    b1[pl][1] = r[3];
  }
}
// B (16 x 8) of n-tiles n0 and n0 + 8 = X[k0 + k][n], X stored k-major, at column n0.
__device__ __forceinline__ void pfrag_b_cols2(uint32_t (&b0)[3][2], uint32_t (&b1)[3][2],
                                              const bf16* P, int ld, int ps, int k0) {
  const int l = threadIdx.x & 31;
  const bf16* q = P + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + (l >> 4) * 8;
#pragma unroll
  for (int pl = 0; pl < 3; ++pl) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, q + pl * ps);
    b0[pl][0] = r[0];
    b0[pl][1] = r[1];
    b1[pl][0] = r[2];
    b1[pl][1] = r[3];
  }
}

// -- products of a warp ------------------------------------------------------------

// acc (16 x KA) += tril(q k^T) [v | 1] over the NK keys [key0, key0 + NK)
// of rows [R0, R0 + 16) (Qw, Kc, Vc at those rows and keys) when `keys`,
// plus q [S | z] over the depths [p0, p1) of q's columns when Sa is given.
template <int EC, int NK, class A>
__device__ __forceinline__ void fwd_part(float (&acc)[NA_MAX][4], const float* Qw,
                                         const float* Kc, const float* Vc, bool keys,
                                         const float* Sa, int p0, int p1, int R0, int key0,
                                         const A& a) {
  const Dims<EC> d(a);
  const int lde = d.EP + PAD, lda = d.KA + PAD, na = d.KA / 8;
  float s[NK / 8][4];
  zero(s);
#pragma unroll
  for (int k0 = 0; k0 < MAX_E; k0 += 16) {
    if (k0 >= d.EP) continue;
    uint32_t aq[3][4];
    frag_a_rows(aq, Qw, lde, k0);
    if (keys) {
#pragma unroll
      for (int n = 0; n < NK / 8; ++n) {        // scores q k^T
        uint32_t bk[3][2];
        frag_b_rows(bk, Kc + n * 8 * lde, lde, k0);
        mma6(s[n], aq, bk);
      }
    }
    if (Sa != nullptr && k0 >= p0 && k0 < p1) {
#pragma unroll
      for (int n = 0; n < NA_MAX; ++n) {        // q [S | z]
        if (n >= na) continue;
        uint32_t bs[3][2];
        frag_b_cols(bs, Sa + n * 8, lda, k0);
        mma6(acc[n], aq, bs);
      }
    }
  }
  if (!keys) return;
  mask(s, NK / 8, [&](int i, int j) { return key0 + j <= R0 + i; });
#pragma unroll
  for (int ks = 0; ks < NK / 16; ++ks) {        // tril(A) [v | 1]
    uint32_t aa[3][4];
    frag_a_acc(aa, s[2 * ks], s[2 * ks + 1]);
#pragma unroll
    for (int n = 0; n < NA_MAX; ++n) {
      if (n >= na) continue;
      uint32_t bv[3][2];
      frag_b_cols(bv, Vc + n * 8, lda, ks * 16);
      mma6(acc[n], aa, bv);
    }
  }
}

// The backward's products read their operand tiles through a view: FView,
// an f32 tile (row stride ld floats) split into planes fragment by
// fragment in registers (the S <= T pass), or PView, a tile kept as its
// planes (the long pass, read by ldmatrix).  rows(r) / cols(c) offset a
// view; B fragments come in pairs of n-tiles (n0, n0 + 8).  Either view
// gives the same fragments, so the same bits.
struct FView {
  const float* p;
  int ld;
  __device__ __forceinline__ FView rows(int r) const { return FView{p + r * ld, ld}; }
  __device__ __forceinline__ FView cols(int c) const { return FView{p + c, ld}; }
};
struct PView {
  const bf16* p;
  int ld, ps;
  __device__ __forceinline__ PView rows(int r) const { return PView{p + r * ld, ld, ps}; }
  __device__ __forceinline__ PView cols(int c) const { return PView{p + c, ld, ps}; }
};
__device__ __forceinline__ void frag_a(uint32_t (&a)[3][4], FView v, int k0) {
  frag_a_rows(a, v.p, v.ld, k0);
}
__device__ __forceinline__ void frag_a(uint32_t (&a)[3][4], PView v, int k0) {
  pfrag_a(a, v.p, v.ld, v.ps, k0);
}
// B = X[n][k0 + k], X n-major (rows n0, n0 + 8 of the view).
__device__ __forceinline__ void frag_b_rows2(uint32_t (&b0)[3][2], uint32_t (&b1)[3][2],
                                             FView v, int k0) {
  frag_b_rows(b0, v.p, v.ld, k0);
  frag_b_rows(b1, v.p + 8 * v.ld, v.ld, k0);
}
__device__ __forceinline__ void frag_b_rows2(uint32_t (&b0)[3][2], uint32_t (&b1)[3][2],
                                             PView v, int k0) {
  pfrag_b_rows2(b0, b1, v.p, v.ld, v.ps, k0);
}
// B = X[k0 + k][n], X k-major (columns n0, n0 + 8 of the view).
__device__ __forceinline__ void frag_b_cols2(uint32_t (&b0)[3][2], uint32_t (&b1)[3][2],
                                             FView v, int k0) {
  frag_b_cols(b0, v.p, v.ld, k0);
  frag_b_cols(b1, v.p + 8, v.ld, k0);
}
__device__ __forceinline__ void frag_b_cols2(uint32_t (&b0)[3][2], uint32_t (&b1)[3][2],
                                             PView v, int k0) {
  pfrag_b_cols2(b0, b1, v.p, v.ld, v.ps, k0);
}

// dq (16 x EP) += tril([dnum | dd] [v | 1]^T) k over the NK keys [key0,
// key0 + NK) of rows [R0, R0 + 16) when `keys`, plus [dnum | dd] [S | z]^T
// over the depths [p0, p1) of [dnum | dd]'s columns when Sa is given.
template <int EC, int NK, class V, class A>
__device__ __forceinline__ void dq_part(float (&dq)[MAX_E / 8][4], V DNw, V Kc, V Vc,
                                        bool keys, const V* Sa, int p0, int p1, int R0,
                                        int key0, const A& a) {
  const Dims<EC> d(a);
  const int ne = d.EP / 8;
  float m[NK / 8][4];
  zero(m);
#pragma unroll
  for (int k0 = 0; k0 < MAX_E + 16; k0 += 16) {
    if (k0 >= d.KA) continue;
    uint32_t ad[3][4];
    frag_a(ad, DNw, k0);
    if (keys) {
#pragma unroll
      for (int n = 0; n < NK / 8; n += 2) {
        uint32_t b0[3][2], b1[3][2];
        frag_b_rows2(b0, b1, Vc.rows(n * 8), k0);
        mma6(m[n], ad, b0);
        mma6(m[n + 1], ad, b1);
      }
    }
    if (Sa != nullptr && k0 >= p0 && k0 < p1) {
#pragma unroll
      for (int n = 0; n < MAX_E / 8; n += 2) {
        if (n >= ne) continue;
        uint32_t b0[3][2], b1[3][2];
        frag_b_rows2(b0, b1, Sa->rows(n * 8), k0);
        mma6(dq[n], ad, b0);
        mma6(dq[n + 1], ad, b1);
      }
    }
  }
  if (!keys) return;
  mask(m, NK / 8, [&](int i, int j) { return key0 + j <= R0 + i; });
#pragma unroll
  for (int ks = 0; ks < NK / 16; ++ks) {
    uint32_t am[3][4];
    frag_a_acc(am, m[2 * ks], m[2 * ks + 1]);
#pragma unroll
    for (int n = 0; n < MAX_E / 8; n += 2) {
      if (n >= ne) continue;
      uint32_t b0[3][2], b1[3][2];
      frag_b_cols2(b0, b1, Kc.cols(n * 8), ks * 16);
      mma6(dq[n], am, b0);
      mma6(dq[n + 1], am, b1);
    }
  }
}

// Keys [J0, J0 + 16) (Kw, Vw) against the NQ queries [q0, q0 + NQ) (Qc,
// DNc) when `queries`: dk (16 x EP) += triu([v | 1] [dnum | dd]^T) q, plus
// [v | 1] [G | gz]^T over the depths [p0, p1) of [v | 1]'s columns when G
// is given.
template <int EC, int NQ, class V, class A>
__device__ __forceinline__ void dk_part(float (&dk)[MAX_E / 8][4], V Vw, V Qc, V DNc,
                                        bool queries, const V* G, int p0, int p1, int J0, int q0,
                                        const A& a) {
  const Dims<EC> d(a);
  const int ne = d.EP / 8;
  float p[NQ / 8][4];
  zero(p);
#pragma unroll
  for (int k0 = 0; k0 < MAX_E + 16; k0 += 16) {
    if (k0 >= d.KA) continue;
    uint32_t av[3][4];
    frag_a(av, Vw, k0);
    if (queries) {
#pragma unroll
      for (int n = 0; n < NQ / 8; n += 2) {
        uint32_t b0[3][2], b1[3][2];
        frag_b_rows2(b0, b1, DNc.rows(n * 8), k0);
        mma6(p[n], av, b0);
        mma6(p[n + 1], av, b1);
      }
    }
    if (G != nullptr && k0 >= p0 && k0 < p1) {
#pragma unroll
      for (int n = 0; n < MAX_E / 8; n += 2) {
        if (n >= ne) continue;
        uint32_t b0[3][2], b1[3][2];
        frag_b_rows2(b0, b1, G->rows(n * 8), k0);
        mma6(dk[n], av, b0);
        mma6(dk[n + 1], av, b1);
      }
    }
  }
  if (!queries) return;
  mask(p, NQ / 8, [&](int j, int i) { return q0 + i >= J0 + j; });
#pragma unroll
  for (int ks = 0; ks < NQ / 16; ++ks) {
    uint32_t ap[3][4];
    frag_a_acc(ap, p[2 * ks], p[2 * ks + 1]);
#pragma unroll
    for (int n = 0; n < MAX_E / 8; n += 2) {
      if (n >= ne) continue;
      uint32_t b0[3][2], b1[3][2];
      frag_b_cols2(b0, b1, Qc.cols(n * 8), ks * 16);
      mma6(dk[n], ap, b0);
      mma6(dk[n + 1], ap, b1);
    }
  }
}

// The same keys and queries: dv (16 x EP) += triu(k q^T) dnum, plus k G
// over the depths [p0, p1) of k's columns when G is given.
template <int EC, int NQ, class V, class A>
__device__ __forceinline__ void dv_part(float (&dv)[MAX_E / 8][4], V Kw, V Qc, V DNc,
                                        bool queries, const V* G, int p0, int p1, int J0, int q0,
                                        const A& a) {
  const Dims<EC> d(a);
  const int ne = d.EP / 8;
  float p[NQ / 8][4];
  zero(p);
#pragma unroll
  for (int k0 = 0; k0 < MAX_E; k0 += 16) {
    if (k0 >= d.EP) continue;
    uint32_t ak[3][4];
    frag_a(ak, Kw, k0);
    if (queries) {
#pragma unroll
      for (int n = 0; n < NQ / 8; n += 2) {
        uint32_t b0[3][2], b1[3][2];
        frag_b_rows2(b0, b1, Qc.rows(n * 8), k0);
        mma6(p[n], ak, b0);
        mma6(p[n + 1], ak, b1);
      }
    }
    if (G != nullptr && k0 >= p0 && k0 < p1) {
#pragma unroll
      for (int n = 0; n < MAX_E / 8; n += 2) {
        if (n >= ne) continue;
        uint32_t b0[3][2], b1[3][2];
        frag_b_cols2(b0, b1, G->cols(n * 8), k0);
        mma6(dv[n], ak, b0);
        mma6(dv[n + 1], ak, b1);
      }
    }
  }
  if (!queries) return;
  mask(p, NQ / 8, [&](int j, int i) { return q0 + i >= J0 + j; });
#pragma unroll
  for (int ks = 0; ks < NQ / 16; ++ks) {
    uint32_t ap[3][4];
    frag_a_acc(ap, p[2 * ks], p[2 * ks + 1]);
#pragma unroll
    for (int n = 0; n < MAX_E / 8; n += 2) {
      if (n >= ne) continue;
      uint32_t b0[3][2], b1[3][2];
      frag_b_cols2(b0, b1, DNc.cols(n * 8), ks * 16);
      mma6(dv[n], ap, b0);
      mma6(dv[n + 1], ap, b1);
    }
  }
}

// Rows [0, 16 nr) x columns f < E of the warps' partials red[w0 .. w1)
// (each 16 nr x ld), added in order, to rows [row0, row0 + 16 nr) of t,
// each value times min(phi, 1) of the same element of phi when phi is
// given (kernel C's fold of phi' into d phi(q), d phi(k)).
template <typename TO, typename TI, class A>
__device__ __forceinline__ void reduce_rows(const float* red, int ld, int w0, int w1, int nr,
                                            const Bhse<TO>& t, const Bhse<TI>* phi, int b,
                                            int h, int row0, const A& a) {
  const int half = a.E / 2, rows = 16 * nr;
  for (int idx = threadIdx.x; idx < rows * half; idx += blockDim.x) {
    const int i = idx / half, f = 2 * (idx % half);
    if (row0 + i >= a.S) continue;
    float x = 0.f, y = 0.f;
    for (int ww = w0; ww < w1; ++ww) {
      x += red[(ww * rows + i) * ld + f];
      y += red[(ww * rows + i) * ld + f + 1];
    }
    if (phi != nullptr) {
      const float2 p = ld2(phi->at(b, h, row0 + i, f));
      x *= fminf(p.x, 1.f);
      y *= fminf(p.y, 1.f);
    }
    st2(t.mut(b, h, row0 + i, f), x, y);
  }
}
// The same for the forward's [num | den] partials (KA columns at ld):
// out = num / (den + eps) and den.
template <class A>
__device__ __forceinline__ void reduce_out(const float* red, int ld, int w0, int w1, int nr,
                                           int b, int h, int row0, const A& a) {
  const int half = a.E / 2, rows = 16 * nr;
  auto* dn = a.den + ((size_t)b * a.H + h) * a.S;
  for (int idx = threadIdx.x; idx < rows * half; idx += blockDim.x) {
    const int i = idx / half, f = 2 * (idx % half);
    if (row0 + i >= a.S) continue;
    float x = 0.f, y = 0.f, ds = 0.f;
    for (int ww = w0; ww < w1; ++ww) {
      const float* row = red + (ww * rows + i) * ld;
      x += row[f];
      y += row[f + 1];
      ds += row[a.E];
    }
    const float inv = 1.f / (ds + a.eps);
    st2(a.o.mut(b, h, row0 + i, f), x * inv, y * inv);
    if (f == 0) st1(dn + row0 + i, ds);
  }
}

// -- the forward -----------------------------------------------------------------

// S <= T: block (16-row group r, head, sequence), 4 warps; warp w takes the
// keys [16 w, 16 w + 16) (w <= r), its partial sums meet in shared memory
// and are added in warp order.
template <int EC, class A>
__global__ void __launch_bounds__(128) cp_fwd_short_kernel(A a) {
  extern __shared__ __align__(16) float sm[];
  const Dims<EC> d(a);
  const int h = blockIdx.y, b = blockIdx.z, r = blockIdx.x, r0 = 16 * r, w = threadIdx.x >> 5;
  const int lde = d.EP + PAD, lda = d.KA + PAD, nkeys = r0 + 16;
  float* Q = sm;                   // 16 x EP
  float* K = Q + 16 * lde;         // keys [0, r0 + 16) x EP
  float* V = K + T * lde;          // x KA
  float* red = sm;                 // after the products: 4 x 16 x KA partial [num | den]
  load_rows(Q, lde, a.q, b, h, r0, 16, d.EP, a);
  load_rows(K, lde, a.k, b, h, 0, nkeys, d.EP, a);
  load_rows(V, lda, a.v, b, h, 0, nkeys, d.KA, a);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  set_ones(V, lda, 0, nkeys, a);
  __syncthreads();
  float acc[NA_MAX][4];
  zero(acc);
  if (w <= r)
    fwd_part<EC, 16>(acc, Q, K + 16 * w * lde, V + 16 * w * lda, true, nullptr, 0, 0, r0,
                     16 * w, a);
  __syncthreads();
  put_acc(red + w * 16 * lda, lda, acc, d.KA / 8);
  __syncthreads();
  reduce_out(red, lda, 0, r + 1, 1, b, h, r0, a);
  count_run(0);
}

// S > T: block (tile, head, sequence), 8 warps: warp w the rows [16 (w % 4),
// +16) of the tile against half the tile's keys, [32 (w / 4), +32) (masked
// past the rows; none past them: skipped), and half the depths of the
// prefix product with [S | z]; the two halves' sums meet in shared memory.
template <int EC, class A>
__global__ void __launch_bounds__(256, 2) cp_fwd_long_kernel(A a) {
  extern __shared__ __align__(16) float sm[];
  const Dims<EC> d(a);
  const int h = blockIdx.y, b = blockIdx.z, tile = blockIdx.x, t0 = tile * T;
  const int w = threadIdx.x >> 5, rg = w & 3, hf = w >> 2;
  const int lde = d.EP + PAD, lda = d.KA + PAD;
  float* Q = sm;                   // 64 x EP
  float* K = Q + T * lde;          // 64 x EP
  float* V = K + T * lde;          // 64 x KA
  float* Sa = V + T * lda;         // EP x KA: [S | z] of the tiles before
  float* red = sm;                 // after the products: 2 x 64 x KA
  load_rows(Q, lde, a.q, b, h, t0, T, d.EP, a);
  load_rows(K, lde, a.k, b, h, t0, T, d.EP, a);
  load_rows(V, lda, a.v, b, h, t0, T, d.KA, a);
  cp_async_commit();
  if (tile > 0) sum_slots(Sa, lda, 0, b, h, 0, tile, a);
  cp_async_wait<0>();
  __syncthreads();
  set_ones(V, lda, t0, T, a);
  __syncthreads();
  const int R0 = t0 + 16 * rg, key0 = t0 + 32 * hf, pm = d.EP / 32 * 16;
  float acc[NA_MAX][4];
  zero(acc);
  fwd_part<EC, 32>(acc, Q + 16 * rg * lde, K + 32 * hf * lde, V + 32 * hf * lda, key0 <= R0 + 15,
                   tile > 0 ? Sa : nullptr, hf ? pm : 0, hf ? d.EP : pm, R0, key0, a);
  __syncthreads();
  put_acc(red + (hf * T + 16 * rg) * lda, lda, acc, d.KA / 8);
  __syncthreads();
  reduce_out(red, lda, 0, 2, 4, b, h, t0, a);
  count_run(0);
}

// -- the backward ----------------------------------------------------------------

// S <= T: block (2 r + role, head, sequence), 4 warps.  Role 0: d phi(q)
// of rows [16 r, 16 r + 16), warp w the keys [16 w, 16 w + 16) (w <= r);
// role 1: d phi(k), dv of keys [16 r, 16 r + 16), warp w the queries
// [16 w, 16 w + 16) (w >= r); partials added in warp order.
template <int EC, class A>
__global__ void __launch_bounds__(128) cp_bwd_short_kernel(A a) {
  extern __shared__ __align__(16) float sm[];
  const Dims<EC> d(a);
  const int role = blockIdx.x & 1, r = blockIdx.x >> 1, r0 = 16 * r;
  const int h = blockIdx.y, b = blockIdx.z, w = threadIdx.x >> 5;
  const int lde = d.EP + PAD, lda = d.KA + PAD, nw = (a.S + 15) / 16, ne = d.EP / 8;
  float d0[MAX_E / 8][4], d1[MAX_E / 8][4];
  zero(d0);
  zero(d1);
  if (role == 0) {
    const int nkeys = r0 + 16;
    float* dd = sm;                  // 16, and den + eps 16
    float* DN = dd + 32;             // 16 x KA
    float* K = DN + 16 * lda;        // keys [0, r0 + 16) x EP
    float* V = K + T * lde;          // x KA
    float* red = DN;                 // after the products: 4 x 16 x EP
    load_rows(DN, lda, a.g, b, h, r0, 16, d.KA, a);
    load_rows(K, lde, a.k, b, h, 0, nkeys, d.EP, a);
    load_rows(V, lda, a.v, b, h, 0, nkeys, d.KA, a);
    cp_async_commit();
    form_dd(dd, dd + 16, b, h, r0, 16, a);
    cp_async_wait<0>();
    __syncthreads();
    set_ones(V, lda, 0, nkeys, a);
    form_dnum(DN, lda, dd, dd + 16, r0, 16, a);
    __syncthreads();
    if (w <= r)
      dq_part<EC, 16>(d0, FView{DN, lda}, FView{K, lde}.rows(16 * w),
                      FView{V, lda}.rows(16 * w), true, (const FView*)nullptr, 0, 0, r0, 16 * w,
                      a);
    __syncthreads();
    put_acc(red + w * 16 * lde, lde, d0, ne);
    __syncthreads();
    reduce_rows(red, lde, 0, r + 1, 1, a.dq, a.fold ? &a.q : nullptr, b, h, r0, a);
  } else {
    const int nq = T - r0;
    float* dd = sm;                  // 64, and den + eps 64
    float* K = dd + 2 * T;           // keys [r0, r0 + 16) x EP
    float* V = K + 16 * lde;         // x KA
    float* Q = V + 16 * lda;         // queries [r0, T) x EP
    float* DN = Q + T * lde;         // x KA
    float* red = K;                  // after the products: 2 x 4 x 16 x EP
    load_rows(K, lde, a.k, b, h, r0, 16, d.EP, a);
    load_rows(V, lda, a.v, b, h, r0, 16, d.KA, a);
    load_rows(Q, lde, a.q, b, h, r0, nq, d.EP, a);
    load_rows(DN, lda, a.g, b, h, r0, nq, d.KA, a);
    cp_async_commit();
    form_dd(dd, dd + T, b, h, r0, nq, a);
    cp_async_wait<0>();
    __syncthreads();
    set_ones(V, lda, r0, 16, a);
    form_dnum(DN, lda, dd, dd + T, r0, nq, a);
    __syncthreads();
    const bool on = w >= r && w < nw;
    const FView Qc = FView{Q, lde}.rows(16 * w - r0), DNc = FView{DN, lda}.rows(16 * w - r0);
    if (on) {
      dk_part<EC, 16>(d0, FView{V, lda}, Qc, DNc, true, (const FView*)nullptr, 0, 0, r0, 16 * w,
                      a);
      dv_part<EC, 16>(d1, FView{K, lde}, Qc, DNc, true, (const FView*)nullptr, 0, 0, r0, 16 * w,
                      a);
    }
    __syncthreads();
    put_acc(red + w * 16 * lde, lde, d0, ne);
    put_acc(red + (4 + w) * 16 * lde, lde, d1, ne);
    __syncthreads();
    reduce_rows(red, lde, r, nw, 1, a.dk, a.fold ? &a.k : nullptr, b, h, r0, a);
    reduce_rows(red + 4 * 16 * lde, lde, r, nw, 1, a.dv, decltype(&a.k)(nullptr), b, h, r0,
                a);
  }
  count_run(1);
}

// S > T: block (2 tile + role, head, sequence), 8 warps, warp w the rows
// [16 (w % 4), +16) of the tile and half, [32 (w / 4), +32), of the
// other side's rows (skipped where the mask keeps none) and of the depths
// of the state product; the halves' sums meet in shared memory.  Role 0:
// d phi(q) from the tile's keys and the prefix (S, z); role 1: d phi(k),
// dv from the tile's queries and the suffix (G, gz).  Every operand tile
// is split into its planes once, as it is loaded (153 KB at E = 64: one
// block an SM), and read by ldmatrix.
template <int EC, class A>
__global__ void __launch_bounds__(256, 1) cp_bwd_long_kernel(A a) {
  extern __shared__ __align__(16) float sm[];
  const Dims<EC> d(a);
  const int role = blockIdx.x & 1, tile = blockIdx.x >> 1, t0 = tile * T;
  const int h = blockIdx.y, b = blockIdx.z, w = threadIdx.x >> 5, rg = w & 3, hf = w >> 2;
  const int lde = d.EP + PAD, R0 = t0 + 16 * rg, c0 = t0 + 32 * hf;
  const int se = d.EP + BPAD, sa = d.KA + BPAD, pe = T * se, pa = T * sa, ps = d.EP * sa;
  float* dd = sm;                              // 64, and den + eps 64
  bf16* DN = reinterpret_cast<bf16*>(dd + 2 * T);   // planes: 64 x KA
  bf16* K = DN + 3 * pa;                       // 64 x EP
  bf16* V = K + 3 * pe;                        // 64 x KA
  bf16* Q = V + 3 * pa;                        // 64 x EP (role 1)
  bf16* Sa = Q + 3 * pe;                       // EP x KA: [S | z] before, or [G | gz] after
  float* red = dd + 2 * T;                     // after the products: 2 x 2 x 64 x EP f32
  const bool more = role == 0 ? tile > 0 : tile < a.NT - 1;
  form_dd(dd, dd + T, b, h, t0, T, a);
  load_planes(K, se, pe, a.k, b, h, t0, d.EP, nullptr, a);
  load_planes(V, sa, pa, a.v, b, h, t0, d.KA, nullptr, a);
  if (role == 1) load_planes(Q, se, pe, a.q, b, h, t0, d.EP, nullptr, a);
  if (more) {
    const auto put = [&](int e, int f, float4 v) { st_planes4(Sa + e * sa + f, ps, v); };
    if (role == 0) {
      sum_slots_to(put, 0, b, h, 0, tile, a);
    } else {
      sum_slots_to(put, 1, b, h, tile + 1, a.NT, a);
    }
  }
  __syncthreads();
  load_planes(DN, sa, pa, a.g, b, h, t0, d.KA, dd + T, a);   // dnum = g / (den + eps)
  __syncthreads();                                             // its zeros past E written
  for (int r = threadIdx.x; r < T; r += blockDim.x) {          // the ones and dd columns
    const bool ok = t0 + r < a.S;
    st_planes1(V + r * sa + a.E, pa, ok ? 1.f : 0.f);
    st_planes1(DN + r * sa + a.E, pa, ok ? dd[r] : 0.f);
  }
  __syncthreads();
  const int ne = d.EP / 8, pka = d.KA / 32 * 16 + (d.KA % 32), pke = d.EP / 32 * 16;
  const PView vDN{DN, sa, pa}, vK{K, se, pe}, vV{V, sa, pa}, vQ{Q, se, pe}, vS{Sa, sa, ps};
  float d0[MAX_E / 8][4], d1[MAX_E / 8][4];
  zero(d0);
  zero(d1);
  if (role == 0) {
    dq_part<EC, 32>(d0, vDN.rows(16 * rg), vK.rows(32 * hf), vV.rows(32 * hf), c0 <= R0 + 15,
                    more ? &vS : nullptr, hf ? pka : 0, hf ? d.KA : pka, R0, c0, a);
  } else {
    const bool on = c0 + 31 >= R0;
    dk_part<EC, 32>(d0, vV.rows(16 * rg), vQ.rows(32 * hf), vDN.rows(32 * hf), on,
                    more ? &vS : nullptr, hf ? pka : 0, hf ? d.KA : pka, R0, c0, a);
    dv_part<EC, 32>(d1, vK.rows(16 * rg), vQ.rows(32 * hf), vDN.rows(32 * hf), on,
                    more ? &vS : nullptr, hf ? pke : 0, hf ? d.EP : pke, R0, c0, a);
  }
  __syncthreads();
  put_acc(red + (hf * T + 16 * rg) * lde, lde, d0, ne);
  if (role == 1) put_acc(red + ((2 + hf) * T + 16 * rg) * lde, lde, d1, ne);
  __syncthreads();
  if (role == 0) {
    reduce_rows(red, lde, 0, 2, 4, a.dq, a.fold ? &a.q : nullptr, b, h, t0, a);
  } else {
    reduce_rows(red, lde, 0, 2, 4, a.dk, a.fold ? &a.k : nullptr, b, h, t0, a);
    reduce_rows(red + 2 * T * lde, lde, 0, 2, 4, a.dv, decltype(&a.k)(nullptr), b, h, t0, a);
  }
  count_run(1);
}

// -- launches ----------------------------------------------------------------------

// Shared memory of each kernel (the partial sums reuse the operands' space
// once the products are done).
inline size_t fwd_smem(bool lng, int EP, int KA) {
  const size_t lde = EP + PAD, lda = KA + PAD;
  const size_t ops = lng ? 2 * T * lde + T * lda + EP * lda : 16 * lde + T * lde + T * lda;
  return sizeof(float) * std::max(ops, (lng ? 2 * T : 4 * 16) * lda);
}
inline size_t bwd_smem(bool lng, int EP, int KA) {
  const size_t lde = EP + PAD, lda = KA + PAD;
  if (lng)       // the planes of DN, K, V, Q, [S | z], or the partial sums
    return sizeof(float) * 2 * T +
           std::max(sizeof(bf16) * 3 * (2 * T * (KA + BPAD) + 2 * T * (EP + BPAD) +
                                        EP * (KA + BPAD)),
                    sizeof(float) * 4 * T * lde);
  const size_t dq = 32 + std::max(16 * lda + T * lde + T * lda, 4 * 16 * lde);
  const size_t dkv = 2 * T + std::max(16 * (lde + lda) + T * (lde + lda), 8 * 16 * lde);
  return sizeof(float) * std::max(dq, dkv);
}
inline size_t state_smem(int EP, int KA) {
  return sizeof(float) * (2 * T + std::max((size_t)T * (EP + PAD + KA + PAD),
                                           2 * (size_t)EP * KA));
}

// Launch with `smem` bytes of dynamic shared memory, raising the kernel's
// limit once a device and size (the attribute call costs a round trip to
// the CUDA runtime; a small table remembers what was set).
template <class K, class A>
inline int launch(K kernel, dim3 grid, int threads, size_t smem, const A& a, cudaStream_t st) {
  struct Set {
    const void* fn;
    int dev, bytes;
  };
  static Set done[64];
  static int n_done = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  bool known = false;
  for (int i = 0; i < n_done && !known; ++i)
    known = done[i].fn == (const void*)kernel && done[i].dev == dev && done[i].bytes >= (int)smem;
  if (!known) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (n_done < 64) done[n_done++] = Set{(const void*)kernel, dev, (int)smem};
  }
  kernel<<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The shape fields of a call's Args (the tensors are the caller's).
template <class A>
inline A make_args(int H, int S, int E, float eps, float* scratch) {
  A a{};
  a.H = H;
  a.S = S;
  a.E = E;
  a.EP = round16(E);
  a.KA = round16(E + 1);
  a.NT = (S + T - 1) / T;
  a.eps = eps;
  a.scratch = scratch;
  return a;
}

// A forward call: one launch at S <= T, else the state pass and the
// output pass.
template <int EC, class A>
inline int forward(const A& a, int B, cudaStream_t st) {
  if (a.NT == 1)
    return launch(cp_fwd_short_kernel<EC, A>, dim3((a.S + 15) / 16, a.H, B), 128,
                  fwd_smem(false, a.EP, a.KA), a, st);
  const int rc = launch(cp_state_kernel<EC, A>, dim3(a.NT - 1, a.H, B), 256,
                        state_smem(a.EP, a.KA), a, st);
  if (rc) return rc;
  return launch(cp_fwd_long_kernel<EC, A>, dim3(a.NT, a.H, B), 256,
                fwd_smem(true, a.EP, a.KA), a, st);
}

template <int EC, class A>
inline int backward(const A& a, int B, cudaStream_t st) {
  if (a.NT == 1)
    return launch(cp_bwd_short_kernel<EC, A>, dim3(2 * ((a.S + 15) / 16), a.H, B), 128,
                  bwd_smem(false, a.EP, a.KA), a, st);
  const int rc = launch(cp_state_kernel<EC, A>, dim3(2 * (a.NT - 1), a.H, B), 256,
                        state_smem(a.EP, a.KA), a, st);
  if (rc) return rc;
  return launch(cp_bwd_long_kernel<EC, A>, dim3(2 * a.NT, a.H, B), 256,
                bwd_smem(true, a.EP, a.KA), a, st);
}

// A call at the model's head width (64) or any other.
template <class A>
inline int forward_any(const A& a, int B, cudaStream_t st) {
  return a.E == 64 ? forward<64>(a, B, st) : forward<0>(a, B, st);
}
template <class A>
inline int backward_any(const A& a, int B, cudaStream_t st) {
  return a.E == 64 ? backward<64>(a, B, st) : backward<0>(a, B, st);
}

// f32 scratch floats of a call (0 at S <= T): the prefix (and, backward,
// suffix) state of each tile.
inline long long scratch_floats(int B, int H, int S, int E, int backward) {
  const int nt = (S + T - 1) / T;
  if (nt <= 1) return 0;
  return (backward ? 2LL : 1LL) * B * H * nt * round16(E) * round16(E + 1);
}

// The runs counter of this library: runs[0] forward, runs[1] backward,
// zeroed after the read with reset.  Waits for the card.
inline int read_runs(long long* runs, int reset) {
  unsigned long long n[2] = {0, 0};
  cudaError_t e = cudaMemcpyFromSymbol(n, cp_runs, sizeof n);
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[2] = {0, 0};
    e = cudaMemcpyToSymbol(cp_runs, zero, sizeof zero);
  }
  runs[0] = (long long)n[0];
  runs[1] = (long long)n[1];
  return (int)e;
}

inline bool shape_ok(int B, int H, int S, int E) {
  return B > 0 && B <= 65535 && H > 0 && H <= 65535 && S > 0 && E > 0 && E % 4 == 0 &&
         E <= MAX_E;
}

}  // namespace cpk
}  // namespace rlmg
