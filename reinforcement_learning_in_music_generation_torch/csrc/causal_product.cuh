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
// gradients written in TO.  f32 tiles are copied by cp.async and split
// into three bf16 planes; bf16 tiles are copied by cp.async straight into
// one bf16 plane (a bf16 value is its own hi plane: nothing is widened or
// split).  F: <float, float> and <bf16, bf16, bf16>.  C: forward <float, T> on the
// projection's unrounded f32 values (att rounded to h's type T on store),
// backward <T, T> on the stored residual, with fold set: d phi(q) and
// d phi(k) leave the pass that writes them times phi' = min(phi, 1) of
// the stored phi, as JAX's _qab_bwd folds them.  The third parameter TD
// is den's type: F's bf16 instantiation stores den rounded to bf16, as
// _fwd_pallas returns it, and then forms the backward's dnum = g / (den +
// eps) and dd = -sum(g out) / (den + eps) in bf16 arithmetic, as
// _bwd_pallas forms them outside its kernels (each product g out rounded,
// the sum taken in f32 and rounded, den + eps and each quotient rounded),
// so [dnum | dd] holds bf16 values too; with an f32 den (F's f32
// instantiation, C) they are f32.
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
//    over the bf16 planes of each operand.  An f32 operand (the score
//    tiles A, m, p, P, the state slots S / z / G / gz, an f32 tile, C's
//    f32 dnum) is three planes (x = hi + mid + lo); a bf16 one (a tile of
//    a bf16 tensor, F's bf16 [dnum | dd], the ones column) is one (Tiles,
//    compiled from Args).  mma_pl issues the products of mma6 (the six
//    whose terms reach 2^-16 of a product) that pair two planes both
//    operands hold, in mma6's order: six where neither is bf16, three
//    where one is, one where both are; each depth of 16 summed afresh
//    and added to the running sum in f32 (train_gemm_tc.cuh's arithmetic
//    for kernels D and G).  A dropped product's terms are exact zeros, so
//    a bf16 call's bits are the f32 route's on the widened tensors, and
//    its f32 instantiations compile to what they were.  The long backward
//    (S > T) keeps each operand tile as its planes in shared memory and
//    reads fragments by ldmatrix (f32: split once as the block loads it,
//    153 KB at E = 64, one block an SM; bf16: 75 KB with one plane a
//    tile, two blocks an SM); the other passes split f32 tiles in
//    registers, fragment by fragment, and read bf16 planes by ldmatrix.
//    The score tile never leaves registers: its accumulator is the next
//    product's A operand.  The kernels are compiled for the model's head
//    width (E = 64: every loop unrolls without branches, so a tile's
//    independent products interleave) and for any other width.
//  * bf16 tiles go by 16-byte cp.async where every base and stride is a
//    multiple of 8 elements, else by 8-byte ones (the wrappers take
//    strides that are multiples of 4): chosen at launch (Args::cp16).
//  * The last launch of a call counts the call's run on the card
//    (cp_runs, one counter a library), so graph replays are counted by the
//    kernel.
//  What holds it back (PERF.md): the long backward waits for its loads,
//  the passes on f32 tiles split planes in registers for each fragment,
//  and at S > T the backward's dk / dv role does twice the dq role's
//  products.

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
  using In = TI;
  using Den = TD;
  Bhse<TI> q, k, v, g;
  Bhse<TO> o, dq, dk, dv;
  TD* den;           // (B, H, S) contiguous
  float* scratch;    // S > T: per tile k^T [v|1] (and q^T [dnum|dd]), EP x KA each
  int H, S, E, EP, KA, NT;
  float eps;
  int fold;          // backward: dq, dk times min(q, 1), min(k, 1) of the inputs
  int cp16;          // bf16 tiles by 16-byte copies (else 8): set at launch
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
// acc (16 x 8) += a b at f32 grade, a of PA planes and b of PB (3: an f32
// operand, hi + mid + lo; 1: a bf16 one, its own hi plane): of the six
// plane products whose terms reach 2^-16 of a product (mma6), those whose
// planes both operands hold, in mma6's order (lo.hi, hi.lo, mid.mid,
// mid.hi, hi.mid, hi.hi), summed afresh, then one rounded f32 add (the
// tensor cores truncate what they add to a running sum).  A product left
// out adds exact zeros, so every PA, PB gives mma6's bits on the widened
// operands.
template <int PA, int PB>
__device__ __forceinline__ void mma_pl(float* acc, const uint32_t (&a)[PA][4],
                                       const uint32_t (&b)[PB][2]) {
  static_assert((PA == 1 || PA == 3) && (PB == 1 || PB == 3), "one or three planes");
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (PA == 3) mma_bf16(c, a[PA - 1], b[0]);
  if constexpr (PB == 3) mma_bf16(c, a[0], b[PB - 1]);
  if constexpr (PA == 3 && PB == 3) mma_bf16(c, a[1], b[1]);
  if constexpr (PA == 3) mma_bf16(c, a[PA - 2], b[0]);
  if constexpr (PB == 3) mma_bf16(c, a[0], b[PB - 2]);
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

// -- operand tiles in shared memory ------------------------------------------------
//
// A product reads each operand tile through a view: FView, an f32 tile
// (row stride ld floats) split into three planes fragment by fragment in
// registers, or PView<N>, a tile kept as N bf16 planes (plane p at p + p
// ps, rows of ld = width + BPAD bf16, an odd number of 16-byte units, so
// ldmatrix's eight rows of a matrix fall in distinct banks), read by
// ldmatrix (x4: an A tile, or the B tiles of two neighbouring n-tiles, as
// the backward reads them; x2: one B tile, as the forward and the state
// pass read them; .trans where the tile is stored k-major).  Either view
// of the same f32 values gives the same bits; a bf16 tile's one plane is
// what the f32 views give as its hi plane (mid and lo are zeros).
// rows(r) / cols(c) offset a view.

constexpr int BPAD = 8;

struct FView {
  static constexpr int NP = 3;
  const float* p;
  int ld;
  __host__ __device__ static constexpr size_t bytes(int rows, int width) {
    return sizeof(float) * (size_t)rows * (width + PAD);
  }
  __device__ __forceinline__ static FView at(unsigned char* base, int rows, int width) {
    return FView{reinterpret_cast<const float*>(base), width + PAD};
  }
  __device__ __forceinline__ float* w() const { return const_cast<float*>(p); }
  __device__ __forceinline__ FView rows(int r) const { return FView{p + r * ld, ld}; }
  __device__ __forceinline__ FView cols(int c) const { return FView{p + c, ld}; }
};
template <int N>
struct PView {
  static constexpr int NP = N;
  const bf16* p;
  int ld, ps;
  __host__ __device__ static constexpr size_t bytes(int rows, int width) {
    return sizeof(bf16) * N * (size_t)rows * (width + BPAD);
  }
  __device__ __forceinline__ static PView at(unsigned char* base, int rows, int width) {
    return PView{reinterpret_cast<const bf16*>(base), width + BPAD, rows * (width + BPAD)};
  }
  __device__ __forceinline__ bf16* w() const { return const_cast<bf16*>(p); }
  __device__ __forceinline__ PView rows(int r) const { return PView{p + r * ld, ld, ps}; }
  __device__ __forceinline__ PView cols(int c) const { return PView{p + c, ld, ps}; }
};

// The views of a call's tiles, compiled from its Args: one plane where the
// values are bf16 (the inputs of a bf16 instantiation; [dnum | dd] where
// den is bf16 too, since dnum and dd are rounded to bf16 before they
// enter), else three (f32).  In / Dn: the forward, the state pass and the
// short backward (f32 tiles split in registers); InP / DnP: the long
// backward (every tile kept as planes).
template <class A>
struct Tiles {
  static constexpr bool in1 = std::is_same<typename A::In, bf16>::value;
  static constexpr bool dn1 = in1 && std::is_same<typename A::Den, bf16>::value;
  using In = typename std::conditional<in1, PView<1>, FView>::type;
  using Dn = typename std::conditional<dn1, PView<1>, FView>::type;
  using InP = PView<in1 ? 1 : 3>;
  using DnP = PView<dn1 ? 1 : 3>;
  static constexpr int bwd_long_blocks = in1 ? 2 : 1;   // blocks an SM (shared memory)
};

__device__ __forceinline__ void frag_a(uint32_t (&a)[3][4], FView v, int k0) {
  frag_a_rows(a, v.p, v.ld, k0);
}
// A (16 x 16) = X[m][k0 + k] of the planes at row 0.
template <int N>
__device__ __forceinline__ void frag_a(uint32_t (&a)[N][4], PView<N> v, int k0) {
  const int l = threadIdx.x & 31;
  const bf16* q = v.p + (l & 15) * v.ld + k0 + (l >> 4) * 8;
#pragma unroll
  for (int pl = 0; pl < N; ++pl) ldmatrix_x4(a[pl], q + pl * v.ps);
}
// A (16 x 16) = X[k0 + k][m], X stored k-major (column m0 of the view).
__device__ __forceinline__ void frag_a_cols(uint32_t (&a)[3][4], FView v, int k0) {
  frag_a_cols(a, v.p, v.ld, k0);
}
template <int N>
__device__ __forceinline__ void frag_a_cols(uint32_t (&a)[N][4], PView<N> v, int k0) {
  const int l = threadIdx.x & 31;
  const bf16* q = v.p + (k0 + (l & 7) + (l >> 4) * 8) * v.ld + ((l >> 3) & 1) * 8;
#pragma unroll
  for (int pl = 0; pl < N; ++pl) ldmatrix_x4_trans(a[pl], q + pl * v.ps);
}
// B (16 x 8) = X[n][k0 + k], X n-major (row n0 of the view).
__device__ __forceinline__ void frag_b_rows1(uint32_t (&b)[3][2], FView v, int k0) {
  frag_b_rows(b, v.p, v.ld, k0);
}
template <int N>
__device__ __forceinline__ void frag_b_rows1(uint32_t (&b)[N][2], PView<N> v, int k0) {
  const int l = threadIdx.x & 31;
  const bf16* q = v.p + (l & 7) * v.ld + k0 + ((l >> 3) & 1) * 8;
#pragma unroll
  for (int pl = 0; pl < N; ++pl) ldmatrix_x2(b[pl], q + pl * v.ps);
}
// B (16 x 8) = X[k0 + k][n], X k-major (column n0 of the view).
__device__ __forceinline__ void frag_b_cols1(uint32_t (&b)[3][2], FView v, int k0) {
  frag_b_cols(b, v.p, v.ld, k0);
}
template <int N>
__device__ __forceinline__ void frag_b_cols1(uint32_t (&b)[N][2], PView<N> v, int k0) {
  const int l = threadIdx.x & 31;
  const bf16* q = v.p + (k0 + (l & 15)) * v.ld;
#pragma unroll
  for (int pl = 0; pl < N; ++pl) ldmatrix_x2_trans(b[pl], q + pl * v.ps);
}
// B = X[n][k0 + k], X n-major (rows n0, n0 + 8 of the view).
__device__ __forceinline__ void frag_b_rows2(uint32_t (&b0)[3][2], uint32_t (&b1)[3][2],
                                             FView v, int k0) {
  frag_b_rows(b0, v.p, v.ld, k0);
  frag_b_rows(b1, v.p + 8 * v.ld, v.ld, k0);
}
template <int N>
__device__ __forceinline__ void frag_b_rows2(uint32_t (&b0)[N][2], uint32_t (&b1)[N][2],
                                             PView<N> v, int k0) {
  const int l = threadIdx.x & 31;
  const bf16* q = v.p + ((l & 7) + ((l >> 4) << 3)) * v.ld + k0 + ((l >> 3) & 1) * 8;
#pragma unroll
  for (int pl = 0; pl < N; ++pl) {
    uint32_t r[4];
    ldmatrix_x4(r, q + pl * v.ps);
    b0[pl][0] = r[0];
    b0[pl][1] = r[1];
    b1[pl][0] = r[2];
    b1[pl][1] = r[3];
  }
}
// B = X[k0 + k][n], X k-major (columns n0, n0 + 8 of the view).
__device__ __forceinline__ void frag_b_cols2(uint32_t (&b0)[3][2], uint32_t (&b1)[3][2],
                                             FView v, int k0) {
  frag_b_cols(b0, v.p, v.ld, k0);
  frag_b_cols(b1, v.p + 8, v.ld, k0);
}
template <int N>
__device__ __forceinline__ void frag_b_cols2(uint32_t (&b0)[N][2], uint32_t (&b1)[N][2],
                                             PView<N> v, int k0) {
  const int l = threadIdx.x & 31;
  const bf16* q = v.p + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * v.ld + (l >> 4) * 8;
#pragma unroll
  for (int pl = 0; pl < N; ++pl) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, q + pl * v.ps);
    b0[pl][0] = r[0];
    b0[pl][1] = r[1];
    b1[pl][0] = r[2];
    b1[pl][1] = r[3];
  }
}

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
// Element (r, c) of a tile: read as f32, written from f32 (a one-plane
// tile takes only bf16 values, so the store is exact).
__device__ __forceinline__ float get1(FView v, int r, int c) { return v.p[r * v.ld + c]; }
__device__ __forceinline__ float get1(PView<1> v, int r, int c) {
  return __bfloat162float(v.p[r * v.ld + c]);
}
__device__ __forceinline__ void put1(FView v, int r, int c, float x) { v.w()[r * v.ld + c] = x; }
__device__ __forceinline__ void put1(PView<1> v, int r, int c, float x) {
  v.w()[r * v.ld + c] = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void put1(PView<3> v, int r, int c, float x) {
  st_planes1(v.w() + r * v.ld + c, v.ps, x);
}

// -- loads ---------------------------------------------------------------------

// Rows [row0, row0 + n) of t into the tile v, `width` columns; rows >= S
// and columns >= E are zeros.  f32 into an f32 tile: by cp.async; bf16
// into one plane: by cp.async of 16-byte pieces where a.cp16 (the last
// piece of a row cut at E, its rest zero-filled), else of 8; bf16 into an
// f32 tile (kernel C's f32 dnum from a bf16 g): loaded four at a time (a
// batch of loads in flight) and widened as stored.
template <class A>
__device__ __forceinline__ void stage(FView v, const Bhse<float>& t, int b, int h, int row0,
                                      int n, int width, const A& a) {
  const int c4 = width / 4;
  for (int idx = threadIdx.x; idx < n * c4; idx += blockDim.x) {
    const int r = idx / c4, c = (idx % c4) * 4, i = row0 + r;
    const bool ok = i < a.S && c < a.E;
    cp_async16(v.w() + r * v.ld + c, ok ? t.at(b, h, i, c) : t.p, ok);
  }
}
template <class A>
__device__ __forceinline__ void stage(FView v, const Bhse<bf16>& t, int b, int h, int row0,
                                      int n, int width, const A& a) {
  constexpr int U = 4;
  const int c4 = width / 4, total = n * c4;
  for (int base = threadIdx.x; base < total; base += U * blockDim.x) {
    float4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * blockDim.x, r = idx / c4, c = (idx % c4) * 4, i = row0 + r;
      x[u] = idx < total && i < a.S && c < a.E ? ld4(t.at(b, h, i, c))
                                                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total)
        *reinterpret_cast<float4*>(v.w() + (idx / c4) * v.ld + (idx % c4) * 4) = x[u];
    }
  }
}
template <class A>
__device__ __forceinline__ void stage(PView<1> v, const Bhse<bf16>& t, int b, int h, int row0,
                                      int n, int width, const A& a) {
  if (a.cp16) {
    const int c8 = width / 8;
    for (int idx = threadIdx.x; idx < n * c8; idx += blockDim.x) {
      const int r = idx / c8, c = (idx % c8) * 8, i = row0 + r;
      const int nb = i < a.S ? 2 * max(0, min(8, a.E - c)) : 0;
      cp_async_bytes(v.w() + r * v.ld + c, nb ? t.at(b, h, i, c) : t.p, nb);
    }
  } else {
    const int c4 = width / 4;
    for (int idx = threadIdx.x; idx < n * c4; idx += blockDim.x) {
      const int r = idx / c4, c = (idx % c4) * 4, i = row0 + r;
      const bool ok = i < a.S && c < a.E;
      cp_async8(v.w() + r * v.ld + c, ok ? t.at(b, h, i, c) : t.p, ok);
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
template <class V, class A>
__device__ __forceinline__ void set_ones(V v, int row0, int n, const A& a) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) put1(v, r, a.E, row0 + r < a.S ? 1.f : 0.f);
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
// [dnum | dd] in place over the upstream gradient's rows in the tile DN
// (KA wide; after the copies landed): dnum = g / (den + eps), column E = dd.
template <class V, class A>
__device__ __forceinline__ void form_dnum(V DN, const float* dd, const float* dv, int row0,
                                          int n, const A& a) {
  const int c = a.E + 1;
  for (int idx = threadIdx.x; idx < n * c; idx += blockDim.x) {
    const int r = idx / c, f = idx % c;
    if (row0 + r >= a.S) continue;          // zeros already
    put1(DN, r, f, f == a.E ? dd[r] : dna_round<A>(get1(DN, r, f) / dv[r]));
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

// One tile's increment X^T Y into its slot: warp w the e rows [16 (w % 4),
// +16) over half the tile's rows, [32 (w / 4), +32), the halves added in
// shared memory.  X: k or q (view XV); Y: [v | 1] or [dnum | dd] (YV).
template <int EC, class XV, class YV, class A>
__device__ __forceinline__ void state_tile(unsigned char* sm, int which, int t, int b, int h,
                                           const A& a) {
  const Dims<EC> d(a);
  const int w = threadIdx.x >> 5, e0 = 16 * (w & 3);
  const int hf = w >> 2, na = d.KA / 8, row0 = t * T;
  float* dd = reinterpret_cast<float*>(sm);           // 64, and den + eps 64 (which 1)
  unsigned char* xs = sm + sizeof(float) * 2 * T;
  const XV Xs = XV::at(xs, T, d.EP);                   // 64 x EP: k or q
  const YV Ys = YV::at(xs + XV::bytes(T, d.EP), T, d.KA);   // 64 x KA: [v | 1] or [dnum | dd]
  float* red = reinterpret_cast<float*>(xs);           // after the products: 2 x EP x KA
  stage(Xs, which ? a.q : a.k, b, h, row0, T, d.EP, a);
  stage(Ys, which ? a.g : a.v, b, h, row0, T, d.KA, a);
  cp_async_commit();
  if (which) form_dd(dd, dd + T, b, h, row0, T, a);
  cp_async_wait<0>();
  __syncthreads();
  if (which) {
    form_dnum(Ys, dd, dd + T, row0, T, a);
  } else {
    set_ones(Ys, row0, T, a);
  }
  __syncthreads();
  float acc[NA_MAX][4];
  zero(acc);
  if (e0 < d.EP) {
#pragma unroll
    for (int k0 = 0; k0 < 32; k0 += 16) {
      uint32_t af[XV::NP][4];
      frag_a_cols(af, Xs.cols(e0), 32 * hf + k0);
#pragma unroll
      for (int n = 0; n < NA_MAX; ++n) {
        if (n >= na) continue;
        uint32_t bf[YV::NP][2];
        frag_b_cols1(bf, Ys.cols(n * 8), 32 * hf + k0);
        mma_pl(acc[n], af, bf);
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

// Block (job, head, sequence), 8 warps: the state increment of one tile,
// k^T [v | 1] (which 0) or q^T [dnum | dd] (which 1, backward), into its
// scratch slot.  Forward: jobs = tiles 0 .. NT - 2 of which 0; backward:
// those, then tiles 1 .. NT - 1 of which 1.  Every tile in parallel: the
// prefix and suffix sums are taken by the output pass.  Where [dnum | dd]
// takes other planes than [v | 1] (kernel C's f32 dnum beside bf16
// tiles), each kind has its own copy of the products.
template <int EC, class A>
__global__ void __launch_bounds__(256, 2) cp_state_kernel(A a) {
  extern __shared__ __align__(16) float sm[];
  using In = typename Tiles<A>::In;
  using Dn = typename Tiles<A>::Dn;
  unsigned char* s = reinterpret_cast<unsigned char*>(sm);
  const int which = blockIdx.x / (a.NT - 1), t = blockIdx.x % (a.NT - 1) + which;
  const int h = blockIdx.y, b = blockIdx.z;
  if constexpr (std::is_same<In, Dn>::value) {
    state_tile<EC, In, In>(s, which, t, b, h, a);
  } else if (which) {
    state_tile<EC, In, Dn>(s, which, t, b, h, a);
  } else {
    state_tile<EC, In, In>(s, which, t, b, h, a);
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

// Rows [row0, row0 + T) of t, columns [0, width), as three planes at P
// (the long backward's f32 tiles, and kernel C's f32 dnum); rows >= S and
// columns >= E are zeros; each value divided by div[r] where div is given
// (the backward's dnum = g / (den + eps)).  Four loads in flight a thread.
template <class A, typename X>
__device__ __forceinline__ void load_planes(PView<3> P, const Bhse<X>& t, int b, int h, int row0,
                                            int width, const float* div, const A& a) {
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
      st_planes4(P.w() + r * P.ld + c, P.ps, v[u]);
    }
  }
}
// The long backward's input tiles: three planes split as loaded (f32), or
// one plane by cp.async (bf16).
template <class A, typename X>
__device__ __forceinline__ void stage_long(PView<3> v, const Bhse<X>& t, int b, int h, int row0,
                                           int width, const A& a) {
  load_planes(v, t, b, h, row0, width, nullptr, a);
}
template <class A>
__device__ __forceinline__ void stage_long(PView<1> v, const Bhse<bf16>& t, int b, int h,
                                           int row0, int width, const A& a) {
  stage(v, t, b, h, row0, T, width, a);
}

// -- products of a warp ------------------------------------------------------------

// acc (16 x KA) += tril(q k^T) [v | 1] over the NK keys [key0, key0 + NK)
// of rows [R0, R0 + 16) (Qw, Kc, Vc at those rows and keys) when `keys`,
// plus q [S | z] over the depths [p0, p1) of q's columns when Sa (f32, KA
// + PAD floats a row) is given.
template <int EC, int NK, class V, class A>
__device__ __forceinline__ void fwd_part(float (&acc)[NA_MAX][4], V Qw, V Kc, V Vc, bool keys,
                                         const float* Sa, int p0, int p1, int R0, int key0,
                                         const A& a) {
  const Dims<EC> d(a);
  const int lda = d.KA + PAD, na = d.KA / 8;
  float s[NK / 8][4];
  zero(s);
#pragma unroll
  for (int k0 = 0; k0 < MAX_E; k0 += 16) {
    if (k0 >= d.EP) continue;
    uint32_t aq[V::NP][4];
    frag_a(aq, Qw, k0);
    if (keys) {
#pragma unroll
      for (int n = 0; n < NK / 8; ++n) {        // scores q k^T
        uint32_t bk[V::NP][2];
        frag_b_rows1(bk, Kc.rows(n * 8), k0);
        mma_pl(s[n], aq, bk);
      }
    }
    if (Sa != nullptr && k0 >= p0 && k0 < p1) {
#pragma unroll
      for (int n = 0; n < NA_MAX; ++n) {        // q [S | z]
        if (n >= na) continue;
        uint32_t bs[3][2];
        frag_b_cols(bs, Sa + n * 8, lda, k0);
        mma_pl(acc[n], aq, bs);
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
      uint32_t bv[V::NP][2];
      frag_b_cols1(bv, Vc.cols(n * 8), ks * 16);
      mma_pl(acc[n], aa, bv);
    }
  }
}

// dq (16 x EP) += tril([dnum | dd] [v | 1]^T) k over the NK keys [key0,
// key0 + NK) of rows [R0, R0 + 16) when `keys`, plus [dnum | dd] [S | z]^T
// over the depths [p0, p1) of [dnum | dd]'s columns when Sa is given.
template <int EC, int NK, class VD, class V, class VS, class A>
__device__ __forceinline__ void dq_part(float (&dq)[MAX_E / 8][4], VD DNw, V Kc, V Vc,
                                        bool keys, const VS* Sa, int p0, int p1, int R0,
                                        int key0, const A& a) {
  const Dims<EC> d(a);
  const int ne = d.EP / 8;
  float m[NK / 8][4];
  zero(m);
#pragma unroll
  for (int k0 = 0; k0 < MAX_E + 16; k0 += 16) {
    if (k0 >= d.KA) continue;
    uint32_t ad[VD::NP][4];
    frag_a(ad, DNw, k0);
    if (keys) {
#pragma unroll
      for (int n = 0; n < NK / 8; n += 2) {
        uint32_t b0[V::NP][2], b1[V::NP][2];
        frag_b_rows2(b0, b1, Vc.rows(n * 8), k0);
        mma_pl(m[n], ad, b0);
        mma_pl(m[n + 1], ad, b1);
      }
    }
    if (Sa != nullptr && k0 >= p0 && k0 < p1) {
#pragma unroll
      for (int n = 0; n < MAX_E / 8; n += 2) {
        if (n >= ne) continue;
        uint32_t b0[VS::NP][2], b1[VS::NP][2];
        frag_b_rows2(b0, b1, Sa->rows(n * 8), k0);
        mma_pl(dq[n], ad, b0);
        mma_pl(dq[n + 1], ad, b1);
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
      uint32_t b0[V::NP][2], b1[V::NP][2];
      frag_b_cols2(b0, b1, Kc.cols(n * 8), ks * 16);
      mma_pl(dq[n], am, b0);
      mma_pl(dq[n + 1], am, b1);
    }
  }
}

// Keys [J0, J0 + 16) (Vw) against the NQ queries [q0, q0 + NQ) (Qc, DNc)
// when `queries`: dk (16 x EP) += triu([v | 1] [dnum | dd]^T) q, plus
// [v | 1] [G | gz]^T over the depths [p0, p1) of [v | 1]'s columns when G
// is given.
template <int EC, int NQ, class V, class VD, class VS, class A>
__device__ __forceinline__ void dk_part(float (&dk)[MAX_E / 8][4], V Vw, V Qc, VD DNc,
                                        bool queries, const VS* G, int p0, int p1, int J0, int q0,
                                        const A& a) {
  const Dims<EC> d(a);
  const int ne = d.EP / 8;
  float p[NQ / 8][4];
  zero(p);
#pragma unroll
  for (int k0 = 0; k0 < MAX_E + 16; k0 += 16) {
    if (k0 >= d.KA) continue;
    uint32_t av[V::NP][4];
    frag_a(av, Vw, k0);
    if (queries) {
#pragma unroll
      for (int n = 0; n < NQ / 8; n += 2) {
        uint32_t b0[VD::NP][2], b1[VD::NP][2];
        frag_b_rows2(b0, b1, DNc.rows(n * 8), k0);
        mma_pl(p[n], av, b0);
        mma_pl(p[n + 1], av, b1);
      }
    }
    if (G != nullptr && k0 >= p0 && k0 < p1) {
#pragma unroll
      for (int n = 0; n < MAX_E / 8; n += 2) {
        if (n >= ne) continue;
        uint32_t b0[VS::NP][2], b1[VS::NP][2];
        frag_b_rows2(b0, b1, G->rows(n * 8), k0);
        mma_pl(dk[n], av, b0);
        mma_pl(dk[n + 1], av, b1);
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
      uint32_t b0[V::NP][2], b1[V::NP][2];
      frag_b_cols2(b0, b1, Qc.cols(n * 8), ks * 16);
      mma_pl(dk[n], ap, b0);
      mma_pl(dk[n + 1], ap, b1);
    }
  }
}

// The same keys (Kw) and queries: dv (16 x EP) += triu(k q^T) dnum, plus
// k G over the depths [p0, p1) of k's columns when G is given.
template <int EC, int NQ, class V, class VD, class VS, class A>
__device__ __forceinline__ void dv_part(float (&dv)[MAX_E / 8][4], V Kw, V Qc, VD DNc,
                                        bool queries, const VS* G, int p0, int p1, int J0, int q0,
                                        const A& a) {
  const Dims<EC> d(a);
  const int ne = d.EP / 8;
  float p[NQ / 8][4];
  zero(p);
#pragma unroll
  for (int k0 = 0; k0 < MAX_E; k0 += 16) {
    if (k0 >= d.EP) continue;
    uint32_t ak[V::NP][4];
    frag_a(ak, Kw, k0);
    if (queries) {
#pragma unroll
      for (int n = 0; n < NQ / 8; n += 2) {
        uint32_t b0[V::NP][2], b1[V::NP][2];
        frag_b_rows2(b0, b1, Qc.rows(n * 8), k0);
        mma_pl(p[n], ak, b0);
        mma_pl(p[n + 1], ak, b1);
      }
    }
    if (G != nullptr && k0 >= p0 && k0 < p1) {
#pragma unroll
      for (int n = 0; n < MAX_E / 8; n += 2) {
        if (n >= ne) continue;
        uint32_t b0[VS::NP][2], b1[VS::NP][2];
        frag_b_cols2(b0, b1, G->cols(n * 8), k0);
        mma_pl(dv[n], ak, b0);
        mma_pl(dv[n + 1], ak, b1);
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
      uint32_t b0[VD::NP][2], b1[VD::NP][2];
      frag_b_cols2(b0, b1, DNc.cols(n * 8), ks * 16);
      mma_pl(dv[n], ap, b0);
      mma_pl(dv[n + 1], ap, b1);
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
  using In = typename Tiles<A>::In;
  const Dims<EC> d(a);
  const int h = blockIdx.y, b = blockIdx.z, r = blockIdx.x, r0 = 16 * r, w = threadIdx.x >> 5;
  const int lda = d.KA + PAD, nkeys = r0 + 16;
  unsigned char* s = reinterpret_cast<unsigned char*>(sm);
  const In Q = In::at(s, 16, d.EP);                                  // 16 x EP
  unsigned char* sk = s + In::bytes(16, d.EP);
  const In K = In::at(sk, T, d.EP);                                  // keys [0, r0 + 16) x EP
  const In V = In::at(sk + In::bytes(T, d.EP), T, d.KA);              // x KA
  float* red = sm;                 // after the products: 4 x 16 x KA partial [num | den]
  stage(Q, a.q, b, h, r0, 16, d.EP, a);
  stage(K, a.k, b, h, 0, nkeys, d.EP, a);
  stage(V, a.v, b, h, 0, nkeys, d.KA, a);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  set_ones(V, 0, nkeys, a);
  __syncthreads();
  float acc[NA_MAX][4];
  zero(acc);
  if (w <= r)
    fwd_part<EC, 16>(acc, Q, K.rows(16 * w), V.rows(16 * w), true, nullptr, 0, 0, r0, 16 * w,
                     a);
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
  using In = typename Tiles<A>::In;
  const Dims<EC> d(a);
  const int h = blockIdx.y, b = blockIdx.z, tile = blockIdx.x, t0 = tile * T;
  const int w = threadIdx.x >> 5, rg = w & 3, hf = w >> 2;
  const int lda = d.KA + PAD;
  unsigned char* s = reinterpret_cast<unsigned char*>(sm);
  const In Q = In::at(s, T, d.EP);                                   // 64 x EP
  const In K = In::at(s + In::bytes(T, d.EP), T, d.EP);               // 64 x EP
  unsigned char* sv = s + 2 * In::bytes(T, d.EP);
  const In V = In::at(sv, T, d.KA);                                  // 64 x KA
  float* Sa = reinterpret_cast<float*>(sv + In::bytes(T, d.KA));     // EP x KA: [S | z] before
  float* red = sm;                 // after the products: 2 x 64 x KA
  stage(Q, a.q, b, h, t0, T, d.EP, a);
  stage(K, a.k, b, h, t0, T, d.EP, a);
  stage(V, a.v, b, h, t0, T, d.KA, a);
  cp_async_commit();
  if (tile > 0) sum_slots(Sa, lda, 0, b, h, 0, tile, a);
  cp_async_wait<0>();
  __syncthreads();
  set_ones(V, t0, T, a);
  __syncthreads();
  const int R0 = t0 + 16 * rg, key0 = t0 + 32 * hf, pm = d.EP / 32 * 16;
  float acc[NA_MAX][4];
  zero(acc);
  fwd_part<EC, 32>(acc, Q.rows(16 * rg), K.rows(32 * hf), V.rows(32 * hf), key0 <= R0 + 15,
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
  using In = typename Tiles<A>::In;
  using Dn = typename Tiles<A>::Dn;
  const Dims<EC> d(a);
  const int role = blockIdx.x & 1, r = blockIdx.x >> 1, r0 = 16 * r;
  const int h = blockIdx.y, b = blockIdx.z, w = threadIdx.x >> 5;
  const int lde = d.EP + PAD, nw = (a.S + 15) / 16, ne = d.EP / 8;
  float d0[MAX_E / 8][4], d1[MAX_E / 8][4];
  zero(d0);
  zero(d1);
  if (role == 0) {
    const int nkeys = r0 + 16;
    float* dd = sm;                  // 16, and den + eps 16
    unsigned char* s = reinterpret_cast<unsigned char*>(dd + 32);
    const Dn DN = Dn::at(s, 16, d.KA);                               // 16 x KA
    unsigned char* sk = s + Dn::bytes(16, d.KA);
    const In K = In::at(sk, T, d.EP);                                // keys [0, r0 + 16) x EP
    const In V = In::at(sk + In::bytes(T, d.EP), T, d.KA);            // x KA
    float* red = dd + 32;            // after the products: 4 x 16 x EP
    stage(DN, a.g, b, h, r0, 16, d.KA, a);
    stage(K, a.k, b, h, 0, nkeys, d.EP, a);
    stage(V, a.v, b, h, 0, nkeys, d.KA, a);
    cp_async_commit();
    form_dd(dd, dd + 16, b, h, r0, 16, a);
    cp_async_wait<0>();
    __syncthreads();
    set_ones(V, 0, nkeys, a);
    form_dnum(DN, dd, dd + 16, r0, 16, a);
    __syncthreads();
    if (w <= r)
      dq_part<EC, 16>(d0, DN, K.rows(16 * w), V.rows(16 * w), true, (const FView*)nullptr, 0, 0,
                      r0, 16 * w, a);
    __syncthreads();
    put_acc(red + w * 16 * lde, lde, d0, ne);
    __syncthreads();
    reduce_rows(red, lde, 0, r + 1, 1, a.dq, a.fold ? &a.q : nullptr, b, h, r0, a);
  } else {
    const int nq = T - r0;
    float* dd = sm;                  // 64, and den + eps 64
    unsigned char* s = reinterpret_cast<unsigned char*>(dd + 2 * T);
    const In K = In::at(s, 16, d.EP);                                // keys [r0, r0 + 16) x EP
    unsigned char* sv = s + In::bytes(16, d.EP);
    const In V = In::at(sv, 16, d.KA);                               // x KA
    unsigned char* sq = sv + In::bytes(16, d.KA);
    const In Q = In::at(sq, T, d.EP);                                // queries [r0, T) x EP
    const Dn DN = Dn::at(sq + In::bytes(T, d.EP), T, d.KA);           // x KA
    float* red = dd + 2 * T;         // after the products: 2 x 4 x 16 x EP
    stage(K, a.k, b, h, r0, 16, d.EP, a);
    stage(V, a.v, b, h, r0, 16, d.KA, a);
    stage(Q, a.q, b, h, r0, nq, d.EP, a);
    stage(DN, a.g, b, h, r0, nq, d.KA, a);
    cp_async_commit();
    form_dd(dd, dd + T, b, h, r0, nq, a);
    cp_async_wait<0>();
    __syncthreads();
    set_ones(V, r0, 16, a);
    form_dnum(DN, dd, dd + T, r0, nq, a);
    __syncthreads();
    const bool on = w >= r && w < nw;
    const In Qc = Q.rows(16 * w - r0);
    const Dn DNc = DN.rows(16 * w - r0);
    if (on) {
      dk_part<EC, 16>(d0, V, Qc, DNc, true, (const FView*)nullptr, 0, 0, r0, 16 * w, a);
      dv_part<EC, 16>(d1, K, Qc, DNc, true, (const FView*)nullptr, 0, 0, r0, 16 * w, a);
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
// is kept as its planes and read by ldmatrix: f32 tiles split into three
// as they are loaded (153 KB at E = 64: one block an SM), bf16 ones copied
// by cp.async into one (75 KB for F's bf16 instantiation, 98 KB for C's,
// whose f32 dnum keeps three: two blocks an SM); [G | gz] / [S | z] is f32
// (three planes).
template <int EC, class A>
__global__ void __launch_bounds__(256, Tiles<A>::bwd_long_blocks) cp_bwd_long_kernel(A a) {
  extern __shared__ __align__(16) float sm[];
  using IP = typename Tiles<A>::InP;
  using DP = typename Tiles<A>::DnP;
  const Dims<EC> d(a);
  const int role = blockIdx.x & 1, tile = blockIdx.x >> 1, t0 = tile * T;
  const int h = blockIdx.y, b = blockIdx.z, w = threadIdx.x >> 5, rg = w & 3, hf = w >> 2;
  const int lde = d.EP + PAD, R0 = t0 + 16 * rg, c0 = t0 + 32 * hf;
  float* dd = sm;                              // 64, and den + eps 64
  unsigned char* s = reinterpret_cast<unsigned char*>(dd + 2 * T);
  const DP vDN = DP::at(s, T, d.KA);                               // planes: 64 x KA
  unsigned char* sk = s + DP::bytes(T, d.KA);
  const IP vK = IP::at(sk, T, d.EP);                               // 64 x EP
  unsigned char* sv = sk + IP::bytes(T, d.EP);
  const IP vV = IP::at(sv, T, d.KA);                               // 64 x KA
  unsigned char* sq = sv + IP::bytes(T, d.KA);
  const IP vQ = IP::at(sq, T, d.EP);                               // 64 x EP (role 1)
  // EP x KA: [S | z] before, or [G | gz] after
  const PView<3> vS = PView<3>::at(sq + IP::bytes(T, d.EP), d.EP, d.KA);
  float* red = dd + 2 * T;                     // after the products: 2 x 2 x 64 x EP f32
  const bool more = role == 0 ? tile > 0 : tile < a.NT - 1;
  if constexpr (IP::NP == 1) {                 // the copies fly while dd and the slots are summed
    stage_long(vK, a.k, b, h, t0, d.EP, a);
    stage_long(vV, a.v, b, h, t0, d.KA, a);
    if (role == 1) stage_long(vQ, a.q, b, h, t0, d.EP, a);
    if constexpr (DP::NP == 1) stage(vDN, a.g, b, h, t0, T, d.KA, a);
    cp_async_commit();
    form_dd(dd, dd + T, b, h, t0, T, a);
  } else {
    form_dd(dd, dd + T, b, h, t0, T, a);
    stage_long(vK, a.k, b, h, t0, d.EP, a);
    stage_long(vV, a.v, b, h, t0, d.KA, a);
    if (role == 1) stage_long(vQ, a.q, b, h, t0, d.EP, a);
  }
  if (more) {
    const auto put = [&](int e, int f, float4 v) { st_planes4(vS.w() + e * vS.ld + f, vS.ps, v); };
    if (role == 0) {
      sum_slots_to(put, 0, b, h, 0, tile, a);
    } else {
      sum_slots_to(put, 1, b, h, tile + 1, a.NT, a);
    }
  }
  if constexpr (IP::NP == 1) cp_async_wait<0>();
  __syncthreads();
  if constexpr (DP::NP == 1) {                 // [dnum | dd] in place, and the ones column
    form_dnum(vDN, dd, dd + T, t0, T, a);
    set_ones(vV, t0, T, a);
  } else {
    load_planes(vDN, a.g, b, h, t0, d.KA, dd + T, a);   // dnum = g / (den + eps)
    __syncthreads();                                      // its zeros past E written
    for (int r = threadIdx.x; r < T; r += blockDim.x) {   // the ones and dd columns
      const bool ok = t0 + r < a.S;
      put1(vV, r, a.E, ok ? 1.f : 0.f);
      put1(vDN, r, a.E, ok ? dd[r] : 0.f);
    }
  }
  __syncthreads();
  const int ne = d.EP / 8, pka = d.KA / 32 * 16 + (d.KA % 32), pke = d.EP / 32 * 16;
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

// Shared memory of each kernel for A's tiles (the partial sums reuse the
// operands' space once the products are done).
template <class A>
inline size_t fwd_smem(bool lng, int EP, int KA) {
  using In = typename Tiles<A>::In;
  const size_t lda = KA + PAD;
  const size_t ops = lng ? 2 * In::bytes(T, EP) + In::bytes(T, KA) + sizeof(float) * EP * lda
                         : In::bytes(16, EP) + In::bytes(T, EP) + In::bytes(T, KA);
  return std::max(ops, sizeof(float) * (lng ? 2 * T : 4 * 16) * lda);
}
template <class A>
inline size_t bwd_smem(bool lng, int EP, int KA) {
  using In = typename Tiles<A>::In;
  using Dn = typename Tiles<A>::Dn;
  using IP = typename Tiles<A>::InP;
  using DP = typename Tiles<A>::DnP;
  const size_t lde = EP + PAD;
  if (lng)       // the planes of DN, K, V, Q, [S | z], or the partial sums
    return sizeof(float) * 2 * T +
           std::max(DP::bytes(T, KA) + 2 * IP::bytes(T, EP) + IP::bytes(T, KA) +
                        PView<3>::bytes(EP, KA),
                    sizeof(float) * 4 * T * lde);
  const size_t dq = sizeof(float) * 32 +
                    std::max(Dn::bytes(16, KA) + In::bytes(T, EP) + In::bytes(T, KA),
                             sizeof(float) * 4 * 16 * lde);
  const size_t dkv = sizeof(float) * 2 * T +
                     std::max(In::bytes(16, EP) + In::bytes(16, KA) + In::bytes(T, EP) +
                                  Dn::bytes(T, KA),
                              sizeof(float) * 8 * 16 * lde);
  return std::max(dq, dkv);
}
template <class A>
inline size_t state_smem(int EP, int KA) {
  using In = typename Tiles<A>::In;
  using Dn = typename Tiles<A>::Dn;
  return sizeof(float) * 2 * T + std::max(In::bytes(T, EP) + std::max(In::bytes(T, KA),
                                                                       Dn::bytes(T, KA)),
                                          sizeof(float) * 2 * (size_t)EP * KA);
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
inline int forward(const A& a0, int B, cudaStream_t st) {
  A a = a0;
  a.cp16 = copies16(a.q, B, a.H, a.S) && copies16(a.k, B, a.H, a.S) &&
           copies16(a.v, B, a.H, a.S);
  if (a.NT == 1)
    return launch(cp_fwd_short_kernel<EC, A>, dim3((a.S + 15) / 16, a.H, B), 128,
                  fwd_smem<A>(false, a.EP, a.KA), a, st);
  const int rc = launch(cp_state_kernel<EC, A>, dim3(a.NT - 1, a.H, B), 256,
                        state_smem<A>(a.EP, a.KA), a, st);
  if (rc) return rc;
  return launch(cp_fwd_long_kernel<EC, A>, dim3(a.NT, a.H, B), 256,
                fwd_smem<A>(true, a.EP, a.KA), a, st);
}

template <int EC, class A>
inline int backward(const A& a0, int B, cudaStream_t st) {
  A a = a0;
  a.cp16 = copies16(a.q, B, a.H, a.S) && copies16(a.k, B, a.H, a.S) &&
           copies16(a.v, B, a.H, a.S) && copies16(a.g, B, a.H, a.S);
  if (a.NT == 1)
    return launch(cp_bwd_short_kernel<EC, A>, dim3(2 * ((a.S + 15) / 16), a.H, B), 128,
                  bwd_smem<A>(false, a.EP, a.KA), a, st);
  const int rc = launch(cp_state_kernel<EC, A>, dim3(2 * (a.NT - 1), a.H, B), 256,
                        state_smem<A>(a.EP, a.KA), a, st);
  if (rc) return rc;
  return launch(cp_bwd_long_kernel<EC, A>, dim3(2 * a.NT, a.H, B), 256,
                bwd_smem<A>(true, a.EP, a.KA), a, st);
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
