// Band (sliding-window) softmax attention, forward and backward ("kernel
// E"): the CUDA counterpart of
// reinforcement_learning_in_music_generation_tpu/ops/window_attention_kernel.py
// window_attention_pallas (its Pallas bodies _fwd_kernel, _dq_kernel and
// _dkv_kernel).
//
// q, k, v, out (B, H, S, E) of one type T, f32 or bf16 (JAX's kernel takes
// any dtype and computes in f32), with any batch / head / row strides that
// are multiples of 4 elements (the last dimension contiguous); mask (B, S)
// f32, 1 = keep.  At bf16 each tile is copied by cp.async straight into
// one bf16 plane (a bf16 value is exact in f32 and its own hi plane:
// nothing is widened or split), out and the gradients are rounded on
// store, the row statistics stay f32, and D = rowsum(dO * O) reads the
// stored, rounded out, as _wa_bwd takes it.  Query
// i sees key j when |i - j| <= w and j < S: keys outside that band are not
// in the row's softmax (the kernels visit only the key tiles the band
// touches, and drop the rest of a tile); a key inside it that the mask
// drops scores the finite -1e9, as on the TPU.  Every row is finite: a row
// with no kept key in its band averages its band uniformly.  Masked scores
// are constants, so they pass no gradient to q or k.
//
// Forward, wa_fwd_kernel: one block of 4 warps per (64 query rows, batch x
// head), each warp 16 rows.  The block walks the 64-key tiles of
// [q0 - w, q0 + 63 + w] clipped to [0, S) (at most 10 at w = 256), with an
// online softmax: per tile S = q k^T * scale, the running row max m and sum
// l, out = out * exp(m_old - m_new) + P v.  It writes out / l and the row
// statistics (m, log l), whose sum is the row's LSE.  The backward takes
// P = exp((S - m) - log l) from them, not exp(S - LSE): in a row whose band
// holds only masked keys m = -1e9, and m + log l rounds back to m in f32.
// The TPU kernel read a 256-row block against its three clamped neighbours,
// which needed block >= w; the tile loop takes any w.
// Backward, deterministic (no atomics), in three passes:
//   wa_rowdot_kernel D = rowsum(dO * O), a warp a row;
//   wa_dkv_kernel    per key tile, over the query tiles that see it (the
//                    band, mirrored), with keys as rows: S^T = k q^T,
//                    dP^T = v dO^T, P^T = exp((S^T - m) - log l),
//                    dS^T = P^T (dP^T - D), dv += P^T dO, dk += dS^T q; and
//                    each dS^T tile to its slot of a scratch buffer;
//   wa_dq_kernel     per query tile, over its key tiles in order: dq += dS k,
//                    dS read back from the slots.
// Five tile products, the function's count (the TPU's dq pass recomputed
// S and dP: seven): the dS slots (279 MB at the discriminator's shape,
// written and read once) cost less than the two recomputed products did.
//
// Every tile product runs on the tensor cores at f32 grade: mma.sync
// m16n8k16 over the bf16 planes of its operands, an f32 operand in three
// (x = hi + mid + lo, the 24 bits of an f32 value), a bf16 one in one.
// mma_pl issues those of the six plane products whose terms reach 2^-16
// of a product (mma6) that pair planes both operands hold, in mma6's
// order: six where neither is bf16, three where one is, one where both
// are; each depth of 16 summed afresh and added to the running sum in f32
// (train_gemm_tc.cuh's arithmetic for kernels D and G).  A product left
// out adds exact zeros, so a bf16 call's bits are the f32 route's on the
// widened tensors.  At bf16: S = q k^T and dP^T = v dO^T one product, P v,
// P^T dO, dS^T q and dS k three (P and dS are f32).
//   * f32 q, k, v and dO tiles are copied by cp.async (16 bytes a thread,
//     straight from the strided tensors, rows past S and columns past E
//     zero-filled) into an f32 staging area, the next tile's copy in flight
//     while the current one is multiplied; each tile is split into its
//     three planes once, in shared memory.  bf16 tiles are copied by
//     cp.async into their one plane, two buffers a tile (the next tile's
//     copy in flight), 16-byte pieces where every base and stride is a
//     multiple of 8 elements, else 8-byte ones (chosen at launch: cp16).
//     Planes have depth padded to a multiple of 16 with zeros and rows
//     padded by 16 bytes against bank conflicts, and are read by ldmatrix:
//     plain where the tile is the B operand with the product's depth along
//     its rows' contiguous dimension (S = q k^T, dP = dO v^T, their
//     transposes), .trans where the depth runs down its rows (P v, dS k,
//     P^T dO, dS^T q).  The forward keeps q's fragments in registers
//     (three planes, or one at bf16).
//   * P and dS are formed in registers and split there, once a tile: the
//     accumulator of a 16 x 16 piece is the next product's A operand.
//   * The online softmax keeps each row's running max and sum in registers,
//     reduced across the quad of lanes that share the row.
//   * The dk / dv pass's blocks have 8 warps: warps w and w + 4 share a
//     16-row group of the key tile, each taking 32 of the query tile's 64
//     rows, and add their sums in a fixed order at the end, so each warp
//     holds half the accumulators (f32: one block an SM, its four
//     three-plane tiles; bf16: 56 KB at E = 64, two).  The dq pass reads
//     the dS^T slots with ldmatrix.trans as the A operand (split into
//     three planes: dS is f32); it holds two tiles' planes.  Blocks an SM
//     (WaBlocks): f32 2 / 1 / 2 (forward, dk / dv, dq), bf16 3 / 2 / 3.
// Kernels are compiled for the depth padded to 16, 32, 48 or 64 (head
// widths that are multiples of 4 up to 64).
//
// Bound on the card (PERF.md).  At B = 4, H = 8, S = 3584, E = 64, w = 256 the
// band holds 1,772,800 (query, key) pairs per (b, h): the forward is 2
// products (14.52 GFLOP) and the backward 5 (36.31 GFLOP), against ~0.04 ms
// of bytes: at f32 grade on the tensor cores (989/6 TFLOP/s) 0.088 / 0.220
// ms (f32 FMAs outside them: 0.217 / 0.542).  The 64-row tiles compute 12%
// more pairs than the band holds.

#include <cuda_runtime.h>
#include <math.h>

#include "tc_mma.cuh"

namespace rlmg {

using bf16 = __nv_bfloat16;

constexpr int WA_T = 64, WA_MAX_E = 64;
constexpr int WA_THREADS = 128;         // forward: 4 warps of 16 query rows
constexpr int WA_BWD_THREADS = 256;     // backward: 8 warps, two a 16-row group
constexpr int WA_PAD = 8;                // bf16 a plane row is padded by
constexpr float WA_NEG = -1e9f;          // score of a masked key (finite, as on the TPU)
constexpr float WA_FLOOR = -3.0e38f;     // running max before any key is seen

#define RLMG_CHECK()                           \
  do {                                         \
    const cudaError_t e_ = cudaGetLastError(); \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

// A (B, H, S, E) tensor of T: base and strides in elements (batch, head, row).
template <typename T>
struct Bhsd {
  const T* p;
  long long sb, sh, ss;
  __device__ __forceinline__ const T* row(int b, int h, int s) const {
    return p + b * sb + h * sh + s * ss;
  }
  __device__ __forceinline__ T* out_row(int b, int h, int s) const {
    return const_cast<T*>(row(b, h, s));
  }
};

__device__ __forceinline__ float wa_f(float x) { return x; }
__device__ __forceinline__ float wa_f(bf16 x) { return __bfloat162float(x); }

// Planes a tile of T's values takes: three for f32 (hi, mid, lo), one for
// bf16 (its own hi plane).
template <typename T>
struct WaPlanes {
  static constexpr int N = sizeof(T) == 2 ? 1 : 3;
};

// A tile of 64 rows as NP bf16 planes in shared memory, depth EP (the head
// width padded to 16), rows of STRIDE bf16.
template <int EP, int NP = 3>
struct WaTile {
  static constexpr int STRIDE = EP + WA_PAD, PLANE = WA_T * STRIDE, ELEMS = NP * PLANE;
  static constexpr int BYTES = ELEMS * 2, STAGE_FLOATS = WA_T * EP;
};

// -- staging and planes ----------------------------------------------------------

// Rows s0 .. s0 + 63 of (b, h) into stg [64][EP] f32 by cp.async; rows past
// S and columns past E are zeros.
template <int EP>
__device__ __forceinline__ void stage_rows(float* stg, const Bhsd<float>& t, int b, int h,
                                           int s0, int S, int E) {
  constexpr int PR = EP / 4;             // 16-byte pieces a row
  for (int idx = threadIdx.x; idx < WA_T * PR; idx += blockDim.x) {
    const int r = idx / PR, c = (idx % PR) * 4;
    const bool ok = s0 + r < S && c < E;
    cp_async16(stg + r * EP + c, ok ? t.row(b, h, s0 + r) + c : t.p, ok);
  }
}
// Rows s0 .. s0 + 63 of a bf16 tensor by cp.async straight into the tile's
// one plane pl (rows past S and columns past E zeros): 16-byte pieces
// where cp16 (every base and stride a multiple of 8 elements; a row's last
// piece cut at E, its rest zero-filled), else 8-byte ones.
template <int EP>
__device__ __forceinline__ void stage_plane(bf16* pl, const Bhsd<bf16>& t, int b, int h, int s0,
                                            int S, int E, int cp16) {
  using P = WaTile<EP, 1>;
  if (cp16) {
    constexpr int PR = EP / 8;
    for (int idx = threadIdx.x; idx < WA_T * PR; idx += blockDim.x) {
      const int r = idx / PR, c = (idx % PR) * 8;
      const int nb = s0 + r < S ? 2 * max(0, min(8, E - c)) : 0;
      cp_async_bytes(pl + r * P::STRIDE + c, nb ? t.row(b, h, s0 + r) + c : t.p, nb);
    }
  } else {
    constexpr int PR = EP / 4;
    for (int idx = threadIdx.x; idx < WA_T * PR; idx += blockDim.x) {
      const int r = idx / PR, c = (idx % PR) * 4;
      const bool ok = s0 + r < S && c < E;
      cp_async8(pl + r * P::STRIDE + c, ok ? t.row(b, h, s0 + r) + c : t.p, ok);
    }
  }
}

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

// The staged f32 tile into its three planes.
template <int EP>
__device__ __forceinline__ void split_tile(bf16* pl, const float* stg) {
  using P = WaTile<EP>;
  constexpr int PR = EP / 4;
  for (int idx = threadIdx.x; idx < WA_T * PR; idx += blockDim.x) {
    const int r = idx / PR, c = (idx % PR) * 4;
    const float4 x = *reinterpret_cast<const float4*>(stg + r * EP + c);
    uint32_t h0, m0, l0, h1, m1, l1;
    split2(x.x, x.y, h0, m0, l0);
    split2(x.z, x.w, h1, m1, l1);
    bf16* d = pl + r * P::STRIDE + c;
    *reinterpret_cast<uint2*>(d) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(d + P::PLANE) = make_uint2(m0, m1);
    *reinterpret_cast<uint2*>(d + 2 * P::PLANE) = make_uint2(l0, l1);
  }
}

// -- fragments (mma.m16n8k16 row.col layouts) ----------------------------------

// A (16 x 16): rows row0.. of the tile, depth k0..
template <int EP, int NP>
__device__ __forceinline__ void frag_a(uint32_t (&a)[NP][4], const bf16* pl, int row0, int k0) {
  using P = WaTile<EP, NP>;
  const int lane = threadIdx.x & 31;
  const bf16* s = pl + (row0 + (lane & 15)) * P::STRIDE + k0 + (lane >> 4) * 8;
#pragma unroll
  for (int p = 0; p < NP; ++p) ldmatrix_x4(a[p], s + p * P::PLANE);
}
// B of two n-tiles (n0.. n0 + 15) at depth k0..: the tile's rows are n,
// depth along them (b[p][0..1] the first n-tile, b[p][2..3] the second)
template <int EP, int NP>
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[NP][4], const bf16* pl, int n0,
                                            int k0) {
  using P = WaTile<EP, NP>;
  const int lane = threadIdx.x & 31;
  const bf16* s =
      pl + (n0 + (lane & 7) + (lane >> 4) * 8) * P::STRIDE + k0 + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int p = 0; p < NP; ++p) ldmatrix_x4(b[p], s + p * P::PLANE);
}
// B of two n-tiles at depth k0..: the tile's rows are the depth, n along them
template <int EP, int NP>
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[NP][4], const bf16* pl, int k0,
                                            int n0) {
  using P = WaTile<EP, NP>;
  const int lane = threadIdx.x & 31;
  const bf16* s = pl + (k0 + (lane & 15)) * P::STRIDE + n0 + (lane >> 4) * 8;
#pragma unroll
  for (int p = 0; p < NP; ++p) ldmatrix_x4_trans(b[p], s + p * P::PLANE);
}
// A (16 x 16): rows m0.. of the product, depth k0..: the tile's rows are the
// depth, the product's rows along them
template <int EP, int NP>
__device__ __forceinline__ void frag_a_cols(uint32_t (&a)[NP][4], const bf16* pl, int m0,
                                            int k0) {
  using P = WaTile<EP, NP>;
  const int lane = threadIdx.x & 31;
  const bf16* s =
      pl + (k0 + (lane & 7) + (lane >> 4) * 8) * P::STRIDE + m0 + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int p = 0; p < NP; ++p) ldmatrix_x4_trans(a[p], s + p * P::PLANE);
}
// A (16 x 16) from a product's two 16 x 8 accumulator tiles (its n is this
// product's depth), split into planes
__device__ __forceinline__ void frag_a_acc(uint32_t (&a)[3][4], const float* c0,
                                           const float* c1) {
  split2(c0[0], c0[1], a[0][0], a[1][0], a[2][0]);
  split2(c0[2], c0[3], a[0][1], a[1][1], a[2][1]);
  split2(c1[0], c1[1], a[0][2], a[1][2], a[2][2]);
  split2(c1[2], c1[3], a[0][3], a[1][3], a[2][3]);
}
// acc (16 x 8) += a b at f32 grade, a of PA planes and b of PB (3: f32, 1:
// bf16), b the n-tile at b[p][o..o+1]: of the six plane products whose
// terms reach 2^-16 of a product (mma6: lo.hi, hi.lo, mid.mid, mid.hi,
// hi.mid, hi.hi), those whose planes both operands hold, in that order,
// summed afresh, then one rounded f32 add (the tensor cores truncate what
// they add to a running sum).  A product left out adds exact zeros.
template <int PA, int PB>
__device__ __forceinline__ void mma_pl(float* acc, const uint32_t (&a)[PA][4],
                                       const uint32_t (&b)[PB][4], int o) {
  static_assert((PA == 1 || PA == 3) && (PB == 1 || PB == 3), "one or three planes");
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (PA == 3) mma_bf16(c, a[PA - 1], &b[0][o]);
  if constexpr (PB == 3) mma_bf16(c, a[0], &b[PB - 1][o]);
  if constexpr (PA == 3 && PB == 3) mma_bf16(c, a[1], &b[1][o]);
  if constexpr (PA == 3) mma_bf16(c, a[PA - 2], &b[0][o]);
  if constexpr (PB == 3) mma_bf16(c, a[0], &b[PB - 2][o]);
  mma_bf16(c, a[0], &b[0][o]);
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
// c (16 x 16 NP2) = A B^T over depth EP: A's rows row0.. of ta, B's rows
// n0 .. n0 + 16 NP2 - 1 of tb, both tiles of NP planes
template <int EP, int NP, int NP2>
__device__ __forceinline__ void tile_scores(float (&c)[2 * NP2][4], const bf16* ta, int row0,
                                            const bf16* tb, int n0) {
  zero(c);
#pragma unroll
  for (int ks = 0; ks < EP / 16; ++ks) {
    uint32_t a[NP][4];
    frag_a<EP>(a, ta, row0, ks * 16);
#pragma unroll
    for (int np = 0; np < NP2; ++np) {
      uint32_t b[NP][4];
      frag_b_rows<EP>(b, tb, n0 + np * 16, ks * 16);
      mma_pl(c[2 * np], a, b, 0);
      mma_pl(c[2 * np + 1], a, b, 2);
    }
  }
}
// acc (16 x EP) += X tb[k0 .. k0 + 16 KP - 1], X (16 x 16 KP) in
// accumulators, tb of NP planes
template <int EP, int NP, int KP>
__device__ __forceinline__ void tile_apply(float (&acc)[EP / 8][4], const float (&x)[2 * KP][4],
                                           const bf16* tb, int k0) {
#pragma unroll
  for (int kp = 0; kp < KP; ++kp) {
    uint32_t a[3][4];
    frag_a_acc(a, x[2 * kp], x[2 * kp + 1]);
#pragma unroll
    for (int np = 0; np < EP / 16; ++np) {
      uint32_t b[NP][4];
      frag_b_cols<EP>(b, tb, k0 + kp * 16, np * 16);
      mma_pl(acc[2 * np], a, b, 0);
      mma_pl(acc[2 * np + 1], a, b, 2);
    }
  }
}
// The backward's warp pairs: warps w and w + 4 share a 16-row group of the
// block's own tile, each taking 32 of the other tile's 64 rows; the second
// warp's sums go through `red` to the first, which adds them (a fixed
// order) and writes the rows.
template <int EP>
__device__ __forceinline__ void pair_sum(float (&acc)[EP / 8][4], float* red, int half) {
  const int i = (threadIdx.x & 127) * (EP / 2);
  if (half == 1)
#pragma unroll
    for (int n = 0; n < EP / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) red[i + 4 * n + q] = acc[n][q];
  __syncthreads();
  if (half == 0)
#pragma unroll
    for (int n = 0; n < EP / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[n][q] += red[i + 4 * n + q];
}

// max / sum over the quad of lanes that share an accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ bool in_band(int qp, int kp, int S, int w) {
  return qp < S && kp < S && abs(qp - kp) <= w;
}

// Keep flags of keys k0 .. k0 + 63 (0 past S).
__device__ __forceinline__ void load_keep(const float* mask, int b, int k0, int S, float* km) {
  for (int j = threadIdx.x; j < WA_T; j += blockDim.x)
    km[j] = k0 + j < S ? mask[(size_t)b * S + k0 + j] : 0.f;
}

// (m, log l, D) of query rows q0 .. q0 + 63 into rm, rl, rd (0 past S); rd
// from rowdot when it is given.
__device__ __forceinline__ void load_rows(const float* stats, const float* rowdot,
                                          size_t n_rows, int bh, int q0, int S, float* rm,
                                          float* rl, float* rd) {
  for (int i = threadIdx.x; i < WA_T; i += blockDim.x) {
    const bool ok = q0 + i < S;
    const size_t at = (size_t)bh * S + q0 + i;
    rm[i] = ok ? stats[at] : 0.f;
    rl[i] = ok ? stats[n_rows + at] : 0.f;
    if (rowdot != nullptr) rd[i] = ok ? rowdot[at] : 0.f;
  }
}

// P = exp((score - m) - log l) of one entry (0 outside the band) and
// whether the key is kept (only kept scores depend on q and k).
__device__ __forceinline__ float band_prob(float s, int qp, int kp, float keep, float row_m,
                                           float row_logl, int S, int w, float scale,
                                           bool& kept) {
  kept = false;
  if (!in_band(qp, kp, S, w)) return 0.f;
  kept = keep > 0.f;
  return expf(((kept ? s * scale : WA_NEG) - row_m) - row_logl);
}

// Blocks an SM each kernel is compiled for, by tensor type (bf16 tiles
// take a third of the shared memory).
template <typename T>
struct WaBlocks {
  static constexpr bool one = WaPlanes<T>::N == 1;
  static constexpr int FWD = one ? 3 : 2, DKV = one ? 2 : 1, DQ = one ? 3 : 2;
};

// -- forward -----------------------------------------------------------------------

template <int EP, typename T>
__global__ void __launch_bounds__(WA_THREADS, WaBlocks<T>::FWD)
wa_fwd_kernel(Bhsd<T> q, Bhsd<T> k, Bhsd<T> v, const float* __restrict__ mask, Bhsd<T> o,
              float* __restrict__ stats, int H, int S, int E, int w, float scale, int cp16) {
  constexpr int NP = WaPlanes<T>::N;
  using P = WaTile<EP, NP>;
  extern __shared__ __align__(16) unsigned char wa_smem[];
  // f32: the k and v planes, then their f32 staging area [2][64][EP];
  // bf16: two buffers of each plane, the next tile's copy in the other
  bf16* kpl = reinterpret_cast<bf16*>(wa_smem);
  bf16* vpl = kpl + (NP == 1 ? 2 : 1) * P::ELEMS;
  float* stg = reinterpret_cast<float*>(vpl + (NP == 1 ? 2 : 1) * P::ELEMS);
  float* km = NP == 1 ? stg : stg + 2 * P::STAGE_FLOATS;    // [64]
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * WA_T;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t2 = (lane & 3) * 2;

  // q's planes, through the k planes, into registers for the whole walk
  uint32_t qa[EP / 16][NP][4];
  if constexpr (NP == 1) {
    stage_plane<EP>(kpl + P::ELEMS, q, b, h, q0, S, E, cp16);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < EP / 16; ++ks) frag_a<EP>(qa[ks], kpl + P::ELEMS, r0, ks * 16);
  } else {
    stage_rows<EP>(stg, q, b, h, q0, S, E);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    split_tile<EP>(kpl, stg);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < EP / 16; ++ks) frag_a<EP>(qa[ks], kpl, r0, ks * 16);
  }

  const int kt0 = max(0, q0 - w) / WA_T, kt1 = min(S - 1, q0 + WA_T - 1 + w) / WA_T;
  if constexpr (NP == 1) {
    stage_plane<EP>(kpl, k, b, h, kt0 * WA_T, S, E, cp16);
    stage_plane<EP>(vpl, v, b, h, kt0 * WA_T, S, E, cp16);
  } else {
    stage_rows<EP>(stg, k, b, h, kt0 * WA_T, S, E);
    stage_rows<EP>(stg + P::STAGE_FLOATS, v, b, h, kt0 * WA_T, S, E);
  }
  cp_async_commit();
  float m[2] = {WA_FLOOR, WA_FLOOR}, l[2] = {0.f, 0.f}, acc[EP / 8][4];
  zero(acc);
  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k0 = kt * WA_T, buf = NP == 1 ? (kt - kt0) & 1 : 0;
    const bf16* kt_pl = kpl + buf * P::ELEMS;
    const bf16* vt_pl = vpl + buf * P::ELEMS;
    cp_async_wait<0>();
    __syncthreads();                   // the tile landed; the last tile's readers are done
    if constexpr (NP == 3) {
      split_tile<EP>(kpl, stg);
      split_tile<EP>(vpl, stg + P::STAGE_FLOATS);
    }
    load_keep(mask, b, k0, S, km);
    __syncthreads();
    if (kt < kt1) {                    // the next tile's copy runs under this one's products
      if constexpr (NP == 1) {
        stage_plane<EP>(kpl + (buf ^ 1) * P::ELEMS, k, b, h, k0 + WA_T, S, E, cp16);
        stage_plane<EP>(vpl + (buf ^ 1) * P::ELEMS, v, b, h, k0 + WA_T, S, E, cp16);
      } else {
        stage_rows<EP>(stg, k, b, h, k0 + WA_T, S, E);
        stage_rows<EP>(stg + P::STAGE_FLOATS, v, b, h, k0 + WA_T, S, E);
      }
    }
    cp_async_commit();
    float s[8][4];
    zero(s);
#pragma unroll
    for (int ks = 0; ks < EP / 16; ++ks)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[NP][4];
        frag_b_rows<EP>(bk, kt_pl, np * 16, ks * 16);
        mma_pl(s[2 * np], qa[ks], bk, 0);
        mma_pl(s[2 * np + 1], qa[ks], bk, 2);
      }
    float mt[2] = {WA_FLOOR, WA_FLOOR};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1, col = j * 8 + t2 + (e & 1);
        if (in_band(q0 + r0 + g + 8 * rr, k0 + col, S, w)) {
          s[j][e] = km[col] > 0.f ? s[j][e] * scale : WA_NEG;
          mt[rr] = fmaxf(mt[rr], s[j][e]);
        } else {
          s[j][e] = -INFINITY;         // not in the row's softmax
        }
      }
    float alpha[2], mn[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mn[rr] = fmaxf(m[rr], quad_max(mt[rr]));
      alpha[rr] = expf(m[rr] - mn[rr]);
      m[rr] = mn[rr];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const float p = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - mn[rr]);
        s[j][e] = p;
        ps[rr] += p;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + quad_sum(ps[rr]);
#pragma unroll
    for (int n = 0; n < EP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    tile_apply<EP, NP, 4>(acc, s, vt_pl, 0);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qp = q0 + r0 + g + 8 * rr;
    if (qp >= S) continue;
    const float inv = 1.f / l[rr];
    T* orow = o.out_row(b, h, qp);
#pragma unroll
    for (int n = 0; n < EP / 8; ++n) {
      const int col = n * 8 + t2;
      if (col < E) st2(orow + col, acc[n][2 * rr] * inv, acc[n][2 * rr + 1] * inv);
    }
    if (t2 == 0) {                     // (m, log l): rows of stats[0] and stats[1]
      stats[(size_t)bh * S + qp] = m[rr];
      stats[(size_t)gridDim.y * S + (size_t)bh * S + qp] = logf(l[rr]);
    }
  }
}

// -- backward ----------------------------------------------------------------------

// Key tile kt meets the query tiles from wa_first_tile(kt) on (at most
// wa_slots of them); its dS^T share of query tile qt is the 64 x 64 f32 slot
// [key][query] at (bh, kt, qt - wa_first_tile(kt)) of the scratch.
__host__ __device__ __forceinline__ int wa_first_tile(int t, int w) {
  return max(0, t * WA_T - w) / WA_T;
}
__host__ __device__ __forceinline__ int wa_slots(int w) { return (2 * w + WA_T - 1) / WA_T + 2; }
template <typename T>
__device__ __forceinline__ T* wa_slot(T* dss, int bh, int n_tiles, int kt, int j, int w) {
  return dss + (((size_t)bh * n_tiles + kt) * wa_slots(w) + j) * (WA_T * WA_T);
}

// D = rowsum(dO * O), a warp a row of the B H S rows, in f32 from the
// stored O.
template <typename T>
__global__ void wa_rowdot_kernel(Bhsd<T> o, Bhsd<T> dout, float* __restrict__ rowdot, int H,
                                 int S, int E, int rows) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int bh = r / S, i = r % S, b = bh / H, h = bh % H;
  const T* gr = dout.row(b, h, i);
  const T* orow = o.row(b, h, i);
  float d = 0.f;
  for (int f = lane; f < E; f += 32) d = fmaf(wa_f(gr[f]), wa_f(orow[f]), d);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  if (lane == 0) rowdot[r] = d;
}

// Per query tile, after wa_dkv_kernel: dq = scale * sum over its key tiles,
// in order, of dS k, dS read from the key tiles' slots (f32: three planes;
// k one plane at bf16, two buffers).
template <int EP, typename T>
__global__ void __launch_bounds__(WA_THREADS, WaBlocks<T>::DQ)
wa_dq_kernel(Bhsd<T> k, const float* __restrict__ dss, Bhsd<T> dq, int H, int S, int E, int w,
             float scale, int cp16) {
  constexpr int NP = WaPlanes<T>::N;
  using P = WaTile<EP, NP>;
  using PS = WaTile<WA_T>;                 // a dS^T slot: 64 keys x 64 queries
  extern __shared__ __align__(16) unsigned char wa_smem[];
  bf16* kpl = reinterpret_cast<bf16*>(wa_smem);             // f32 one tile, bf16 two
  bf16* dspl = kpl + (NP == 1 ? 2 : 1) * P::ELEMS;
  float* stg = reinterpret_cast<float*>(dspl + PS::ELEMS);   // f32: k [64][EP]
  float* sstg = stg + (NP == 1 ? 0 : P::STAGE_FLOATS);       // dS^T [64][64]
  const int bh = blockIdx.y, b = bh / H, h = bh % H, qt = blockIdx.x, q0 = qt * WA_T;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int kt0 = max(0, q0 - w) / WA_T, kt1 = min(S - 1, q0 + WA_T - 1 + w) / WA_T;
  auto stage = [&](int kt) {
    if constexpr (NP == 1) {
      stage_plane<EP>(kpl + ((kt - kt0) & 1) * P::ELEMS, k, b, h, kt * WA_T, S, E, cp16);
    } else {
      stage_rows<EP>(stg, k, b, h, kt * WA_T, S, E);
    }
    const float* sl = wa_slot(dss, bh, gridDim.x, kt, qt - wa_first_tile(kt, w), w);
    for (int idx = threadIdx.x; idx < WA_T * WA_T / 4; idx += blockDim.x)
      cp_async16(sstg + 4 * idx, sl + 4 * idx, true);
  };
  stage(kt0);
  cp_async_commit();
  float acc[EP / 8][4];
  zero(acc);
  for (int kt = kt0; kt <= kt1; ++kt) {
    const bf16* kt_pl = kpl + (NP == 1 ? ((kt - kt0) & 1) * P::ELEMS : 0);
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (NP == 3) split_tile<EP>(kpl, stg);
    split_tile<WA_T>(dspl, sstg);
    __syncthreads();
    if (kt < kt1) stage(kt + 1);
    cp_async_commit();
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {       // dq += dS k over the tile's 64 keys
      uint32_t a[3][4];
      frag_a_cols<WA_T>(a, dspl, r0, kp * 16);
#pragma unroll
      for (int np = 0; np < EP / 16; ++np) {
        uint32_t bk[NP][4];
        frag_b_cols<EP>(bk, kt_pl, kp * 16, np * 16);
        mma_pl(acc[2 * np], a, bk, 0);
        mma_pl(acc[2 * np + 1], a, bk, 2);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qp = q0 + r0 + g + 8 * rr;
    if (qp >= S) continue;
    T* drow = dq.out_row(b, h, qp);
#pragma unroll
    for (int n = 0; n < EP / 8; ++n) {
      const int col = n * 8 + t2;
      if (col < E) st2(drow + col, acc[n][2 * rr] * scale, acc[n][2 * rr + 1] * scale);
    }
  }
}

// Per key tile: the accumulators' rows are keys (j), their columns queries
// (i).  f32: k, v, q, dO as three planes each, the next q / dO staged f32;
// bf16: k and v one plane each, q and dO one plane in each of two buffers.
template <int EP, typename T>
__global__ void __launch_bounds__(WA_BWD_THREADS, WaBlocks<T>::DKV)
wa_dkv_kernel(Bhsd<T> q, Bhsd<T> k, Bhsd<T> v, const float* __restrict__ mask, Bhsd<T> dout,
              const float* __restrict__ stats, const float* __restrict__ rowdot, Bhsd<T> dk,
              Bhsd<T> dv, float* __restrict__ dss, int H, int S, int E, int w, float scale,
              int cp16) {
  constexpr int NP = WaPlanes<T>::N;
  using P = WaTile<EP, NP>;
  extern __shared__ __align__(16) unsigned char wa_smem[];
  bf16* kpl = reinterpret_cast<bf16*>(wa_smem);
  bf16* vpl = kpl + P::ELEMS;
  bf16* qpl = vpl + P::ELEMS;                        // bf16: two buffers of q, then of dO
  bf16* dopl = qpl + (NP == 1 ? 2 : 1) * P::ELEMS;
  float* stg = reinterpret_cast<float*>(dopl + (NP == 1 ? 2 : 1) * P::ELEMS);  // f32: [2][64][EP]
  float* km = NP == 1 ? stg : stg + 2 * P::STAGE_FLOATS;  // [64]: the block's keys
  float* rm = km + WA_T;               // [64]: m, log l and D of the query tile's rows
  float* rl = rm + WA_T;
  float* rd = rl + WA_T;
  // after the walk: the warp pairs' sums (bf16: over the q and dO buffers)
  float* red = NP == 1 ? reinterpret_cast<float*>(qpl) : stg;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * WA_T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (warp & 3) * 16, half = warp >> 2, c0 = half * 32;   // keys; queries c0..
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int qt0 = max(0, k0 - w) / WA_T, qt1 = min(S - 1, k0 + WA_T - 1 + w) / WA_T;

  if constexpr (NP == 1) {
    stage_plane<EP>(kpl, k, b, h, k0, S, E, cp16);
    stage_plane<EP>(vpl, v, b, h, k0, S, E, cp16);
    stage_plane<EP>(qpl, q, b, h, qt0 * WA_T, S, E, cp16);
    stage_plane<EP>(dopl, dout, b, h, qt0 * WA_T, S, E, cp16);
    cp_async_commit();
    load_keep(mask, b, k0, S, km);
  } else {
    stage_rows<EP>(stg, k, b, h, k0, S, E);
    stage_rows<EP>(stg + P::STAGE_FLOATS, v, b, h, k0, S, E);
    cp_async_commit();
    load_keep(mask, b, k0, S, km);
    cp_async_wait<0>();
    __syncthreads();
    split_tile<EP>(kpl, stg);
    split_tile<EP>(vpl, stg + P::STAGE_FLOATS);
    __syncthreads();
    stage_rows<EP>(stg, q, b, h, qt0 * WA_T, S, E);
    stage_rows<EP>(stg + P::STAGE_FLOATS, dout, b, h, qt0 * WA_T, S, E);
    cp_async_commit();
  }
  float dka[EP / 8][4], dva[EP / 8][4];
  zero(dka);
  zero(dva);
  for (int qt = qt0; qt <= qt1; ++qt) {
    const int q0 = qt * WA_T, buf = NP == 1 ? (qt - qt0) & 1 : 0;
    const bf16* qt_pl = qpl + buf * P::ELEMS;
    const bf16* dt_pl = dopl + buf * P::ELEMS;
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (NP == 3) {
      split_tile<EP>(qpl, stg);
      split_tile<EP>(dopl, stg + P::STAGE_FLOATS);
    }
    load_rows(stats, rowdot, (size_t)gridDim.y * S, bh, q0, S, rm, rl, rd);
    __syncthreads();
    if (qt < qt1) {
      if constexpr (NP == 1) {
        stage_plane<EP>(qpl + (buf ^ 1) * P::ELEMS, q, b, h, q0 + WA_T, S, E, cp16);
        stage_plane<EP>(dopl + (buf ^ 1) * P::ELEMS, dout, b, h, q0 + WA_T, S, E, cp16);
      } else {
        stage_rows<EP>(stg, q, b, h, q0 + WA_T, S, E);
        stage_rows<EP>(stg + P::STAGE_FLOATS, dout, b, h, q0 + WA_T, S, E);
      }
    }
    cp_async_commit();
    float st[4][4], dpt[4][4];
    tile_scores<EP, NP, 2>(st, kpl, r0, qt_pl, c0);        // S^T[j][i]
    tile_scores<EP, NP, 2>(dpt, vpl, r0, dt_pl, c0);       // dP^T[j][i]
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = r0 + g + 8 * (e >> 1), i = c0 + jj * 8 + t2 + (e & 1);
        bool kept;
        const float p = band_prob(st[jj][e], q0 + i, k0 + key, km[key], rm[i], rl[i], S, w,
                                  scale, kept);
        st[jj][e] = p;                                        // P^T
        dpt[jj][e] = kept ? p * (dpt[jj][e] - rd[i]) : 0.f;   // dS^T
      }
    float* sl = wa_slot(dss, bh, gridDim.x, blockIdx.x, qt - qt0, w);   // for the dq pass
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<float2*>(sl + (r0 + g + 8 * rr) * WA_T + c0 + jj * 8 + t2) =
            make_float2(dpt[jj][2 * rr], dpt[jj][2 * rr + 1]);
    tile_apply<EP, NP, 2>(dva, st, dt_pl, c0);
    tile_apply<EP, NP, 2>(dka, dpt, qt_pl, c0);
  }
  cp_async_wait<0>();
  __syncthreads();
  pair_sum<EP>(dva, red, half);
  pair_sum<EP>(dka, red + WA_T * EP, half);
  if (half == 1) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kp = k0 + r0 + g + 8 * rr;
    if (kp >= S) continue;
    T* krow = dk.out_row(b, h, kp);
    T* vrow = dv.out_row(b, h, kp);
#pragma unroll
    for (int n = 0; n < EP / 8; ++n) {
      const int col = n * 8 + t2;
      if (col >= E) continue;
      st2(krow + col, dka[n][2 * rr] * scale, dka[n][2 * rr + 1] * scale);
      st2(vrow + col, dva[n][2 * rr], dva[n][2 * rr + 1]);
    }
  }
}

// Shared memory of each kernel at depth EP for T's tiles: f32, each tile's
// planes and two staged f32 tiles; bf16, two buffers of each plane that
// changes along the walk; and the rows' small vectors.
template <int EP, typename T>
struct WaSmem {
  static constexpr bool one = WaPlanes<T>::N == 1;
  using P = WaTile<EP, WaPlanes<T>::N>;
  static constexpr int STAGES = one ? 0 : 2 * P::STAGE_FLOATS * 4;
  static constexpr int FWD = (one ? 4 : 2) * P::BYTES + STAGES + WA_T * 4;
  static constexpr int DKV = (one ? 6 : 4) * P::BYTES + STAGES + 4 * WA_T * 4;
  static constexpr int DQ = (one ? 2 : 1) * P::BYTES + WaTile<WA_T>::BYTES +
                            ((one ? 0 : P::STAGE_FLOATS) + WA_T * WA_T) * 4;
  // the dk / dv pass's pair sums fit where bf16 keeps its q and dO buffers
  static_assert(!one || 4 * P::BYTES >= 2 * WA_T * EP * 4, "pair sums");
};

template <typename T>
inline Bhsd<T> tensor(const void* p, const long long* st) {
  return Bhsd<T>{(const T*)p, st[0], st[1], st[2]};
}

inline bool shape_ok(int B, int H, int S, int E, int w) {
  return B > 0 && H > 0 && S > 0 && w > 0 && E > 0 && E % 4 == 0 && E <= WA_MAX_E;
}

template <int EP, typename T>
int fwd_launch(const Bhsd<T>& q, const Bhsd<T>& k, const Bhsd<T>& v, const float* mask,
               const Bhsd<T>& o, float* stats, int B, int H, int S, int E, int w, float scale,
               cudaStream_t st) {
  constexpr int smem = WaSmem<EP, T>::FWD;
  const cudaError_t e = cudaFuncSetAttribute(wa_fwd_kernel<EP, T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int cp16 = copies16(q, B, H, S) && copies16(k, B, H, S) && copies16(v, B, H, S);
  const dim3 grid((S + WA_T - 1) / WA_T, B * H);
  wa_fwd_kernel<EP, T><<<grid, WA_THREADS, smem, st>>>(q, k, v, mask, o, stats, H, S, E, w,
                                                       scale, cp16);
  RLMG_CHECK();
  return 0;
}

template <int EP, typename T>
int bwd_launch(const Bhsd<T>& q, const Bhsd<T>& k, const Bhsd<T>& v, const float* mask,
               const Bhsd<T>& o, const Bhsd<T>& dout, const float* stats, float* rowdot,
               float* dss, const Bhsd<T>& dq, const Bhsd<T>& dk, const Bhsd<T>& dv, int B, int H,
               int S, int E, int w, float scale, cudaStream_t st) {
  constexpr int s_dkv = WaSmem<EP, T>::DKV, s_dq = WaSmem<EP, T>::DQ;
  cudaError_t e = cudaFuncSetAttribute(wa_dkv_kernel<EP, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, s_dkv);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wa_dq_kernel<EP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             s_dq);
  if (e != cudaSuccess) return (int)e;
  const int cp16 = copies16(q, B, H, S) && copies16(k, B, H, S) && copies16(v, B, H, S) &&
                   copies16(dout, B, H, S);
  const int rows = B * H * S;
  wa_rowdot_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(o, dout, rowdot, H, S, E, rows);
  RLMG_CHECK();
  const dim3 grid((S + WA_T - 1) / WA_T, B * H);
  wa_dkv_kernel<EP, T><<<grid, WA_BWD_THREADS, s_dkv, st>>>(q, k, v, mask, dout, stats, rowdot,
                                                            dk, dv, dss, H, S, E, w, scale,
                                                            cp16);
  RLMG_CHECK();
  wa_dq_kernel<EP, T><<<grid, WA_THREADS, s_dq, st>>>(k, dss, dq, H, S, E, w, scale, cp16);
  RLMG_CHECK();
  return 0;
}

// A forward or backward call at the head width's compiled depth.
template <typename T>
int window_fwd(const void* q, const void* k, const void* v, const float* mask, void* out,
               float* stats, const long long* strides, int B, int H, int S, int E, int w,
               float scale, cudaStream_t st) {
  const Bhsd<T> tq = tensor<T>(q, strides), tk = tensor<T>(k, strides + 3),
                tv = tensor<T>(v, strides + 6), to = tensor<T>(out, strides + 9);
  switch ((E + 15) / 16) {
    case 1: return fwd_launch<16, T>(tq, tk, tv, mask, to, stats, B, H, S, E, w, scale, st);
    case 2: return fwd_launch<32, T>(tq, tk, tv, mask, to, stats, B, H, S, E, w, scale, st);
    case 3: return fwd_launch<48, T>(tq, tk, tv, mask, to, stats, B, H, S, E, w, scale, st);
    default: return fwd_launch<64, T>(tq, tk, tv, mask, to, stats, B, H, S, E, w, scale, st);
  }
}

template <typename T>
int window_bwd(const void* q, const void* k, const void* v, const float* mask, const void* out,
               const void* dout, const float* stats, float* rowdot, float* dss, void* dq,
               void* dk, void* dv, const long long* strides, int B, int H, int S, int E, int w,
               float scale, cudaStream_t st) {
  const Bhsd<T> tq = tensor<T>(q, strides), tk = tensor<T>(k, strides + 3),
                tv = tensor<T>(v, strides + 6), to = tensor<T>(out, strides + 9),
                tdo = tensor<T>(dout, strides + 12), tdq = tensor<T>(dq, strides + 15),
                tdk = tensor<T>(dk, strides + 18), tdv = tensor<T>(dv, strides + 21);
#define RLMG_WA_BWD(EP) \
  bwd_launch<EP, T>(tq, tk, tv, mask, to, tdo, stats, rowdot, dss, tdq, tdk, tdv, B, H, S, E, w, \
                    scale, st)
  switch ((E + 15) / 16) {
    case 1: return RLMG_WA_BWD(16);
    case 2: return RLMG_WA_BWD(32);
    case 3: return RLMG_WA_BWD(48);
    default: return RLMG_WA_BWD(64);
  }
#undef RLMG_WA_BWD
}

}  // namespace rlmg

extern "C" {

// out (B, H, S, E) of q, k, v and mask, and stats (2, B, H, S) contiguous
// f32: each row's max score m and log l (LSE = m + log l).  q, k, v, out
// f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); strides: (batch, head, row) of
// q, k, v, out, in elements; w the one-sided window; scale = 1 / sqrt(E).
// Returns 0 or the first CUDA error code.
int rlmg_window_attn_fwd(const void* q, const void* k, const void* v, const float* mask,
                         void* out, float* stats, const long long* strides, int B, int H,
                         int S, int E, int w, float scale, int is_bf16, void* stream) {
  using namespace rlmg;
  if (!shape_ok(B, H, S, E, w)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return window_fwd<bf16>(q, k, v, mask, out, stats, strides, B, H, S, E, w, scale, st);
  return window_fwd<float>(q, k, v, mask, out, stats, strides, B, H, S, E, w, scale, st);
}

// f32 values of the backward's dS scratch at this shape (one 64 x 64 slot
// for each key tile and query tile of the band).
long long rlmg_window_attn_scratch_floats(int B, int H, int S, int w) {
  using namespace rlmg;
  return (long long)B * H * ((S + WA_T - 1) / WA_T) * wa_slots(w) * WA_T * WA_T;
}

// dq, dk, dv of the upstream gradient dout, from the forward's out and
// stats, all but the f32 scratch in the forward's type.  rowdot: (B, H,
// S) f32 scratch for D = rowsum(dout * out); dss:
// rlmg_window_attn_scratch_floats f32 for dS.  strides: q, k, v, out,
// dout, dq, dk, dv.
int rlmg_window_attn_bwd(const void* q, const void* k, const void* v, const float* mask,
                         const void* out, const void* dout, const float* stats, float* rowdot,
                         float* dss, void* dq, void* dk, void* dv, const long long* strides,
                         int B, int H, int S, int E, int w, float scale, int is_bf16,
                         void* stream) {
  using namespace rlmg;
  if (!shape_ok(B, H, S, E, w)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return window_bwd<bf16>(q, k, v, mask, out, dout, stats, rowdot, dss, dq, dk, dv, strides,
                            B, H, S, E, w, scale, st);
  return window_bwd<float>(q, k, v, mask, out, dout, stats, rowdot, dss, dq, dk, dv, strides,
                           B, H, S, E, w, scale, st);
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
