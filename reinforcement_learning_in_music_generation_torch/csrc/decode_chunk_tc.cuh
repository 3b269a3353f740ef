// Kernel B: one decode token of the layer stack, the embedding and the
// heads + sampling pass, with every product on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, f32 sums), at JAX v6's arithmetic for
// either weight type.  v6 casts each product's input activations to the
// weights' type and sums in f32
// (reinforcement_learning_in_music_generation_tpu/ops/decode_kernel_v6.py
// :255 qkv, :286 Wo, :292 FFN1, :296 FFN2, :331 the heads):
//   bf16 weights (generate's default): each product's input rounded to
//     bf16, one bf16 product (PL = 1 plane an operand);
//   f32 weights: the cast is a no-op, so each product is taken at f32
//     grade: both operands split into three bf16 planes (x = hi + mid +
//     lo, the 24 bits of an f32 value) and the six plane products whose
//     terms reach 2^-16 of a product, each depth of 16 summed afresh and
//     added to the running sum in f32 (train_gemm_tc.cuh's arithmetic for
//     kernels D and G; PL = 3).
// The weights' planes are packed once by the wrapper
// (ops/decode_kernel_v6.py make_v6_params), rows padded to a multiple of 8
// with zeros; the passes that produce a later product's operand write its
// planes (one bf16 copy or three planes).  Plain C interface; no PyTorch
// headers.
//
// Per token, kernels in this order (tc_enqueue_token):
//   tc_embed_kernel   h = sum_f M[off_f + tok_f] + b_in + pe[pos] (f32) and
//                     its planes, one block per song
//   per layer:
//   tc_gemm_kernel    qkv partial sums = h @ Wqkv, split along K
//   tc_attn_kernel    one block per (song, head): sums the qkv partials (+ b,
//                     phi on q and k), S += phi(k) v^T, z += phi(k), att =
//                     phi(q)^T S / (phi(q).z + eps) stored as planes; S and z
//                     read and written once with 16-byte accesses (head
//                     widths 16, 32, 64, 128; others: tc_attn_any_kernel)
//   tc_gemm_kernel    Wo partial sums = att @ Wo
//   tc_ln_kernel      h1 = LN1(h + (sum of partials + bo)), f32 and planes
//   tc_gemm_kernel    y1 = gelu_exact(h1 @ W1 + b1) as planes, not split
//   tc_gemm_kernel    FFN2 partial sums = y1 @ W2
//   tc_ln_kernel      h = LN2(h1 + (sum + b2)), f32 and planes; after the
//                     last layer also the final LN, as planes for the heads
//   tc_gemm_kernel    logit partial sums = LN_f(h) @ W_heads
//   tc_sample_kernel  one block per (song, field): sums the partials, + head
//                     bias, temperature, sample_logit (decode_sample.cuh)
// The position, the token row, the seed and the sampling settings come
// from a block on the card (TcCtrl: written by a small kernel at the start
// of each call, its counter advanced by the last LN2), so one shape's
// token kernels are captured once as a CUDA graph that serves every call,
// launched T times a call (decode_chunk.cu rlmg_decode_chunk_tc).  Each
// kernel is launched as a programmatic dependent of the one before it
// (griddep_wait below).
//
// The products (tc_gemm_kernel): mma.sync.m16n8k16 bf16 -> f32 from
// ldmatrix fragments, operand tiles of 32 along K staged through shared
// memory by cp.async in a ring of stages (each stage holds every plane).
// Below 256 songs each weight element serves only B rows, under the card's
// ridge: the products stream weights, in 64 x 32 tiles (4 warps of 16
// rows), each product split along K until about two blocks per SM are in
// flight.  From 256 songs on, 128 x 128 tiles (8 warps of 64 x 32) cut the
// operands' re-reads from L2.  The split's partial sums are added in a
// fixed order by the pass that reads them (attn, LN, sample), so every
// result is bit-reproducible and a chunk split into two calls gives the
// same tokens.  FFN1 is not split: its gelu needs the whole sum.  Operand
// rows are padded to a multiple of 8 values (16 bytes); the copies fill
// what lies past K or N with zeros, so with f32 weights any d_model and
// d_inner go in (bf16 weights are read in place and need multiples of 8).

#pragma once

#include "decode_sample.cuh"
#include "tc_mma.cuh"

namespace rlmg {

using bf16 = __nv_bfloat16;

constexpr int TC_BK = 32;
constexpr int TC_PAD = 8;                 // bf16 per smem row, breaks ldmatrix bank conflicts
constexpr int TC_TARGET_BLOCKS = 264;     // small tiles: ~2 blocks on each of 132 SMs
constexpr int TC_SMS = 132;
constexpr int TC_MIN_KTILES = 4, TC_MAX_SPLIT = 8;
constexpr int TC_LARGE_ROWS = 256;        // batches from here on take the large tiles

// bf16 planes of a product operand with f32 weights (3), with bf16 weights (1)
template <typename TW>
__host__ __device__ constexpr int tc_planes() {
  return sizeof(TW) == 4 ? 3 : 1;
}

// Row length of an operand in memory: n values padded to a multiple of 8.
__host__ __device__ __forceinline__ int tc_ld(int n) { return (n + 7) & ~7; }

// A product operand in device memory: its planes (hi, mid, lo; only p[0]
// with one plane), row-major.
struct TcOp {
  bf16* p[3];
};

// Operand value(s) at i: one plane holds bf16(v) (v6's cast), three hold
// hi, mid, lo (each remainder is exact in f32).
template <int PL>
__device__ __forceinline__ void st_op(const TcOp& o, size_t i, float v) {
  const bf16 h = __float2bfloat16_rn(v);
  o.p[0][i] = h;
  if constexpr (PL == 1) return;
  const float r = v - __bfloat162float(h);
  const bf16 m = __float2bfloat16_rn(r);
  o.p[1][i] = m;
  o.p[2][i] = __float2bfloat16_rn(r - __bfloat162float(m));
}
// the pair (i, i + 1), i even
template <int PL>
__device__ __forceinline__ void st_op2(const TcOp& o, size_t i, float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(o.p[0] + i) = h;
  if constexpr (PL == 1) return;
  const float2 fh = __bfloat1622float2(h);
  a -= fh.x;
  b -= fh.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(o.p[1] + i) = m;
  const float2 fm = __bfloat1622float2(m);
  *reinterpret_cast<__nv_bfloat162*>(o.p[2] + i) = __floats2bfloat162_rn(a - fm.x, b - fm.y);
}

// A product tile: BM x BN outputs by WM x WN warps, each warp (BM/WM) x
// (BN/WN) in m16n8k16 pieces, K in steps of TC_BK through a ring of STAGES
// shared-memory stages (dynamic shared memory), PL planes an operand.
template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int PL_>
struct TcTile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, STAGES = STAGES_, PL = PL_;
  static constexpr int THREADS = WM * WN * 32, MT = BM / WM / 16, NT = BN / WN / 8;
  static constexpr int AS = TC_BK + TC_PAD, WS = BN + TC_PAD;   // smem row strides (bf16)
  static constexpr int A_ELEMS = BM * AS, W_ELEMS = TC_BK * WS;
  static constexpr int STAGE = PL * (A_ELEMS + W_ELEMS);          // bf16: A planes, W planes
  static constexpr int SMEM = STAGES * STAGE * 2;
  static constexpr int A_LOADS = BM * 4 / THREADS, W_LOADS = TC_BK * BN / 8 / THREADS;
  static_assert(MT >= 1 && NT % 2 == 0 && BM % (16 * WM) == 0 && BN % (16 * WN) == 0 &&
                A_LOADS * THREADS == BM * 4 && W_LOADS * THREADS == TC_BK * BN / 8, "tile");
};
// S: the weight-streaming regime (decode batches up to a few hundred
// songs): many small tiles, each product split along K to fill the card
// (two blocks an SM also with three planes).  L: larger batches, 128 x 128
// tiles, so A and W are read from L2 16 and 8 times fewer than with S.
template <int PL>
struct TcTiles;
template <>
struct TcTiles<1> {
  using S = TcTile<64, 32, 4, 1, 6, 1>;
  using L = TcTile<128, 128, 2, 4, 4, 1>;
};
template <>
struct TcTiles<3> {
  using S = TcTile<64, 32, 4, 1, 4, 3>;
  using L = TcTile<128, 128, 2, 4, 3, 3>;
};

// Programmatic dependent launch (griddep_wait, griddep_launch in
// tc_mma.cuh): every kernel of a token is launched with programmatic stream
// serialization, lets the next kernel launch as soon as all its own blocks
// run, and waits for the previous kernel's completion and memory before it
// reads anything an earlier kernel wrote or writes anything at all.  A
// kernel's launch and what it may do before the wait (the products
// prefetch their weight tiles) overlap the previous kernel's tail.  Every
// kernel waits, so completion is ordered transitively along the token.

template <typename... KArgs, typename... Args>
inline int pdl_launch(void (*kernel)(KArgs...), dim3 grid, dim3 block, size_t smem,
                      cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// sum_{z < n} p[z * stride], added in z order (n <= TC_MAX_SPLIT): the loads
// are issued together, so the K split costs one round trip, not n.
__device__ __forceinline__ float split_sum(const float* p, size_t stride, int n) {
  float v[TC_MAX_SPLIT];
#pragma unroll
  for (int zi = 0; zi < TC_MAX_SPLIT; ++zi) v[zi] = zi < n ? p[zi * stride] : 0.f;
  float acc = 0.f;
#pragma unroll
  for (int zi = 0; zi < TC_MAX_SPLIT; ++zi)
    if (zi < n) acc += v[zi];
  return acc;
}

// bytes of the 16-byte piece at index i of a row of n bf16 values
__device__ __forceinline__ int piece_bytes(int i, int n) { return max(0, min(16, 2 * (n - i))); }

enum { TC_EPI_PART = 0, TC_EPI_GELU = 1 };

// a (M,K) @ w (K,N), both row-major as T::PL bf16 planes with rows of lda
// and ldw values (multiples of 8), f32 sums, in tiles of T.  Block (bx, by,
// bz): the tile (by, bx) over K range [bz*kchunk, (bz+1)*kchunk).
// TC_EPI_PART: the raw partial sum to part[bz] (M,N) f32; TC_EPI_GELU (one
// K range): gelu_exact(sum + bias) as the planes of y (rows of ldy).  Rows
// past M, columns past N and depths past K are read as zeros and not
// stored.
template <class T, int EPI, typename TW>
__global__ void __launch_bounds__(T::THREADS)
tc_gemm_kernel(TcOp a, int lda, TcOp w, int ldw, const TW* __restrict__ bias,
               float* __restrict__ part, TcOp y, int ldy, int M, int K, int N, int kchunk) {
  constexpr int PL = T::PL;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* const sm = reinterpret_cast<bf16*>(tc_smem);     // [STAGES][A planes][W planes]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  const int nk = (ke - kb + TC_BK - 1) / TC_BK;

  auto load_a = [&](int slot, int k0) {   // BM rows x 4 pieces of 8
    bf16* s = sm + slot * T::STAGE;
#pragma unroll
    for (int i = 0; i < T::A_LOADS; ++i) {
      const int c = tid + i * T::THREADS, r = c >> 2, k = k0 + (c & 3) * 8;
      const int nb = m0 + r < M ? piece_bytes(k, ke) : 0;
      const size_t off = nb ? (size_t)(m0 + r) * lda + k : 0;
#pragma unroll
      for (int pl = 0; pl < PL; ++pl)
        cp_async_bytes(s + pl * T::A_ELEMS + r * T::AS + (c & 3) * 8, a.p[pl] + off, nb);
    }
  };
  auto load_w = [&](int slot, int k0) {   // TC_BK rows x BN/8 pieces of 8
    bf16* s = sm + slot * T::STAGE + PL * T::A_ELEMS;
#pragma unroll
    for (int i = 0; i < T::W_LOADS; ++i) {
      const int c = tid + i * T::THREADS, r = c / (T::BN / 8), cn = (c % (T::BN / 8)) * 8;
      const int k = k0 + r, n = n0 + cn;
      const int nb = k < ke ? piece_bytes(n, N) : 0;
      const size_t off = nb ? (size_t)k * ldw + n : 0;
#pragma unroll
      for (int pl = 0; pl < PL; ++pl)
        cp_async_bytes(s + pl * T::W_ELEMS + r * T::WS + cn, w.p[pl] + off, nb);
    }
  };

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the weights do not depend on earlier kernels: their first tiles are
  // in flight before the wait (they join commit group 0)
#pragma unroll
  for (int st = 0; st < T::STAGES - 1; ++st)
    if (st < nk) load_w(st, kb + st * TC_BK);
  griddep_wait();
  griddep_launch();
#pragma unroll
  for (int st = 0; st < T::STAGES - 1; ++st) {
    if (st < nk) load_a(st, kb + st * TC_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();
    const int nt = kt + T::STAGES - 1;
    if (nt < nk) {
      load_a(nt % T::STAGES, kb + nt * TC_BK);
      load_w(nt % T::STAGES, kb + nt * TC_BK);
    }
    cp_async_commit();
    const bf16* a_s = sm + (kt % T::STAGES) * T::STAGE;
    const bf16* w_s = a_s + PL * T::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t af[T::MT][PL][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int pl = 0; pl < PL; ++pl)
          ldmatrix_x4(af[i][pl], a_s + pl * T::A_ELEMS +
                                     (wm * (T::BM / T::WM) + i * 16 + (lane & 15)) * T::AS +
                                     kk + (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < T::NT / 2; ++p) {
        uint32_t bq[PL][4];
#pragma unroll
        for (int pl = 0; pl < PL; ++pl)
          ldmatrix_x4_trans(bq[pl], w_s + pl * T::W_ELEMS + (kk + (lane & 15)) * T::WS +
                                        wn * (T::BN / T::WN) + p * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < T::MT; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int o = 2 * half;
            if constexpr (PL == 1) {
              mma_bf16(acc[i][2 * p + half], af[i][0], &bq[0][o]);
            } else {
              // planes 0, 1, 2 = hi, mid, lo: a fresh sum of this depth's
              // six products, then one rounded f32 add (the tensor cores
              // truncate what they add to a running sum)
              float c[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(c, af[i][2], &bq[0][o]);
              mma_bf16(c, af[i][0], &bq[2][o]);
              mma_bf16(c, af[i][1], &bq[1][o]);
              mma_bf16(c, af[i][1], &bq[0][o]);
              mma_bf16(c, af[i][0], &bq[1][o]);
              mma_bf16(c, af[i][0], &bq[0][o]);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][2 * p + half][q] += c[q];
            }
          }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      const int n = n0 + wn * (T::BN / T::WN) + j * 8 + t2;
      if (n >= N) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + wm * (T::BM / T::WM) + i * 16 + g + hr * 8;
        if (m >= M) continue;
        const float v0 = acc[i][j][2 * hr], v1 = acc[i][j][2 * hr + 1];
        if (EPI == TC_EPI_PART) {
          float* p = part + (size_t)blockIdx.z * M * N + (size_t)m * N + n;
          if (N & 1) {                  // rows of an odd length: no 8-byte pairs
            p[0] = v0;
            if (n + 1 < N) p[1] = v1;
          } else {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          }
        } else {
          const float y0 = gelu_exact(v0 + ld(bias + n));
          const float y1 = n + 1 < N ? gelu_exact(v1 + ld(bias + n + 1)) : 0.f;
          st_op2<PL>(y, (size_t)m * ldy + n, y0, y1);   // a column past N lands in the padding
        }
      }
    }
}

// How one product runs: its tile and its K split (s ranges of kchunk, a
// multiple of TC_BK).  Large tiles from TC_LARGE_ROWS rows.
struct TcProduct {
  int s, kchunk, large;
};

inline TcProduct tc_split(int M, int K, int N, bool allow) {
  using TS = TcTiles<1>::S;
  using TL = TcTiles<1>::L;
  const int large = M >= TC_LARGE_ROWS;
  const int bm = large ? TL::BM : TS::BM, bn = large ? TL::BN : TS::BN;
  const int tiles = ((N + bn - 1) / bn) * ((M + bm - 1) / bm);
  const int ktiles = (K + TC_BK - 1) / TC_BK;
  int cap = ktiles / TC_MIN_KTILES;
  cap = cap < 1 ? 1 : (cap > TC_MAX_SPLIT ? TC_MAX_SPLIT : cap);
  // small tiles split until ~2 blocks an SM are in flight; large ones only
  // up to one wave, since their partial sums (s x B x N f32, written and
  // read again) would cost more than the idle SMs
  int s = !allow ? 1 : large ? TC_SMS / tiles : (TC_TARGET_BLOCKS + tiles - 1) / tiles;
  s = s < 1 ? 1 : (s > cap ? cap : s);
  const int kchunk = ((ktiles + s - 1) / s) * TC_BK;
  return {(K + kchunk - 1) / kchunk, kchunk, large};
}

template <class T, int EPI, typename TW>
int tc_gemm_tile(const TcOp& a, int lda, const TcOp& w, int ldw, const TW* bias, float* part,
                 const TcOp& y, int ldy, int M, int K, int N, const TcProduct& sp,
                 cudaStream_t st) {
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, sp.s);
  return pdl_launch(tc_gemm_kernel<T, EPI, TW>, grid, dim3(T::THREADS), T::SMEM, st, a, lda, w,
                    ldw, bias, part, y, ldy, M, K, N, sp.kchunk);
}

template <int EPI, typename TW>
int tc_gemm(const TcOp& a, int lda, const TcOp& w, int ldw, const TW* bias, float* part,
            const TcOp& y, int ldy, int M, int K, int N, const TcProduct& sp, cudaStream_t st) {
  using Tiles = TcTiles<tc_planes<TW>()>;
  return sp.large ? tc_gemm_tile<typename Tiles::L, EPI, TW>(a, lda, w, ldw, bias, part, y, ldy,
                                                             M, K, N, sp, st)
                  : tc_gemm_tile<typename Tiles::S, EPI, TW>(a, lda, w, ldw, bias, part, y, ldy,
                                                             M, K, N, sp, st);
}

// Shared memory above 48 KB must be granted to each product kernel once.
template <typename TW>
int tc_gemm_prepare() {
  using Tiles = TcTiles<tc_planes<TW>()>;
  using TS = typename Tiles::S;
  using TL = typename Tiles::L;
  const void* fns[4] = {(const void*)tc_gemm_kernel<TS, TC_EPI_PART, TW>,
                        (const void*)tc_gemm_kernel<TS, TC_EPI_GELU, TW>,
                        (const void*)tc_gemm_kernel<TL, TC_EPI_PART, TW>,
                        (const void*)tc_gemm_kernel<TL, TC_EPI_GELU, TW>};
  const int smem[4] = {TS::SMEM, TS::SMEM, TL::SMEM, TL::SMEM};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t e =
        cudaFuncSetAttribute(fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, smem[i]);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename TS>
struct Vec16;            // 16 bytes of state: 8 bf16 or 4 f32 values
template <>
struct Vec16<bf16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& r, float* v) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float* v) {
    uint4 r;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
};
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

// The state pass's shape at head width E: lane l of a warp owns the state
// columns u0..u0+VEC-1 (u0 = (l % UC) VEC) of the rows l / UC + RPP p, so a
// warp reads and writes S in 16-byte pieces, 512 contiguous bytes per
// instruction; the E / RPP passes of a (song, head) are shared by W warps,
// up to G pieces in flight per lane.
template <typename TS, int E>
struct AttnShape {
  static constexpr int VEC = Vec16<TS>::N, UC = E / VEC, RPP = 32 / UC, NP = E / RPP;
  static constexpr int W = NP < 4 ? NP : 4, PW = NP / W, G = PW < 8 ? PW : 8;
  static_assert(E % VEC == 0 && 32 % UC == 0 && NP % W == 0 && PW % G == 0 && E <= 32 * W,
                "head width");
};

// One block of W warps per (song b, head hh) of one layer.  qkvp: nsplit
// partial sums (B, 3D) of the qkv product; bias (3D).  num is summed over
// a lane's rows, across the lanes of its column group in a fixed shuffle
// order, then over the warps in order.  att = num / den as the planes of
// Wo's operand (rows of ldd; v6 casts att to the weights' type before Wo).
template <typename TS, int E, typename TW>
__global__ void __launch_bounds__(AttnShape<TS, E>::W * 32)
tc_attn_kernel(const float* __restrict__ qkvp, int nsplit, const TW* __restrict__ bias,
               TS* __restrict__ s, TS* __restrict__ z, TcOp att, int ldd, int B, int H,
               float eps) {
  using A = AttnShape<TS, E>;
  constexpr int VEC = A::VEC, UC = A::UC, RPP = A::RPP, W = A::W, PW = A::PW, G = A::G;
  __shared__ float qkv_s[3][E];
  __shared__ float dq[E];
  __shared__ float nump[W][E];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pair = blockIdx.x, b = pair / H, hh = pair % H, D = H * E;
  const int u0 = (lane % UC) * VEC, j0 = lane / UC;
  // The state was last written by the previous token's graph, which ended
  // before this one began (graph launches in a stream are ordered): its
  // first pieces and z are loaded before the wait, while the qkv product
  // (the previous kernel) still runs.
  TS* sp = s + (size_t)pair * E * E + u0;
  TS* zp = z + (size_t)pair * E + tid;
  const float z_old = tid < E ? ld(zp) : 0.f;
  uint4 raw[G];
#pragma unroll
  for (int q = 0; q < G; ++q)
    raw[q] = *reinterpret_cast<const uint4*>(sp + (size_t)(j0 + RPP * (warp * PW + q)) * E);
  griddep_wait();
  griddep_launch();
  const size_t ld3 = (size_t)3 * D;
  for (int i = tid; i < 3 * E; i += W * 32) {
    const int which = i / E, j = i % E, col = which * D + hh * E + j;
    const float v = split_sum(qkvp + b * ld3 + col, B * ld3, nsplit) + ld(bias + col);
    qkv_s[which][j] = which < 2 ? phi(v) : v;
  }
  __syncthreads();
  const float* qs = qkv_s[0];
  const float* ks = qkv_s[1];
  const float* vs = qkv_s[2];

  float vv[VEC], num[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    vv[i] = vs[u0 + i];
    num[i] = 0.f;
  }
#pragma unroll
  for (int p0 = 0; p0 < PW; p0 += G) {
    if (p0 > 0) {
#pragma unroll
      for (int q = 0; q < G; ++q)
        raw[q] = *reinterpret_cast<const uint4*>(
            sp + (size_t)(j0 + RPP * (warp * PW + p0 + q)) * E);
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int j = j0 + RPP * (warp * PW + p0 + q);
      const float kj = ks[j], qj = qs[j];
      float sv[VEC];
      Vec16<TS>::unpack(raw[q], sv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sv[i] = fmaf(kj, vv[i], sv[i]);
        num[i] = fmaf(qj, sv[i], num[i]);
      }
      *reinterpret_cast<uint4*>(sp + (size_t)j * E) = Vec16<TS>::pack(sv);
    }
  }
  if (tid < E) {
    const float zv = z_old + ks[tid];
    st(zp, zv);
    dq[tid] = qs[tid] * zv;
  }
#pragma unroll
  for (int off = UC; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < VEC; ++i) num[i] += __shfl_xor_sync(0xffffffffu, num[i], off);
  if (j0 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) nump[warp][u0 + i] = num[i];
  }
  __syncthreads();
  if (tid < E) {
    float d = 0.f;
    for (int j = 0; j < E; ++j) d += dq[j];
    float n = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) n += nump[w][tid];
    st_op<tc_planes<TW>()>(att, (size_t)b * ldd + hh * E + tid, n / (d + eps));
  }
}

// The state pass at the head widths tc_attn_kernel does not take (any E up
// to MAX_E): thread u of one block per (song, head) owns state column u
// and walks the rows in order, so a warp reads and writes a row's columns
// side by side.  The same products and sums as tc_attn_kernel's, in the
// same order for den; num is summed over the rows in order.
template <typename TS, typename TW>
__global__ void __launch_bounds__(MAX_E)
tc_attn_any_kernel(const float* __restrict__ qkvp, int nsplit, const TW* __restrict__ bias,
                   TS* __restrict__ s, TS* __restrict__ z, TcOp att, int ldd, int B, int H,
                   int E, float eps) {
  __shared__ float qkv_s[3][MAX_E];
  __shared__ float dq[MAX_E];
  const int u = threadIdx.x, pair = blockIdx.x, b = pair / H, hh = pair % H, D = H * E;
  griddep_wait();
  griddep_launch();
  const size_t ld3 = (size_t)3 * D;
  for (int i = u; i < 3 * E; i += blockDim.x) {
    const int which = i / E, j = i % E, col = which * D + hh * E + j;
    const float v = split_sum(qkvp + b * ld3 + col, B * ld3, nsplit) + ld(bias + col);
    qkv_s[which][j] = which < 2 ? phi(v) : v;
  }
  __syncthreads();
  float num = 0.f;
  if (u < E) {
    TS* sp = s + (size_t)pair * E * E + u;
    const float vu = qkv_s[2][u];
    for (int j = 0; j < E; ++j) {
      const float sv = fmaf(qkv_s[1][j], vu, ld(sp + (size_t)j * E));
      st(sp + (size_t)j * E, sv);
      num = fmaf(qkv_s[0][j], sv, num);
    }
    TS* zp = z + (size_t)pair * E + u;
    const float zv = ld(zp) + qkv_s[1][u];
    st(zp, zv);
    dq[u] = qkv_s[0][u] * zv;
  }
  __syncthreads();
  if (u < E) {
    float d = 0.f;
    for (int j = 0; j < E; ++j) d += dq[j];
    st_op<tc_planes<TW>()>(att, (size_t)b * ldd + hh * E + u, num / (d + eps));
  }
}

// out = LN(resid + (sum of nsplit partials + bias)) * scale + shift, f32 and
// as the planes outb (rows of ldd), one block per row; with fls != nullptr
// also LN(out) * fls + flb as the planes hfb, the final LN before the
// heads.  advance (the token counter, read by no kernel between the last
// LN2 and the sampling pass): + 1.
template <typename TW>
__global__ void __launch_bounds__(LN_THREADS)
tc_ln_kernel(const float* __restrict__ part, int nsplit, const TW* __restrict__ bias,
             const float* __restrict__ resid, const TW* __restrict__ scale,
             const TW* __restrict__ shift, float* __restrict__ out, TcOp outb, int ldd,
             const float* __restrict__ fls, const float* __restrict__ flb, TcOp hfb,
             int* __restrict__ advance, int M, int D) {
  constexpr int PL = tc_planes<TW>();
  __shared__ float xr[MAX_D];
  __shared__ float red[32];
  griddep_wait();
  griddep_launch();
  if (advance != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *advance += 1;
  const size_t base = (size_t)blockIdx.x * D, MD = (size_t)M * D;
  const size_t obase = (size_t)blockIdx.x * ldd;
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    xr[i] = resid[base + i] + (split_sum(part + base + i, MD, nsplit) + ld(bias + i));
  __syncthreads();
  ln_row(xr, D, 1e-5f, red);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = xr[i] * ld(scale + i) + ld(shift + i);
    out[base + i] = v;
    st_op<PL>(outb, obase + i, v);
    xr[i] = v;
  }
  if (fls == nullptr) return;
  __syncthreads();
  ln_row(xr, D, 1e-5f, red);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    st_op<PL>(hfb, obase + i, xr[i] * fls[i] + flb[i]);
}

template <typename TW, typename... Args>
int tc_ln(int M, int D, cudaStream_t st, Args... args) {
  return pdl_launch(tc_ln_kernel<TW>, dim3(M), dim3(LN_THREADS), 0, st, args..., M, D);
}

// A call's values on the card, written by tc_begin_kernel at the start of
// every call and read by the token graph, so that one graph serves every
// call of its shape: t0, the chunk's first position; step, the tokens
// decoded so far in this call (the last LN2 of a token adds one, so the
// sampling pass reads one more); the sampling seed and mode; the fields'
// embedding offsets, temperatures and nucleus masses.
struct TcCtrl {
  int t0, step;
  uint32_t seed;
  int greedy;
  FieldArgs fa;
};

// tokbuf (T+1, B, NF): row 0 the fed token tok0, row t+1 the token emitted
// at position t0 + t.  c: the call's values, step 0.
__global__ void tc_begin_kernel(const int* __restrict__ tok0, int* __restrict__ tokbuf,
                                TcCtrl* __restrict__ ctrl, TcCtrl c, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) tokbuf[i] = tok0[i];
  if (i == 0) *ctrl = c;
}

template <int PL>
__global__ void tc_embed_kernel(const TcCtrl* __restrict__ ctrl, const int* __restrict__ tokbuf,
                                const float* __restrict__ m, const float* __restrict__ bin,
                                const float* __restrict__ pe, float* __restrict__ h, TcOp hb,
                                int ldd, int B, int NF, int D) {
  griddep_wait();
  griddep_launch();
  const int b = blockIdx.x, step = ctrl->step, pos = ctrl->t0 + step;
  float* h_b = h + (size_t)b * D;
  embed_row(tokbuf + ((size_t)step * B + b) * NF, m, ctrl->fa, bin, pe + (size_t)pos * D, h_b,
            NF, D);
  for (int d = threadIdx.x; d < D; d += blockDim.x)   // the same thread wrote h_b[d]
    st_op<PL>(hb, (size_t)b * ldd + d, h_b[d]);
}

// One block of VF_PAD threads per (song b, field f): x = (sum of the logit
// partials + head bias) / temperature, then sample_logit.
__global__ void __launch_bounds__(VF_PAD)
tc_sample_kernel(const float* __restrict__ logp, int nsplit, const float* __restrict__ hb,
                 const TcCtrl* __restrict__ ctrl, int* __restrict__ tokbuf, int B, int NF) {
  __shared__ float red[32];
  __shared__ int redi[32];
  griddep_wait();
  griddep_launch();
  const int b = blockIdx.x / NF, f = blockIdx.x % NF, v = threadIdx.x;
  const int step = ctrl->step - 1, pos = ctrl->t0 + step;
  const int ncol = NF * VF_PAD, col = f * VF_PAD + v;
  const float acc = split_sum(logp + (size_t)b * ncol + col, (size_t)B * ncol, nsplit);
  const float x = (acc + hb[col]) * ctrl->fa.tinv[f];
  const int tok = sample_logit(x, ctrl->fa, b, f, pos, ctrl->seed, ctrl->greedy, red, redi);
  if (v == 0) tokbuf[((size_t)(step + 1) * B + b) * NF + f] = tok;
}

// The K splits of one token's products at batch B.
struct TcPlan {
  TcProduct qkv, wo, f1, f2, heads;
};

inline TcPlan tc_plan(int B, int D, int DI, int NF) {
  return {tc_split(B, D, 3 * D, true), tc_split(B, D, D, true), tc_split(B, D, DI, false),
          tc_split(B, DI, D, true), tc_split(B, D, NF * VF_PAD, true)};
}

// The token's buffers, carved from one workspace of tc_workspace_bytes:
// f32 rows of D (3D, NF VF_PAD) values, and the products' operands as PL
// planes with rows of tc_ld(D) (y1: tc_ld(DI)).
struct TcBufs {
  float *h, *h1, *qkvp, *part, *logp;   // f32: residual stream, LN1 out, partial sums
  TcOp hb, h1b, att, y1, hfb;           // the products' operands
  TcCtrl* ctrl;
};

inline size_t tc_align(size_t n) { return (n + 255) & ~(size_t)255; }

inline size_t tc_carve(char* base, int B, int D, int DI, int NF, int PL, TcBufs* o) {
  const TcPlan pl = tc_plan(B, D, DI, NF);
  const size_t bd = (size_t)B * D;
  const size_t part = (size_t)(pl.wo.s > pl.f2.s ? pl.wo.s : pl.f2.s) * bd;
  size_t off = 0;
  auto take = [&](size_t bytes) -> char* {
    char* p = base ? base + off : nullptr;
    off += tc_align(bytes);
    return p;
  };
  auto op = [&](size_t values) {
    TcOp t = {{nullptr, nullptr, nullptr}};
    for (int i = 0; i < PL; ++i) t.p[i] = (bf16*)take(2 * values);
    return t;
  };
  const size_t bdp = (size_t)B * tc_ld(D);
  o->h = (float*)take(4 * bd);
  o->h1 = (float*)take(4 * bd);
  o->qkvp = (float*)take(4 * (size_t)pl.qkv.s * 3 * bd);
  o->part = (float*)take(4 * part);
  o->logp = (float*)take(4 * (size_t)pl.heads.s * B * NF * VF_PAD);
  o->hb = op(bdp);
  o->h1b = op(bdp);
  o->att = op(bdp);
  o->y1 = op((size_t)B * tc_ld(DI));
  o->hfb = op(bdp);
  o->ctrl = (TcCtrl*)take(sizeof(TcCtrl));
  return off;
}

// The state pass takes any head width up to MAX_E.  bf16 weights are read
// in place in 16-byte pieces (d_model and d_inner multiples of 8); f32
// weights reach the products as planes the wrapper pads.
inline bool tc_shape_ok(int D, int H, int DI, int w_f32) {
  const int E = H > 0 ? D / H : 0;
  return E * H == D && E >= 1 && E <= MAX_E && D <= MAX_D && DI >= 1 &&
         (w_f32 || (D % 8 == 0 && DI % 8 == 0));
}

template <typename TS, typename TW>
int tc_attn(const float* qkvp, int nsplit, const TW* bias, TS* s, TS* z, const TcOp& att,
            int ldd, int B, int H, int E, float eps, cudaStream_t st) {
#define RLMG_TC_ATT(EV)                                                                       \
  pdl_launch(tc_attn_kernel<TS, EV, TW>, dim3(B * H), dim3(AttnShape<TS, EV>::W * 32), 0, st, \
             qkvp, nsplit, bias, s, z, att, ldd, B, H, eps)
  switch (E) {
    case 16: return RLMG_TC_ATT(16);
    case 32: return RLMG_TC_ATT(32);
    case 64: return RLMG_TC_ATT(64);
    case 128: return RLMG_TC_ATT(128);
    default:
      return pdl_launch(tc_attn_any_kernel<TS, TW>, dim3(B * H), dim3(MAX_E), 0, st, qkvp,
                        nsplit, bias, s, z, att, ldd, B, H, E, eps);
  }
#undef RLMG_TC_ATT
}

// The products' weights, in the order of TcArgs::wp.
enum { TC_QKV, TC_WO, TC_F1, TC_F2, TC_HEADS, TC_PRODUCTS };

// The arguments a token's graph holds: its shape, and the pointers that
// the per-call values (TcCtrl) do not carry.  w: the layer weights in their
// type (the products read their matrices from wp); wp: the planes of the
// products' weights (qkv (L, D, 3D), wo (L, D, D), f1 (L, D, DI), f2 (L,
// DI, D), heads (D, NF VF_PAD), rows of tc_ld of their width; bf16 weights
// are their own single plane).  Zeroed before it is filled, so it compares
// as bytes.
struct TcArgs {
  int* tokbuf;
  const float *m, *bin, *pe, *head_b, *fls, *flb;
  const void* w[N_WEIGHTS];
  const bf16* wp[TC_PRODUCTS][3];
  void *s, *z;
  char* work;
  int L, B, D, H, DI, NF, s_bf16, w_f32, dev;
  float eps;
};

inline bool tc_same_shape(const TcArgs& a, const TcArgs& b) {
  return a.dev == b.dev && a.L == b.L && a.B == b.B && a.D == b.D && a.H == b.H &&
         a.DI == b.DI && a.NF == b.NF && a.s_bf16 == b.s_bf16 && a.w_f32 == b.w_f32;
}

#define RLMG_TC_STEP(expr)       \
  do {                           \
    const int rc_ = (int)(expr); \
    if (rc_) return -rc_;        \
    ++n;                         \
  } while (0)

// Enqueue one token's kernels on st (captured into the call's graph): TS
// the state's type, TW the weights'.  Returns the number of kernels
// enqueued, or minus a CUDA error code.
template <typename TS, typename TW>
int tc_enqueue_token(const TcArgs& a, cudaStream_t st) {
  constexpr int PL = tc_planes<TW>();
  const int B = a.B, D = a.D, H = a.H, DI = a.DI, NF = a.NF, E = D / H;
  const int ldd = tc_ld(D), ldi = tc_ld(DI), ld3 = tc_ld(3 * D), ldh = tc_ld(NF * VF_PAD);
  const TcPlan pl = tc_plan(B, D, DI, NF);
  TcBufs o;
  tc_carve(a.work, B, D, DI, NF, PL, &o);
  const size_t sl = (size_t)B * H * E * E, zl = (size_t)B * H * E;
  auto W = [&](int i) { return (const TW*)a.w[i]; };
  auto wop = [&](int i, size_t off) {
    TcOp t = {{nullptr, nullptr, nullptr}};
    for (int p = 0; p < PL; ++p) t.p[p] = const_cast<bf16*>(a.wp[i][p]) + off;
    return t;
  };
  const TcOp none = {{nullptr, nullptr, nullptr}};
  const TW* no_bias = nullptr;
  int n = 0;
  RLMG_TC_STEP(pdl_launch(tc_embed_kernel<PL>, dim3(B), dim3(256), 0, st, (const TcCtrl*)o.ctrl,
                          (const int*)a.tokbuf, a.m, a.bin, a.pe, o.h, o.hb, ldd, B, NF, D));
  for (int l = 0; l < a.L; ++l) {
    const size_t d = (size_t)l * D;
    RLMG_TC_STEP(tc_gemm<TC_EPI_PART>(o.hb, ldd, wop(TC_QKV, d * ld3), ld3, no_bias, o.qkvp,
                                      none, 0, B, D, 3 * D, pl.qkv, st));
    RLMG_TC_STEP(tc_attn<TS>(o.qkvp, pl.qkv.s, W(B_QKV) + 3 * d, (TS*)a.s + l * sl,
                             (TS*)a.z + l * zl, o.att, ldd, B, H, E, a.eps, st));
    RLMG_TC_STEP(tc_gemm<TC_EPI_PART>(o.att, ldd, wop(TC_WO, d * ldd), ldd, no_bias, o.part,
                                      none, 0, B, D, D, pl.wo, st));
    RLMG_TC_STEP(tc_ln<TW>(B, D, st, (const float*)o.part, pl.wo.s, W(B_O) + d,
                           (const float*)o.h, W(LN1_S) + d, W(LN1_B) + d, o.h1, o.h1b, ldd,
                           (const float*)nullptr, (const float*)nullptr, none, (int*)nullptr));
    RLMG_TC_STEP(tc_gemm<TC_EPI_GELU>(o.h1b, ldd, wop(TC_F1, d * ldi), ldi,
                                      W(B_F1) + (size_t)l * DI, nullptr, o.y1, ldi, B, D, DI,
                                      pl.f1, st));
    RLMG_TC_STEP(tc_gemm<TC_EPI_PART>(o.y1, ldi, wop(TC_F2, (size_t)l * DI * ldd), ldd, no_bias,
                                      o.part, none, 0, B, DI, D, pl.f2, st));
    const bool last = l == a.L - 1;
    RLMG_TC_STEP(tc_ln<TW>(B, D, st, (const float*)o.part, pl.f2.s, W(B_F2) + d,
                           (const float*)o.h1, W(LN2_S) + d, W(LN2_B) + d, o.h, o.hb, ldd,
                           last ? a.fls : nullptr, a.flb, o.hfb,
                           last ? &o.ctrl->step : nullptr));
  }
  RLMG_TC_STEP(tc_gemm<TC_EPI_PART>(o.hfb, ldd, wop(TC_HEADS, 0), ldh, no_bias, o.logp, none, 0,
                                    B, D, NF * VF_PAD, pl.heads, st));
  RLMG_TC_STEP(pdl_launch(tc_sample_kernel, dim3(B * NF), dim3(VF_PAD), 0, st,
                          (const float*)o.logp, pl.heads.s, a.head_b, (const TcCtrl*)o.ctrl,
                          a.tokbuf, B, NF));
  return n;
}

#undef RLMG_TC_STEP

}  // namespace rlmg
