// Kernel B's route for bf16 weights: one decode token of the layer stack,
// the embedding and the heads + sampling pass, with every product on the
// tensor cores (bf16 inputs, f32 sums), as JAX's v6 computes them: v6
// casts each product's input activations to the weights' type
// (reinforcement_learning_in_music_generation_tpu/ops/decode_kernel_v6.py
// :255 qkv, :286 Wo, :292 FFN1, :296 FFN2, :331 the heads) and sums in f32.
// Plain C interface; no PyTorch headers.
//
// Per token, kernels in this order (tc_enqueue_token):
//   tc_embed_kernel   h = sum_f M[off_f + tok_f] + b_in + pe[pos] (f32) and
//                     its bf16 copy, one block per song
//   per layer:
//   tc_gemm_kernel    qkv partial sums = bf16(h) @ Wqkv, split along K
//   tc_attn_kernel    one block per (song, head): sums the qkv partials (+ b,
//                     phi on q and k), S += phi(k) v^T, z += phi(k), att =
//                     phi(q)^T S / (phi(q).z + eps) stored in bf16; S and z
//                     read and written once with 16-byte accesses (head
//                     widths 16, 32, 64, 128; others: tc_attn_any_kernel)
//   tc_gemm_kernel    Wo partial sums = att @ Wo
//   tc_ln_kernel      h1 = LN1(h + (sum of partials + bo)), f32 and bf16
//   tc_gemm_kernel    y1 = bf16(gelu_exact(bf16(h1) @ W1 + b1)), not split
//   tc_gemm_kernel    FFN2 partial sums = y1 @ W2
//   tc_ln_kernel      h = LN2(h1 + (sum + b2)), f32 and bf16; after the last
//                     layer also the final LN, in bf16 for the heads
//   tc_gemm_kernel    logit partial sums = bf16(LN_f(h)) @ W_heads
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
// memory by cp.async in a ring of stages.  Below 256 songs each weight
// element serves only B rows, under the card's ridge: the products stream
// weights, in 64 x 32 tiles (4 warps of 16 rows), each product split along
// K until about two blocks per SM are in flight.  From 256 songs on, 128 x
// 128 tiles (8 warps of 64 x 32) cut the operands' re-reads from L2.  The
// split's partial sums are added in a fixed order by the pass that reads
// them (attn, LN, sample), so every result is bit-reproducible and a chunk
// split into two calls gives the same tokens.  FFN1 is not split: its gelu
// needs the whole sum.

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

// A product tile: BM x BN outputs by WM x WN warps, each warp (BM/WM) x
// (BN/WN) in m16n8k16 pieces, K in steps of TC_BK through a ring of STAGES
// shared-memory stages (dynamic shared memory).
template <int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct TcTile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int THREADS = WM * WN * 32, MT = BM / WM / 16, NT = BN / WN / 8;
  static constexpr int AS = TC_BK + TC_PAD, WS = BN + TC_PAD;   // smem row strides (bf16)
  static constexpr int A_ELEMS = BM * AS, W_ELEMS = TC_BK * WS;
  static constexpr int SMEM = STAGES * (A_ELEMS + W_ELEMS) * 2;
  static constexpr int A_LOADS = BM * 4 / THREADS, W_LOADS = TC_BK * BN / 8 / THREADS;
  static_assert(MT >= 1 && NT % 2 == 0 && BM % (16 * WM) == 0 && BN % (16 * WN) == 0 &&
                A_LOADS * THREADS == BM * 4 && W_LOADS * THREADS == TC_BK * BN / 8, "tile");
};
// the weight-streaming regime (decode batches up to a few hundred songs):
// many small tiles, each product split along K to fill the card
using TileS = TcTile<64, 32, 4, 1, 6>;
// larger batches: 128 x 128 tiles, so A and W are read from L2 16 and 8
// times fewer than with TileS
using TileL = TcTile<128, 128, 2, 4, 4>;

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

enum { TC_EPI_PART = 0, TC_EPI_GELU = 1 };

// a (M,K) bf16 @ w (K,N) bf16, both row-major, f32 sums, in tiles of T.
// Block (bx, by, bz): the tile (by, bx) over K range [bz*kchunk,
// (bz+1)*kchunk).  TC_EPI_PART: the raw partial sum to part[bz] (M,N) f32;
// TC_EPI_GELU (one K range): bf16(gelu_exact(sum + bias)) to y (M,N).  Rows
// past M and columns past N are read as zeros and not stored.  Needs K, N
// multiples of 8 (16-byte rows).
template <class T, int EPI>
__global__ void __launch_bounds__(T::THREADS)
tc_gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
               const bf16* __restrict__ bias, float* __restrict__ part, bf16* __restrict__ y,
               int M, int K, int N, int kchunk) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* as = reinterpret_cast<bf16*>(tc_smem);           // [STAGES][BM][AS]
  bf16* ws = as + T::STAGES * T::A_ELEMS;                // [STAGES][TC_BK][WS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  const int nk = (ke - kb + TC_BK - 1) / TC_BK;

  auto load_a = [&](int slot, int k0) {   // BM rows x 4 chunks of 8
#pragma unroll
    for (int i = 0; i < T::A_LOADS; ++i) {
      const int c = tid + i * T::THREADS, r = c >> 2, k = k0 + (c & 3) * 8;
      const bool ok = m0 + r < M && k < ke;
      cp_async16(as + slot * T::A_ELEMS + r * T::AS + (c & 3) * 8,
                 ok ? a + (size_t)(m0 + r) * K + k : a, ok);
    }
  };
  auto load_w = [&](int slot, int k0) {   // TC_BK rows x BN/8 chunks of 8
#pragma unroll
    for (int i = 0; i < T::W_LOADS; ++i) {
      const int c = tid + i * T::THREADS, r = c / (T::BN / 8), cn = (c % (T::BN / 8)) * 8;
      const int k = k0 + r, n = n0 + cn;
      const bool ok = k < ke && n < N;
      cp_async16(ws + slot * T::W_ELEMS + r * T::WS + cn, ok ? w + (size_t)k * N + n : w, ok);
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
    const bf16* a_s = as + (kt % T::STAGES) * T::A_ELEMS;
    const bf16* w_s = ws + (kt % T::STAGES) * T::W_ELEMS;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t af[T::MT][4], bfr[T::NT / 2][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
        ldmatrix_x4(af[i], a_s + (wm * (T::BM / T::WM) + i * 16 + (lane & 15)) * T::AS + kk +
                               (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < T::NT / 2; ++p)
        ldmatrix_x4_trans(bfr[p], w_s + (kk + (lane & 15)) * T::WS + wn * (T::BN / T::WN) +
                                      p * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int p = 0; p < T::NT / 2; ++p) {
          mma_bf16(acc[i][2 * p], af[i], &bfr[p][0]);
          mma_bf16(acc[i][2 * p + 1], af[i], &bfr[p][2]);
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
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          const float y0 = gelu_exact(v0 + __bfloat162float(bias[n]));
          const float y1 = gelu_exact(v1 + __bfloat162float(bias[n + 1]));
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + n) =
              __floats2bfloat162_rn(y0, y1);
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
  const int large = M >= TC_LARGE_ROWS;
  const int bm = large ? TileL::BM : TileS::BM, bn = large ? TileL::BN : TileS::BN;
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

template <class T, int EPI>
int tc_gemm_tile(const bf16* a, const bf16* w, const bf16* bias, float* part, bf16* y, int M,
                 int K, int N, const TcProduct& sp, cudaStream_t st) {
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, sp.s);
  return pdl_launch(tc_gemm_kernel<T, EPI>, grid, dim3(T::THREADS), T::SMEM, st, a, w, bias,
                    part, y, M, K, N, sp.kchunk);
}

template <int EPI>
int tc_gemm(const bf16* a, const bf16* w, const bf16* bias, float* part, bf16* y, int M, int K,
            int N, const TcProduct& sp, cudaStream_t st) {
  return sp.large ? tc_gemm_tile<TileL, EPI>(a, w, bias, part, y, M, K, N, sp, st)
                  : tc_gemm_tile<TileS, EPI>(a, w, bias, part, y, M, K, N, sp, st);
}

// Shared memory above 48 KB must be granted to each product kernel once.
inline int tc_gemm_prepare() {
  const void* fns[4] = {(const void*)tc_gemm_kernel<TileS, TC_EPI_PART>,
                        (const void*)tc_gemm_kernel<TileS, TC_EPI_GELU>,
                        (const void*)tc_gemm_kernel<TileL, TC_EPI_PART>,
                        (const void*)tc_gemm_kernel<TileL, TC_EPI_GELU>};
  const int smem[4] = {TileS::SMEM, TileS::SMEM, TileL::SMEM, TileL::SMEM};
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
// order, then over the warps in order.  att = num / den in bf16 (v6 casts
// att to the weights' type before Wo).
template <typename TS, int E>
__global__ void __launch_bounds__(AttnShape<TS, E>::W * 32)
tc_attn_kernel(const float* __restrict__ qkvp, int nsplit, const bf16* __restrict__ bias,
               TS* __restrict__ s, TS* __restrict__ z, bf16* __restrict__ att, int B, int H,
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
    const float v = split_sum(qkvp + b * ld3 + col, B * ld3, nsplit) +
                    __bfloat162float(bias[col]);
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
    att[(size_t)b * D + hh * E + tid] = __float2bfloat16_rn(n / (d + eps));
  }
}

// The state pass at the head widths tc_attn_kernel does not take (any E up
// to MAX_E): thread u of one block per (song, head) owns state column u
// and walks the rows in order, so a warp reads and writes a row's columns
// side by side.  The same products and sums as tc_attn_kernel's, in the
// same order for den; num is summed over the rows in order.
template <typename TS>
__global__ void __launch_bounds__(MAX_E)
tc_attn_any_kernel(const float* __restrict__ qkvp, int nsplit, const bf16* __restrict__ bias,
                   TS* __restrict__ s, TS* __restrict__ z, bf16* __restrict__ att, int B, int H,
                   int E, float eps) {
  __shared__ float qkv_s[3][MAX_E];
  __shared__ float dq[MAX_E];
  const int u = threadIdx.x, pair = blockIdx.x, b = pair / H, hh = pair % H, D = H * E;
  griddep_wait();
  griddep_launch();
  const size_t ld3 = (size_t)3 * D;
  for (int i = u; i < 3 * E; i += blockDim.x) {
    const int which = i / E, j = i % E, col = which * D + hh * E + j;
    const float v = split_sum(qkvp + b * ld3 + col, B * ld3, nsplit) +
                    __bfloat162float(bias[col]);
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
    att[(size_t)b * D + hh * E + u] = __float2bfloat16_rn(num / (d + eps));
  }
}

// out = LN(resid + (sum of nsplit partials + bias)) * scale + shift, f32 and
// bf16, one block per row; with fls != nullptr also hfb = bf16(LN(out) *
// fls + flb), the final LN before the heads.  advance (the token counter,
// read by no kernel between the last LN2 and the sampling pass): + 1.
__global__ void __launch_bounds__(LN_THREADS)
tc_ln_kernel(const float* __restrict__ part, int nsplit, const bf16* __restrict__ bias,
             const float* __restrict__ resid, const bf16* __restrict__ scale,
             const bf16* __restrict__ shift, float* __restrict__ out, bf16* __restrict__ outb,
             const float* __restrict__ fls, const float* __restrict__ flb,
             bf16* __restrict__ hfb, int* __restrict__ advance, int M, int D) {
  __shared__ float xr[MAX_D];
  __shared__ float red[32];
  griddep_wait();
  griddep_launch();
  if (advance != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *advance += 1;
  const size_t base = (size_t)blockIdx.x * D, MD = (size_t)M * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    xr[i] = resid[base + i] + (split_sum(part + base + i, MD, nsplit) +
                               __bfloat162float(bias[i]));
  __syncthreads();
  ln_row(xr, D, 1e-5f, red);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = xr[i] * __bfloat162float(scale[i]) + __bfloat162float(shift[i]);
    out[base + i] = v;
    outb[base + i] = __float2bfloat16_rn(v);
    xr[i] = v;
  }
  if (fls == nullptr) return;
  __syncthreads();
  ln_row(xr, D, 1e-5f, red);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    hfb[base + i] = __float2bfloat16_rn(xr[i] * fls[i] + flb[i]);
}

template <typename... Args>
int tc_ln(int M, int D, cudaStream_t st, Args... args) {
  return pdl_launch(tc_ln_kernel, dim3(M), dim3(LN_THREADS), 0, st, args..., M, D);
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

__global__ void tc_embed_kernel(const TcCtrl* __restrict__ ctrl, const int* __restrict__ tokbuf,
                                const float* __restrict__ m, const float* __restrict__ bin,
                                const float* __restrict__ pe, float* __restrict__ h,
                                bf16* __restrict__ hb, int B, int NF, int D) {
  griddep_wait();
  griddep_launch();
  const int b = blockIdx.x, step = ctrl->step, pos = ctrl->t0 + step;
  float* h_b = h + (size_t)b * D;
  embed_row(tokbuf + ((size_t)step * B + b) * NF, m, ctrl->fa, bin, pe + (size_t)pos * D, h_b,
            NF, D);
  for (int d = threadIdx.x; d < D; d += blockDim.x)   // the same thread wrote h_b[d]
    hb[(size_t)b * D + d] = __float2bfloat16_rn(h_b[d]);
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

// The token's buffers, carved from one workspace of tc_workspace_bytes.
struct TcBufs {
  float *h, *h1, *qkvp, *part, *logp;   // f32: residual stream, LN1 out, partial sums
  bf16 *hbf, *h1bf, *att, *y1, *hfbf;   // bf16 inputs of the products
  TcCtrl* ctrl;
};

inline size_t tc_align(size_t n) { return (n + 255) & ~(size_t)255; }

inline size_t tc_carve(char* base, int B, int D, int DI, int NF, TcBufs* o) {
  const TcPlan pl = tc_plan(B, D, DI, NF);
  const size_t bd = (size_t)B * D;
  const size_t part = (size_t)(pl.wo.s > pl.f2.s ? pl.wo.s : pl.f2.s) * bd;
  const size_t sizes[11] = {4 * bd, 4 * bd, 4 * (size_t)pl.qkv.s * 3 * bd, 4 * part,
                            4 * (size_t)pl.heads.s * B * NF * VF_PAD, 2 * bd, 2 * bd, 2 * bd,
                            2 * (size_t)B * DI, 2 * bd, sizeof(TcCtrl)};
  void** slots[11] = {(void**)&o->h, (void**)&o->h1, (void**)&o->qkvp, (void**)&o->part,
                      (void**)&o->logp, (void**)&o->hbf, (void**)&o->h1bf, (void**)&o->att,
                      (void**)&o->y1, (void**)&o->hfbf, (void**)&o->ctrl};
  size_t off = 0;
  for (int i = 0; i < 11; ++i) {
    if (base) *slots[i] = base + off;
    off += tc_align(sizes[i]);
  }
  return off;
}

// The products' operand rows are read in 16-byte pieces (D and DI
// multiples of 8); the state pass takes any head width up to MAX_E.
inline bool tc_shape_ok(int D, int H, int DI) {
  const int E = H > 0 ? D / H : 0;
  return E * H == D && E <= MAX_E && D % 8 == 0 && DI % 8 == 0 && D <= MAX_D;
}

template <typename TS>
int tc_attn(const float* qkvp, int nsplit, const bf16* bias, TS* s, TS* z, bf16* att, int B,
            int H, int E, float eps, cudaStream_t st) {
#define RLMG_TC_ATT(EV)                                                                  \
  pdl_launch(tc_attn_kernel<TS, EV>, dim3(B * H), dim3(AttnShape<TS, EV>::W * 32), 0, st, \
             qkvp, nsplit, bias, s, z, att, B, H, eps)
  switch (E) {
    case 16: return RLMG_TC_ATT(16);
    case 32: return RLMG_TC_ATT(32);
    case 64: return RLMG_TC_ATT(64);
    case 128: return RLMG_TC_ATT(128);
    default:
      return pdl_launch(tc_attn_any_kernel<TS>, dim3(B * H), dim3(MAX_E), 0, st, qkvp, nsplit,
                        bias, s, z, att, B, H, E, eps);
  }
#undef RLMG_TC_ATT
}

// The arguments a token's graph holds: its shape, and the pointers that
// the per-call values (TcCtrl) do not carry.  Zeroed before it is filled,
// so it compares as bytes.
struct TcArgs {
  int* tokbuf;
  const float *m, *bin, *pe, *head_b, *fls, *flb;
  const bf16* head_w;
  const bf16* w[N_WEIGHTS];
  void *s, *z;
  char* work;
  int L, B, D, H, DI, NF, s_bf16, dev;
  float eps;
};

inline bool tc_same_shape(const TcArgs& a, const TcArgs& b) {
  return a.dev == b.dev && a.L == b.L && a.B == b.B && a.D == b.D && a.H == b.H &&
         a.DI == b.DI && a.NF == b.NF && a.s_bf16 == b.s_bf16;
}

#define RLMG_TC_STEP(expr)       \
  do {                           \
    const int rc_ = (int)(expr); \
    if (rc_) return -rc_;        \
    ++n;                         \
  } while (0)

// Enqueue one token's kernels on st (captured into the call's graph).
// Returns the number of kernels enqueued, or minus a CUDA error code.
template <typename TS>
int tc_enqueue_token(const TcArgs& a, cudaStream_t st) {
  const int B = a.B, D = a.D, H = a.H, DI = a.DI, NF = a.NF, E = D / H;
  const TcPlan pl = tc_plan(B, D, DI, NF);
  TcBufs o;
  tc_carve(a.work, B, D, DI, NF, &o);
  const size_t sl = (size_t)B * H * E * E, zl = (size_t)B * H * E;
  const bf16* const* w = a.w;
  int n = 0;
  RLMG_TC_STEP(pdl_launch(tc_embed_kernel, dim3(B), dim3(256), 0, st, (const TcCtrl*)o.ctrl,
                          (const int*)a.tokbuf, a.m, a.bin, a.pe, o.h, o.hbf, B, NF, D));
  for (int l = 0; l < a.L; ++l) {
    const size_t dd = (size_t)l * D * D, d = (size_t)l * D;
    RLMG_TC_STEP(tc_gemm<TC_EPI_PART>(o.hbf, w[W_QKV] + 3 * dd, nullptr, o.qkvp, nullptr, B, D,
                                      3 * D, pl.qkv, st));
    RLMG_TC_STEP(tc_attn<TS>(o.qkvp, pl.qkv.s, w[B_QKV] + 3 * d, (TS*)a.s + l * sl,
                             (TS*)a.z + l * zl, o.att, B, H, E, a.eps, st));
    RLMG_TC_STEP(tc_gemm<TC_EPI_PART>(o.att, w[W_O] + dd, nullptr, o.part, nullptr, B, D, D,
                                      pl.wo, st));
    RLMG_TC_STEP(tc_ln(B, D, st, (const float*)o.part, pl.wo.s, w[B_O] + d, (const float*)o.h,
                       w[LN1_S] + d, w[LN1_B] + d, o.h1, o.h1bf, (const float*)nullptr,
                       (const float*)nullptr, (bf16*)nullptr, (int*)nullptr));
    RLMG_TC_STEP(tc_gemm<TC_EPI_GELU>(o.h1bf, w[W_F1] + (size_t)l * D * DI,
                                      w[B_F1] + (size_t)l * DI, nullptr, o.y1, B, D, DI, pl.f1,
                                      st));
    RLMG_TC_STEP(tc_gemm<TC_EPI_PART>(o.y1, w[W_F2] + (size_t)l * DI * D, nullptr, o.part,
                                      nullptr, B, DI, D, pl.f2, st));
    const bool last = l == a.L - 1;
    RLMG_TC_STEP(tc_ln(B, D, st, (const float*)o.part, pl.f2.s, w[B_F2] + d,
                       (const float*)o.h1, w[LN2_S] + d, w[LN2_B] + d, o.h, o.hbf,
                       last ? a.fls : nullptr, a.flb, o.hfbf, last ? &o.ctrl->step : nullptr));
  }
  RLMG_TC_STEP(tc_gemm<TC_EPI_PART>(o.hfbf, a.head_w, nullptr, o.logp, nullptr, B, D,
                                    NF * VF_PAD, pl.heads, st));
  RLMG_TC_STEP(pdl_launch(tc_sample_kernel, dim3(B * NF), dim3(VF_PAD), 0, st,
                          (const float*)o.logp, pl.heads.s, a.head_b, (const TcCtrl*)o.ctrl,
                          a.tokbuf, B, NF));
  return n;
}

#undef RLMG_TC_STEP

}  // namespace rlmg
