// T decode tokens per call with the sampling on the card: latency mode for a
// few songs (v8, v7: B <= 16) and the batch-major v5 at any batch.  The
// CUDA counterparts of
// reinforcement_learning_in_music_generation_tpu/ops/experimental/
//   decode_kernel_v8.py fused_decode_v8 (its Pallas body _v8_kernel: one
//                       grid program per token, an in-kernel loop over the
//                       layers, weights and state resident in VMEM),
//   decode_kernel_v7.py fused_decode_v7 (_v7_kernel: grid (T, L), one
//                       program per layer per token) and
//   decode_kernel_v5.py fused_decode_v5 (_v5_kernel: grid (T,), the
//                       batch-major state streamed through VMEM per layer
//                       in blocks of bb songs).
// All three compute one function, so here they share one set of device
// functions and differ only in how much of it one launch does and where
// the state lives:
//
//   v8  one persistent cooperative launch per chunk.  The grid is one block
//       per SM (all co-resident, as cudaLaunchCooperativeKernel requires);
//       every token runs its phases separated by grid-wide barriers
//       (cooperative_groups grid.sync()), 6 L + 2 of them a token.  Each
//       block owns fixed (layer, song, head) slices of the state S, z: it
//       loads them into shared memory at the first token, updates them
//       there and writes them back after the last (the counterpart of v8's
//       VMEM-resident state).  The sampled token reaches the next token's
//       embedding through device memory (B x NF ints).
//   v7  L + 2 launches a token, the loop over T and L in C on the host: the
//       embedding, one cooperative launch per layer (its phases separated by
//       5 grid barriers), the heads + sample pass.  The state lives in
//       device memory, since shared memory does not outlive a launch.
//   v5  one cooperative launch for all T tokens, v8's phases, with the f32
//       state in device memory in v5's layout, S (L, B, E, H E) and z
//       (L, B, H E), read and written every token (at B=256 it cannot stay
//       on chip).  A product item carries bb songs (8, 16 or 32, dividing
//       B), the counterpart of the TPU kernel's bb-song state blocks; the
//       state items stay one (song, head) slice.
// The same device functions in the same order give v7 and v8 bit-equal
// tokens and states.  Every phase splits its work into items whose
// arithmetic does not depend on the grid size or on which block runs them.
//
// Per token and layer (the math of decode_kernel_v4 / decode_layers.cuh):
//   A  qkv partial products: items of 64 columns x 64 rows of Wqkv, the
//      partial sums of each 64-row slice in device memory
//   B  one block per owned (song, head) slice: q, k, v = the partials'
//      sum + bias, phi on q and k; S += k v^T, z += k, att = q^T S /
//      (q.z + eps) (attn_slice of decode_layers.cuh); then att times the
//      head's E rows of Wo, a partial sum of the Wo product per head
//   D  one block per song: h1 = LN1(h + sum of the heads' partials + bo)
//   E  FFN1 partial products (items as in A) over h1
//   F  FFN2 partial products; each item forms its 64 rows of
//      y = gelu_exact(sum of FFN1's partials + b1) itself
//   G  one block per song: h = LN2(h1 + sum of FFN2's partials + b2)
// and per token the embedding (embed_row of decode_sample.cuh) before the
// first layer and, after the last, one block per (song, field) for the
// final LN, heads, temperature, nucleus and Gumbel-max (heads_sample_row,
// the pass of kernel B, with its Philox counter (position, field, vocab
// index, song): the stream depends only on the position, so a chunk split
// in two calls emits the same tokens).  Everything accumulates in f32;
// weights are read in their stored type, the state in its own.  Partial
// sums are added in a fixed order: no atomics.
//
// Bound on the card.  Each token must read every layer's weights once,
// L (4 D^2 + 2 D DI) values (12 layers at D=512, DI=2048: 75.5 MB in bf16,
// 151 MB in f32), and does 2 B (L (4 D^2 + 2 D DI) + D NF VF_PAD)
// operations: at B <= 16 the bytes bind, about 23 us a token in bf16 at
// 3.35 TB/s.  The weights cannot stay resident on this card as they do in
// the TPU kernels' VMEM (75.5 MB is more than the 50 MB L2 and the 132 x
// 227 KB of shared memory), so they stream from device memory every token;
// the state stays on chip for v8 (12 x 16 x 8 x 64 x 64 x 2 B = 12.6 MB at
// B=16 in bf16, under 100 KB a block) and streams every token for v7.  What
// the design does about the bound: every phase spreads its weight tiles
// over all SMs; what it does not do yet: tensor cores, wide loads, and
// overlap of one phase's weight loads with the barrier before it.  At
// B <= 16 the barriers and the latency of each phase's loads set the time,
// not the bytes.  v5 at B=256 also streams the f32 state, 2 x 410 MB a
// token: the bytes bind (0.27 ms a token at 3.35 TB/s).  Its 19.7 GFLOP a
// token are bf16 products in the TPU function (activations cast to the
// weights' type), 0.02 ms at the tensor cores' 989 TFLOP/s; this kernel
// does them as f32 FMAs outside the tensor cores, which alone take 0.29 ms
// at 67 TFLOP/s.

#include <cooperative_groups.h>

#include "decode_layers.cuh"
#include "decode_sample.cuh"

namespace cg = cooperative_groups;

namespace rlmg {

constexpr int LT_THREADS = 256;               // heads_sample_row: thread v owns logit v
constexpr int LT_TN = 64, LT_KC = 64;         // product item: 64 columns x 64 rows
constexpr int LT_KQ = LT_KC / (LT_THREADS / LT_TN);   // rows per thread: 16
constexpr int LT_MAX_B = 16;
static_assert(LT_THREADS == VF_PAD && LT_THREADS == ATT_THREADS, "one block size");

__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

// RLMG_V5_ABLATE (v5 only, for attributing its time; the output is garbage):
// ABLATE_STATE streams the state through and skips every other layer
// phase, ABLATE_ATTN keeps the products and streams the state through
// without its update and read (att = 0).
enum { ABLATE_NONE = 0, ABLATE_STATE = 1, ABLATE_ATTN = 2 };

struct LatArgs {
  const void* w[N_WEIGHTS];      // stacked layer weights, one type (decode_layers.cuh order)
  const float* m;                // folded embedding (sum V_f, D)
  const float* bin;              // in_linear bias (D)
  const float* pe;               // (max_len, D)
  const void* hw;                // padded heads (D, NF * VF_PAD), the weights' type
  const float *hb, *fls, *flb;   // head bias (NF * VF_PAD), final LN (D)
  FieldArgs fa;
  const int* tok0;               // (B, NF), fed at t0
  int* tokens;                   // (T, B, NF)
  void *s, *z;                   // (L, B, H, E, E), (L, B, H, E); v5: (L, B, E, H E),
                                 // (L, B, H E)
  float *h, *h1;                 // (B, D) each
  float *pqkv, *po, *p1, *p2;    // partial sums: (D/64, B, 3D), (H, B, D), (D/64, B, DI), (DI/64, B, D)
  int L, B, D, H, DI, NF, T, t0;
  unsigned int seed;
  int greedy;
  float eps;
  int ablate;                    // v5 only
};

// Shared floats one block needs for the phases (the largest of them), when a
// product item carries nb songs.
inline size_t work_floats(int nb, int D, int H) {
  const size_t gemm = 4 * (size_t)nb * LT_KC;                 // x chunk + 3 partial rows
  const size_t attn = 5 * (size_t)(D / H) + ATT_THREADS + 1;   // q k v dq att, part, den
  const size_t row = (size_t)D + 64;                           // x row, red, redi
  size_t w = gemm > attn ? gemm : attn;
  w = w > row ? w : row;
  return (w + 3) / 4 * 4;                                      // 16-byte aligned state after it
}

inline size_t resident_bytes(int L, int B, int D, int H, int s_bf16, int grid) {
  const size_t E = D / H, slices = (size_t)L * B * H;
  const size_t nloc = (slices + grid - 1) / grid;
  return nloc * (E * E + E) * (s_bf16 ? 2 : 4);
}

template <typename TW>
struct LayerW {
  const TW *qkv, *bqkv, *wo, *bo, *l1s, *l1b, *w1, *b1, *w2, *b2, *l2s, *l2b;
};

template <typename TW>
__device__ __forceinline__ LayerW<TW> layer_w(const LatArgs& a, int l) {
  const size_t D = a.D, DI = a.DI, dd = (size_t)l * D * D, d = (size_t)l * D;
  const TW* const* W = (const TW* const*)a.w;
  return {W[W_QKV] + 3 * dd, W[B_QKV] + 3 * d, W[W_O] + dd,          W[B_O] + d,
          W[LN1_S] + d,      W[LN1_B] + d,     W[W_F1] + l * D * DI, W[B_F1] + l * DI,
          W[W_F2] + l * DI * D, W[B_F2] + d,   W[LN2_S] + d,         W[LN2_B] + d};
}

// part[kc] (B, N) = x[:, 64 kc : 64 kc + 64] @ w[64 kc : 64 kc + 64, :] for
// every 64-row slice kc, one (64 columns, 64 rows) tile of w per item.
// x (B, K) is the sum of nsum slices of src (nsum, B, K), and
// gelu_exact(. + xbias) when xbias is given.  Thread (c, kq) takes column
// c over rows 16 kq .. 16 kq + 15 for every song of the item; the four
// quarters are added in order.  An item carries all B <= MB songs, or,
// CHUNKED (v5), one chunk of MB songs; a song's sums do not depend on MB
// or on the chunk it falls in.
template <typename TW, int MB, bool CHUNKED>
__device__ void skinny_gemm(const float* src, int nsum, const TW* __restrict__ xbias,
                            const TW* __restrict__ w, float* part, int B, int K, int N,
                            float* wk, int g, int G) {
  const int n_nt = N / LT_TN, n_kc = K / LT_KC;
  const int items = n_nt * n_kc * (CHUNKED ? (B + MB - 1) / MB : 1);
  const int rb = CHUNKED ? MB : B;  // songs an item holds at most
  float* xs = wk;                    // (rb, 64)
  float* red = wk + rb * LT_KC;      // (3, rb, 64)
  const int c = threadIdx.x % LT_TN, kq = threadIdx.x / LT_TN;
  for (int it = g; it < items; it += G) {
    const int nt = it % n_nt, kc = CHUNKED ? (it / n_nt) % n_kc : it / n_nt;
    const int b0 = CHUNKED ? it / (n_nt * n_kc) * MB : 0;
    const int nb = CHUNKED ? min(MB, B - b0) : B, n = nt * LT_TN + c, k0 = kc * LT_KC;
    __syncthreads();               // the last item's xs and red are read
    for (int i = threadIdx.x; i < nb * LT_KC; i += blockDim.x) {
      const int b = b0 + i / LT_KC, k = k0 + i % LT_KC;
      float v = 0.f;
      for (int j = 0; j < nsum; ++j) v += __ldcg(src + ((size_t)j * B + b) * K + k);
      xs[i] = xbias ? gelu_exact(v + ld(xbias + k)) : v;
    }
    __syncthreads();
    float acc[MB];
#pragma unroll
    for (int b = 0; b < MB; ++b) acc[b] = 0.f;
    const TW* wp = w + (size_t)(k0 + kq * LT_KQ) * N + n;
    const float* xk = xs + kq * LT_KQ;
#pragma unroll
    for (int k = 0; k < LT_KQ; ++k) {
      const float wv = ldg(wp + (size_t)k * N);
#pragma unroll
      for (int b = 0; b < MB; ++b)
        if (b < nb) acc[b] = fmaf(xk[b * LT_KC + k], wv, acc[b]);
    }
    if (kq > 0) {
#pragma unroll
      for (int b = 0; b < MB; ++b)
        if (b < nb) red[((kq - 1) * rb + b) * LT_TN + c] = acc[b];
    }
    __syncthreads();
    if (kq == 0) {
#pragma unroll
      for (int b = 0; b < MB; ++b)
        if (b < nb)
          part[((size_t)kc * B + b0 + b) * N + n] = ((acc[b] + red[b * LT_TN + c]) +
                                                     red[(rb + b) * LT_TN + c]) +
                                                    red[(2 * rb + b) * LT_TN + c];
    }
  }
}

// Phase B for one (song b, head hd) slice of layer w; sp, zp its state, the
// rows of sp rs values apart.  V5: the v5 kernel, which honours a.ablate.
template <typename TW, typename TS, bool V5>
__device__ void attn_wo_slice(const LatArgs& a, const LayerW<TW>& w, int b, int hd, TS* sp,
                              TS* zp, int rs, float* wk) {
  const int D = a.D, E = D / a.H, nk = D / LT_KC, tid = threadIdx.x;
  float* qs = wk;
  float* ks = qs + E;
  float* vs = ks + E;
  float* dq = vs + E;
  float* att = dq + E;
  float* part = att + E;
  float* den = part + ATT_THREADS;
  __syncthreads();
  if (tid < E) {
    const int cq = hd * E + tid;
    float q = 0.f, k = 0.f, v = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float* p = a.pqkv + ((size_t)j * a.B + b) * 3 * D;
      q += __ldcg(p + cq);
      k += __ldcg(p + D + cq);
      v += __ldcg(p + 2 * D + cq);
    }
    qs[tid] = phi(q + ld(w.bqkv + cq));
    ks[tid] = phi(k + ld(w.bqkv + D + cq));
    vs[tid] = v + ld(w.bqkv + 2 * D + cq);
  }
  __syncthreads();
  if (V5 && a.ablate == ABLATE_ATTN) {   // the state streamed through, no update or read
    for (int i = tid; i < E * E; i += blockDim.x) {
      TS* p = sp + (size_t)(i / E) * rs + i % E;
      st(p, ld(p));
    }
    if (tid < E) {
      st(zp + tid, ld(zp + tid));
      att[tid] = 0.f;
    }
  } else {
    attn_slice<TS>(qs, ks, vs, sp, zp, att, E, a.eps, part, dq, den, rs);
  }
  __syncthreads();
  const TW* wo = w.wo + (size_t)hd * E * D;
  float* out = a.po + ((size_t)hd * a.B + b) * D;
  for (int n = tid; n < D; n += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int e = 0; e < E; ++e) acc = fmaf(att[e], ldg(wo + (size_t)e * D + n), acc);
    out[n] = acc;
  }
}

// out[b] = LN(resid[b] + (sum of nsum partial rows + bias)) * scale + shift.
template <typename TW>
__device__ void res_ln_row(const float* resid, const float* part, int nsum,
                           const TW* __restrict__ bias, const TW* __restrict__ scale,
                           const TW* __restrict__ shift, float* out, int B, int D, int b,
                           float* wk) {
  float* xr = wk;
  float* red = wk + D;
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float v = 0.f;
    for (int j = 0; j < nsum; ++j) v += __ldcg(part + ((size_t)j * B + b) * D + i);
    xr[i] = __ldcg(resid + (size_t)b * D + i) + (v + ld(bias + i));
  }
  __syncthreads();
  ln_row(xr, D, 1e-5f, red);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    out[(size_t)b * D + i] = xr[i] * ld(scale + i) + ld(shift + i);
}

// First slice index >= base that block g owns (index = g mod G).
__device__ __forceinline__ int first_owned(int base, int g, int G) {
  return base + ((g - base % G) % G + G) % G;
}

// The phases of layer l (A, B, D, E, F, G) with grid barriers between
// them; the caller synchronises after G.  With s_res, the state slices
// live in shared memory (slice i at s_res[(i / G) E E]); else in a.s, a.z,
// in the DecodeState layout, or, V5, in v5's (the products then carry
// chunks of MB songs).
template <typename TW, typename TS, int MB, bool V5>
__device__ void layer_phases(const LatArgs& a, int l, float* wk, TS* s_res, TS* z_res) {
  cg::grid_group grid = cg::this_grid();
  const int g = blockIdx.x, G = gridDim.x;
  const int B = a.B, D = a.D, H = a.H, E = D / H, DI = a.DI, BH = B * H;
  const LayerW<TW> w = layer_w<TW>(a, l);
  skinny_gemm<TW, MB, V5>(a.h, 1, nullptr, w.qkv, a.pqkv, B, D, 3 * D, wk, g, G);
  grid.sync();
  for (int i = first_owned(l * BH, g, G); i < (l + 1) * BH; i += G) {
    const int j = i - l * BH, b = j / H, hd = j % H;
    TS *sp, *zp;
    int rs = E;
    if (s_res) {
      sp = s_res + (size_t)(i / G) * E * E;
      zp = z_res + (size_t)(i / G) * E;
    } else if (V5) {                             // (L, B, E, H E), (L, B, H E)
      sp = (TS*)a.s + (size_t)(l * B + b) * E * D + hd * E;
      zp = (TS*)a.z + (size_t)(l * B + b) * D + hd * E;
      rs = D;
    } else {
      sp = (TS*)a.s + (size_t)i * E * E;
      zp = (TS*)a.z + (size_t)i * E;
    }
    attn_wo_slice<TW, TS, V5>(a, w, b, hd, sp, zp, rs, wk);
  }
  grid.sync();
  for (int b = g; b < B; b += G)
    res_ln_row<TW>(a.h, a.po, H, w.bo, w.l1s, w.l1b, a.h1, B, D, b, wk);
  grid.sync();
  skinny_gemm<TW, MB, V5>(a.h1, 1, nullptr, w.w1, a.p1, B, D, DI, wk, g, G);
  grid.sync();
  skinny_gemm<TW, MB, V5>(a.p1, D / LT_KC, w.b1, w.w2, a.p2, B, DI, D, wk, g, G);
  grid.sync();
  for (int b = g; b < B; b += G)
    res_ln_row<TW>(a.h1, a.p2, DI / LT_KC, w.b2, w.l2s, w.l2b, a.h, B, D, b, wk);
}

// Token t's embedding into a.h, one block per song.
__device__ void embed_phase(const LatArgs& a, int t, int g, int G) {
  const int* tok = t == 0 ? a.tok0 : a.tokens + (size_t)(t - 1) * a.B * a.NF;
  const float* pe_row = a.pe + (size_t)(a.t0 + t) * a.D;
  for (int b = g; b < a.B; b += G)
    embed_row(tok + (size_t)b * a.NF, a.m, a.fa, a.bin, pe_row, a.h + (size_t)b * a.D, a.NF,
              a.D);
}

// Token t's successors from a.h, one block per (song, field).
template <typename TW>
__device__ void sample_phase(const LatArgs& a, int t, int g, int G, float* wk) {
  for (int i = g; i < a.B * a.NF; i += G) {
    const int b = i / a.NF, f = i % a.NF;
    __syncthreads();
    const int tok = heads_sample_row<TW>(a.h + (size_t)b * a.D, a.fls, a.flb, (const TW*)a.hw,
                                         a.hb, a.fa, b, f, a.NF, a.D, a.t0 + t, a.seed,
                                         a.greedy, wk, wk + a.D, (int*)(wk + a.D + 32));
    if (threadIdx.x == 0) a.tokens[((size_t)t * a.B + b) * a.NF + f] = tok;
  }
}

extern __shared__ __align__(16) unsigned char lt_smem[];

// v8: the whole chunk in one cooperative launch of one block per SM.
template <typename TW, typename TS>
__global__ void __launch_bounds__(LT_THREADS, 1)
latency_v8_kernel(const __grid_constant__ LatArgs a, int work) {
  cg::grid_group grid = cg::this_grid();
  const int g = blockIdx.x, G = gridDim.x;
  const int E = a.D / a.H, n_sl = a.L * a.B * a.H;
  float* wk = (float*)lt_smem;
  TS* s_res = (TS*)(wk + work);
  TS* z_res = s_res + (size_t)((n_sl + G - 1) / G) * E * E;
  for (int k = 0; g + k * G < n_sl; ++k) {        // load the owned slices
    const size_t i = g + (size_t)k * G;
    const TS* s_src = (const TS*)a.s + i * E * E;
    for (int x = threadIdx.x; x < E * E; x += blockDim.x) s_res[(size_t)k * E * E + x] = s_src[x];
    for (int x = threadIdx.x; x < E; x += blockDim.x)
      z_res[(size_t)k * E + x] = ((const TS*)a.z)[i * E + x];
  }
  __syncthreads();
  for (int t = 0; t < a.T; ++t) {
    embed_phase(a, t, g, G);
    grid.sync();
    for (int l = 0; l < a.L; ++l) {
      layer_phases<TW, TS, LT_MAX_B, false>(a, l, wk, s_res, z_res);
      grid.sync();
    }
    sample_phase<TW>(a, t, g, G, wk);
    if (t + 1 < a.T) grid.sync();
  }
  __syncthreads();
  for (int k = 0; g + k * G < n_sl; ++k) {        // write them back
    const size_t i = g + (size_t)k * G;
    TS* s_dst = (TS*)a.s + i * E * E;
    for (int x = threadIdx.x; x < E * E; x += blockDim.x) s_dst[x] = s_res[(size_t)k * E * E + x];
    for (int x = threadIdx.x; x < E; x += blockDim.x)
      ((TS*)a.z)[i * E + x] = z_res[(size_t)k * E + x];
  }
}

// v7: one layer of one token, a cooperative launch; the embedding and the
// heads + sample pass are launches of their own.
template <typename TW, typename TS>
__global__ void __launch_bounds__(LT_THREADS)
latency_v7_layer_kernel(const __grid_constant__ LatArgs a, int l) {
  layer_phases<TW, TS, LT_MAX_B, false>(a, l, (float*)lt_smem, (TS*)nullptr, (TS*)nullptr);
}

__global__ void __launch_bounds__(LT_THREADS) latency_embed_kernel(const __grid_constant__ LatArgs a,
                                                                   int t) {
  embed_phase(a, t, blockIdx.x, gridDim.x);
}

template <typename TW>
__global__ void __launch_bounds__(LT_THREADS)
latency_sample_kernel(const __grid_constant__ LatArgs a, int t) {
  sample_phase<TW>(a, t, blockIdx.x, gridDim.x, (float*)lt_smem);
}

// ABLATE_STATE's layer: v5's f32 state of layer l read and written back,
// nothing else.
__device__ void stream_state(const LatArgs& a, int l, int g, int G) {
  const size_t nz = (size_t)a.B * a.D, ns = nz * (a.D / a.H);
  float* s = (float*)a.s + l * ns;
  float* z = (float*)a.z + l * nz;
  const size_t i0 = (size_t)g * blockDim.x + threadIdx.x, step = (size_t)G * blockDim.x;
  for (size_t i = i0; i < ns; i += step) __stcg(s + i, __ldcg(s + i));
  for (size_t i = i0; i < nz; i += step) __stcg(z + i, __ldcg(z + i));
}

// v5: T tokens of B songs in one cooperative launch of one block per SM,
// v8's phases with the f32 state in device memory in the batch-major
// layout (read and written every token: it cannot stay on chip at B=256),
// the products carrying MB songs an item.
template <typename TW, int MB>
__global__ void __launch_bounds__(LT_THREADS, 1) decode_v5_kernel(const __grid_constant__ LatArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int g = blockIdx.x, G = gridDim.x;
  float* wk = (float*)lt_smem;
  for (int t = 0; t < a.T; ++t) {
    embed_phase(a, t, g, G);
    grid.sync();
    for (int l = 0; l < a.L; ++l) {
      if (a.ablate == ABLATE_STATE)
        stream_state(a, l, g, G);
      else
        layer_phases<TW, float, MB, true>(a, l, wk, (float*)nullptr, (float*)nullptr);
      grid.sync();
    }
    sample_phase<TW>(a, t, g, G, wk);
    if (t + 1 < a.T) grid.sync();
  }
}

inline int card(int* n_sm, int* max_smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// 0 when `grid` blocks of kern with `smem` dynamic shared bytes can all be
// resident, as a cooperative launch needs; the launch is refused, never
// shrunk, when they cannot.
template <typename K>
int cooperative_ok(K kern, int grid, size_t smem, int n_sm) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, LT_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  return per_sm * n_sm < grid ? (int)cudaErrorCooperativeLaunchTooLarge : 0;
}

// *launched receives the number of kernel launches issued.
template <typename TW, typename TS>
int latency_run(int version, LatArgs& a, int n_sm, cudaStream_t st, int* launched) {
  const int work = (int)work_floats(a.B < LT_MAX_B ? a.B : LT_MAX_B, a.D, a.H);
  if (version == 8) {
    const size_t smem = work * sizeof(float) +
                        resident_bytes(a.L, a.B, a.D, a.H, sizeof(TS) == 2, n_sm);
    const auto kern = latency_v8_kernel<TW, TS>;
    const int rc = cooperative_ok(kern, n_sm, smem, n_sm);
    if (rc) return rc;
    void* args[] = {(void*)&a, (void*)&work};
    const cudaError_t e =
        cudaLaunchCooperativeKernel((const void*)kern, n_sm, LT_THREADS, args, smem, st);
    if (e != cudaSuccess) return (int)e;
    *launched = 1;
    return 0;
  }
  const size_t smem = work * sizeof(float);
  const auto layer = latency_v7_layer_kernel<TW, TS>;
  const int rc = cooperative_ok(layer, n_sm, smem, n_sm);
  if (rc) return rc;
  for (int t = 0; t < a.T; ++t) {
    latency_embed_kernel<<<a.B, LT_THREADS, 0, st>>>(a, t);
    RLMG_CHECK();
    ++*launched;
    for (int l = 0; l < a.L; ++l) {
      void* args[] = {(void*)&a, (void*)&l};
      const cudaError_t e =
          cudaLaunchCooperativeKernel((const void*)layer, n_sm, LT_THREADS, args, smem, st);
      if (e != cudaSuccess) return (int)e;
      ++*launched;
    }
    latency_sample_kernel<TW><<<a.B * a.NF, LT_THREADS, smem, st>>>(a, t);
    RLMG_CHECK();
    ++*launched;
  }
  return 0;
}

template <typename TW, int MB>
int v5_run(LatArgs& a, int n_sm, cudaStream_t st) {
  const size_t smem = work_floats(MB, a.D, a.H) * sizeof(float);
  const auto kern = decode_v5_kernel<TW, MB>;
  const int rc = cooperative_ok(kern, n_sm, smem, n_sm);
  if (rc) return rc;
  void* args[] = {(void*)&a};
  return (int)cudaLaunchCooperativeKernel((const void*)kern, n_sm, LT_THREADS, args, smem, st);
}

inline bool phases_shape_ok(int D, int H, int DI, int NF) {
  return stack_shape_ok(D, H) && D % LT_KC == 0 && DI % LT_KC == 0 && NF >= 1 && NF <= MAX_NF;
}

inline bool latency_shape_ok(int B, int D, int H, int DI, int NF) {
  return B >= 1 && B <= LT_MAX_B && phases_shape_ok(D, H, DI, NF);
}

// The kernels' arguments; scratch holds rlmg_latency_scratch_floats floats.
inline LatArgs lat_args(const int* tok0, int* tokens, const float* m, const float* bin,
                        const float* pe, const void* const* w, const void* hw, const float* hb,
                        const float* fls, const float* flb, const int* off, const float* tinv,
                        const float* topp, void* s, void* z, float* scratch, int T, int t0,
                        unsigned int seed, int greedy, int L, int B, int D, int H, int DI,
                        int NF, float eps) {
  LatArgs a{};
  for (int i = 0; i < N_WEIGHTS; ++i) a.w[i] = w[i];
  a.m = m;
  a.bin = bin;
  a.pe = pe;
  a.hw = hw;
  a.hb = hb;
  a.fls = fls;
  a.flb = flb;
  a.fa = field_args(off, tinv, topp, NF);
  a.tok0 = tok0;
  a.tokens = tokens;
  a.s = s;
  a.z = z;
  const size_t bd = (size_t)B * D, nk = D / LT_KC;
  a.h = scratch;
  a.h1 = a.h + bd;
  a.pqkv = a.h1 + bd;
  a.po = a.pqkv + nk * 3 * bd;
  a.p1 = a.po + (size_t)H * bd;
  a.p2 = a.p1 + nk * B * (size_t)DI;
  a.L = L;
  a.B = B;
  a.D = D;
  a.H = H;
  a.DI = DI;
  a.NF = NF;
  a.T = T;
  a.t0 = t0;
  a.seed = seed;
  a.greedy = greedy;
  a.eps = eps;
  return a;
}

}  // namespace rlmg

extern "C" {

// f32 scratch floats the latency kernels need: h, h1 and the partial sums.
long long rlmg_latency_scratch_floats(int B, int D, int H, int DI) {
  const long long b = B, d = D, di = DI, nk = D / rlmg::LT_KC, nk2 = DI / rlmg::LT_KC;
  return 2 * b * d + nk * b * 3 * d + (long long)H * b * d + nk * b * di + nk2 * b * d;
}

// Dynamic shared bytes a block of the version's layer launch needs on a
// grid of `grid` blocks (v8: its resident state slices included).
long long rlmg_latency_smem_bytes(int version, int L, int B, int D, int H, int s_bf16, int grid) {
  const long long work = (long long)rlmg::work_floats(B < rlmg::LT_MAX_B ? B : rlmg::LT_MAX_B,
                                                      D, H) * 4;
  return version == 8 ? work + (long long)rlmg::resident_bytes(L, B, D, H, s_bf16, grid) : work;
}

// The current card's SM count and the shared bytes one block may opt in to.
int rlmg_latency_card(int* n_sm, int* max_smem) { return rlmg::card(n_sm, max_smem); }

// Decode T tokens with kernel `version` (7 or 8).  tok0 (B,NF) int32 is fed
// at position t0; tokens (T,B,NF) int32 receives the T successors.  s, z
// are updated in place.  off, tinv, topp are host arrays of NF values;
// scratch holds rlmg_latency_scratch_floats floats.  pe is the whole
// (max_len, D) f32 table; rows t0..t0+T-1 are read.  *launched receives
// the number of kernel launches the call issued (v8: 1, v7: (L + 2) T).
int rlmg_latency_decode(int version, const int* tok0, int* tokens, const float* m,
                        const float* bin, const float* pe, const void* const* w, const void* hw,
                        const float* hb, const float* fls, const float* flb, const int* off,
                        const float* tinv, const float* topp, void* s, void* z, float* scratch,
                        int T, int t0, unsigned int seed, int greedy, int L, int B, int D, int H,
                        int DI, int NF, float eps, int w_bf16, int s_bf16, void* stream,
                        int* launched) {
  *launched = 0;
  if (!rlmg::latency_shape_ok(B, D, H, DI, NF) || (version != 7 && version != 8) || T < 1)
    return (int)cudaErrorInvalidValue;
  int n_sm = 0, max_smem = 0;
  const int rc = rlmg::card(&n_sm, &max_smem);
  if (rc) return rc;
  rlmg::LatArgs a = rlmg::lat_args(tok0, tokens, m, bin, pe, w, hw, hb, fls, flb, off, tinv,
                                    topp, s, z, scratch, T, t0, seed, greedy, L, B, D, H, DI,
                                    NF, eps);
  cudaStream_t st = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (w_bf16)
    return s_bf16 ? rlmg::latency_run<bf, bf>(version, a, n_sm, st, launched)
                  : rlmg::latency_run<bf, float>(version, a, n_sm, st, launched);
  return s_bf16 ? rlmg::latency_run<float, bf>(version, a, n_sm, st, launched)
                : rlmg::latency_run<float, float>(version, a, n_sm, st, launched);
}

// Decode T tokens of B songs with the v5 kernel, one cooperative launch.
// tok0 (B, NF) int32 is the first token fed; tokens (T, B, NF) int32
// receives the T successors.  s (L, B, E, H E) and z (L, B, H E) f32 are
// updated in place.  pe_rows (T, D) f32 are the fed tokens' positional
// rows; the Philox position of token t is t.  bb (8, 16 or 32, dividing B)
// is the number of songs a product item carries.  ablate: ABLATE_* (0 for
// a real decode).  Other arguments as rlmg_latency_decode's.
int rlmg_decode_v5(const int* tok0, int* tokens, const float* m, const float* bin,
                   const float* pe_rows, const void* const* w, const void* hw, const float* hb,
                   const float* fls, const float* flb, const int* off, const float* tinv,
                   const float* topp, float* s, float* z, float* scratch, int T,
                   unsigned int seed, int greedy, int L, int B, int D, int H, int DI, int NF,
                   int bb, float eps, int w_bf16, int ablate, void* stream) {
  if (!rlmg::phases_shape_ok(D, H, DI, NF) || T < 1 || B < 1 ||
      (bb != 8 && bb != 16 && bb != 32) || B % bb || ablate < 0 || ablate > 2)
    return (int)cudaErrorInvalidValue;
  int n_sm = 0, max_smem = 0;
  const int rc = rlmg::card(&n_sm, &max_smem);
  if (rc) return rc;
  rlmg::LatArgs a = rlmg::lat_args(tok0, tokens, m, bin, pe_rows, w, hw, hb, fls, flb, off, tinv,
                                    topp, s, z, scratch, T, 0, seed, greedy, L, B, D, H, DI, NF,
                                    eps);
  a.ablate = ablate;
  cudaStream_t st = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (w_bf16) {
    if (bb == 8) return rlmg::v5_run<bf, 8>(a, n_sm, st);
    if (bb == 16) return rlmg::v5_run<bf, 16>(a, n_sm, st);
    return rlmg::v5_run<bf, 32>(a, n_sm, st);
  }
  if (bb == 8) return rlmg::v5_run<float, 8>(a, n_sm, st);
  if (bb == 16) return rlmg::v5_run<float, 16>(a, n_sm, st);
  return rlmg::v5_run<float, 32>(a, n_sm, st);
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
