// One decode token through every layer in one cooperative launch, its
// products on the tensor cores at f32 grade: kernel A (decode_step.cu, the
// counterpart of reinforcement_learning_in_music_generation_tpu/ops/
// decode_kernel_v4.py fused_stack_step_v4), v3 (decode_aug.cu, of
// ops/decode_kernel_v3.py fused_stack_step) and v2 (decode_aug.cu, of
// ops/experimental/decode_kernel.py fused_layer_step_v2: one layer, the
// tanh gelu, TANH below) share it.  Plain C interface through the sources;
// no PyTorch headers.
//
// Arithmetic: the TPU kernels' own.  Activations stay f32; the weights, bf16
// or f32, are cast up; every sum is f32; the state is accumulated in f32
// and rounded only where it is stored, and the read uses the unrounded sums
// (decode_kernel_v4.py :63-64, :79-81, :95-96, :101-107; v3 :102-124).  A
// product runs on mma.sync.m16n8k16 (bf16 operands, f32 sums) with the f32
// activation split into three bf16 planes, x = hi + mid + lo (its 24 bits):
//   bf16 weights, exact in one plane: three products a depth of 16
//     (lo.w, mid.w, hi.w);
//   f32 weights, split the same way in registers: the six products whose
//     terms reach 2^-16 of a product (lo.hi, hi.lo, mid.mid, mid.hi,
//     hi.mid, hi.hi), as train_gemm_tc.cuh forms them.
// Each depth of 16 is summed afresh, in three independent sums added in
// f32: the tensor cores truncate what they add to a running sum.  LN1
// takes (h + att Wo) + bo, LN2 h1 + (y W2 + b2), the TPU kernels' orders.
//
// A token is 4 L grid barriers (grid.sync), 4 a layer:
//   Q   items: (16 songs, NT columns of 8) of x @ Wqkv + b, phi on q and k.
//       The block stages its 16 rows of x in shared memory, at layer 0 the
//       embedding h_in, else LN2 of the previous layer's r2 formed there
//       (the item of column group 0 also writes them to hres, the layer's
//       residual).  Then the state items, one per (song, head, 64 state
//       columns), on the blocks with the fewest products: S[:, u] += phi(k)
//       v[u], num[u] = phi(q) . S[:, u], den = phi(q) . (z + phi(k)) + eps,
//       att = num / den.  An item reads its old state before it waits, and
//       waits only for the Q items of its 16 songs (a counter per row tile,
//       release / acquire), not for the grid.
//   O   where a head has several state items (E > 64), z += phi(k) (column
//       E of the augmented state for v3; else the state item did it), then
//       items of att @ Wo with r1 = (hres + acc) + bo.
//   F1  LN1 of r1 formed in shared memory (column group 0 writes h1); y =
//       gelu_exact(h1 @ W1 + b1) (v2: the tanh gelu).
//   F2  r2 = h1 + (y @ W2 + b2).
// After the last layer the blocks form h_out = LN2 of r2.
// Within an item the 16 warps split the NT column tiles and K, and the
// block adds the warps' sums in a fixed order: no atomics on values, every
// result bit-reproducible.  NT is chosen per product so that about one
// item runs on each SM.  A LayerNorm row is formed by one warp from its
// registers.  A tile of at most 8 songs feeds rows 8-15 of the products as
// zero registers.
//
// Weights: the matrices reach the kernel in mma fragment order, packed once
// by the wrapper (ops/decode_kernel_v4.py pack_fragments): for a (K, N)
// weight, K padded with zeros to Kp, a multiple of 32, [N / 8][Kp / 32][32
// lanes][8 values], each lane's 8 values the B fragments of two depths of
// 16, so one 16-byte copy (32 for f32) a lane brings a warp 32 depths of an
// 8-column tile, coalesced.  A warp starts its weight copies (cp.async into
// its own shared memory) before it stages the activations.  (Asking the L2
// for the next phases' weights ahead of time, cp.async.bulk.prefetch,
// measured no faster: scripts/profile_torch_stack_phases.py.)
//
// Bound on the card: per token the weights are read once (37.7M values at
// the flagship width: 75.5 MB in bf16) and the state read and written once;
// 2 B L (4 D^2 + 2 D DI) multiply-adds.  At the songs of the per-step path
// (B <= 64) the bytes bind; three (six) bf16 products a product keep the
// tensor cores far from binding.  What the design does: one launch a token
// (was 108 for A, 276 for v3 at 8 heads), four grid barriers a layer,
// intermediates in L2-resident f32 buffers, every SM streaming weights.
// What holds it back: a phase's dependent global round trips (the barrier,
// the staged rows, the epilogue's stores), a few us each.
//
// Launch: capturable (one cooperative launch on the caller's stream, no
// allocation, no host sync); the caller owns every buffer across calls.
// The kernel counts its own runs (sk_runs, below), so a replayed graph's
// launches are counted where they happen, not assumed by the host.

#pragma once

#include <cooperative_groups.h>

#include "decode_layers.cuh"
#include "tc_mma.cuh"

namespace rlmg {

namespace cgs = cooperative_groups;

constexpr int SK_THREADS = 512, SK_WARPS = SK_THREADS / 32;
constexpr int SK_ROWS = 16;            // songs an item (one m16 tile)
constexpr int SK_APAD = 8;             // floats a staged row is padded by (bank spread)
constexpr int SK_CT = 64;              // state columns a state item
// The weight chunks a warp has in flight: 8 of 32 depths (bf16; 4 of f32),
// 4 KB a warp, copied by cp.async into the warp's own shared memory (no
// registers held while the rows are staged).
constexpr int SK_WCHUNKS = 8;
constexpr int SK_WSMEM = SK_WCHUNKS * 32 * 16;        // bytes a warp
constexpr int SK_RG = SK_THREADS / SK_CT;   // row groups of a state item
constexpr int SK_LN_MAX = 1024;        // a LayerNorm row's values, held by one warp

// Development timing (-DSK_PROFILE builds only, scripts/
// profile_torch_stack_phases.py): block x's %globaltimer at mark m of layer
// l: 0-8 the phases and barriers of a layer (below); 9 + 3 ph + {0, 1, 2}
// product ph's first item staged, multiplied, stored; 21-23 the first state
// item's early reads done, wait over, item done.
#ifdef SK_PROFILE
constexpr int SK_MARKS = 24, SK_MAX_L = 16, SK_MAX_G = 160;
__device__ unsigned long long sk_marks[SK_MAX_L * SK_MARKS][SK_MAX_G];
#define SK_MARK(l, m)                                                                   \
  do {                                                                                  \
    if (threadIdx.x == 0 && (l) < SK_MAX_L && blockIdx.x < SK_MAX_G) {                  \
      unsigned long long t_;                                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                            \
      sk_marks[(l) * SK_MARKS + (m)][blockIdx.x] = t_;                                  \
    }                                                                                   \
  } while (0)
#else
#define SK_MARK(l, m) \
  do {                \
  } while (0)
#endif

// Launches of the token kernel that ran to their end, counted by the
// kernel: block 0's thread 0 adds 1 as a launch ends.  One counter a
// library and gelu (decode_step: A; decode_aug: v3, and v2 on the tanh
// gelu's), read by stack_tc_runs.
__device__ unsigned long long sk_runs;
__device__ unsigned long long sk_runs_tanh;

enum { SK_Q = 0, SK_O = 1, SK_F1 = 2, SK_F2 = 3 };
// vectors, each stacked over L: qkv bias (3D), Wo bias, LN1 scale / shift,
// FFN1 bias (DI), FFN2 bias, LN2 scale / shift
enum { SV_BQKV, SV_BO, SV_LN1S, SV_LN1B, SV_B1, SV_B2, SV_LN2S, SV_LN2B, SV_N };

struct StackTcArgs {
  const void* w[4];          // packed Wqkv (D x 3D), Wo (D x D), W1 (D x DI), W2 (DI x D), over L
  const void* v[SV_N];       // the vectors, in the vectors' type
  void* s;                   // A: S (L, B, H, E, E); v3: the augmented (L, H, B, E, E + 1)
  void* z;                   // A: z (L, B, H, E); v3: unused (column E of s)
  const float* h_in;         // (B, D) the embedding, read only
  float* h_out;              // (B, D)
  float *hres, *qkv, *att, *r1, *h1, *y, *r2;   // (B, D) but qkv (B, 3D), y (B, DI)
  unsigned int* cnt;         // one a row tile, zero on entry and on exit
  int L, B, D, H, DI;
  float eps;
  int head_major;            // qkv columns [q_h k_h v_h] by head (v3) or [q | k | v] (A)
  int nt[4];                 // column tiles of 8 an item, by product
};

// Shared memory a block needs: the weight pieces in flight, 16 staged rows
// of the widest K, the warps' partial sums, a LayerNorm's scale and shift,
// and the state items' scratch (inside the staged rows).
__host__ __device__ __forceinline__ int pad32(int k) { return (k + 31) & ~31; }

inline size_t stack_tc_smem_bytes(int D, int DI) {
  const int K = pad32(D > DI ? D : DI);
  return (size_t)(SK_ROWS * (K + SK_APAD) + SK_WARPS * 128 + 2 * pad32(D) + 64) *
             sizeof(float) + (size_t)SK_WARPS * SK_WSMEM;
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
// Two f32 values as three bf16x2 planes (hi, mid, lo).  Each remainder is
// exact in f32.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 fh = __bfloat1622float2(h);
  a -= fh.x;
  b -= fh.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(a, b);
  const float2 fm = __bfloat1622float2(m);
  const __nv_bfloat162 o = __floats2bfloat162_rn(a - fm.x, b - fm.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&o);
}

template <typename T>
__device__ __forceinline__ const T* layer_vec(const StackTcArgs& a, int i, int l) {
  const int n = i == SV_BQKV ? 3 * a.D : i == SV_B1 ? a.DI : a.D;
  return (const T*)a.v[i] + (size_t)l * n;
}

// The product of phase ph at layer l: its K, N, weights and input.
struct SkProd {
  int K, Kp, N, nt;   // K and K padded to 32
  const uint4* w;     // this layer's packed weights
  const float* src;   // (B, K) f32 input rows
  int ln;             // stage the LayerNorm of src (layer lnl's vectors lnv, lnv + 1)
  int lnv;            // which LN: SV_LN1S or SV_LN2S
  int lnl;            // and of which layer
  float* keep;        // column group 0 writes the staged rows here (or null)
};

template <typename TW>
__device__ __forceinline__ SkProd sk_prod(const StackTcArgs& a, int ph, int l) {
  const int D = a.D, DI = a.DI;
  SkProd p;
  p.nt = a.nt[ph];
  p.ln = 0;
  p.lnv = SV_LN2S;
  p.lnl = l - 1;
  p.keep = nullptr;
  if (ph == SK_Q) {
    p.K = D, p.N = 3 * D, p.src = l ? a.r2 : a.h_in;
    p.ln = l > 0;
    p.keep = l ? a.hres : nullptr;
  } else if (ph == SK_O) {
    p.K = D, p.N = D, p.src = a.att;
  } else if (ph == SK_F1) {
    p.K = D, p.N = DI, p.src = a.r1, p.ln = 1, p.lnv = SV_LN1S, p.lnl = l, p.keep = a.h1;
  } else {
    p.K = DI, p.N = D, p.src = a.y;
  }
  p.Kp = pad32(p.K);
  p.w = (const uint4*)((const TW*)a.w[ph] + (size_t)l * p.Kp * p.N);
  return p;
}

// Items of a product: (row tile, group of nt column tiles), row tile major.
__device__ __forceinline__ int sk_items(const StackTcArgs& a, const SkProd& p) {
  return ((a.B + SK_ROWS - 1) / SK_ROWS) * (p.N / 8 / p.nt);
}

// The rows of a tile of `rows` songs the products read: all 16, or the
// first 8 when they hold every song (the other 8 enter the products as
// zero registers).
__device__ __forceinline__ int sk_staged_rows(int rows) { return rows > 8 ? SK_ROWS : 8; }

// 16 rows of the product's input into shared memory (rows past B and
// columns past K are zeros).  as: 16 rows of Kp + SK_APAD; lnv: 2 Kp floats.
// Every global load a thread makes is issued before any is waited for.
// Without a LayerNorm each warp stages pieces of 1024 values of a row,
// eight 16-byte loads a lane in flight.  With one (K = D <= SK_LN_MAX) warp
// r stages row r: its values stay in the lanes' registers for the passes of
// (x - mu) * rsqrt(var + 1e-5) * scale + shift (the TPU kernels' _ln), the
// scale and shift come through lnv, and only the result is stored.
template <typename TV>
__device__ void sk_stage(const StackTcArgs& a, const SkProd& p, int rt, float* as,
                         float* lnv) {
  constexpr int SB = 8;
  const int K = p.K, Kp = p.Kp, st = Kp + SK_APAD, tid = threadIdx.x, q4 = Kp / 4;
  const int rows = min(SK_ROWS, a.B - rt * SK_ROWS);
  const float* src = p.src + (size_t)rt * SK_ROWS * K;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!p.ln) {
    // warp w stages (row, segment) pairs w, w + SK_WARPS, ...: a segment is
    // 8 x 32 float4 of a row, one 16-byte load a lane each, all in flight
    constexpr int SEG = 8 * 32;
    const int warp = tid >> 5, lane = tid & 31, k4 = K / 4, nseg = (q4 + SEG - 1) / SEG;
    for (int pr = warp; pr < sk_staged_rows(rows) * nseg; pr += SK_WARPS) {
      const int r = pr / nseg, i0 = (pr % nseg) * SEG + lane;
      float4 v[SB];
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int i = i0 + 32 * u;
        v[u] = r < rows && i < k4 ? __ldcg((const float4*)(src + (size_t)r * K) + i) : zero4;
      }
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int i = i0 + 32 * u;
        if (i < q4) *(float4*)(as + r * st + 4 * i) = v[u];
      }
    }
    __syncthreads();
    return;
  }
  constexpr int RV = SK_LN_MAX / 128;            // float4 a lane holds of a row
  const int warp = tid >> 5, lane = tid & 31, k4 = K / 4;
  float4 v[RV];
  const bool live = warp < rows;
  if (live) {
#pragma unroll
    for (int u = 0; u < RV; ++u) {
      const int i = lane + 32 * u;
      v[u] = i < k4 ? __ldcg((const float4*)(src + (size_t)warp * K) + i) : zero4;
    }
  }
  const TV* sc = layer_vec<TV>(a, p.lnv, p.lnl);
  const TV* sh = layer_vec<TV>(a, p.lnv + 1, p.lnl);
  for (int k = tid; k < K; k += SK_THREADS) {
    lnv[k] = ld(sc + k);
    lnv[Kp + k] = ld(sh + k);
  }
  for (int r = warp; r < sk_staged_rows(rows); r += SK_WARPS) {   // rows past B, pad columns
    const int from = r < rows ? k4 : 0;
    for (int i = from + lane; i < q4; i += 32) *(float4*)(as + r * st + 4 * i) = zero4;
  }
  __syncthreads();                                    // lnv
  if (live) {
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < RV; ++u) sum += (v[u].x + v[u].y) + (v[u].z + v[u].w);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum / K;
    float sq = 0.f;
#pragma unroll
    for (int u = 0; u < RV; ++u) {
      if (lane + 32 * u < k4) {
        const float dx = v[u].x - mu, dy = v[u].y - mu, dz = v[u].z - mu, dw = v[u].w - mu;
        sq += (dx * dx + dy * dy) + (dz * dz + dw * dw);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float inv = rsqrtf(sq / K + 1e-5f);
    float* x = as + warp * st;
#pragma unroll
    for (int u = 0; u < RV; ++u) {
      const int k = 4 * (lane + 32 * u);
      if (k < K) {
        float4 o;
        o.x = (v[u].x - mu) * inv * lnv[k] + lnv[Kp + k];
        o.y = (v[u].y - mu) * inv * lnv[k + 1] + lnv[Kp + k + 1];
        o.z = (v[u].z - mu) * inv * lnv[k + 2] + lnv[Kp + k + 2];
        o.w = (v[u].w - mu) * inv * lnv[k + 3] + lnv[Kp + k + 3];
        *(float4*)(x + k) = o;
      }
    }
  }
  __syncthreads();
}

// The operands of an item's epilogue a thread reads from global memory:
// the bias and, for O and F2, the residual.  Loaded before the products.
constexpr int SK_EPI = SK_WARPS * 128 / SK_THREADS;   // outputs a thread, at most

// One product phase.  red: SK_WARPS x 128 floats of shared memory; lnv: 2
// pad32(D); wsm: SK_WARPS x SK_WSMEM bytes.  TANH: FFN1's gelu is the tanh
// approximation (v2) instead of gelu_exact (A, v3).
template <typename TW, typename TV, bool TANH>
__device__ void sk_product(const StackTcArgs& a, int ph, int l, float* as, float* red,
                           float* lnv, uint4* wsm) {
  constexpr int U = sizeof(TW) / 2;            // 16-byte pieces a lane a chunk
  constexpr int CB = SK_WCHUNKS / U;           // chunks a batch
  const SkProd p = sk_prod<TW>(a, ph, l);
  const int NT = p.nt, KS = SK_WARPS / NT, K = p.K, C = p.Kp / 32, st = p.Kp + SK_APAD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tid = threadIdx.x;
  const int wn = warp % NT, ks = warp / NT;
  const int cpw = (C + KS - 1) / KS, c0 = min(C, ks * cpw), c1 = min(C, c0 + cpw);
  const int groups = p.N / 8 / NT, items = sk_items(a, p);
  const int g4 = lane >> 2, t4 = lane & 3;
  uint4* wl = wsm + (size_t)warp * (SK_WSMEM / 16) + lane * U;   // this lane's pieces
  int staged = -1;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int rt = it / groups, g = it % groups, j = g * NT + wn;
    const uint4* wp = p.w + ((size_t)j * C) * 32 * U + lane * U;
    auto load = [&](int cb) {                  // chunks cb.. of this warp's K slice
      for (int ci = 0; ci < CB && cb + ci < c1; ++ci)
#pragma unroll
        for (int u = 0; u < U; ++u)
          cp_async16(wl + ci * 32 * U + u, wp + (size_t)(cb + ci) * 32 * U + u, true);
      cp_async_commit();
    };
    load(c0);                                   // in flight while the rows are staged
    // this thread's outputs' bias and residual, also in flight
    float eb[SK_EPI], er[SK_EPI];
    const TV* bias = layer_vec<TV>(a, ph == SK_Q ? SV_BQKV : ph == SK_O ? SV_BO
                                   : ph == SK_F1 ? SV_B1 : SV_B2, l);
    const float* resid = ph == SK_O ? (l ? a.hres : a.h_in) : ph == SK_F2 ? a.h1 : nullptr;
#pragma unroll
    for (int e = 0; e < SK_EPI; ++e) {
      const int o = tid + e * SK_THREADS, idx = o & 127;
      const int m = rt * SK_ROWS + (idx >> 3), n = (g * NT + (o >> 7)) * 8 + (idx & 7);
      const bool on = o < NT * 128 && m < a.B;
      eb[e] = on ? ld(bias + n) : 0.f;
      er[e] = on && resid != nullptr ? __ldcg(resid + (size_t)m * a.D + n) : 0.f;
    }
    if (rt != staged) {
      sk_stage<TV>(a, p, rt, as, lnv);
      staged = rt;
    }
    if (it == (int)blockIdx.x) SK_MARK(l, 9 + 3 * ph);
    if (p.keep != nullptr && g == 0) {          // the layer's residual rows
      for (int i = tid; i < SK_ROWS * K; i += SK_THREADS) {
        const int r = i / K, k = i % K, m = rt * SK_ROWS + r;
        if (m < a.B) p.keep[(size_t)m * K + k] = as[r * st + k];
      }
    }
    const bool upper = a.B - rt * SK_ROWS > 8;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int cb = c0; cb < c1; cb += CB) {
      if (cb != c0) load(cb);
      cp_async_wait<0>();                       // this lane's pieces (no other lane's)
#pragma unroll
      for (int ci = 0; ci < CB; ++ci) {
        const int c = cb + ci;
        if (c >= c1) break;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int k0 = c * 32 + s * 16 + 2 * t4;
          const float2 x0 = *(const float2*)(as + g4 * st + k0);
          const float2 x2 = *(const float2*)(as + g4 * st + k0 + 8);
          uint32_t ah[4] = {0u, 0u, 0u, 0u}, am[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
          split2(x0.x, x0.y, ah[0], am[0], al[0]);
          split2(x2.x, x2.y, ah[2], am[2], al[2]);
          if (upper) {                          // rows 8-15 of the tile
            const float2 x1 = *(const float2*)(as + (g4 + 8) * st + k0);
            const float2 x3 = *(const float2*)(as + (g4 + 8) * st + k0 + 8);
            split2(x1.x, x1.y, ah[1], am[1], al[1]);
            split2(x3.x, x3.y, ah[3], am[3], al[3]);
          }
          // this depth's products in three fresh sums (independent, so the
          // tensor cores overlap them), added in f32 smallest first
          float f0[4] = {0.f, 0.f, 0.f, 0.f}, f1[4] = {0.f, 0.f, 0.f, 0.f};
          float f2[4] = {0.f, 0.f, 0.f, 0.f};
          if constexpr (U == 1) {
            const uint4 q = wl[ci * 32];
            const uint32_t b[2] = {s ? q.z : q.x, s ? q.w : q.y};
            mma_bf16(f0, al, b);
            mma_bf16(f1, am, b);
            mma_bf16(f2, ah, b);
          } else {
            const uint4 q = wl[ci * 64 + s];    // b0 b1 b2 b3 of depth s, f32
            uint32_t bh[2], bm[2], bl[2];
            split2(__uint_as_float(q.x), __uint_as_float(q.y), bh[0], bm[0], bl[0]);
            split2(__uint_as_float(q.z), __uint_as_float(q.w), bh[1], bm[1], bl[1]);
            mma_bf16(f0, al, bh);
            mma_bf16(f1, am, bm);
            mma_bf16(f2, ah, bm);
            mma_bf16(f0, ah, bl);
            mma_bf16(f1, am, bh);
            mma_bf16(f2, ah, bh);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] += (f0[q] + f1[q]) + f2[q];
        }
      }
    }
    if (it == (int)blockIdx.x) SK_MARK(l, 10 + 3 * ph);
    float* rw = red + warp * 128;
    rw[g4 * 8 + 2 * t4] = acc[0];
    rw[g4 * 8 + 2 * t4 + 1] = acc[1];
    rw[(g4 + 8) * 8 + 2 * t4] = acc[2];
    rw[(g4 + 8) * 8 + 2 * t4 + 1] = acc[3];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < SK_EPI; ++e) {
      const int o = tid + e * SK_THREADS;
      const int tl = o >> 7, idx = o & 127, r = idx >> 3;
      const int m = rt * SK_ROWS + r, n = (g * NT + tl) * 8 + (idx & 7);
      if (o >= NT * 128 || m >= a.B) continue;
      float v4[4] = {0.f, 0.f, 0.f, 0.f};        // four chains, added in a fixed order
      for (int q = 0; q < KS; ++q) v4[q & 3] += red[(q * NT + tl) * 128 + idx];
      float v = (v4[0] + v4[1]) + (v4[2] + v4[3]);
      const size_t mi = (size_t)m;
      if (ph == SK_Q) {
        const int E = a.D / a.H;
        v += eb[e];
        const bool is_qk = a.head_major ? (n % (3 * E)) < 2 * E : n < 2 * a.D;
        a.qkv[mi * 3 * a.D + n] = is_qk ? phi(v) : v;
      } else if (ph == SK_O) {
        a.r1[mi * a.D + n] = (er[e] + v) + eb[e];
      } else if (ph == SK_F1) {
        a.y[mi * a.DI + n] = TANH ? gelu_tanh(v + eb[e]) : gelu_exact(v + eb[e]);
      } else {
        a.r2[mi * a.D + n] = er[e] + (v + eb[e]);
      }
    }
    __syncthreads();                            // red and the staged rows are free again
    if (ph == SK_Q && tid == 0) {               // this item's qkv columns are written
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(a.cnt + rt) : "memory");
    }
    if (it == (int)blockIdx.x) SK_MARK(l, 11 + 3 * ph);
  }
}

// Where the state slice of (song b, head h) at layer l lies, and its z.
template <typename TS, bool AUG>
struct SkSlice {
  TS* s;          // E rows of W values
  const TS* z;    // E values zs apart
  int W, zs;
  __device__ SkSlice(const StackTcArgs& a, int l, int b, int h) {
    const int E = a.D / a.H;
    W = AUG ? E + 1 : E;
    s = AUG ? (TS*)a.s + (((size_t)l * a.H + h) * a.B + b) * E * W
            : (TS*)a.s + (((size_t)l * a.B + b) * a.H + h) * E * W;
    z = AUG ? s + E : (const TS*)a.z + (((size_t)l * a.B + b) * a.H + h) * E;
    zs = AUG ? W : 1;
  }
};

// The block that runs state item `it` (the last blocks first: they have
// the fewest product items) and the items of this block.
__device__ __forceinline__ int sk_state_item0(int items) {
  const int first = (int)gridDim.x - 1 - (int)blockIdx.x;
  return first < items ? first : items;
}

constexpr int SK_SROWS = 8;    // state rows a thread holds at once

// The state items of layer l: (song, head, 64 state columns).  sm: scratch.
template <typename TS, bool AUG>
__device__ void sk_state(const StackTcArgs& a, int l, float* sm) {
  const int B = a.B, H = a.H, D = a.D, E = D / H, tid = threadIdx.x;
  const int n_ct = (E + SK_CT - 1) / SK_CT, items = B * H * n_ct;
  const unsigned int target =
      (unsigned int)(l + 1) * (unsigned int)(3 * D / 8 / a.nt[SK_Q]);
  float* qs = sm;                 // E
  float* ks = qs + E;             // E
  float* zv = ks + E;             // E: z (before this token)
  float* vs = zv + E;             // SK_CT
  float* part = vs + SK_CT;       // SK_THREADS
  float* red = part + SK_THREADS; // 32
  const int c = tid % SK_CT, rg = tid / SK_CT;
  for (int it = sk_state_item0(items); it < items; it += gridDim.x) {
    const int b = it / (H * n_ct), h = (it / n_ct) % H, ct = it % n_ct, u = ct * SK_CT + c;
    const SkSlice<TS, AUG> sl(a, l, b, h);
    // this thread's first rows of S and the slice's z do not depend on the
    // token: read before the wait
    float old[SK_SROWS];
#pragma unroll
    for (int q = 0; q < SK_SROWS; ++q) {
      const int jj = rg + q * SK_RG;
      old[q] = u < E && jj < E ? ld(sl.s + (size_t)jj * sl.W + u) : 0.f;
    }
    for (int i = tid; i < E; i += SK_THREADS) zv[i] = ld(sl.z + (size_t)i * sl.zs);
    const bool first = it == sk_state_item0(items);
    if (first) SK_MARK(l, 21);
    if (tid == 0) {
      // a wait that outlasts any token (about 4 s) is a fault: trap rather
      // than hang the card
      for (unsigned int spin = 0; ld_acquire(a.cnt + b / SK_ROWS) < target; ++spin) {
        if (spin > (1u << 26)) __trap();
        __nanosleep(32);
      }
    }
    __syncthreads();
    if (first) SK_MARK(l, 22);
    const float* row = a.qkv + (size_t)b * 3 * D;
    const int qo = a.head_major ? h * 3 * E : h * E;
    const int ko = a.head_major ? qo + E : D + qo, vo = a.head_major ? qo + 2 * E : 2 * D + qo;
    for (int i = tid; i < E; i += SK_THREADS) {
      qs[i] = __ldcg(row + qo + i);
      ks[i] = __ldcg(row + ko + i);
    }
    if (tid < SK_CT) vs[tid] = u < E ? __ldcg(row + vo + u) : 0.f;
    __syncthreads();
    float dq = 0.f;
    for (int i = tid; i < E; i += SK_THREADS) dq = fmaf(qs[i], zv[i] + ks[i], dq);
    const float den = block_sum(dq, red) + a.eps;
    if (n_ct == 1)                  // the item's only reader of z: z += phi(k) now
      for (int i = tid; i < E; i += SK_THREADS)
        st(const_cast<TS*>(sl.z) + (size_t)i * sl.zs, zv[i] + ks[i]);
    float num = 0.f;
    if (u < E) {
      const float vu = vs[c];
      for (int j0 = rg; j0 < E; j0 += SK_RG * SK_SROWS) {
        if (j0 != rg) {
#pragma unroll
          for (int q = 0; q < SK_SROWS; ++q) {
            const int jj = j0 + q * SK_RG;
            old[q] = jj < E ? ld(sl.s + (size_t)jj * sl.W + u) : 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < SK_SROWS; ++q) {
          const int jj = j0 + q * SK_RG;
          if (jj < E) {
            const float sv = fmaf(ks[jj], vu, old[q]);
            st(sl.s + (size_t)jj * sl.W + u, sv);
            num = fmaf(qs[jj], sv, num);
          }
        }
      }
    }
    part[tid] = num;
    __syncthreads();
    if (rg == 0 && u < E) {
      float n = 0.f;
      for (int q = 0; q < SK_RG; ++q) n += part[q * SK_CT + c];
      a.att[(size_t)b * D + h * E + u] = n / den;
    }
    __syncthreads();
    if (first) SK_MARK(l, 23);
  }
}

// z += phi(k) for layer l (column E of the augmented state for v3),
// grid-wide, where a head's state items are several (E > SK_CT): every
// item has read z by the grid barrier before this pass.
template <typename TS, bool AUG>
__device__ void sk_z_update(const StackTcArgs& a, int l) {
  const int B = a.B, H = a.H, D = a.D, E = D / H, n = B * H * E;
  if (E <= SK_CT) return;
  for (int i = blockIdx.x * SK_THREADS + threadIdx.x; i < n; i += gridDim.x * SK_THREADS) {
    const int j = i % E, h = (i / E) % H, b = i / (E * H);
    const int ko = a.head_major ? h * 3 * E + E : D + h * E;
    const float k = __ldcg(a.qkv + (size_t)b * 3 * D + ko + j);
    TS* zp = AUG ? (TS*)a.s + ((((size_t)l * H + h) * B + b) * E + j) * (E + 1) + E
                 : (TS*)a.z + (((size_t)l * B + b) * H + h) * E + j;
    st(zp, ld(zp) + k);
  }
}


template <typename TW, typename TV, typename TS, bool AUG, bool TANH = false>
__global__ void __launch_bounds__(SK_THREADS, 1) stack_tc_kernel(StackTcArgs a) {
  extern __shared__ __align__(16) float sk_smem[];
  cgs::grid_group grid = cgs::this_grid();
  const int K = pad32(a.D > a.DI ? a.D : a.DI);
  uint4* wsm = reinterpret_cast<uint4*>(sk_smem);
  float* as = sk_smem + SK_WARPS * SK_WSMEM / 4;
  float* red = as + SK_ROWS * (K + SK_APAD);
  float* lnv = red + SK_WARPS * 128;
  for (int l = 0; l < a.L; ++l) {
    SK_MARK(l, 0);
    sk_product<TW, TV, TANH>(a, SK_Q, l, as, red, lnv, wsm);
    SK_MARK(l, 1);
    sk_state<TS, AUG>(a, l, as);
    SK_MARK(l, 2);
    grid.sync();
    SK_MARK(l, 3);
    sk_z_update<TS, AUG>(a, l);
    sk_product<TW, TV, TANH>(a, SK_O, l, as, red, lnv, wsm);
    SK_MARK(l, 4);
    grid.sync();
    SK_MARK(l, 5);
    sk_product<TW, TV, TANH>(a, SK_F1, l, as, red, lnv, wsm);
    SK_MARK(l, 6);
    grid.sync();
    SK_MARK(l, 7);
    sk_product<TW, TV, TANH>(a, SK_F2, l, as, red, lnv, wsm);
    SK_MARK(l, 8);
    grid.sync();
  }
  // h_out = LN2 of the last layer's r2, a warp a row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, D = a.D;
  const TV* sc = layer_vec<TV>(a, SV_LN2S, a.L - 1);
  const TV* sh = layer_vec<TV>(a, SV_LN2B, a.L - 1);
  for (int m = blockIdx.x * SK_WARPS + warp; m < a.B; m += gridDim.x * SK_WARPS) {
    const float* x = a.r2 + (size_t)m * D;
    float sum = 0.f;
    for (int k = lane; k < D; k += 32) sum += __ldcg(x + k);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum / D;
    float sq = 0.f;
    for (int k = lane; k < D; k += 32) {
      const float d = __ldcg(x + k) - mu;
      sq += d * d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float inv = rsqrtf(sq / D + 1e-5f);
    for (int k = lane; k < D; k += 32)
      a.h_out[(size_t)m * D + k] = (__ldcg(x + k) - mu) * inv * ld(sc + k) + ld(sh + k);
  }
  if (blockIdx.x == 0) {                       // every wait of this launch is over
    for (int i = threadIdx.x; i < (a.B + SK_ROWS - 1) / SK_ROWS; i += SK_THREADS) a.cnt[i] = 0;
    if (threadIdx.x == 0) atomicAdd(TANH ? &sk_runs_tanh : &sk_runs, 1ull);
  }
}

// f32 scratch floats a launch needs at batch B: hres, qkv (3 D), att, r1,
// h1, y (DI), r2.
inline long long stack_tc_scratch_floats(int B, int D, int DI) {
  return (long long)B * (8LL * D + DI);
}

// The launch's arguments: weights, vectors, state, input and output, and
// the scratch of stack_tc_scratch_floats cut into its buffers.
inline StackTcArgs stack_tc_args(const void* const* w, const void* const* v, void* s, void* z,
                                 const float* h_in, float* h_out, float* scratch,
                                 unsigned int* cnt, int L, int B, int D, int H, int DI,
                                 float eps, int head_major) {
  StackTcArgs a{};
  for (int i = 0; i < 4; ++i) a.w[i] = w[i];
  for (int i = 0; i < SV_N; ++i) a.v[i] = v[i];
  a.s = s;
  a.z = z;
  a.h_in = h_in;
  a.h_out = h_out;
  a.hres = scratch;
  a.qkv = a.hres + (size_t)B * D;
  a.att = a.qkv + (size_t)B * 3 * D;
  a.r1 = a.att + (size_t)B * D;
  a.h1 = a.r1 + (size_t)B * D;
  a.y = a.h1 + (size_t)B * D;
  a.r2 = a.y + (size_t)B * DI;
  a.cnt = cnt;
  a.L = L;
  a.B = B;
  a.D = D;
  a.H = H;
  a.DI = DI;
  a.eps = eps;
  a.head_major = head_major;
  return a;
}

// sk_runs (tanh: sk_runs_tanh) since the last reset (waits for the card);
// reset zeroes it after the read.  A negative value is minus a CUDA error
// code.
inline long long stack_tc_runs(int reset, bool tanh = false) {
  unsigned long long n = 0;
  cudaError_t e = tanh ? cudaMemcpyFromSymbol(&n, sk_runs_tanh, sizeof n)
                       : cudaMemcpyFromSymbol(&n, sk_runs, sizeof n);
  if (e == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    e = tanh ? cudaMemcpyToSymbol(sk_runs_tanh, &zero, sizeof zero)
             : cudaMemcpyToSymbol(sk_runs, &zero, sizeof zero);
  }
  return e == cudaSuccess ? (long long)n : -(long long)e;
}

// Column tiles of 8 an item for a product of N columns: the fewest (a
// power of two dividing both N / 8 and SK_WARPS) that keep the items within
// one wave of `grid` blocks.
inline int stack_tc_nt(int N, int B, int grid) {
  const int tiles = N / 8, rts = (B + SK_ROWS - 1) / SK_ROWS;
  int nt = 1;
  while (nt < SK_WARPS && tiles % (2 * nt) == 0 && (tiles / nt) * rts > grid) nt *= 2;
  return nt;
}

// Shapes the kernel takes: D, DI multiples of 8 (column tiles of 8,
// rows staged 16 bytes at a time), D <= 1024 (a LayerNorm row held by one
// warp), 16 rows of the widest product within a block's shared memory.
inline bool stack_tc_shape_ok(int D, int H, int DI) {
  return H > 0 && D % H == 0 && D % 8 == 0 && DI % 8 == 0 && D <= SK_LN_MAX &&
         stack_tc_smem_bytes(D, DI) <= 227 * 1024;
}

// One launch: a token through all L layers.  Fills a.nt, sets the launch
// grid (one block an SM) and returns 0 or a CUDA error code.
template <typename TW, typename TV, typename TS, bool AUG, bool TANH = false>
int stack_tc_launch(StackTcArgs a, cudaStream_t st) {
  auto kern = stack_tc_kernel<TW, TV, TS, AUG, TANH>;
  const size_t smem = stack_tc_smem_bytes(a.D, a.DI);
  // the function's shared-memory limit and the residency check, once an
  // instantiation and size (the first call is an eager one; a capture then
  // issues only the launch)
  static size_t ready_smem = 0;
  static int n_sm = 0;
  if (smem > ready_smem) {
    int dev = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, SK_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    ready_smem = smem;
  }
  const int grid = n_sm;
  a.nt[SK_Q] = stack_tc_nt(3 * a.D, a.B, grid);
  a.nt[SK_O] = stack_tc_nt(a.D, a.B, grid);
  a.nt[SK_F1] = stack_tc_nt(a.DI, a.B, grid);
  a.nt[SK_F2] = stack_tc_nt(a.D, a.B, grid);
  void* args[] = {&a};
  const cudaError_t e =
      cudaLaunchCooperativeKernel((const void*)kern, grid, SK_THREADS, args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace rlmg
