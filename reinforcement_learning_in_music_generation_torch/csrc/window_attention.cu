// Band (sliding-window) softmax attention, forward and backward: the CUDA
// counterpart of
// reinforcement_learning_in_music_generation_tpu/ops/window_attention_kernel.py
// window_attention_pallas (its Pallas bodies _fwd_kernel, _dq_kernel and
// _dkv_kernel).
//
// q, k, v, out (B, H, S, E) f32 with any batch / head / row strides (the last
// dimension contiguous); mask (B, S) f32, 1 = keep.  Query i sees key j when
// |i - j| <= w and j < S: keys outside that band are not in the row's softmax
// (the kernels visit only the key tiles the band touches, and drop the rest
// of a tile); a key inside it that the mask drops scores the finite -1e9, as
// on the TPU.  Every row is finite: a row with no kept key in its band
// averages its band uniformly.  Masked scores are constants, so they pass no
// gradient to q or k.
//
// Forward, wa_fwd_kernel: one block per (64 query rows, batch x head).  The
// block keeps q^T in shared memory and walks the 64-key tiles of
// [q0 - w, q0 + 63 + w] clipped to [0, S) (at most 10 at w = 256), with an
// online softmax: per tile S = q k^T * scale, the running row max m and sum l,
// out = out * exp(m_old - m_new) + P v.  It writes out / l and the row
// statistics (m, log l), whose sum is the row's LSE.  The backward takes
// P = exp((S - m) - log l) from them, not exp(S - LSE): in a row whose band
// holds only masked keys m = -1e9, and m + log l rounds back to m in f32.
// The TPU kernel read a 256-row block against its three clamped neighbours,
// which needed block >= w; the tile loop takes any w.
// Backward, two passes as on the TPU, both deterministic (no atomics):
//   wa_dq_kernel   per query tile: D = rowsum(dO * O) (written for the next
//                  pass), then over its key tiles P = exp((S - m) - log l),
//                  dP = dO v^T, dS = P (dP - D), dq += dS k;
//   wa_dkv_kernel  per key tile, over the query tiles that see it (the same
//                  band, mirrored): dv += P^T dO, dk += dS^T q.
// Thread layout of every 64 x 64 product: 256 threads, each a 4 x 4 register
// block (rows 4 (tid / 16), columns 4 (tid % 16)) summed from shared memory
// by outer4 (train_gemm.cuh); the 16 lanes that share a row reduce its max
// and sum with shuffles.  Shared memory: forward 64 KB, dq 96 KB, dk/dv 112
// KB at E = 64, so two blocks fit on an SM.
//
// Bound on the card (PERF.md).  At B = 4, H = 8, S = 3584, E = 64, w = 256 the
// band holds 1,772,800 (query, key) pairs per (b, h): the forward is 2
// products (14.52 GFLOP) and the backward 5 (36.31 GFLOP), against ~0.04 ms
// of bytes, so f32 operations bind (0.217 / 0.542 ms at 67 TFLOP/s outside
// the tensor cores).  What the design does about it: every product runs from
// shared memory in 4x4 register blocks and the (64, 64) score, probability
// and dS tiles never leave shared memory; the 64-row tiles compute 12% more
// pairs than the band holds.  No tensor cores yet.

#include "train_gemm.cuh"

namespace rlmg {

constexpr int WA_T = 64, WA_THREADS = 256, WA_MAX_E = 64;
constexpr float WA_NEG = -1e9f;          // score of a masked key (finite, as on the TPU)
constexpr float WA_FLOOR = -3.0e38f;     // running max before any key is seen

// A (B, H, S, E) tensor: base and strides in elements (batch, head, row).
struct Bhsd {
  const float* p;
  long long sb, sh, ss;
  __device__ __forceinline__ const float* row(int b, int h, int s) const {
    return p + b * sb + h * sh + s * ss;
  }
};

// Rows s0 .. s0 + 63 of (b, h) into shared memory: transposed T[e][i]
// and / or row-major R[i][e] (either may be null); rows at or past S are 0.
__device__ __forceinline__ void load_tile(const Bhsd& t, int b, int h, int s0, int S, int E,
                                          float* T, float* R) {
  const int E4 = E / 4;
  if (T != nullptr)
    for (int idx = threadIdx.x; idx < WA_T * E4; idx += WA_THREADS) {
      const int i = idx % WA_T, e = 4 * (idx / WA_T);   // i fastest: conflict-free stores
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s0 + i < S) x = *reinterpret_cast<const float4*>(t.row(b, h, s0 + i) + e);
      T[e * WA_T + i] = x.x;
      T[(e + 1) * WA_T + i] = x.y;
      T[(e + 2) * WA_T + i] = x.z;
      T[(e + 3) * WA_T + i] = x.w;
    }
  if (R != nullptr)
    for (int idx = threadIdx.x; idx < WA_T * E4; idx += WA_THREADS) {
      const int i = idx / E4, e = 4 * (idx % E4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s0 + i < S) x = *reinterpret_cast<const float4*>(t.row(b, h, s0 + i) + e);
      *reinterpret_cast<float4*>(R + i * E + e) = x;
    }
}

// Keep flags of keys k0 .. k0 + 63 (0 past S).
__device__ __forceinline__ void load_keep(const float* mask, int b, int k0, int S, float* km) {
  for (int j = threadIdx.x; j < WA_T; j += WA_THREADS)
    km[j] = k0 + j < S ? mask[(size_t)b * S + k0 + j] : 0.f;
}

__device__ __forceinline__ bool in_band(int qp, int kp, int S, int w) {
  return qp < S && kp < S && abs(qp - kp) <= w;
}

// max / sum over the 16 lanes that share a row group (lanes differ in bits 0-3)
__device__ __forceinline__ float row16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void store4(float* dst, const float (&a)[4], float s) {
  *reinterpret_cast<float4*>(dst) = make_float4(a[0] * s, a[1] * s, a[2] * s, a[3] * s);
}

__global__ void __launch_bounds__(WA_THREADS, 2)
wa_fwd_kernel(Bhsd q, Bhsd k, Bhsd v, const float* __restrict__ mask, Bhsd o,
              float* __restrict__ stats, int H, int S, int E, int w, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* qT = sm;                      // E x T
  float* kT = qT + E * WA_T;           // E x T
  float* vr = kT + E * WA_T;           // T x E
  float* PT = vr + WA_T * E;           // T x T, PT[j][i] = P[i][j]
  float* km = PT + WA_T * WA_T;        // T
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * WA_T;
  const int r0 = (threadIdx.x >> 4) * 4, c0 = (threadIdx.x & 15) * 4;
  load_tile(q, b, h, q0, S, E, qT, nullptr);
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) m[ii] = WA_FLOOR, l[ii] = 0.f;
  zero4(acc);
  const int kt0 = max(0, q0 - w) / WA_T, kt1 = min(S - 1, q0 + WA_T - 1 + w) / WA_T;
  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k0 = kt * WA_T;
    __syncthreads();                   // the last tile's readers are done
    load_tile(k, b, h, k0, S, E, kT, nullptr);
    load_tile(v, b, h, k0, S, E, nullptr, vr);
    load_keep(mask, b, k0, S, km);
    __syncthreads();
    float s[4][4];
    zero4(s);
    outer4(s, qT, WA_T, r0, kT, WA_T, c0, E);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      float mt = WA_FLOOR;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (in_band(q0 + r0 + ii, k0 + c0 + jj, S, w)) {
          s[ii][jj] = km[c0 + jj] > 0.f ? s[ii][jj] * scale : WA_NEG;
          mt = fmaxf(mt, s[ii][jj]);
        } else {
          s[ii][jj] = -INFINITY;       // not in the row's softmax
        }
      }
      const float mn = fmaxf(m[ii], row16_max(mt));
      const float alpha = expf(m[ii] - mn);
      m[ii] = mn;
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = s[ii][jj] == -INFINITY ? 0.f : expf(s[ii][jj] - mn);
        PT[(c0 + jj) * WA_T + r0 + ii] = p;
        ps += p;
      }
      l[ii] = l[ii] * alpha + row16_sum(ps);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[ii][jj] *= alpha;
    }
    __syncthreads();
    if (c0 < E) outer4(acc, PT, WA_T, r0, vr, E, c0, WA_T);
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int qp = q0 + r0 + ii;
    if (qp >= S) continue;
    if (c0 < E) store4(const_cast<float*>(o.row(b, h, qp)) + c0, acc[ii], 1.f / l[ii]);
    if (c0 == 0) {                     // (m, log l): rows of stats[0] and stats[1]
      stats[(size_t)bh * S + qp] = m[ii];
      stats[(size_t)gridDim.y * S + (size_t)bh * S + qp] = logf(l[ii]);
    }
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

// The (m, log l) of query rows q0 .. q0 + 63 into rm, rl (0 past S).
__device__ __forceinline__ void load_stats(const float* stats, size_t n_rows, int bh, int q0,
                                           int S, float* rm, float* rl) {
  for (int i = threadIdx.x; i < WA_T; i += WA_THREADS) {
    const bool ok = q0 + i < S;
    rm[i] = ok ? stats[(size_t)bh * S + q0 + i] : 0.f;
    rl[i] = ok ? stats[n_rows + (size_t)bh * S + q0 + i] : 0.f;
  }
}

__global__ void __launch_bounds__(WA_THREADS, 2)
wa_dq_kernel(Bhsd q, Bhsd k, Bhsd v, const float* __restrict__ mask, Bhsd o, Bhsd dout,
             const float* __restrict__ stats, float* __restrict__ rowdot, Bhsd dq, int H,
             int S, int E, int w, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* qT = sm;                      // E x T
  float* doT = qT + E * WA_T;          // E x T
  float* kT = doT + E * WA_T;          // E x T
  float* vT = kT + E * WA_T;           // E x T
  float* kr = vT + E * WA_T;           // T x E
  float* dST = kr + WA_T * E;          // T x T, dST[j][i] = dS[i][j]
  float* km = dST + WA_T * WA_T;       // T
  float* rm = km + WA_T;               // T: row max m of the tile's rows
  float* rl = rm + WA_T;               // T: their log l
  float* rd = rl + WA_T;               // T: their D
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * WA_T;
  const int r0 = (threadIdx.x >> 4) * 4, c0 = (threadIdx.x & 15) * 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_tile(q, b, h, q0, S, E, qT, nullptr);
  load_tile(dout, b, h, q0, S, E, doT, nullptr);
  for (int i = warp; i < WA_T; i += WA_THREADS / 32) {   // D = rowsum(dO * O), a warp a row
    float d = 0.f;
    if (q0 + i < S) {
      const float* gr = dout.row(b, h, q0 + i);
      const float* orow = o.row(b, h, q0 + i);
      for (int f = lane; f < E; f += 32) d = fmaf(gr[f], orow[f], d);
    }
    d = warp_sum(d);
    if (lane == 0) {
      rd[i] = d;
      if (q0 + i < S) rowdot[(size_t)bh * S + q0 + i] = d;
    }
  }
  load_stats(stats, (size_t)gridDim.y * S, bh, q0, S, rm, rl);
  float acc[4][4];
  zero4(acc);
  const int kt0 = max(0, q0 - w) / WA_T, kt1 = min(S - 1, q0 + WA_T - 1 + w) / WA_T;
  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k0 = kt * WA_T;
    __syncthreads();
    load_tile(k, b, h, k0, S, E, kT, kr);
    load_tile(v, b, h, k0, S, E, vT, nullptr);
    load_keep(mask, b, k0, S, km);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero4(s);
    zero4(dp);
    outer4(s, qT, WA_T, r0, kT, WA_T, c0, E);
    outer4(dp, doT, WA_T, r0, vT, WA_T, c0, E);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        bool kept;
        const float p = band_prob(s[ii][jj], q0 + r0 + ii, k0 + c0 + jj, km[c0 + jj],
                                  rm[r0 + ii], rl[r0 + ii], S, w, scale, kept);
        dST[(c0 + jj) * WA_T + r0 + ii] = kept ? p * (dp[ii][jj] - rd[r0 + ii]) : 0.f;
      }
    __syncthreads();
    if (c0 < E) outer4(acc, dST, WA_T, r0, kr, E, c0, WA_T);
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
    if (q0 + r0 + ii < S && c0 < E)
      store4(const_cast<float*>(dq.row(b, h, q0 + r0 + ii)) + c0, acc[ii], scale);
}

// Per key tile: rows of the 4x4 blocks are keys (j), columns queries (i).
__global__ void __launch_bounds__(WA_THREADS, 2)
wa_dkv_kernel(Bhsd q, Bhsd k, Bhsd v, const float* __restrict__ mask, Bhsd dout,
              const float* __restrict__ stats, const float* __restrict__ rowdot, Bhsd dk,
              Bhsd dv, int H, int S, int E, int w, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* kT = sm;                      // E x T
  float* vT = kT + E * WA_T;           // E x T
  float* qT = vT + E * WA_T;           // E x T
  float* doT = qT + E * WA_T;          // E x T
  float* qr = doT + E * WA_T;          // T x E
  float* dor = qr + WA_T * E;          // T x E
  float* Pb = dor + WA_T * E;          // T x T, Pb[i][j]: P, then dS
  float* km = Pb + WA_T * WA_T;        // T
  float* rm = km + WA_T;               // T: m, log l and D of the query tile's rows
  float* rl = rm + WA_T;               // T
  float* rd = rl + WA_T;               // T
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * WA_T;
  const int r0 = (threadIdx.x >> 4) * 4, c0 = (threadIdx.x & 15) * 4;
  load_tile(k, b, h, k0, S, E, kT, nullptr);
  load_tile(v, b, h, k0, S, E, vT, nullptr);
  load_keep(mask, b, k0, S, km);
  float dka[4][4], dva[4][4];
  zero4(dka);
  zero4(dva);
  const int qt0 = max(0, k0 - w) / WA_T, qt1 = min(S - 1, k0 + WA_T - 1 + w) / WA_T;
  for (int qt = qt0; qt <= qt1; ++qt) {
    const int q0 = qt * WA_T;
    __syncthreads();
    load_tile(q, b, h, q0, S, E, qT, qr);
    load_tile(dout, b, h, q0, S, E, doT, dor);
    load_stats(stats, (size_t)gridDim.y * S, bh, q0, S, rm, rl);
    for (int i = threadIdx.x; i < WA_T; i += WA_THREADS)
      rd[i] = q0 + i < S ? rowdot[(size_t)bh * S + q0 + i] : 0.f;
    __syncthreads();
    float st[4][4], dpt[4][4], ds[4][4];
    zero4(st);
    zero4(dpt);
    outer4(st, kT, WA_T, r0, qT, WA_T, c0, E);      // S^T[j][i]
    outer4(dpt, vT, WA_T, r0, doT, WA_T, c0, E);    // dP^T[j][i]
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        bool kept;
        const float p = band_prob(st[jj][ii], q0 + c0 + ii, k0 + r0 + jj, km[r0 + jj],
                                  rm[c0 + ii], rl[c0 + ii], S, w, scale, kept);
        ds[jj][ii] = kept ? p * (dpt[jj][ii] - rd[c0 + ii]) : 0.f;
        Pb[(c0 + ii) * WA_T + r0 + jj] = p;
      }
    __syncthreads();
    if (c0 < E) outer4(dva, Pb, WA_T, r0, dor, E, c0, WA_T);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) Pb[(c0 + ii) * WA_T + r0 + jj] = ds[jj][ii];
    __syncthreads();
    if (c0 < E) outer4(dka, Pb, WA_T, r0, qr, E, c0, WA_T);
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int kp = k0 + r0 + jj;
    if (kp >= S || c0 >= E) continue;
    store4(const_cast<float*>(dk.row(b, h, kp)) + c0, dka[jj], scale);
    store4(const_cast<float*>(dv.row(b, h, kp)) + c0, dva[jj], 1.f);
  }
}

inline size_t fwd_smem(int E) { return (3 * (size_t)E * WA_T + WA_T * WA_T + WA_T) * 4; }
inline size_t dq_smem(int E) { return (5 * (size_t)E * WA_T + WA_T * WA_T + 4 * WA_T) * 4; }
inline size_t dkv_smem(int E) { return (6 * (size_t)E * WA_T + WA_T * WA_T + 4 * WA_T) * 4; }

inline Bhsd tensor(const float* p, const long long* st) { return Bhsd{p, st[0], st[1], st[2]}; }

inline bool shape_ok(int B, int H, int S, int E, int w) {
  return B > 0 && H > 0 && S > 0 && w > 0 && E > 0 && E % 4 == 0 && E <= WA_MAX_E;
}

}  // namespace rlmg

extern "C" {

// out (B, H, S, E) of q, k, v and mask, and stats (2, B, H, S) contiguous
// f32: each row's max score m and log l (LSE = m + log l).  strides:
// (batch, head, row) of q, k, v, out, in elements; w the one-sided window;
// scale = 1 / sqrt(E).  Returns 0 or the first CUDA error code.
int rlmg_window_attn_fwd(const float* q, const float* k, const float* v, const float* mask,
                         float* out, float* stats, const long long* strides, int B, int H,
                         int S, int E, int w, float scale, void* stream) {
  using namespace rlmg;
  if (!shape_ok(B, H, S, E, w)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = fwd_smem(E);
  cudaFuncSetAttribute(wa_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((S + WA_T - 1) / WA_T, B * H);
  wa_fwd_kernel<<<grid, WA_THREADS, smem, st>>>(
      tensor(q, strides), tensor(k, strides + 3), tensor(v, strides + 6), mask,
      tensor(out, strides + 9), stats, H, S, E, w, scale);
  RLMG_CHECK();
  return 0;
}

// dq, dk, dv of the upstream gradient dout, from the forward's out and
// stats.  rowdot: (B, H, S) f32 scratch for D = rowsum(dout * out).
// strides: q, k, v, out, dout, dq, dk, dv.
int rlmg_window_attn_bwd(const float* q, const float* k, const float* v, const float* mask,
                         const float* out, const float* dout, const float* stats, float* rowdot,
                         float* dq, float* dk, float* dv, const long long* strides, int B, int H,
                         int S, int E, int w, float scale, void* stream) {
  using namespace rlmg;
  if (!shape_ok(B, H, S, E, w)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Bhsd tq = tensor(q, strides), tk = tensor(k, strides + 3), tv = tensor(v, strides + 6);
  const Bhsd to = tensor(out, strides + 9), tdo = tensor(dout, strides + 12);
  const size_t s1 = dq_smem(E), s2 = dkv_smem(E);
  cudaFuncSetAttribute(wa_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  cudaFuncSetAttribute(wa_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  const dim3 grid((S + WA_T - 1) / WA_T, B * H);
  wa_dq_kernel<<<grid, WA_THREADS, s1, st>>>(tq, tk, tv, mask, to, tdo, stats, rowdot,
                                             tensor(dq, strides + 15), H, S, E, w, scale);
  RLMG_CHECK();
  wa_dkv_kernel<<<grid, WA_THREADS, s2, st>>>(tq, tk, tv, mask, tdo, stats, rowdot,
                                              tensor(dk, strides + 18), tensor(dv, strides + 21),
                                              H, S, E, w, scale);
  RLMG_CHECK();
  return 0;
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
