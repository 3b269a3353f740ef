// Causal linear-attention product of feature-mapped q and k, forward and
// backward ("kernel F"): the CUDA counterpart of
// reinforcement_learning_in_music_generation_tpu/ops/linear_attention.py
// _fwd_pallas (Pallas body _fwd_kernel) and _bwd_pallas (_bwd_dq_kernel,
// _bwd_dkv_kernel), which replaced fast_transformers' causal_product.
//
//   out_i = phi(q_i) S_i / (phi(q_i) . z_i + eps),
//   S_i = sum_{j <= i} phi(k_j) v_j^T,  z_i = sum_{j <= i} phi(k_j),
// with den_i = phi(q_i) . z_i returned unclipped beside out, as _fwd_pallas
// returns it.  phi(q), phi(k), v, out, the gradients: (B, H, S, E) f32 with
// batch / head / row strides that are multiples of 4 elements, 16-byte
// aligned bases and a unit last stride, so the (B, H, S, E) views of
// (B, S, H, E) projections go in and come out without copies; den
// (B, H, S) contiguous.  E <= 64, a multiple of 4.
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
//    (train_gemm_tc.cuh's arithmetic for kernels D and G).  The planes are
//    split in registers from f32 tiles in shared memory; the score tile
//    never leaves registers: its accumulator is the next product's A
//    operand.  The kernels are compiled for the model's head width
//    (E = 64: every loop unrolls without branches, so a tile's independent
//    products interleave) and for any other width.
//  * Loads: 16 bytes a thread by cp.async straight from the strided
//    tensors into shared memory, rows past S and columns past E filled
//    with zeros by the copy (nothing is padded or copied in memory).
//  * The last launch of a call counts the call's run on the card
//    (cp_runs), so graph replays are counted by the kernel.
//  What holds it back (PERF.md): the planes are split in registers for
//  each fragment, and at S > T the backward's dk / dv role does twice the
//  dq role's products.

#include <cuda_runtime.h>

#include <algorithm>

#include "tc_mma.cuh"

namespace rlmg {
namespace cpk {

constexpr int T = 64;            // rows a tile
constexpr int MAX_E = 64;
constexpr int PAD = 8;           // floats a shared-memory row is padded by

// Calls that ran to their end: [0] forward, [1] backward.
__device__ unsigned long long cp_runs[2];

// A (B, H, S, E) tensor: base and strides in elements (batch, head, row).
struct Bhse {
  const float* p;
  long long sb, sh, ss;
  __device__ __forceinline__ const float* at(int b, int h, int i, int e) const {
    return p + b * sb + h * sh + i * ss + e;
  }
  __device__ __forceinline__ float* mut(int b, int h, int i, int e) const {
    return const_cast<float*>(at(b, h, i, e));
  }
};

struct Args {
  Bhse q, k, v, o, g, dq, dk, dv;
  float* den;        // (B, H, S) contiguous
  float* scratch;    // S > T: per tile k^T [v|1] (and q^T [dnum|dd]), EP x KA each
  int H, S, E, EP, KA, NT;
  float eps;
};

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) / 16 * 16; }

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

// Rows [row0, row0 + n) of t into X (ld floats a row), `width` columns,
// by cp.async; rows >= S and columns >= E are zeros.
__device__ __forceinline__ void load_rows(float* X, int ld, const Bhse& t, int b, int h,
                                          int row0, int n, int width, const Args& a) {
  const int c4 = width / 4;
  for (int idx = threadIdx.x; idx < n * c4; idx += blockDim.x) {
    const int r = idx / c4, c = (idx % c4) * 4, i = row0 + r;
    const bool ok = i < a.S && c < a.E;
    cp_async16(X + r * ld + c, ok ? t.at(b, h, i, c) : t.p, ok);
  }
}
// Slot t of the scratch: tile t's state increment, k^T [v | 1] (which 0)
// or q^T [dnum | dd] (which 1).
__device__ __forceinline__ float* slot(const Args& a, int which, int b, int h, int t) {
  const size_t tile = (size_t)a.EP * a.KA;
  return a.scratch + ((((size_t)which * gridDim.z + b) * a.H + h) * a.NT + t) * tile;
}
// The ones column of [v | 1] for rows [row0, row0 + n) (after the copies landed).
__device__ __forceinline__ void set_ones(float* V, int ld, int row0, int n, const Args& a) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) V[r * ld + a.E] = row0 + r < a.S ? 1.f : 0.f;
}
// Of rows [row0, row0 + n) (n a multiple of 16): dd_i = -sum_f g out /
// (den + eps) into dd[] and den + eps into dv[] (0 and 1 past S), from the
// tensors, two threads a row with all their loads in flight at once (runs
// while the copies fly).
__device__ __forceinline__ void form_dd(float* dd, float* dv, int b, int h, int row0, int n,
                                        const Args& a) {
  for (int idx = threadIdx.x; idx < 2 * n; idx += blockDim.x) {
    const int r = idx >> 1, part = idx & 1, i = row0 + r;
    float s = 0.f;
    if (i < a.S) {
      const float4* gr = reinterpret_cast<const float4*>(a.g.at(b, h, i, 0));
      const float4* orow = reinterpret_cast<const float4*>(a.o.at(b, h, i, 0));
      float4 x[MAX_E / 8], y[MAX_E / 8];
#pragma unroll
      for (int c = 0; c < MAX_E / 8; ++c)
        if (2 * c + part < a.E / 4) {
          x[c] = gr[2 * c + part];
          y[c] = orow[2 * c + part];
        }
#pragma unroll
      for (int c = 0; c < MAX_E / 8; ++c)
        if (2 * c + part < a.E / 4)
          s = fmaf(x[c].w, y[c].w, fmaf(x[c].z, y[c].z, fmaf(x[c].y, y[c].y,
                                                             fmaf(x[c].x, y[c].x, s))));
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (part == 0) {
      const float d = i < a.S ? a.den[((size_t)b * a.H + h) * a.S + i] + a.eps : 1.f;
      dd[r] = -s / d;
      dv[r] = d;
    }
  }
}
// [dnum | dd] in place over the upstream gradient's rows in DN (KA wide;
// after the copies landed): dnum = g / (den + eps), column E = dd.
__device__ __forceinline__ void form_dnum(float* DN, int ld, const float* dd, const float* dv,
                                          int row0, int n, const Args& a) {
  const int c = a.E + 1;
  for (int idx = threadIdx.x; idx < n * c; idx += blockDim.x) {
    const int r = idx / c, f = idx % c;
    if (row0 + r >= a.S) continue;          // zeros already
    DN[r * ld + f] = f == a.E ? dd[r] : DN[r * ld + f] / dv[r];
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
  __device__ __forceinline__ explicit Dims(const Args& a)
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
template <int EC>
__global__ void __launch_bounds__(256, 2) cp_state_kernel(Args a) {
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

// X (EP x KA at ld) = the sum of the scratch slots [ta, tb) of kind which,
// in slot order; every thread keeps its columns' loads of up to 16 slots
// in flight at once (runs while the block's copies fly).
__device__ __forceinline__ void sum_slots(float* X, int ld, int which, int b, int h, int ta,
                                          int tb, const Args& a) {
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
    *reinterpret_cast<float4*>(X + e * ld + f) = s;
  }
}

// -- products of a warp ------------------------------------------------------------

// acc (16 x KA) += tril(q k^T) [v | 1] over the NK keys [key0, key0 + NK)
// of rows [R0, R0 + 16) (Qw, Kc, Vc at those rows and keys) when `keys`,
// plus q [S | z] over the depths [p0, p1) of q's columns when Sa is given.
template <int EC, int NK>
__device__ __forceinline__ void fwd_part(float (&acc)[NA_MAX][4], const float* Qw,
                                         const float* Kc, const float* Vc, bool keys,
                                         const float* Sa, int p0, int p1, int R0, int key0,
                                         const Args& a) {
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

// dq (16 x EP) += tril([dnum | dd] [v | 1]^T) k over the NK keys [key0,
// key0 + NK) of rows [R0, R0 + 16) when `keys`, plus [dnum | dd] [S | z]^T
// over the depths [p0, p1) of [dnum | dd]'s columns when Sa is given.
template <int EC, int NK>
__device__ __forceinline__ void dq_part(float (&dq)[MAX_E / 8][4], const float* DNw,
                                        const float* Kc, const float* Vc, bool keys,
                                        const float* Sa, int p0, int p1, int R0, int key0,
                                        const Args& a) {
  const Dims<EC> d(a);
  const int lde = d.EP + PAD, lda = d.KA + PAD, ne = d.EP / 8;
  float m[NK / 8][4];
  zero(m);
#pragma unroll
  for (int k0 = 0; k0 < MAX_E + 16; k0 += 16) {
    if (k0 >= d.KA) continue;
    uint32_t ad[3][4];
    frag_a_rows(ad, DNw, lda, k0);
    if (keys) {
#pragma unroll
      for (int n = 0; n < NK / 8; ++n) {
        uint32_t bv[3][2];
        frag_b_rows(bv, Vc + n * 8 * lda, lda, k0);
        mma6(m[n], ad, bv);
      }
    }
    if (Sa != nullptr && k0 >= p0 && k0 < p1) {
#pragma unroll
      for (int n = 0; n < MAX_E / 8; ++n) {
        if (n >= ne) continue;
        uint32_t bs[3][2];
        frag_b_rows(bs, Sa + n * 8 * lda, lda, k0);
        mma6(dq[n], ad, bs);
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
    for (int n = 0; n < MAX_E / 8; ++n) {
      if (n >= ne) continue;
      uint32_t bk[3][2];
      frag_b_cols(bk, Kc + n * 8, lde, ks * 16);
      mma6(dq[n], am, bk);
    }
  }
}

// Keys [J0, J0 + 16) (Kw, Vw) against the NQ queries [q0, q0 + NQ) (Qc,
// DNc) when `queries`: dk (16 x EP) += triu([v | 1] [dnum | dd]^T) q, plus
// [v | 1] [G | gz]^T over the depths [p0, p1) of [v | 1]'s columns when G
// is given.
template <int EC, int NQ>
__device__ __forceinline__ void dk_part(float (&dk)[MAX_E / 8][4], const float* Vw,
                                        const float* Qc, const float* DNc, bool queries,
                                        const float* G, int p0, int p1, int J0, int q0,
                                        const Args& a) {
  const Dims<EC> d(a);
  const int lde = d.EP + PAD, lda = d.KA + PAD, ne = d.EP / 8;
  float p[NQ / 8][4];
  zero(p);
#pragma unroll
  for (int k0 = 0; k0 < MAX_E + 16; k0 += 16) {
    if (k0 >= d.KA) continue;
    uint32_t av[3][4];
    frag_a_rows(av, Vw, lda, k0);
    if (queries) {
#pragma unroll
      for (int n = 0; n < NQ / 8; ++n) {
        uint32_t bd[3][2];
        frag_b_rows(bd, DNc + n * 8 * lda, lda, k0);
        mma6(p[n], av, bd);
      }
    }
    if (G != nullptr && k0 >= p0 && k0 < p1) {
#pragma unroll
      for (int n = 0; n < MAX_E / 8; ++n) {
        if (n >= ne) continue;
        uint32_t bg[3][2];
        frag_b_rows(bg, G + n * 8 * lda, lda, k0);
        mma6(dk[n], av, bg);
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
    for (int n = 0; n < MAX_E / 8; ++n) {
      if (n >= ne) continue;
      uint32_t bq[3][2];
      frag_b_cols(bq, Qc + ks * 16 * lde + n * 8, lde, 0);
      mma6(dk[n], ap, bq);
    }
  }
}

// The same keys and queries: dv (16 x EP) += triu(k q^T) dnum, plus k G
// over the depths [p0, p1) of k's columns when G is given.
template <int EC, int NQ>
__device__ __forceinline__ void dv_part(float (&dv)[MAX_E / 8][4], const float* Kw,
                                        const float* Qc, const float* DNc, bool queries,
                                        const float* G, int p0, int p1, int J0, int q0,
                                        const Args& a) {
  const Dims<EC> d(a);
  const int lde = d.EP + PAD, lda = d.KA + PAD, ne = d.EP / 8;
  float p[NQ / 8][4];
  zero(p);
#pragma unroll
  for (int k0 = 0; k0 < MAX_E; k0 += 16) {
    if (k0 >= d.EP) continue;
    uint32_t ak[3][4];
    frag_a_rows(ak, Kw, lde, k0);
    if (queries) {
#pragma unroll
      for (int n = 0; n < NQ / 8; ++n) {
        uint32_t bq[3][2];
        frag_b_rows(bq, Qc + n * 8 * lde, lde, k0);
        mma6(p[n], ak, bq);
      }
    }
    if (G != nullptr && k0 >= p0 && k0 < p1) {
#pragma unroll
      for (int n = 0; n < MAX_E / 8; ++n) {
        if (n >= ne) continue;
        uint32_t bg[3][2];
        frag_b_cols(bg, G + n * 8, lda, k0);
        mma6(dv[n], ak, bg);
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
    for (int n = 0; n < MAX_E / 8; ++n) {
      if (n >= ne) continue;
      uint32_t bd[3][2];
      frag_b_cols(bd, DNc + ks * 16 * lda + n * 8, lda, 0);
      mma6(dv[n], ap, bd);
    }
  }
}

// Rows [0, 16 nr) x columns f < E of the warps' partials red[w0 .. w1)
// (each 16 nr x ld), added in order, to rows [row0, row0 + 16 nr) of t.
__device__ __forceinline__ void reduce_rows(const float* red, int ld, int w0, int w1, int nr,
                                            const Bhse& t, int b, int h, int row0,
                                            const Args& a) {
  const int half = a.E / 2, rows = 16 * nr;
  for (int idx = threadIdx.x; idx < rows * half; idx += blockDim.x) {
    const int i = idx / half, f = 2 * (idx % half);
    if (row0 + i >= a.S) continue;
    float x = 0.f, y = 0.f;
    for (int ww = w0; ww < w1; ++ww) {
      x += red[(ww * rows + i) * ld + f];
      y += red[(ww * rows + i) * ld + f + 1];
    }
    *reinterpret_cast<float2*>(t.mut(b, h, row0 + i, f)) = make_float2(x, y);
  }
}
// The same for the forward's [num | den] partials (KA columns at ld):
// out = num / (den + eps) and den.
__device__ __forceinline__ void reduce_out(const float* red, int ld, int w0, int w1, int nr,
                                           int b, int h, int row0, const Args& a) {
  const int half = a.E / 2, rows = 16 * nr;
  float* dn = a.den + ((size_t)b * a.H + h) * a.S;
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
    *reinterpret_cast<float2*>(a.o.mut(b, h, row0 + i, f)) = make_float2(x * inv, y * inv);
    if (f == 0) dn[row0 + i] = ds;
  }
}

// -- the forward -----------------------------------------------------------------

// S <= T: block (16-row group r, head, sequence), 4 warps; warp w takes the
// keys [16 w, 16 w + 16) (w <= r), its partial sums meet in shared memory
// and are added in warp order.
template <int EC>
__global__ void __launch_bounds__(128) cp_fwd_short_kernel(Args a) {
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
template <int EC>
__global__ void __launch_bounds__(256, 2) cp_fwd_long_kernel(Args a) {
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
template <int EC>
__global__ void __launch_bounds__(128) cp_bwd_short_kernel(Args a) {
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
      dq_part<EC, 16>(d0, DN, K + 16 * w * lde, V + 16 * w * lda, true, nullptr, 0, 0, r0,
                      16 * w, a);
    __syncthreads();
    put_acc(red + w * 16 * lde, lde, d0, ne);
    __syncthreads();
    reduce_rows(red, lde, 0, r + 1, 1, a.dq, b, h, r0, a);
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
    const float* Qc = Q + (16 * w - r0) * lde;
    const float* DNc = DN + (16 * w - r0) * lda;
    if (on) {
      dk_part<EC, 16>(d0, V, Qc, DNc, true, nullptr, 0, 0, r0, 16 * w, a);
      dv_part<EC, 16>(d1, K, Qc, DNc, true, nullptr, 0, 0, r0, 16 * w, a);
    }
    __syncthreads();
    put_acc(red + w * 16 * lde, lde, d0, ne);
    put_acc(red + (4 + w) * 16 * lde, lde, d1, ne);
    __syncthreads();
    reduce_rows(red, lde, r, nw, 1, a.dk, b, h, r0, a);
    reduce_rows(red + 4 * 16 * lde, lde, r, nw, 1, a.dv, b, h, r0, a);
  }
  count_run(1);
}

// S > T: block (2 tile + role, head, sequence), 8 warps, warp w the rows
// [16 (w % 4), +16) of the tile and half, [32 (w / 4), +32), of the
// other side's rows (skipped where the mask keeps none) and of the depths
// of the state product; the halves' sums meet in shared memory.  Role 0:
// d phi(q) from the tile's keys and the prefix (S, z); role 1: d phi(k),
// dv from the tile's queries and the suffix (G, gz).
template <int EC>
__global__ void __launch_bounds__(256, 2) cp_bwd_long_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const Dims<EC> d(a);
  const int role = blockIdx.x & 1, tile = blockIdx.x >> 1, t0 = tile * T;
  const int h = blockIdx.y, b = blockIdx.z, w = threadIdx.x >> 5, rg = w & 3, hf = w >> 2;
  const int lde = d.EP + PAD, lda = d.KA + PAD, R0 = t0 + 16 * rg, c0 = t0 + 32 * hf;
  float* dd = sm;                    // 64, and den + eps 64
  float* DN = dd + 2 * T;            // 64 x KA
  float* K = DN + T * lda;           // 64 x EP
  float* V = K + T * lde;            // 64 x KA
  float* Q = V + T * lda;            // 64 x EP (role 1)
  float* Sa = Q + T * lde;           // EP x KA: [S | z] before, or [G | gz] after
  float* red = DN;                   // after the products: 2 x 2 x 64 x EP
  const bool more = role == 0 ? tile > 0 : tile < a.NT - 1;
  load_rows(DN, lda, a.g, b, h, t0, T, d.KA, a);
  load_rows(K, lde, a.k, b, h, t0, T, d.EP, a);
  load_rows(V, lda, a.v, b, h, t0, T, d.KA, a);
  if (role == 1) load_rows(Q, lde, a.q, b, h, t0, T, d.EP, a);
  cp_async_commit();
  if (more) {
    if (role == 0) {
      sum_slots(Sa, lda, 0, b, h, 0, tile, a);
    } else {
      sum_slots(Sa, lda, 1, b, h, tile + 1, a.NT, a);
    }
  }
  form_dd(dd, dd + T, b, h, t0, T, a);
  cp_async_wait<0>();
  __syncthreads();
  set_ones(V, lda, t0, T, a);
  form_dnum(DN, lda, dd, dd + T, t0, T, a);
  __syncthreads();
  const int ne = d.EP / 8, pa = d.KA / 32 * 16 + (d.KA % 32), pe = d.EP / 32 * 16;
  float d0[MAX_E / 8][4], d1[MAX_E / 8][4];
  zero(d0);
  zero(d1);
  if (role == 0) {
    dq_part<EC, 32>(d0, DN + 16 * rg * lda, K + 32 * hf * lde, V + 32 * hf * lda, c0 <= R0 + 15,
                    more ? Sa : nullptr, hf ? pa : 0, hf ? d.KA : pa, R0, c0, a);
  } else {
    const bool on = c0 + 31 >= R0;
    dk_part<EC, 32>(d0, V + 16 * rg * lda, Q + 32 * hf * lde, DN + 32 * hf * lda, on,
                    more ? Sa : nullptr, hf ? pa : 0, hf ? d.KA : pa, R0, c0, a);
    dv_part<EC, 32>(d1, K + 16 * rg * lde, Q + 32 * hf * lde, DN + 32 * hf * lda, on,
                    more ? Sa : nullptr, hf ? pe : 0, hf ? d.EP : pe, R0, c0, a);
  }
  __syncthreads();
  put_acc(red + (hf * T + 16 * rg) * lde, lde, d0, ne);
  if (role == 1) put_acc(red + ((2 + hf) * T + 16 * rg) * lde, lde, d1, ne);
  __syncthreads();
  if (role == 0) {
    reduce_rows(red, lde, 0, 2, 4, a.dq, b, h, t0, a);
  } else {
    reduce_rows(red, lde, 0, 2, 4, a.dk, b, h, t0, a);
    reduce_rows(red + 2 * T * lde, lde, 0, 2, 4, a.dv, b, h, t0, a);
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
  if (lng)
    return sizeof(float) * (2 * T + std::max(2 * T * lda + 2 * T * lde, 4 * T * lde) +
                            EP * lda);
  const size_t dq = 32 + std::max(16 * lda + T * lde + T * lda, 4 * 16 * lde);
  const size_t dkv = 2 * T + std::max(16 * (lde + lda) + T * (lde + lda), 8 * 16 * lde);
  return sizeof(float) * std::max(dq, dkv);
}
inline size_t state_smem(int EP, int KA) {
  return sizeof(float) * (2 * T + std::max((size_t)T * (EP + PAD + KA + PAD),
                                           2 * (size_t)EP * KA));
}

// Launch with `smem` bytes of dynamic shared memory, raising the kernel's
// limit once a device and size (the attribute call costs a driver round
// trip; a small table remembers what was set).
template <class K>
inline int launch(K kernel, dim3 grid, int threads, size_t smem, const Args& a,
                  cudaStream_t st) {
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

inline Args make_args(int H, int S, int E, float eps, float* scratch) {
  Args a{};
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

template <int EC>
inline int forward(const Args& a, int B, cudaStream_t st) {
  if (a.NT == 1)
    return launch(cp_fwd_short_kernel<EC>, dim3((a.S + 15) / 16, a.H, B), 128,
                  fwd_smem(false, a.EP, a.KA), a, st);
  const int rc = launch(cp_state_kernel<EC>, dim3(a.NT - 1, a.H, B), 256,
                        state_smem(a.EP, a.KA), a, st);
  if (rc) return rc;
  return launch(cp_fwd_long_kernel<EC>, dim3(a.NT, a.H, B), 256, fwd_smem(true, a.EP, a.KA), a,
                st);
}

template <int EC>
inline int backward(const Args& a, int B, cudaStream_t st) {
  if (a.NT == 1)
    return launch(cp_bwd_short_kernel<EC>, dim3(2 * ((a.S + 15) / 16), a.H, B), 128,
                  bwd_smem(false, a.EP, a.KA), a, st);
  const int rc = launch(cp_state_kernel<EC>, dim3(2 * (a.NT - 1), a.H, B), 256,
                        state_smem(a.EP, a.KA), a, st);
  if (rc) return rc;
  return launch(cp_bwd_long_kernel<EC>, dim3(2 * a.NT, a.H, B), 256, bwd_smem(true, a.EP, a.KA),
                a, st);
}

inline Bhse bhse(const void* p, const long long* s) {
  return Bhse{(const float*)p, s[0], s[1], s[2]};
}

inline bool shape_ok(int B, int H, int S, int E) {
  return B > 0 && B <= 65535 && H > 0 && H <= 65535 && S > 0 && E > 0 && E % 4 == 0 &&
         E <= MAX_E;
}

}  // namespace cpk
}  // namespace rlmg

extern "C" {

// f32 scratch floats a call at these shapes needs (0 at S <= 64): the
// prefix (and, backward, suffix) state of each tile.
long long rlmg_causal_product_scratch_floats(int B, int H, int S, int E, int backward) {
  using namespace rlmg::cpk;
  const int nt = (S + T - 1) / T;
  if (nt <= 1) return 0;
  return (backward ? 2LL : 1LL) * B * H * nt * round16(E) * round16(E + 1);
}

// phi(q), phi(k), v (B, H, S, E) f32 -> out (B, H, S, E) and den (B, H, S).
// strides: (batch, head, row) of phi(q), phi(k), v, out, in elements;
// scratch: rlmg_causal_product_scratch_floats(..., 0) floats.  One launch
// at S <= 64, else two (the state pass first).  Returns 0 or a CUDA error
// code.
int rlmg_causal_product_fwd(const void* pq, const void* pk, const void* v, void* out, float* den,
                            float* scratch, const long long* strides, int B, int H, int S,
                            int E, float eps, void* stream) {
  using namespace rlmg::cpk;
  if (!shape_ok(B, H, S, E)) return (int)cudaErrorInvalidValue;
  Args a = make_args(H, S, E, eps, scratch);
  a.q = bhse(pq, strides);
  a.k = bhse(pk, strides + 3);
  a.v = bhse(v, strides + 6);
  a.o = bhse(out, strides + 9);
  a.den = den;
  const cudaStream_t st = (cudaStream_t)stream;
  return E == 64 ? forward<64>(a, B, st) : forward<0>(a, B, st);
}

// From the forward's inputs, out and den and the upstream gradient g,
// writes d phi(q), d phi(k), dv.  strides: (batch, head, row) of phi(q),
// phi(k), v, out, g, dq, dk, dv; scratch: ..._scratch_floats(..., 1).
int rlmg_causal_product_bwd(const void* pq, const void* pk, const void* v, const void* out,
                            const float* den, const void* g, void* dq, void* dk, void* dv,
                            float* scratch, const long long* strides, int B, int H, int S,
                            int E, float eps, void* stream) {
  using namespace rlmg::cpk;
  if (!shape_ok(B, H, S, E)) return (int)cudaErrorInvalidValue;
  Args a = make_args(H, S, E, eps, scratch);
  a.q = bhse(pq, strides);
  a.k = bhse(pk, strides + 3);
  a.v = bhse(v, strides + 6);
  a.o = bhse(out, strides + 9);
  a.g = bhse(g, strides + 12);
  a.dq = bhse(dq, strides + 15);
  a.dk = bhse(dk, strides + 18);
  a.dv = bhse(dv, strides + 21);
  a.den = const_cast<float*>(den);
  const cudaStream_t st = (cudaStream_t)stream;
  return E == 64 ? backward<64>(a, B, st) : backward<0>(a, B, st);
}

// Calls that ran to their end on the current card since the last reset,
// as the kernel counts them: runs[0] forward, runs[1] backward.  Waits for
// the card; reset zeroes the counts after reading them.  Returns 0 or a
// CUDA error code.
int rlmg_causal_product_runs(long long* runs, int reset) {
  unsigned long long n[2] = {0, 0};
  cudaError_t e = cudaMemcpyFromSymbol(n, rlmg::cpk::cp_runs, sizeof n);
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[2] = {0, 0};
    e = cudaMemcpyToSymbol(rlmg::cpk::cp_runs, zero, sizeof zero);
  }
  runs[0] = (long long)n[0];
  runs[1] = (long long)n[1];
  return (int)e;
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
