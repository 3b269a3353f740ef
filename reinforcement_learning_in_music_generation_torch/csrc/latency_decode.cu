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
//
// Arithmetic.  With bf16 weights all three TPU kernels round each product's
// input activations to the weights' type and sum in f32 (qkv, Wo, FFN1,
// FFN2 and the heads: decode_kernel_v8.py :245 :269 :273 :276 :283, v7 :129
// :154 :158 :161 :168, v5 :276 :329 :335 :338 :382); v8 and v7 also store
// the folded embedding rows in the weights' type (make_resident_params
// :137), v5 keeps them f32.  So do these kernels (ld_round); the biases,
// phi, the state update, den, gelu, the residuals, the LayerNorms and the
// sampling stay f32.  With f32 weights every rounding is a no-op.
//
// v8 and v7 share one set of device functions (the lp_* phases below) and
// differ only in how much of them one launch runs:
//
//   v8  one persistent cooperative launch per chunk, one block per SM (all
//       co-resident, as a cooperative launch guarantees).  Each block owns
//       fixed (layer, song, head) slices of the state S, z: it loads them
//       into shared memory at the start, updates them there and writes them
//       back at the end (the counterpart of v8's VMEM-resident state).
//   v7  per token L cooperative layer launches, one heads launch and one
//       sampling launch, captured once per shape as a CUDA graph and
//       replayed T times (the token index lives on the card, advanced by
//       the heads launch); each launch is a programmatic dependent of the
//       one before, so its weight requests overlap the previous launch's
//       tail.  The state lives in device memory.
// The same functions in the same order give v7 and v8 bit-equal tokens and
// states: every item's arithmetic is fixed by the shape, never by the grid,
// the block that runs it or how much shared memory the block has.
//
// A token is 4 L + 2 grid-wide barriers (LP_BARRIERS_LAYER a layer, then
// the heads and the sampling; a barrier is a grid.sync or the start of a
// launch, which waits for the whole launch before it; the kernels count
// those they pass, LpBarriers), 4 phases a layer:
//   Q   every block with an item forms the layer input x (B <= 16 rows) in
//       registers itself: at layer 0 the embedding, sum_f M[off_f + tok_f]
//       + b_in + pe[pos], else LN2 of the previous layer's r2; the block of
//       song b also writes x[b] for the residual.  Items: 16 columns of
//       Wqkv over the whole K, qkv = x @ Wqkv + b (phi on q and k).
//   S   one item per owned (song, head) slice: S += phi(k) v^T, z +=
//       phi(k), att = phi(q)^T S / (phi(q).z + eps) (attn_slice of
//       decode_layers.cuh), then that head's share of the Wo product, att
//       times the head's E rows of Wo, to a partial row; a counter per song
//       (release / acquire) says when the song's H partials are written, and
//       each slice then adds its E columns of them in head order: r1 = (x +
//       sum) + bo.  The counter waits only on the H blocks of one song.
//   F1  LN1 of r1 in registers (the block of song b writes h1[b]); items of
//       16 columns of W1: y = gelu_exact(h1 @ W1 + b1), stored in the
//       weights' type (FFN2 rounds it there anyway).
//   F2  items of 16 columns of W2 over the whole K = DI: r2 = h1 + (y @ W2
//       + b2).
// then per token
//   H   LN2 and the final LN of r2 in registers; items of 16 of the NF x 256
//       padded head columns: logits = hf @ Wh + hb
//   samp one block per (song, field): temperature, the 24-step bisection
//       nucleus and Gumbel-max with Philox4x32-10 bits at counter (position,
//       field, vocab index, song) (sample_logit of decode_sample.cuh, kernel
//       B's), so a chunk split into two calls emits the same tokens.
// Every reduction has a fixed order; no atomics in any sum.
//
// Products.  Every weight tile a block will read is requested before it is
// needed: each block streams its items' tiles, in the order its phases will
// consume them, through a ring of 8 KB shared-memory slots filled by TMA
// copies that one thread issues (a box of 16 columns of a tensor map made
// per call for the products, contiguous bytes for Wo rows; each slot's
// completion counted by an mbarrier); when the block is done with a slot it
// refills it with the next tile of its stream, so the next phases' weights
// are in flight across the barrier and after it the block waits only for
// activations (a few KB from L2).  With bf16 weights a product is
// mma.sync.m16n8k16 bf16 -> f32: the B <= 16 songs are one 16-row A tile
// (unused rows zero; in shared memory, or for FFN2 read from y straight
// into fragments), the weight fragments come from the slot by
// ldmatrix.trans (weights are stored (in, out)), and warp w takes the K
// steps congruent to w mod 8, the 8 warps' sums then added in order.  With f32 weights the products stay f32 FMAs
// (16 lanes a column, K steps congruent to the lane mod 16, a butterfly sum).
// The Wo share of a slice (one row) is an f32 FMA loop over its slots, off
// the tensor cores: the B song blocks of a head each read that head's Wo
// rows.
//
// Bound on the card.  Each token must read every layer's weights once,
// L (4 D^2 + 2 D DI) values (12 layers at D=512, DI=2048: 75.5 MB in bf16,
// 151 MB in f32), and does 2 B (L (4 D^2 + 2 D DI) + D NF VF_PAD)
// operations: at B <= 16 the bytes bind, about 23 us a token in bf16 at
// 3.35 TB/s.  The weights cannot stay resident on this card as they do in
// the TPU kernels' VMEM (75.5 MB is more than the 50 MB L2 and the 132 x
// 227 KB of shared memory), so they stream from device memory every token;
// the state stays on chip for v8 (12 x 16 x 8 x 64 x 64 x 2 B = 12.6 MB at
// B=16 in bf16, under 100 KB a block) and streams every token for v7.  The
// barriers and the latency of each phase's activation reads set the time
// at B <= 16, not the bytes.
//
// v5 keeps its own SIMT phases (v5_* below): per token the embedding, per
// layer the qkv product (64 x 64 tiles, partial sums), the state update and
// Wo product per (song, head), LN1, the two FFN products, LN2, then the
// heads and the sampling, separated by grid barriers, with the f32 state in
// device memory in v5's layout, S (L, B, E, H E) and z (L, B, H E), read
// and written every token (at B=256 it cannot stay on chip).  A product
// item carries bb songs (8, 16 or 32, dividing B), the counterpart of the
// TPU kernel's bb-song state blocks.  At B=256 the f32 state binds, 2 x 410
// MB a token (0.27 ms at 3.35 TB/s); its 19.7 GFLOP a token are bf16
// products (0.02 ms at the tensor cores' 989 TFLOP/s), here f32 FMAs
// outside the tensor cores, which alone take 0.29 ms at 67 TFLOP/s.

#include <cooperative_groups.h>
#include <cuda.h>
#include <string.h>

#include <mutex>

#include "decode_layers.cuh"
#include "decode_sample.cuh"
#include "tc_mma.cuh"

namespace cg = cooperative_groups;

namespace rlmg {

constexpr int LT_THREADS = 256;               // sample_logit: thread v owns logit v
constexpr int LT_MAX_B = 16;
static_assert(LT_THREADS == VF_PAD && LT_THREADS == ATT_THREADS, "one block size");

__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

// First slice index >= base that block g owns (index = g mod G).
__device__ __forceinline__ int first_owned(int base, int g, int G) {
  return base + ((g - base % G) % G + G) % G;
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

extern __shared__ __align__(128) unsigned char lt_smem[];

// =========================================================================
// v8 and v7
// =========================================================================

constexpr int LP_COLS = 16;          // a product item: 16 columns of a weight
constexpr int LP_SLOT = 8192;        // bytes of one ring slot
constexpr int LP_MAX_SLOTS = 32;
constexpr int LP_V7_SLOTS = 12;      // v7's ring (no resident state to make room for)
constexpr int LP_MAX_D = 1024;       // the row-forming phases hold 2 rows of D a warp
constexpr int LP_RJ = LP_MAX_D / 128;     // float4 groups a lane holds of a row
constexpr int LP_HEAD = LP_MAX_SLOTS * 8;  // the slots' mbarriers
constexpr int LP_A_BYTES = 16 * 528;  // one 16-row A chunk (528-byte rows), or scratch
constexpr int LP_BARRIERS_LAYER = 4;  // grid barriers a layer; a token has 4 L + 2
constexpr int LP_PROFILE_MARKS = 4096;

enum { PH_Q = 0, PH_S = 1, PH_F1 = 2, PH_F2 = 3, PH_H = 4 };

// Grid-wide barriers v8 and v7 passed since the last reset.  A launch
// counts those it passes in a register (one at its start, one after each
// grid.sync) and block 0's thread 0 adds the count here as it ends.
__device__ unsigned long long lp_barriers_passed;

struct LpBarriers {
  unsigned int n;
  __device__ void sync(cg::grid_group& grid) {
    grid.sync();
    ++n;
  }
  __device__ void done() const {
    if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&lp_barriers_passed, (unsigned long long)n);
  }
};

// K rows of a product item in one slot, and the A chunk's row stride (in
// elements, 528 bytes: 16-byte aligned rows that break ldmatrix's bank
// conflicts).
template <typename TW>
struct Lp {
  static constexpr int RC = LP_SLOT / (LP_COLS * (int)sizeof(TW));
  static constexpr int AS = 528 / (int)sizeof(TW);
  static_assert(RC % 16 == 0 && AS >= RC, "chunk");
};

// The tensor maps of the product weights, (rows, columns) with the layers
// stacked along the rows: Wqkv (L D, 3 D), W1 (L D, DI), W2 (L DI, D), the
// padded heads (D, NF VF_PAD); boxes of 16 columns x min(RC, K) rows.
enum { TM_QKV = 0, TM_F1 = 1, TM_F2 = 2, TM_H = 3, N_TM = 4 };

struct LpArgs {
  CUtensorMap tm[N_TM];
  const void* w[N_WEIGHTS];      // stacked layer weights, one type (decode_layers.cuh order)
  const float* m;                // folded embedding (sum V_f, D) f32, read rounded to TW
  const float* bin;              // in_linear bias (D)
  const float* pe;               // (max_len, D)
  const void* hw;                // padded heads (D, NF * VF_PAD), the weights' type
  const float *hb, *fls, *flb;   // head bias (NF * VF_PAD), final LN (D)
  FieldArgs fa;
  const int* tok0;               // (B, NF), fed at t0
  int* tokens;                   // (T, B, NF)
  void *s, *z;                   // (L, B, H, E, E), (L, B, H, E)
  float *x, *qkv, *part, *r1, *h1, *r2, *logits;   // see lp_carve
  void* y;                       // (B, DI) in the weights' type
  unsigned int* flags;           // (B): the S phase's counters, zero at a call's start
  int* step;                     // v7: tokens done in this call
#ifdef LP_PROFILE
  unsigned long long* prof;      // see latency_v8_kernel
#endif
  int L, B, D, H, DI, NF, T, t0;
  unsigned int seed;
  int greedy;
  float eps;
};

// The f32 workspace of lp_carve: x, r1, h1, r2 (B, D); qkv (B, 3 D); the
// head partials (H, B, D); the logits (B, MAX_NF VF_PAD); y (B, DI) (f32
// room); the flags and the step.  Each piece a multiple of 4 floats.
inline size_t lp_carve(float* base, int B, int D, int H, int DI, LpArgs* a) {
  const size_t bd = (size_t)B * D;
  const size_t sizes[9] = {bd, 3 * bd, (size_t)H * bd, bd, bd, bd,
                           (size_t)B * MAX_NF * VF_PAD, (size_t)B * DI, (size_t)B + 4};
  float* slots[9];
  size_t off = 0;
  for (int i = 0; i < 9; ++i) {
    slots[i] = base ? base + off : nullptr;
    off += (sizes[i] + 3) / 4 * 4;
  }
  if (a) {
    a->x = slots[0];
    a->qkv = slots[1];
    a->part = slots[2];
    a->r1 = slots[3];
    a->h1 = slots[4];
    a->r2 = slots[5];
    a->logits = slots[6];
    a->y = slots[7];
    a->flags = (unsigned int*)slots[8];
    a->step = (int*)(slots[8] + B);
  }
  return off;
}

template <typename TW>
struct LpLayer {
  const TW *qkv, *bqkv, *wo, *bo, *l1s, *l1b, *w1, *b1, *w2, *b2, *l2s, *l2b;
};

template <typename TW>
__device__ __forceinline__ LpLayer<TW> lp_layer(const LpArgs& a, int l) {
  const size_t D = a.D, DI = a.DI, dd = (size_t)l * D * D, d = (size_t)l * D;
  const TW* const* W = (const TW* const*)a.w;
  return {W[W_QKV] + 3 * dd, W[B_QKV] + 3 * d, W[W_O] + dd,          W[B_O] + d,
          W[LN1_S] + d,      W[LN1_B] + d,     W[W_F1] + l * D * DI, W[B_F1] + l * DI,
          W[W_F2] + l * DI * D, W[B_F2] + d,   W[LN2_S] + d,         W[LN2_B] + d};
}

// -- which items a block runs ------------------------------------------------

__device__ __forceinline__ int count_from(int start, int G, int n) {
  return start < n ? (n - 1 - start) / G + 1 : 0;
}

// The first item of block g in phase ph of layer l (the k-th is G further);
// S items are slice indices j = b H + hd of the layer, owned by block
// (l B H + j) mod G (v8's resident slices).  F2's items run from the last
// block down, away from the blocks that also hold a layer's S slices.
__device__ __forceinline__ int lp_first(const LpArgs& a, int ph, int l) {
  const int g = blockIdx.x, G = gridDim.x, BH = a.B * a.H;
  if (ph == PH_S) return first_owned(l * BH, g, G) - l * BH;
  return ph == PH_F2 ? G - 1 - g : g;
}

__device__ __forceinline__ int lp_items(const LpArgs& a, int ph, int l) {
  const int n = ph == PH_Q ? 3 * a.D / LP_COLS : ph == PH_S ? a.B * a.H
              : ph == PH_F1 ? a.DI / LP_COLS : ph == PH_F2 ? a.D / LP_COLS
              : a.NF * VF_PAD / LP_COLS;
  return count_from(lp_first(a, ph, l), gridDim.x, n);
}

// Slots an item's weight tiles take.
template <typename TW>
__device__ __forceinline__ int lp_chunks(const LpArgs& a, int ph) {
  if (ph == PH_S) {
    const int rw = LP_SLOT / (a.D * (int)sizeof(TW));
    return (a.D / a.H + rw - 1) / rw;
  }
  const int K = ph == PH_F2 ? a.DI : a.D;
  return (K + Lp<TW>::RC - 1) / Lp<TW>::RC;
}

// What one launch runs: tokens [0, T); per token the layer phases of layers
// [l0, l1), then the heads phase when `heads`.
struct LpProg {
  int T, l0, l1;
  bool heads;
};

// -- the weight ring -----------------------------------------------------------

// Every thread holds the consumer's side (the next slot to read and its
// mbarrier phase); thread 0, the producer, also the cursor: token t, phase
// index idx in the token, the block's k-th item of the phase and its
// tile ch, with what the phase and item fix (layer, tiles an item, items,
// the item's first column or Wo row and the bytes of a tile).
struct Ring {
  unsigned char* slots;
  uint64_t* bars;
  int ns, rslot, wslot, inflight;
  uint32_t rpar;
  int t, idx, k, ch;
  bool done;
  int ph, l, nch, nit, id, bytes;
  const char* src;                 // S: the item's first Wo row
};

__device__ __forceinline__ void lp_phase(const LpProg& p, int idx, int* l, int* ph) {
  const int nl = p.l1 - p.l0;
  if (idx < 4 * nl) {
    *l = p.l0 + idx / 4;
    *ph = idx % 4;
  } else {
    *l = p.l1 - 1;
    *ph = PH_H;
  }
}

// K rows of an item's tile (the box of its tensor map).
template <typename TW>
__device__ __forceinline__ int lp_box_rows(int K) {
  return K < Lp<TW>::RC ? K : Lp<TW>::RC;
}

// The cursor's item changed: its first column (products) or Wo rows (S).
template <typename TW>
__device__ void ring_item(Ring& r, const LpArgs& a) {
  if (r.ph == PH_S) {
    const int E = a.D / a.H;
    r.src = (const char*)(lp_layer<TW>(a, r.l).wo + (size_t)(r.id % a.H) * E * a.D);
  }
}

// Move the cursor to the first phase from (t, idx) on with an item.
template <typename TW>
__device__ void ring_seek(Ring& r, const LpArgs& a, const LpProg& p) {
  const int nidx = 4 * (p.l1 - p.l0) + (p.heads ? 1 : 0);
  while (r.t < p.T) {
    if (r.idx == nidx) {
      r.idx = 0;
      ++r.t;
      continue;
    }
    lp_phase(p, r.idx, &r.l, &r.ph);
    r.nit = lp_items(a, r.ph, r.l);
    if (r.nit > 0) {
      r.nch = lp_chunks<TW>(a, r.ph);
      r.k = r.ch = 0;
      r.id = lp_first(a, r.ph, r.l);
      if (r.ph == PH_S)
        r.bytes = LP_SLOT / (a.D * (int)sizeof(TW)) * a.D * (int)sizeof(TW);
      else
        r.bytes = lp_box_rows<TW>(r.ph == PH_F2 ? a.DI : a.D) * LP_COLS * (int)sizeof(TW);
      ring_item<TW>(r, a);
      return;
    }
    ++r.idx;
  }
  r.done = true;
}

template <typename TW>
__device__ __forceinline__ void ring_advance(Ring& r, const LpArgs& a, const LpProg& p) {
  if (++r.ch < r.nch) return;
  r.ch = 0;
  if (++r.k < r.nit) {
    r.id += gridDim.x;
    ring_item<TW>(r, a);
    return;
  }
  ++r.idx;
  ring_seek<TW>(r, a, p);
}

// Thread 0 issues the cursor's tile into the next slot: a box of a tensor
// map (products) or contiguous rows of Wo (S), counted by the slot's
// mbarrier.
template <typename TW>
__device__ __forceinline__ void ring_issue(Ring& r, const LpArgs& a) {
  unsigned char* dst = r.slots + (size_t)r.wslot * LP_SLOT;
  uint64_t* bar = &r.bars[r.wslot];
  if (r.ph == PH_S) {                // rows ch rw .. of the head's E rows of Wo
    const int left = (a.D / a.H) * a.D * (int)sizeof(TW) - r.ch * r.bytes;
    const int bytes = min(r.bytes, left);
    mbar_expect_tx(bar, bytes);
    bulk_load(dst, r.src + (size_t)r.ch * r.bytes, bytes, bar);
  } else {                           // rows ch RC .. of the item's 16 columns
    const int K = r.ph == PH_F2 ? a.DI : a.D;
    const int tm = r.ph == PH_Q ? TM_QKV : r.ph == PH_F1 ? TM_F1 : r.ph == PH_F2 ? TM_F2 : TM_H;
    const int row0 = (r.ph == PH_H ? 0 : r.l * K) + r.ch * Lp<TW>::RC;
    mbar_expect_tx(bar, r.bytes);
    tma_load_2d(dst, &a.tm[tm], r.id * LP_COLS, row0, bar);
  }
  if (++r.wslot == r.ns) r.wslot = 0;
  ++r.inflight;
}

// Thread 0 keeps ns tiles in flight.
template <typename TW>
__device__ __forceinline__ void ring_fill(Ring& r, const LpArgs& a, const LpProg& p) {
  if (threadIdx.x != 0) return;
  if (r.done || r.inflight == r.ns) return;
  fence_proxy_async();                 // the block's reads of the slots come first
  while (!r.done && r.inflight < r.ns) {
    ring_issue<TW>(r, a);
    ring_advance<TW>(r, a, p);
  }
}

// The ring at a launch's start: barriers initialised, the first ns tiles
// requested.
template <typename TW>
__device__ Ring ring_start(const LpArgs& a, const LpProg& p, unsigned char* slots,
                           uint64_t* bars, int ns) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < ns; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Ring r = {};
  r.slots = slots;
  r.bars = bars;
  r.ns = ns;
  ring_seek<TW>(r, a, p);
  ring_fill<TW>(r, a, p);
  return r;
}

// The i-th next tile (i < ns), once its copies have landed.
__device__ __forceinline__ const unsigned char* ring_wait(Ring& r, int i = 0) {
  int slot = r.rslot + i;
  uint32_t par = r.rpar;
  if (slot >= r.ns) {
    slot -= r.ns;
    par ^= 1u;
  }
  mbar_wait(&r.bars[slot], par);
  return r.slots + (size_t)slot * LP_SLOT;
}

// The next n tiles are read by every thread: their slots take the next
// tiles of the stream.
template <typename TW>
__device__ __forceinline__ void ring_release(Ring& r, const LpArgs& a, const LpProg& p,
                                             int n = 1) {
  __syncthreads();
  r.rslot += n;
  if (r.rslot >= r.ns) {
    r.rslot -= r.ns;
    r.rpar ^= 1u;
  }
  r.inflight -= n;
  ring_fill<TW>(r, a, p);
}

// -- rows formed in registers -------------------------------------------------

// Rows w and w + 8 of warp w (zero past B); lane l holds columns
// 4 (l + 32 j) .. + 3.
struct Rows {
  float4 v[2][LP_RJ];
};

__device__ __forceinline__ int rcol(int j) { return 4 * ((threadIdx.x & 31) + 32 * j); }

__device__ __forceinline__ float4 f4(float x) { return make_float4(x, x, x, x); }

__device__ void rows_load(Rows& R, const float* src, int B, int D) {
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < LP_RJ; ++j) {
      const int b = w + 8 * r, c = rcol(j);
      R.v[r][j] = b < B && c < D ? __ldcg((const float4*)(src + (size_t)b * D + c)) : f4(0.f);
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename TP>
__device__ __forceinline__ float4 ld4(const TP* p) {
  return make_float4(ld(p), ld(p + 1), ld(p + 2), ld(p + 3));
}

// A lane's columns of an LN's scale and shift, loaded before the rows
// they normalise (they do not depend on them).
struct LnParams {
  float4 sc[LP_RJ], sh[LP_RJ];
};

template <typename TP>
__device__ __forceinline__ LnParams ln_params(const TP* scale, const TP* shift, int D) {
  LnParams q;
#pragma unroll
  for (int j = 0; j < LP_RJ; ++j) {
    const int c = rcol(j);
    q.sc[j] = c < D ? ld4(scale + c) : f4(0.f);
    q.sh[j] = c < D ? ld4(shift + c) : f4(0.f);
  }
  return q;
}

// Each row < B: LN (eps 1e-5) * scale + shift.
__device__ void rows_ln(Rows& R, int B, int D, const LnParams& q) {
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (w + 8 * r >= B) continue;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < LP_RJ; ++j)
      if (rcol(j) < D) s += (R.v[r][j].x + R.v[r][j].y) + (R.v[r][j].z + R.v[r][j].w);
    const float mu = warp_sum(s) / D;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < LP_RJ; ++j)
      if (rcol(j) < D) {
        const float4 v = R.v[r][j];
        sq += ((v.x - mu) * (v.x - mu) + (v.y - mu) * (v.y - mu)) +
              ((v.z - mu) * (v.z - mu) + (v.w - mu) * (v.w - mu));
      }
    const float inv = rsqrtf(warp_sum(sq) / D + 1e-5f);
#pragma unroll
    for (int j = 0; j < LP_RJ; ++j) {
      const float4 v = R.v[r][j], sc = q.sc[j], sh = q.sh[j];
      R.v[r][j] = make_float4((v.x - mu) * inv * sc.x + sh.x, (v.y - mu) * inv * sc.y + sh.y,
                              (v.z - mu) * inv * sc.z + sh.z, (v.w - mu) * inv * sc.w + sh.w);
    }
  }
}

// The rows the block writes for later phases: song b by block b mod G.
__device__ void rows_store(const Rows& R, float* dst, int B, int D) {
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int b = w + 8 * r;
    if (b >= B || b % gridDim.x != (int)blockIdx.x) continue;
#pragma unroll
    for (int j = 0; j < LP_RJ; ++j)
      if (rcol(j) < D) *(float4*)(dst + (size_t)b * D + rcol(j)) = R.v[r][j];
  }
}

// Token t's embedding: sum_f round(M[off_f + tok_f]) + b_in + pe[pos], in
// field order (JAX v8's one-hot products of memb, stored in the weights'
// type, summed in f32).
template <typename TW>
__device__ void rows_embed(Rows& R, const LpArgs& a, int t) {
  const int* tok = t == 0 ? a.tok0 : a.tokens + (size_t)(t - 1) * a.B * a.NF;
  const float* pe = a.pe + (size_t)(a.t0 + t) * a.D;
  const int w = threadIdx.x >> 5, D = a.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int b = w + 8 * r;
#pragma unroll
    for (int j = 0; j < LP_RJ; ++j) {
      const int c = rcol(j);
      float4 acc = f4(0.f);
      if (b < a.B && c < D) {
        for (int f = 0; f < a.NF; ++f) {
          const float4 m = __ldg((const float4*)(a.m + (size_t)(a.fa.off[f] +
                                                 __ldcg(tok + b * a.NF + f)) * D + c));
          acc = make_float4(acc.x + ld_round<TW>(m.x), acc.y + ld_round<TW>(m.y),
                            acc.z + ld_round<TW>(m.z), acc.w + ld_round<TW>(m.w));
        }
        const float4 bi = __ldg((const float4*)(a.bin + c)), p = __ldg((const float4*)(pe + c));
        acc = make_float4((acc.x + bi.x) + p.x, (acc.y + bi.y) + p.y, (acc.z + bi.z) + p.z,
                          (acc.w + bi.w) + p.w);
      }
      R.v[r][j] = acc;
    }
  }
}

// -- products -------------------------------------------------------------------

__device__ __forceinline__ float2 ld2(const float* p) { return *(const float2*)p; }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*(const __nv_bfloat162*)p);
}

__device__ __forceinline__ void st_pair(float* p, float x, float y) {
  *(float2*)p = make_float2(x, y);
}
__device__ __forceinline__ void st_pair(__nv_bfloat16* p, float x, float y) {
  *(__nv_bfloat162*)p = __floats2bfloat162_rn(x, y);
}

// The A chunk (16 rows x `rows` columns from k0, in TW) from the rows in
// registers; rows past B are zero.
template <typename TW>
__device__ void fill_from_rows(const Rows& R, TW* As, int k0, int rows) {
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < LP_RJ; ++j) {
      const int c = rcol(j) - k0;
      if (c < 0 || c >= rows) continue;
      TW* p = As + (w + 8 * r) * Lp<TW>::AS + c;
      st_pair(p, R.v[r][j].x, R.v[r][j].y);
      st_pair(p + 2, R.v[r][j].z, R.v[r][j].w);
    }
}

// The A chunk from y (B, K) in TW, written by an earlier phase.
template <typename TW>
__device__ void fill_from_y(const TW* y, int B, int K, TW* As, int k0, int rows) {
  constexpr int PER = 16 / sizeof(TW);
  const int per_row = rows / PER;
  for (int i = threadIdx.x; i < 16 * per_row; i += blockDim.x) {
    const int b = i / per_row, c = (i - b * per_row) * PER;
    const int4 v =
        b < B ? __ldcg((const int4*)(y + (size_t)b * K + k0 + c)) : make_int4(0, 0, 0, 0);
    *(int4*)(As + b * Lp<TW>::AS + c) = v;
  }
}

// The 8 warps' (16 x 16) sums added in warp order; thread i gets the sum
// of row i / 16, column i mod 16.  abuf: 8 KB of shared memory.
__device__ __forceinline__ float mma_reduce(const float (&acc)[2][4], unsigned char* abuf) {
  float* red = (float*)abuf;                       // [8 warps][16][16]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    float* o = red + (warp * 16 + g) * 16 + nt * 8 + q2;
    o[0] = acc[nt][0];
    o[1] = acc[nt][1];
    o[128] = acc[nt][2];
    o[129] = acc[nt][3];
  }
  __syncthreads();
  const int row = threadIdx.x >> 4, col = threadIdx.x & 15;
  float v = 0.f;
#pragma unroll
  for (int w = 0; w < 8; ++w) v += red[(w * 16 + row) * 16 + col];
  __syncthreads();
  return v;
}

// The (row, column) of an item's output a thread finishes: thread i row
// i / 16, column i mod 16 (bf16: mma_reduce); f32: row lane mod 16 of
// column 2 warp + lane / 16 (the butterfly's).
template <typename TW>
__device__ __forceinline__ int out_row() {
  return sizeof(TW) == 2 ? (int)threadIdx.x >> 4 : (int)threadIdx.x & 15;
}
template <typename TW>
__device__ __forceinline__ int out_col() {
  const int tid = threadIdx.x;
  return sizeof(TW) == 2 ? tid & 15 : 2 * (tid >> 5) + ((tid & 31) >> 4);
}

// One item: out (16 x 16) = A (16, K) @ the item's 16 columns of W, the
// A chunks written by fill(As, k0, rows), the W tiles from the ring; then
// epi(b, col, sum, pre(b, col)) for every b < B, pre's loads issued before
// the products.  abuf: LP_A_BYTES of shared memory.
template <typename TW, class Fill, class Pre, class Epi>
__device__ void product_item(Ring& r, const LpArgs& a, const LpProg& p, int K,
                             unsigned char* abuf, Fill fill, Pre pre, Epi epi) {
  constexpr int RC = Lp<TW>::RC, AS = Lp<TW>::AS;
  TW* As = (TW*)abuf;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int eb = out_row<TW>(), ec = out_col<TW>();
  const float2 pv = eb < a.B ? pre(eb, ec) : make_float2(0.f, 0.f);
  if constexpr (sizeof(TW) == 2) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int nch = (K + RC - 1) / RC;
    const bool whole = nch <= r.ns;    // release the item's tiles together
    for (int k0 = 0, c = 0; k0 < K; k0 += RC, ++c) {
      const int rows = min(RC, K - k0);
      if (c > 0 && whole) __syncthreads();   // the last chunk's A is read
      fill(As, k0, rows);
      const TW* Ws = (const TW*)ring_wait(r, whole ? c : 0);
      __syncthreads();
      for (int s = warp; s < rows / 16; s += 8) {   // K step k0/16 + s, = warp mod 8
        uint32_t af[4], bfr[4];
        ldmatrix_x4(af, As + (lane & 15) * AS + s * 16 + (lane >> 4) * 8);
        ldmatrix_x4_trans(bfr, Ws + (s * 16 + (lane & 15)) * LP_COLS + (lane >> 4) * 8);
        mma_bf16(acc[0], af, &bfr[0]);
        mma_bf16(acc[1], af, &bfr[2]);
      }
      if (!whole) ring_release<TW>(r, a, p);
    }
    if (whole) ring_release<TW>(r, a, p, nch);
    const float v = mma_reduce(acc, abuf);
    if (eb < a.B) epi(eb, ec, v, pv);
  } else {
    float acc[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) acc[b] = 0.f;
    const int c = 2 * warp + (lane >> 4), kg = lane & 15;
    for (int k0 = 0; k0 < K; k0 += RC) {
      const int rows = min(RC, K - k0);
      fill(As, k0, rows);
      const TW* Ws = (const TW*)ring_wait(r);
      __syncthreads();
      for (int k = kg; k < rows; k += 16) {          // K rows = lane mod 16
        const float wv = Ws[k * LP_COLS + c];
#pragma unroll
        for (int b = 0; b < 16; ++b) acc[b] = fmaf(As[b * AS + k], wv, acc[b]);
      }
      ring_release<TW>(r, a, p);
    }
    float v = 0.f;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
      if (b == kg) v = acc[b];
    }
    if (eb < a.B) epi(eb, ec, v, pv);
  }
}

__device__ __forceinline__ uint32_t ldcg_u32(const __nv_bfloat16* p) {
  return __ldcg((const unsigned int*)p);
}

// A bf16 FFN2 item: as product_item, with the A fragments read straight
// from y (B, K) in device memory into registers, 16 K steps a warp (8
// tiles) in one round trip; the same K steps a warp, in the same order.
template <class Pre, class Epi>
__device__ void product_item_y(Ring& r, const LpArgs& a, const LpProg& p,
                               const __nv_bfloat16* y, int K, unsigned char* abuf, Pre pre,
                               Epi epi) {
  using TW = __nv_bfloat16;
  constexpr int RC = Lp<TW>::RC;                   // 16 K steps a tile, 2 a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q2 = (lane & 3) * 2, B = a.B;
  const int eb = out_row<TW>(), ec = out_col<TW>();
  const float2 pv = eb < B ? pre(eb, ec) : make_float2(0.f, 0.f);
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int kb = 0; kb < K; kb += 8 * RC) {
    uint32_t af[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) {                 // K step kb / 16 + warp + 8 i
      const int k = kb + (warp + 8 * i) * 16 + q2;
      const bool lo = k < K && g < B, hi = k < K && g + 8 < B;
      af[i][0] = lo ? ldcg_u32(y + (size_t)g * K + k) : 0u;
      af[i][1] = hi ? ldcg_u32(y + (size_t)(g + 8) * K + k) : 0u;
      af[i][2] = lo ? ldcg_u32(y + (size_t)g * K + k + 8) : 0u;
      af[i][3] = hi ? ldcg_u32(y + (size_t)(g + 8) * K + k + 8) : 0u;
    }
#pragma unroll
    const int nch = min(8, (K - kb + RC - 1) / RC);
    const bool whole = nch <= r.ns;    // release the batch's tiles together
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c >= nch) break;
      const int steps = min(RC, K - kb - c * RC) / 16;
      const TW* Ws = (const TW*)ring_wait(r, whole ? c : 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = warp + 8 * h;
        if (s < steps) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, Ws + (s * 16 + (lane & 15)) * LP_COLS + (lane >> 4) * 8);
          mma_bf16(acc[0], af[2 * c + h], &bfr[0]);
          mma_bf16(acc[1], af[2 * c + h], &bfr[2]);
        }
      }
      if (!whole) ring_release<TW>(r, a, p);
    }
    if (whole) ring_release<TW>(r, a, p, nch);
  }
  const float v = mma_reduce(acc, abuf);
  if (eb < B) epi(eb, ec, v, pv);
}

// -- the phases -------------------------------------------------------------------

template <typename TW>
__device__ void lp_phase_q(Ring& r, const LpArgs& a, const LpProg& p, int t, int l,
                           unsigned char* abuf) {
  const int n = lp_items(a, PH_Q, l), D = a.D;
  if (n == 0 && (int)blockIdx.x >= a.B) return;
  Rows R;
  if (l == 0) {
    rows_embed<TW>(R, a, t);
  } else {
    const LpLayer<TW> prev = lp_layer<TW>(a, l - 1);
    const LnParams q = ln_params(prev.l2s, prev.l2b, D);
    rows_load(R, a.r2, a.B, D);
    rows_ln(R, a.B, D, q);
  }
  rows_store(R, a.x, a.B, D);
  const LpLayer<TW> lw = lp_layer<TW>(a, l);
  for (int k = 0; k < n; ++k) {
    const int n0 = (lp_first(a, PH_Q, l) + k * gridDim.x) * LP_COLS;
    product_item<TW>(
        r, a, p, D, abuf, [&](TW* As, int k0, int rows) { fill_from_rows(R, As, k0, rows); },
        [&](int, int c) { return make_float2(ld(lw.bqkv + n0 + c), 0.f); },
        [&](int b, int c, float v, float2 q) {
          const int col = n0 + c;
          v += q.x;
          a.qkv[(size_t)b * 3 * D + col] = col < 2 * D ? phi(v) : v;
        });
  }
}

template <typename TW, typename TS>
__device__ void lp_phase_s(Ring& r, const LpArgs& a, const LpProg& p, int t, int l,
                           unsigned char* abuf, TS* s_res, TS* z_res) {
  const int n = lp_items(a, PH_S, l);
  const int D = a.D, H = a.H, E = D / H, B = a.B, G = gridDim.x, tid = threadIdx.x;
  const int j0 = lp_first(a, PH_S, l);
  const LpLayer<TW> lw = lp_layer<TW>(a, l);
  float* qs = (float*)abuf;
  float* ks = qs + E;
  float* vs = ks + E;
  float* dq = vs + E;
  float* att = dq + E;
  float* part = att + E;
  float* den = part + ATT_THREADS;
  const int rw = LP_SLOT / (D * (int)sizeof(TW)), nch = (E + rw - 1) / rw;
  for (int k = 0; k < n; ++k) {
    const int j = j0 + k * G, i = l * B * H + j, b = j / H, hd = j % H;
    TS *sp, *zp;
    if (s_res) {
      sp = s_res + (size_t)(i / G) * E * E;
      zp = z_res + (size_t)(i / G) * E;
    } else {
      sp = (TS*)a.s + (size_t)i * E * E;
      zp = (TS*)a.z + (size_t)i * E;
    }
    __syncthreads();
    if (tid < E) {
      const float* row = a.qkv + (size_t)b * 3 * D + hd * E + tid;
      qs[tid] = __ldcg(row);
      ks[tid] = __ldcg(row + D);
      vs[tid] = __ldcg(row + 2 * D);
    }
    __syncthreads();
    attn_slice<TS>(qs, ks, vs, sp, zp, att, E, a.eps, part, dq, den, E);
    __syncthreads();
    // the head's share of att @ Wo: columns 2 tid + 512 c, rows from the ring
    float acc[LP_MAX_D / 512][2];
#pragma unroll
    for (int c = 0; c < LP_MAX_D / 512; ++c) acc[c][0] = acc[c][1] = 0.f;
    const bool whole = nch <= r.ns;    // release the slice's tiles together
    for (int ch = 0; ch < nch; ++ch) {
      const TW* Ws = (const TW*)ring_wait(r, whole ? ch : 0);
      const int e0 = ch * rw, rows = min(rw, E - e0);
      for (int e = 0; e < rows; ++e) {
        const float av = ld_round<TW>(att[e0 + e]);
#pragma unroll
        for (int c = 0; c < LP_MAX_D / 512; ++c) {
          const int col = 2 * tid + 512 * c;
          if (col < D) {
            const float2 w2 = ld2(Ws + e * D + col);
            acc[c][0] = fmaf(av, w2.x, acc[c][0]);
            acc[c][1] = fmaf(av, w2.y, acc[c][1]);
          }
        }
      }
      if (!whole) ring_release<TW>(r, a, p);
    }
    if (whole) ring_release<TW>(r, a, p, nch);
    float* out = a.part + ((size_t)hd * B + b) * D;
#pragma unroll
    for (int c = 0; c < LP_MAX_D / 512; ++c) {
      const int col = 2 * tid + 512 * c;
      if (col < D) st_pair(out + col, acc[c][0], acc[c][1]);
    }
    __syncthreads();                  // the block's partial row, then its release
    if (tid == 0)
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(a.flags + b) : "memory");
  }
  // each slice adds its E columns of the song's H partials, once all H are in
  const unsigned int target = (unsigned int)H * (unsigned int)(t * a.L + l + 1);
  for (int k = 0; k < n; ++k) {
    const int j = j0 + k * G, b = j / H, hd = j % H, col = hd * E + tid;
    float xb = 0.f;                   // x (written before the barrier) + bo
    if (tid < E) xb = __ldcg(a.x + (size_t)b * D + col);
    const float bo = tid < E ? ld(lw.bo + col) : 0.f;
    if (tid == 0) {
      unsigned int v;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                     : "=r"(v)
                     : "l"(a.flags + b)
                     : "memory");
      } while (v < target);
    }
    __syncthreads();
    if (tid < E) {
      float v = 0.f;
#pragma unroll 8
      for (int h = 0; h < H; ++h) v += __ldcg(a.part + ((size_t)h * B + b) * D + col);
      a.r1[(size_t)b * D + col] = (xb + v) + bo;
    }
  }
}

template <typename TW>
__device__ void lp_phase_f1(Ring& r, const LpArgs& a, const LpProg& p, int l,
                            unsigned char* abuf) {
  const int n = lp_items(a, PH_F1, l), D = a.D, DI = a.DI;
  if (n == 0 && (int)blockIdx.x >= a.B) return;
  const LpLayer<TW> lw = lp_layer<TW>(a, l);
  Rows R;
  const LnParams q = ln_params(lw.l1s, lw.l1b, D);
  rows_load(R, a.r1, a.B, D);
  rows_ln(R, a.B, D, q);
  rows_store(R, a.h1, a.B, D);
  TW* y = (TW*)a.y;
  for (int k = 0; k < n; ++k) {
    const int n0 = (lp_first(a, PH_F1, l) + k * gridDim.x) * LP_COLS;
    product_item<TW>(
        r, a, p, D, abuf, [&](TW* As, int k0, int rows) { fill_from_rows(R, As, k0, rows); },
        [&](int, int c) { return make_float2(ld(lw.b1 + n0 + c), 0.f); },
        [&](int b, int c, float v, float2 q) {
          st(y + (size_t)b * DI + n0 + c, gelu_exact(v + q.x));
        });
  }
}

template <typename TW>
__device__ void lp_phase_f2(Ring& r, const LpArgs& a, const LpProg& p, int l,
                            unsigned char* abuf) {
  const int n = lp_items(a, PH_F2, l), D = a.D, DI = a.DI;
  const LpLayer<TW> lw = lp_layer<TW>(a, l);
  const TW* y = (const TW*)a.y;
  for (int k = 0; k < n; ++k) {
    const int n0 = (lp_first(a, PH_F2, l) + k * gridDim.x) * LP_COLS;
    const auto pre = [&](int b, int c) {
      return make_float2(ld(lw.b2 + n0 + c), __ldcg(a.h1 + (size_t)b * D + n0 + c));
    };
    const auto epi = [&](int b, int c, float v, float2 q) {
      a.r2[(size_t)b * D + n0 + c] = q.y + (v + q.x);
    };
    if constexpr (sizeof(TW) == 2)
      product_item_y(r, a, p, y, DI, abuf, pre, epi);
    else
      product_item<TW>(r, a, p, DI, abuf,
                       [&](TW* As, int k0, int rows) { fill_from_y(y, a.B, DI, As, k0, rows); },
                       pre, epi);
  }
}

template <typename TW>
__device__ void lp_phase_h(Ring& r, const LpArgs& a, const LpProg& p, unsigned char* abuf) {
  const int n = lp_items(a, PH_H, a.L - 1), D = a.D, NFV = a.NF * VF_PAD;
  if (n == 0) return;
  const LpLayer<TW> last = lp_layer<TW>(a, a.L - 1);
  Rows R;
  const LnParams q2 = ln_params(last.l2s, last.l2b, D), qf = ln_params(a.fls, a.flb, D);
  rows_load(R, a.r2, a.B, D);
  rows_ln(R, a.B, D, q2);
  rows_ln(R, a.B, D, qf);
  for (int k = 0; k < n; ++k) {
    const int n0 = (lp_first(a, PH_H, a.L - 1) + k * gridDim.x) * LP_COLS;
    product_item<TW>(
        r, a, p, D, abuf, [&](TW* As, int k0, int rows) { fill_from_rows(R, As, k0, rows); },
        [&](int, int c) { return make_float2(a.hb[n0 + c], 0.f); },
        [&](int b, int c, float v, float2 q) { a.logits[(size_t)b * NFV + n0 + c] = v + q.x; });
  }
}

// One block per (song, field) of token t: x = logit / temperature, then
// sample_logit.  wk: 64 floats of shared memory.
__device__ void lp_phase_sample(const LpArgs& a, int t, float* wk) {
  const int NFV = a.NF * VF_PAD, v = threadIdx.x;
  for (int i = blockIdx.x; i < a.B * a.NF; i += gridDim.x) {
    const int b = i / a.NF, f = i % a.NF;
    __syncthreads();
    const float x = __ldcg(a.logits + (size_t)b * NFV + f * VF_PAD + v) * a.fa.tinv[f];
    const int tok = sample_logit(x, a.fa, b, f, a.t0 + t, a.seed, a.greedy, wk, (int*)(wk + 32));
    if (v == 0) a.tokens[((size_t)t * a.B + b) * a.NF + f] = tok;
  }
}

// Shared memory of a launch: the slots' mbarriers, one A chunk (also the
// scratch of the S, reduction and sampling steps), ns slots, then v8's
// resident state.
struct LpSmem {
  uint64_t* bars;
  unsigned char *abuf, *slots, *state;
};

__device__ __forceinline__ LpSmem lp_smem(int ns) {
  LpSmem m;
  m.bars = (uint64_t*)lt_smem;
  m.abuf = lt_smem + LP_HEAD;
  m.slots = m.abuf + LP_A_BYTES;
  m.state = m.slots + (size_t)ns * LP_SLOT;
  return m;
}

inline size_t lp_fixed_bytes() { return LP_HEAD + LP_A_BYTES; }

inline size_t resident_bytes(int L, int B, int D, int H, int s_bf16, int grid) {
  const size_t E = D / H, slices = (size_t)L * B * H;
  const size_t nloc = (slices + grid - 1) / grid;
  return nloc * (E * E + E) * (s_bf16 ? 2 : 4);
}

// v8: the whole chunk in one cooperative launch of one block per SM.
template <typename TW, typename TS>
__global__ void __launch_bounds__(LT_THREADS, 1)
latency_v8_kernel(const __grid_constant__ LpArgs a, int ns) {
  cg::grid_group grid = cg::this_grid();
  const int g = blockIdx.x, G = gridDim.x;
  const int E = a.D / a.H, n_sl = a.L * a.B * a.H;
  const LpSmem sm = lp_smem(ns);
  const LpProg p{a.T, 0, a.L, true};
  Ring r = ring_start<TW>(a, p, sm.slots, sm.bars, ns);
  LpBarriers bar{1};                              // the launch's start
  TS* s_res = (TS*)sm.state;
  TS* z_res = s_res + (size_t)((n_sl + G - 1) / G) * E * E;
  if (g == 0 && threadIdx.x < a.B) a.flags[threadIdx.x] = 0u;   // seen after the first barrier
  for (int k = 0; g + k * G < n_sl; ++k) {        // load the owned slices
    const size_t i = g + (size_t)k * G;
    const TS* s_src = (const TS*)a.s + i * E * E;
    for (int x = threadIdx.x; x < E * E; x += blockDim.x) s_res[(size_t)k * E * E + x] = s_src[x];
    for (int x = threadIdx.x; x < E; x += blockDim.x)
      z_res[(size_t)k * E + x] = ((const TS*)a.z)[i * E + x];
  }
  __syncthreads();
#ifdef LP_PROFILE
  // scripts/profile_torch_latency_phases.py builds this: thread 0 of block g
  // records %globaltimer at every phase's start and end in
  // prof[g LP_PROFILE_MARKS + i], 8 L + 4 marks a token.
  int ev = 0;
  auto mark = [&]() {
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long tt;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(tt));
      a.prof[(size_t)blockIdx.x * LP_PROFILE_MARKS + ev] = tt;
    }
    ++ev;
  };
#define LP_MARK() mark()
#else
#define LP_MARK()
#endif
  for (int t = 0; t < a.T; ++t) {
    for (int l = 0; l < a.L; ++l) {
      LP_MARK();
      lp_phase_q<TW>(r, a, p, t, l, sm.abuf);
      LP_MARK();
      bar.sync(grid);
      LP_MARK();
      lp_phase_s<TW, TS>(r, a, p, t, l, sm.abuf, s_res, z_res);
      LP_MARK();
      bar.sync(grid);
      LP_MARK();
      lp_phase_f1<TW>(r, a, p, l, sm.abuf);
      LP_MARK();
      bar.sync(grid);
      LP_MARK();
      lp_phase_f2<TW>(r, a, p, l, sm.abuf);
      LP_MARK();
      bar.sync(grid);
    }
    LP_MARK();
    lp_phase_h<TW>(r, a, p, sm.abuf);
    LP_MARK();
    bar.sync(grid);
    LP_MARK();
    lp_phase_sample(a, t, (float*)sm.abuf);
    LP_MARK();
    if (t + 1 < a.T) bar.sync(grid);
  }
  __syncthreads();
  for (int k = 0; g + k * G < n_sl; ++k) {        // write them back
    const size_t i = g + (size_t)k * G;
    TS* s_dst = (TS*)a.s + i * E * E;
    for (int x = threadIdx.x; x < E * E; x += blockDim.x) s_dst[x] = s_res[(size_t)k * E * E + x];
    for (int x = threadIdx.x; x < E; x += blockDim.x)
      ((TS*)a.z)[i * E + x] = z_res[(size_t)k * E + x];
  }
  bar.done();
}

// v7: one layer of one token, a cooperative launch.  Its weights are
// requested before it waits for the launch before it.
template <typename TW, typename TS>
__global__ void __launch_bounds__(LT_THREADS, 1)
latency_v7_layer_kernel(const __grid_constant__ LpArgs a, int l, int ns) {
  cg::grid_group grid = cg::this_grid();
  const LpSmem sm = lp_smem(ns);
  const LpProg p{1, l, l + 1, false};
  Ring r = ring_start<TW>(a, p, sm.slots, sm.bars, ns);
  griddep_wait();
  griddep_launch();
  LpBarriers bar{1};
  const int t = __ldcg(a.step);
  lp_phase_q<TW>(r, a, p, t, l, sm.abuf);
  bar.sync(grid);
  lp_phase_s<TW, TS>(r, a, p, t, l, sm.abuf, (TS*)nullptr, (TS*)nullptr);
  bar.sync(grid);
  lp_phase_f1<TW>(r, a, p, l, sm.abuf);
  bar.sync(grid);
  lp_phase_f2<TW>(r, a, p, l, sm.abuf);
  bar.done();
}

// v7: the heads of one token; advances the token index.
template <typename TW>
__global__ void __launch_bounds__(LT_THREADS, 1)
latency_v7_heads_kernel(const __grid_constant__ LpArgs a, int ns) {
  const LpSmem sm = lp_smem(ns);
  const LpProg p{1, 0, 0, true};
  Ring r = ring_start<TW>(a, p, sm.slots, sm.bars, ns);
  griddep_wait();
  griddep_launch();
  LpBarriers{1}.done();
  lp_phase_h<TW>(r, a, p, sm.abuf);
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.step += 1;   // no block of this launch reads it
}

__global__ void __launch_bounds__(LT_THREADS)
latency_v7_sample_kernel(const __grid_constant__ LpArgs a) {
  __shared__ float wk[64];
  griddep_wait();
  griddep_launch();
  LpBarriers{1}.done();
  lp_phase_sample(a, __ldcg(a.step) - 1, wk);
}

template <typename... KArgs, typename... Args>
int lt_launch(void (*kernel)(KArgs...), int grid, size_t smem, cudaStream_t st, bool coop,
              Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(LT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (coop) {
    attr[n].id = cudaLaunchAttributeCooperative;
    attr[n++].val.cooperative = 1;
  }
  attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;   // a dependent of
  attr[n++].val.programmaticStreamSerializationAllowed = 1;            // the launch before
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

inline size_t lp_v7_smem(int ns) { return lp_fixed_bytes() + (size_t)ns * LP_SLOT; }

// One token of v7 on st: L layer launches, the heads, the sampling.
// Returns the kernels enqueued, or minus a CUDA error code.
template <typename TW, typename TS>
int v7_enqueue_token(const LpArgs& a, int n_sm, cudaStream_t st) {
  const int ns = LP_V7_SLOTS;
  const size_t smem = lp_v7_smem(ns);
  int n = 0;
  for (int l = 0; l < a.L; ++l) {
    const int rc = lt_launch(latency_v7_layer_kernel<TW, TS>, n_sm, smem, st, true, a, l, ns);
    if (rc) return -rc;
    ++n;
  }
  int rc = lt_launch(latency_v7_heads_kernel<TW>, n_sm, smem, st, false, a, ns);
  if (rc) return -rc;
  ++n;
  rc = lt_launch(latency_v7_sample_kernel, a.B * a.NF, 0, st, false, a);
  if (rc) return -rc;
  return n + 1;
}

// One instantiated token graph per shape, holding the arguments of the
// call that last ran it; a call with other arguments captures its token
// again and updates the graph in place (cudaGraphExecUpdate).
struct V7Graph {
  bool used;
  LpArgs args;
  int dev, w_bf16, s_bf16;
  cudaGraphExec_t exec;
  int kernels;
};
constexpr int V7_SHAPES = 8, V7_MAX_DEVICES = 64;
static V7Graph v7_graphs[V7_SHAPES];
static int v7_next = 0;
static cudaStream_t v7_capture_streams[V7_MAX_DEVICES];
static std::mutex v7_mutex;

inline bool v7_same_shape(const V7Graph& c, const LpArgs& a, int dev, int w_bf16, int s_bf16) {
  const LpArgs& o = c.args;
  return c.used && c.dev == dev && c.w_bf16 == w_bf16 && c.s_bf16 == s_bf16 && o.L == a.L &&
         o.B == a.B && o.D == a.D && o.H == a.H && o.DI == a.DI && o.NF == a.NF;
}

template <typename TW, typename TS>
int v7_graph(const LpArgs& a, int n_sm, int dev, V7Graph** out, int* how) {
  const int w_bf16 = sizeof(TW) == 2, s_bf16 = sizeof(TS) == 2;
  V7Graph* slot = nullptr;
  for (V7Graph& c : v7_graphs)
    if (v7_same_shape(c, a, dev, w_bf16, s_bf16)) slot = &c;
  if (slot != nullptr && memcmp(&slot->args, &a, sizeof(LpArgs)) == 0) {
    *out = slot;
    *how = 0;
    return 0;
  }
  if (dev < 0 || dev >= V7_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  cudaStream_t& cs = v7_capture_streams[dev];
  if (cs == nullptr) {
    const cudaError_t e = cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking);
    if (e != cudaSuccess) return (int)e;
  }
  cudaError_t e = cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return (int)e;
  const int n = v7_enqueue_token<TW, TS>(a, n_sm, cs);
  cudaGraph_t g = nullptr;
  e = cudaStreamEndCapture(cs, &g);
  if (n < 0 || e != cudaSuccess) {
    if (g) cudaGraphDestroy(g);
    cudaGetLastError();
    return n < 0 ? -n : (int)e;
  }
  e = cudaErrorUnknown;
  if (slot != nullptr) {
    // updates apply to later launches; those already queued keep theirs
    cudaGraphExecUpdateResultInfo res;
    e = cudaGraphExecUpdate(slot->exec, g, &res);
    if (e == cudaSuccess) {
      *how = 1;
    } else {
      cudaGetLastError();
      cudaGraphExecDestroy(slot->exec);
      slot->used = false;
    }
  }
  if (e != cudaSuccess) {
    if (slot == nullptr) {
      slot = &v7_graphs[v7_next];
      v7_next = (v7_next + 1) % V7_SHAPES;
      if (slot->used) cudaGraphExecDestroy(slot->exec);
      slot->used = false;
    }
    e = cudaGraphInstantiateWithFlags(&slot->exec, g, 0);
    if (e != cudaSuccess) {
      cudaGraphDestroy(g);
      return (int)e;
    }
    *how = 2;
  }
  cudaGraphDestroy(g);
  slot->used = true;
  slot->dev = dev;
  slot->w_bf16 = w_bf16;
  slot->s_bf16 = s_bf16;
  memcpy(&slot->args, &a, sizeof(LpArgs));
  slot->kernels = n;
  *out = slot;
  return 0;
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// A (rows, cols) row-major weight of elem-byte values, boxes of 16 columns
// x box_rows rows, zeros past its end.
inline int make_tmap(CUtensorMap* m, const void* base, int elem, size_t rows, size_t cols,
                     int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)LP_COLS, (cuuint32_t)box_rows}, es[2] = {1, 1};
  const CUtensorMapDataType type =
      elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult r = fn(m, type, 2, (void*)base, dims, strides, box, es,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename TW>
int lp_tmaps(LpArgs& a) {
  const int e = sizeof(TW), rc = Lp<TW>::RC;
  const size_t L = a.L, D = a.D, DI = a.DI;
  const auto box = [rc](size_t K) { return (int)(K < (size_t)rc ? K : rc); };
  int e_ = make_tmap(&a.tm[TM_QKV], a.w[W_QKV], e, L * D, 3 * D, box(D));
  if (!e_) e_ = make_tmap(&a.tm[TM_F1], a.w[W_F1], e, L * D, DI, box(D));
  if (!e_) e_ = make_tmap(&a.tm[TM_F2], a.w[W_F2], e, L * DI, D, box(DI));
  if (!e_) e_ = make_tmap(&a.tm[TM_H], a.hw, e, D, (size_t)a.NF * VF_PAD, box(D));
  return e_;
}

// Slots v8's ring gets from the shared memory its resident state leaves.
inline int lp_v8_slots(int L, int B, int D, int H, int s_bf16, int n_sm, int max_smem) {
  const long long left = (long long)max_smem - (long long)lp_fixed_bytes() -
                         (long long)resident_bytes(L, B, D, H, s_bf16, n_sm);
  const long long ns = left / LP_SLOT;
  return (int)(ns > LP_MAX_SLOTS ? LP_MAX_SLOTS : ns < 0 ? 0 : ns);
}

// info[0]: CUDA kernels launched; info[1]: the ring's slots; info[2] (v7):
// 0 the shape's graph launched as it was, 1 updated, 2 instantiated.
template <typename TW, typename TS>
int latency_run(int version, LpArgs& a, int n_sm, int max_smem, cudaStream_t st, int* info) {
  const int tm = lp_tmaps<TW>(a);
  if (tm) return tm;
  if (version == 8) {
    const int ns = lp_v8_slots(a.L, a.B, a.D, a.H, sizeof(TS) == 2, n_sm, max_smem);
    if (ns < 2) return (int)cudaErrorInvalidValue;
    const size_t smem = lp_fixed_bytes() + (size_t)ns * LP_SLOT +
                        resident_bytes(a.L, a.B, a.D, a.H, sizeof(TS) == 2, n_sm);
    const auto kern = latency_v8_kernel<TW, TS>;
    const int rc = cooperative_ok(kern, n_sm, smem, n_sm);
    if (rc) return rc;
    void* args[] = {(void*)&a, (void*)&ns};
    const cudaError_t e =
        cudaLaunchCooperativeKernel((const void*)kern, n_sm, LT_THREADS, args, smem, st);
    if (e != cudaSuccess) return (int)e;
    info[0] = 1;
    info[1] = ns;
    return 0;
  }
  const size_t smem = lp_v7_smem(LP_V7_SLOTS);
  int rc = cooperative_ok(latency_v7_layer_kernel<TW, TS>, n_sm, smem, n_sm);
  if (!rc) rc = (int)cudaFuncSetAttribute(latency_v7_heads_kernel<TW>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc) return rc;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  // the flags and the token index start at zero
  e = cudaMemsetAsync(a.flags, 0, ((size_t)a.B + 4) * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(v7_mutex);
  V7Graph* g = nullptr;
  rc = v7_graph<TW, TS>(a, n_sm, dev, &g, &info[2]);
  if (rc) return rc;
  for (int t = 0; t < a.T; ++t) {
    e = cudaGraphLaunch(g->exec, st);
    if (e != cudaSuccess) return (int)e;
  }
  info[0] = g->kernels * a.T;
  info[1] = LP_V7_SLOTS;
  return 0;
}

inline bool latency_shape_ok(int B, int D, int H, int DI, int NF) {
  return B >= 1 && B <= LT_MAX_B && stack_shape_ok(D, H) && D % 64 == 0 && DI % 64 == 0 &&
         D <= LP_MAX_D && NF >= 1 && NF <= MAX_NF;
}

// =========================================================================
// v5: its own SIMT phases
// =========================================================================

constexpr int LT_TN = 64, LT_KC = 64;         // product item: 64 columns x 64 rows
constexpr int LT_KQ = LT_KC / (LT_THREADS / LT_TN);   // rows per thread: 16

// RLMG_V5_ABLATE (for attributing its time; the output is garbage):
// ABLATE_STATE streams the state through and skips every other layer
// phase, ABLATE_ATTN keeps the products and streams the state through
// without its update and read (att = 0).
enum { ABLATE_NONE = 0, ABLATE_STATE = 1, ABLATE_ATTN = 2 };

struct LatArgs {
  const void* w[N_WEIGHTS];      // stacked layer weights, one type (decode_layers.cuh order)
  const float* m;                // folded embedding (sum V_f, D), f32
  const float* bin;              // in_linear bias (D)
  const float* pe;               // (T, D): the fed tokens' rows
  const void* hw;                // padded heads (D, NF * VF_PAD), the weights' type
  const float *hb, *fls, *flb;   // head bias (NF * VF_PAD), final LN (D)
  FieldArgs fa;
  const int* tok0;               // (B, NF)
  int* tokens;                   // (T, B, NF)
  float *s, *z;                  // (L, B, E, H E), (L, B, H E)
  float *h, *h1;                 // (B, D) each
  float *pqkv, *po, *p1, *p2;    // partial sums: (D/64, B, 3D), (H, B, D), (D/64, B, DI),
                                 // (DI/64, B, D)
  int L, B, D, H, DI, NF, T;
  unsigned int seed;
  int greedy;
  float eps;
  int ablate;
};

// Shared floats one block needs for the phases (the largest of them), when a
// product item carries nb songs.
inline size_t work_floats(int nb, int D, int H) {
  const size_t gemm = 4 * (size_t)nb * LT_KC;                 // x chunk + 3 partial rows
  const size_t attn = 5 * (size_t)(D / H) + ATT_THREADS + 1;   // q k v dq att, part, den
  const size_t row = (size_t)D + 64;                           // x row, red, redi
  size_t w = gemm > attn ? gemm : attn;
  w = w > row ? w : row;
  return (w + 3) / 4 * 4;
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
// every 64-row slice kc, one (64 columns, 64 rows) tile of w per item and
// MB songs.  x (B, K) is the sum of nsum slices of src (nsum, B, K), and
// gelu_exact(. + xbias) when xbias is given, rounded to TW (v5 casts each
// product's input to the weights' type).  Thread (c, kq) takes column c
// over rows 16 kq .. 16 kq + 15 for every song of the item; the four
// quarters are added in order.  A song's sums do not depend on MB.
template <typename TW, int MB>
__device__ void v5_gemm(const float* src, int nsum, const TW* __restrict__ xbias,
                        const TW* __restrict__ w, float* part, int B, int K, int N, float* wk,
                        int g, int G) {
  const int n_nt = N / LT_TN, n_kc = K / LT_KC;
  const int items = n_nt * n_kc * ((B + MB - 1) / MB);
  float* xs = wk;                    // (MB, 64)
  float* red = wk + MB * LT_KC;      // (3, MB, 64)
  const int c = threadIdx.x % LT_TN, kq = threadIdx.x / LT_TN;
  for (int it = g; it < items; it += G) {
    const int nt = it % n_nt, kc = (it / n_nt) % n_kc, b0 = it / (n_nt * n_kc) * MB;
    const int nb = min(MB, B - b0), n = nt * LT_TN + c, k0 = kc * LT_KC;
    __syncthreads();               // the last item's xs and red are read
    for (int i = threadIdx.x; i < nb * LT_KC; i += blockDim.x) {
      const int b = b0 + i / LT_KC, k = k0 + i % LT_KC;
      float v = 0.f;
      for (int j = 0; j < nsum; ++j) v += __ldcg(src + ((size_t)j * B + b) * K + k);
      xs[i] = ld_round<TW>(xbias ? gelu_exact(v + ld(xbias + k)) : v);
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
        if (b < nb) red[((kq - 1) * MB + b) * LT_TN + c] = acc[b];
    }
    __syncthreads();
    if (kq == 0) {
#pragma unroll
      for (int b = 0; b < MB; ++b)
        if (b < nb)
          part[((size_t)kc * B + b0 + b) * N + n] = ((acc[b] + red[b * LT_TN + c]) +
                                                     red[(MB + b) * LT_TN + c]) +
                                                    red[(2 * MB + b) * LT_TN + c];
    }
  }
}

// The state update and Wo product of one (song b, head hd) slice of layer
// w; sp, zp its state, the rows of sp D values apart.  Honours a.ablate.
template <typename TW>
__device__ void v5_attn_wo(const LatArgs& a, const LayerW<TW>& w, int b, int hd, float* sp,
                           float* zp, float* wk) {
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
  if (a.ablate == ABLATE_ATTN) {   // the state streamed through, no update or read
    for (int i = tid; i < E * E; i += blockDim.x) {
      float* p = sp + (size_t)(i / E) * D + i % E;
      *p = *p;
    }
    if (tid < E) {
      zp[tid] = zp[tid];
      att[tid] = 0.f;
    }
  } else {
    attn_slice<float>(qs, ks, vs, sp, zp, att, E, a.eps, part, dq, den, D);
  }
  __syncthreads();
  const TW* wo = w.wo + (size_t)hd * E * D;
  float* out = a.po + ((size_t)hd * a.B + b) * D;
  for (int n = tid; n < D; n += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int e = 0; e < E; ++e) acc = fmaf(ld_round<TW>(att[e]), ldg(wo + (size_t)e * D + n), acc);
    out[n] = acc;
  }
}

// out[b] = LN(resid[b] + (sum of nsum partial rows + bias)) * scale + shift.
template <typename TW>
__device__ void v5_res_ln(const float* resid, const float* part, int nsum,
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

// The phases of layer l with grid barriers between them; the caller
// synchronises after the last.
template <typename TW, int MB>
__device__ void v5_layer(const LatArgs& a, int l, float* wk) {
  cg::grid_group grid = cg::this_grid();
  const int g = blockIdx.x, G = gridDim.x;
  const int B = a.B, D = a.D, H = a.H, E = D / H, DI = a.DI, BH = B * H;
  const LayerW<TW> w = layer_w<TW>(a, l);
  v5_gemm<TW, MB>(a.h, 1, nullptr, w.qkv, a.pqkv, B, D, 3 * D, wk, g, G);
  grid.sync();
  for (int i = first_owned(l * BH, g, G); i < (l + 1) * BH; i += G) {
    const int j = i - l * BH, b = j / H, hd = j % H;
    v5_attn_wo<TW>(a, w, b, hd, a.s + (size_t)(l * B + b) * E * D + hd * E,
                   a.z + (size_t)(l * B + b) * D + hd * E, wk);
  }
  grid.sync();
  for (int b = g; b < B; b += G)
    v5_res_ln<TW>(a.h, a.po, H, w.bo, w.l1s, w.l1b, a.h1, B, D, b, wk);
  grid.sync();
  v5_gemm<TW, MB>(a.h1, 1, nullptr, w.w1, a.p1, B, D, DI, wk, g, G);
  grid.sync();
  v5_gemm<TW, MB>(a.p1, D / LT_KC, w.b1, w.w2, a.p2, B, DI, D, wk, g, G);
  grid.sync();
  for (int b = g; b < B; b += G)
    v5_res_ln<TW>(a.h1, a.p2, DI / LT_KC, w.b2, w.l2s, w.l2b, a.h, B, D, b, wk);
}

// ABLATE_STATE's layer: the state of layer l read and written back,
// nothing else.
__device__ void stream_state(const LatArgs& a, int l, int g, int G) {
  const size_t nz = (size_t)a.B * a.D, ns = nz * (a.D / a.H);
  float* s = a.s + l * ns;
  float* z = a.z + l * nz;
  const size_t i0 = (size_t)g * blockDim.x + threadIdx.x, step = (size_t)G * blockDim.x;
  for (size_t i = i0; i < ns; i += step) __stcg(s + i, __ldcg(s + i));
  for (size_t i = i0; i < nz; i += step) __stcg(z + i, __ldcg(z + i));
}

// v5: T tokens of B songs in one cooperative launch of one block per SM.
template <typename TW, int MB>
__global__ void __launch_bounds__(LT_THREADS, 1)
decode_v5_kernel(const __grid_constant__ LatArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int g = blockIdx.x, G = gridDim.x;
  float* wk = (float*)lt_smem;
  for (int t = 0; t < a.T; ++t) {
    const int* tok = t == 0 ? a.tok0 : a.tokens + (size_t)(t - 1) * a.B * a.NF;
    for (int b = g; b < a.B; b += G)
      embed_row(tok + (size_t)b * a.NF, a.m, a.fa, a.bin, a.pe + (size_t)t * a.D,
                a.h + (size_t)b * a.D, a.NF, a.D);
    grid.sync();
    for (int l = 0; l < a.L; ++l) {
      if (a.ablate == ABLATE_STATE)
        stream_state(a, l, g, G);
      else
        v5_layer<TW, MB>(a, l, wk);
      grid.sync();
    }
    for (int i = g; i < a.B * a.NF; i += G) {
      const int b = i / a.NF, f = i % a.NF;
      __syncthreads();
      const int tok_bf = heads_sample_row<TW, true>(
          a.h + (size_t)b * a.D, a.fls, a.flb, (const TW*)a.hw, a.hb, a.fa, b, f, a.NF, a.D, t,
          a.seed, a.greedy, wk, wk + a.D, (int*)(wk + a.D + 32));
      if (threadIdx.x == 0) a.tokens[((size_t)t * a.B + b) * a.NF + f] = tok_bf;
    }
    if (t + 1 < a.T) grid.sync();
  }
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

// f32 scratch floats v5 needs: h, h1 and the partial sums.
inline size_t v5_scratch_floats(int B, int D, int H, int DI) {
  const size_t b = B, d = D, di = DI, nk = D / LT_KC, nk2 = DI / LT_KC;
  return 2 * b * d + nk * b * 3 * d + (size_t)H * b * d + nk * b * di + nk2 * b * d;
}

}  // namespace rlmg

extern "C" {

#ifdef LP_PROFILE
// The buffer v8's phase marks go to (LP_PROFILE_MARKS u64 a block).
void* lp_prof_buf = nullptr;
void rlmg_lp_set_prof(void* p) { lp_prof_buf = p; }
#endif

// f32 scratch floats the latency kernels (v8, v7) and v5 need.
long long rlmg_latency_scratch_floats(int B, int D, int H, int DI) {
  const size_t lp = rlmg::lp_carve(nullptr, B, D, H, DI, nullptr);
  const size_t v5 = rlmg::v5_scratch_floats(B, D, H, DI);
  return (long long)(lp > v5 ? lp : v5);
}

// Dynamic shared bytes a block of the version's launch needs on a grid of
// `grid` blocks with `max_smem` bytes a block: v8 its resident state slices
// and at least two ring slots (more slots fill what is left), v7 its fixed
// ring.
long long rlmg_latency_smem_bytes(int version, int L, int B, int D, int H, int s_bf16, int grid,
                                  int max_smem) {
  if (version == 7) return (long long)rlmg::lp_v7_smem(rlmg::LP_V7_SLOTS);
  int ns = rlmg::lp_v8_slots(L, B, D, H, s_bf16, grid, max_smem);
  ns = ns < 2 ? 2 : ns;
  return (long long)(rlmg::lp_fixed_bytes() + (size_t)ns * rlmg::LP_SLOT +
                     rlmg::resident_bytes(L, B, D, H, s_bf16, grid));
}

// Grid-wide barriers a token of v8 and v7 passes by design (v7: kernel
// boundaries included): 4 a layer, then the heads and the sampling.
int rlmg_latency_barriers_per_token(int L) { return rlmg::LP_BARRIERS_LAYER * L + 2; }

// The grid-wide barriers v8 and v7 passed on the current card since the
// last reset (waits for the card); reset: zero the count after reading it.
// Returns minus a CUDA error code on failure.
long long rlmg_latency_barriers_passed(int reset) {
  unsigned long long n = 0;
  cudaError_t e = cudaMemcpyFromSymbol(&n, rlmg::lp_barriers_passed, sizeof n);
  if (e == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    e = cudaMemcpyToSymbol(rlmg::lp_barriers_passed, &zero, sizeof zero);
  }
  return e == cudaSuccess ? (long long)n : -(long long)e;
}

// The current card's SM count and the shared bytes one block may opt in to.
int rlmg_latency_card(int* n_sm, int* max_smem) { return rlmg::card(n_sm, max_smem); }

// Decode T tokens with kernel `version` (7 or 8).  tok0 (B,NF) int32 is fed
// at position t0; tokens (T,B,NF) int32 receives the T successors.  s, z
// are updated in place.  m is the f32 folded embedding; off, tinv, topp are
// host arrays of NF values; scratch holds rlmg_latency_scratch_floats
// floats.  pe is the whole (max_len, D) f32 table; rows t0..t0+T-1 are
// read.  info[0] receives the CUDA kernels the call launched (v8: 1, v7:
// (L + 2) T), info[1] the ring's slots a block, info[2] (v7) how the
// shape's token graph was brought to this call (0 as it was, 1 updated, 2
// instantiated).
int rlmg_latency_decode(int version, const int* tok0, int* tokens, const float* m,
                        const float* bin, const float* pe, const void* const* w, const void* hw,
                        const float* hb, const float* fls, const float* flb, const int* off,
                        const float* tinv, const float* topp, void* s, void* z, float* scratch,
                        int T, int t0, unsigned int seed, int greedy, int L, int B, int D, int H,
                        int DI, int NF, float eps, int w_bf16, int s_bf16, void* stream,
                        int* info) {
  info[0] = info[1] = info[2] = 0;
  if (!rlmg::latency_shape_ok(B, D, H, DI, NF) || (version != 7 && version != 8) || T < 1 ||
      L < 1)
    return (int)cudaErrorInvalidValue;
  int n_sm = 0, max_smem = 0;
  const int rc = rlmg::card(&n_sm, &max_smem);
  if (rc) return rc;
  rlmg::LpArgs a;
  memset(&a, 0, sizeof a);
  for (int i = 0; i < rlmg::N_WEIGHTS; ++i) a.w[i] = w[i];
  a.m = m;
  a.bin = bin;
  a.pe = pe;
  a.hw = hw;
  a.hb = hb;
  a.fls = fls;
  a.flb = flb;
  a.fa = rlmg::field_args(off, tinv, topp, NF);
  a.tok0 = tok0;
  a.tokens = tokens;
  a.s = s;
  a.z = z;
  rlmg::lp_carve(scratch, B, D, H, DI, &a);
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
#ifdef LP_PROFILE
  a.prof = (unsigned long long*)lp_prof_buf;
#endif
  cudaStream_t st = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (w_bf16)
    return s_bf16 ? rlmg::latency_run<bf, bf>(version, a, n_sm, max_smem, st, info)
                  : rlmg::latency_run<bf, float>(version, a, n_sm, max_smem, st, info);
  return s_bf16 ? rlmg::latency_run<float, bf>(version, a, n_sm, max_smem, st, info)
                : rlmg::latency_run<float, float>(version, a, n_sm, max_smem, st, info);
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
  if (!rlmg::stack_shape_ok(D, H) || D % rlmg::LT_KC || DI % rlmg::LT_KC || NF < 1 ||
      NF > rlmg::MAX_NF || T < 1 || B < 1 || (bb != 8 && bb != 16 && bb != 32) || B % bb ||
      ablate < 0 || ablate > 2)
    return (int)cudaErrorInvalidValue;
  int n_sm = 0, max_smem = 0;
  const int rc = rlmg::card(&n_sm, &max_smem);
  if (rc) return rc;
  rlmg::LatArgs a;
  memset(&a, 0, sizeof a);
  for (int i = 0; i < rlmg::N_WEIGHTS; ++i) a.w[i] = w[i];
  a.m = m;
  a.bin = bin;
  a.pe = pe_rows;
  a.hw = hw;
  a.hb = hb;
  a.fls = fls;
  a.flb = flb;
  a.fa = rlmg::field_args(off, tinv, topp, NF);
  a.tok0 = tok0;
  a.tokens = tokens;
  a.s = s;
  a.z = z;
  const size_t bd = (size_t)B * D, nk = D / rlmg::LT_KC;
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
  a.seed = seed;
  a.greedy = greedy;
  a.eps = eps;
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
