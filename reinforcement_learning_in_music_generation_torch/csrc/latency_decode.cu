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
// :137), v5 keeps them f32.  So do these kernels (v8 and v7 by ld_round,
// v5 by storing each product's input in bf16); the biases, phi, the state
// update, den, gelu, the residuals, the LayerNorms and the sampling stay
// f32.  With f32 weights every rounding is a no-op.
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
// v5 (v5_* below) runs every product on the tensor cores in its one
// cooperative launch a call: per token the embedding rows, per layer the
// qkv product, the state items, the Wo product, the LN1 rows, the two FFN
// products and the LN2 rows (after the last layer the final LN), then the
// heads product and the sampling, a grid barrier after each (7 L + 3 a
// token).  Every product is one batch product of the whole batch's rows,
// in items of (16, 32 or 64 songs, 64 columns) over the whole K, or over
// 2 or 4 depth slices where the tiles alone would leave more than half of
// the grid idle (the reading phase adds the slices in order), on
// mma.sync.m16n8k16, its operands staged by cp.async through a ring of
// stages; each product's input is formed once, by the phase before it,
// and stored as bf16 planes (one with bf16 weights: JAX v5's cast, :276
// :329 :335 :338 :382; three with f32 weights: f32 grade, the weights'
// planes built once by make_v6_params).  The f32 state lives in device
// memory in v5's layout, S (L, B, E, H E) and z (L, B, H E), read and
// written once a token by 16-byte copies, an item (song, head) a warp
// (at B=256 it cannot stay on chip).  At B=256 the f32 state binds, 2 x
// 410 MB a token (0.25 ms at 3.35 TB/s); its 19.7 GFLOP a token of bf16
// products take 0.02 ms at the tensor cores' 989 TFLOP/s.  What holds it
// above that (scripts/profile_torch_v5_phases.py): the products' operand
// traffic from L2 (each tile re-reads its rows and weight columns), the
// row and state phases' dependent round trips, 87 grid barriers and the
// sampling's 24-step bisection a (song, field).

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
// v5: every product on the tensor cores
// =========================================================================

// RLMG_V5_ABLATE (for attributing its time; the output is garbage):
// ABLATE_STATE streams the state through and skips every other layer
// phase (the heads then read the embedding), ABLATE_ATTN keeps the
// products and streams the state through without its update and read
// (att = 0).
enum { ABLATE_NONE = 0, ABLATE_STATE = 1, ABLATE_ATTN = 2 };

using bf16 = __nv_bfloat16;

constexpr int V5_WARPS = LT_THREADS / 32;    // 8
constexpr int V5_BN = 64;                    // columns a product tile
constexpr int V5_BK = 64;                    // depths a stage
constexpr int V5_STEPS = V5_BK / 16;         // mma depth steps a stage
constexpr int V5_RS = V5_BK + 8;             // bf16 a staged input row (padded: ldmatrix banks)
constexpr int V5_WS = V5_BN + 8;             // bf16 a staged weight row
constexpr int V5_RED = 40;                   // floats a row of a warp's 16 x 32 sums
constexpr int V5_MAX_BM = 64, V5_MAX_NS = 8, V5_MAX_KS = 4;
constexpr int V5_MAX_D = 1024;               // a row in one warp's registers
constexpr int V5_RV = V5_MAX_D / 128;        // float4 a lane holds of a row

enum { V5_Q = 0, V5_O = 1, V5_F1 = 2, V5_F2 = 3, V5_H = 4, V5_NPROD = 5 };
enum { V5_EMBED = 0, V5_LN1 = 1, V5_LN2 = 2, V5_FINAL = 3 };

// bf16 planes an operand: bf16 weights, one (the JAX cast of the input to
// the weights' type); f32 weights, three (hi, mid, lo: the f32 grade of a
// cast that does nothing).
template <typename TW>
struct V5T {
  static constexpr int PL = sizeof(TW) == 4 ? 3 : 1;
};

struct V5Args {
  const void* w[N_WEIGHTS];     // stacked layer leaves, TW (decode_layers.cuh order); the
                                // vectors are read from here
  const bf16* wp[V5_NPROD];     // each product's weight, (K, N) row-major, as plane 0 of
                                // its bf16 planes: Wqkv (L, D, 3D), Wo (L, D, D), W1 (L, D,
                                // DI), W2 (L, DI, D), the padded heads (D, NF VF_PAD)
  size_t wpl[V5_NPROD];         // elements from one weight plane to the next
  const float* m;               // folded embedding (sum V_f, D), f32
  const float* bin;             // in_linear bias (D)
  const float* pe;              // (T, D): the fed tokens' rows
  const float *hb, *fls, *flb;  // head bias (NF VF_PAD), final LN (D)
  FieldArgs fa;
  const int* tok0;              // (B, NF)
  int* tokens;                  // (T, B, NF)
  float *s, *z;                 // (L, B, E, H E), (L, B, H E)
  float* part[V5_NPROD];        // the products' f32 sums, (ks, B, N) (FFN1: unused)
  float *hres, *h1;             // f32 rows (B, D): the layer's input, LN1's output
  bf16 *xq, *att, *x1, *y;      // the products' inputs as PL planes of B rows
  int L, B, D, H, DI, NF, T;
  int bm, ns, nss, ncs;         // rows a product tile, stages, state warps (a slot each),
                                // column splits a state item
  int ks[V5_NPROD];             // depth slices a product (1: the whole K an item)
  unsigned int seed;
  int greedy;
  float eps;
  int ablate;
};

// Byte offsets of a block's shared memory: the input stages, the state
// warps' slots or the warps' product sums (region a, used in turn), the
// weight stages, and the row phases' vectors (or the state phase's qkv
// bias), the state warps' q, k, v and the sampling's reductions (misc).
struct V5Smem {
  size_t a, w, misc, total;
};

// Floats of a state slot: an item's E / ncs columns of S (E rows), the q,
// k, v partial rows of each of the ksq slices (E each) and z (E).
__host__ __device__ inline int v5_slot_floats(int E, int ksq, int ncs) {
  return E * (E / ncs) + (3 * ksq + 1) * E;
}

template <typename TW>
__host__ __device__ inline V5Smem v5_smem(int bm, int ns, int nss, int D, int E, int ksq,
                                          int ncs) {
  constexpr int PL = V5T<TW>::PL;
  size_t a = (size_t)ns * PL * bm * V5_RS * 2;
  const size_t slots = (size_t)nss * v5_slot_floats(E, ksq, ncs) * 4;
  const size_t red = (size_t)V5_WARPS * 16 * V5_RED * 4;
  a = a > slots ? a : slots;
  a = a > red ? a : red;
  V5Smem s;
  s.a = 0;
  s.w = (a + 127) / 128 * 128;
  s.misc = s.w + (size_t)ns * PL * V5_BK * V5_WS * 2;
  s.total = s.misc + (size_t)(5 * D + 3 * V5_WARPS * E + 64) * 4;
  return s;
}

__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// v as PL bf16 planes `plane` elements apart: bf16(v), or hi, mid, lo
// (each remainder exact in f32, so hi + mid + lo holds v's 24 bits).
template <int PL>
__device__ __forceinline__ void v5_put2(bf16* p, size_t plane, float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(p) = h;
  if constexpr (PL == 3) {
    const float2 fh = __bfloat1622float2(h);
    a -= fh.x;
    b -= fh.y;
    const __nv_bfloat162 m = __floats2bfloat162_rn(a, b);
    *reinterpret_cast<__nv_bfloat162*>(p + plane) = m;
    const float2 fm = __bfloat1622float2(m);
    *reinterpret_cast<__nv_bfloat162*>(p + 2 * plane) = __floats2bfloat162_rn(a - fm.x, b - fm.y);
  }
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// LayerNorm of a row held by one warp (lane holds values 4 (lane + 32 u)
// .. + 3 in v[u]): (x - mu) * rsqrt(var + 1e-5) * sc + sh, the TPU
// kernels' _ln, in place.
template <typename TV>
__device__ __forceinline__ void v5_ln(float4* v, int D, const TV* sc, const TV* sh) {
  const int lane = threadIdx.x & 31, d4 = D / 4;
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < V5_RV; ++u)
    if (lane + 32 * u < d4) sum += (v[u].x + v[u].y) + (v[u].z + v[u].w);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mu = sum / D;
  float sq = 0.f;
#pragma unroll
  for (int u = 0; u < V5_RV; ++u) {
    if (lane + 32 * u < d4) {
      const float dx = v[u].x - mu, dy = v[u].y - mu, dz = v[u].z - mu, dw = v[u].w - mu;
      sq += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float inv = rsqrtf(sq / D + 1e-5f);
#pragma unroll
  for (int u = 0; u < V5_RV; ++u) {
    const int k = 4 * (lane + 32 * u);
    if (k < D) {
      v[u].x = (v[u].x - mu) * inv * ld(sc + k) + ld(sh + k);
      v[u].y = (v[u].y - mu) * inv * ld(sc + k + 1) + ld(sh + k + 1);
      v[u].z = (v[u].z - mu) * inv * ld(sc + k + 2) + ld(sh + k + 2);
      v[u].w = (v[u].w - mu) * inv * ld(sc + k + 3) + ld(sh + k + 3);
    }
  }
}

// Row m of a product's sums, its ks slices added in slice order, into the
// lanes' registers (as v5_ln holds a row); every load is issued first.
__device__ __forceinline__ void v5_sum_row(const float* part, int ks, size_t slice, int D,
                                           float4* v) {
  const int lane = threadIdx.x & 31, d4 = D / 4;
  float4 p[V5_MAX_KS][V5_RV];
#pragma unroll
  for (int s = 0; s < V5_MAX_KS; ++s)
#pragma unroll
    for (int u = 0; u < V5_RV; ++u) {
      const int i = lane + 32 * u;
      p[s][u] = s < ks && i < d4 ? __ldcg((const float4*)(part + s * slice) + i)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
  for (int u = 0; u < V5_RV; ++u) {
    v[u] = p[0][u];
#pragma unroll
    for (int s = 1; s < V5_MAX_KS; ++s)
      if (s < ks) v[u] = add4(v[u], p[s][u]);
  }
}

// The row phases, a warp a song; each forms a product's input once and
// stores it as planes (and its f32 value where a later phase adds it):
//   V5_EMBED  h = sum_f M[off_f + tok_f] + b_in + pe[t] (embed_row's sum):
//             hres (the layer's residual) and xq (Q's input)
//   V5_LN1    h1 = LN1((h + att Wo) + bo) (JAX's h_scr + ao + wob): h1
//             (FFN2's residual) and x1 (FFN1's input)
//   V5_LN2    x = LN2(h1 + (y W2 + b2)): hres and xq, the next layer's
//   V5_FINAL  LN_f of that after the last layer: xq (the heads' input);
//             under ABLATE_STATE LN_f(hres), the layers having been skipped
// A product's sum (att Wo, y W2) is its ks slices added in order.  The
// phase's bias and LayerNorm vectors reach shared memory by cp.async
// first (misc: three in the weights' type at D sizeof(TW) bytes apart,
// LN_f's two f32 ones from byte 12 D).
template <int PL, typename TW>
__device__ void v5_rows(const V5Args& a, int kind, int l, int t, unsigned char* sm,
                        const V5Smem& L) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, D = a.D, d4 = D / 4;
  if ((int)blockIdx.x * V5_WARPS >= a.B) return;           // no row on this block
  const TW* const* W = (const TW* const*)a.w;
  const size_t plane = (size_t)a.B * D, vbytes = (size_t)D * sizeof(TW);
  unsigned char* vb = sm + L.misc;
  const TW* vec = (const TW*)vb;                            // bias, scale, shift
  const float* fls = (const float*)(vb + 12 * (size_t)D);
  const float* flb = fls + D;
  const bool skipped = kind != V5_LN1 && a.ablate == ABLATE_STATE;
  if (kind != V5_EMBED) {
    const bool ln1 = kind == V5_LN1;
    const TW* src[3] = {W[ln1 ? B_O : B_F2] + (size_t)l * D, W[ln1 ? LN1_S : LN2_S] + (size_t)l * D,
                        W[ln1 ? LN1_B : LN2_B] + (size_t)l * D};
    const int pv = (int)(vbytes / 16);
    if (!skipped)
      for (int c = tid; c < 3 * pv; c += LT_THREADS)
        cp_async16(vb + (c / pv) * vbytes + (c % pv) * 16,
                   (const unsigned char*)src[c / pv] + (c % pv) * 16, true);
    if (kind == V5_FINAL)
      for (int c = tid; c < 2 * d4; c += LT_THREADS)
        cp_async16(vb + 12 * (size_t)D + (c / d4) * 4 * (size_t)D + (c % d4) * 16,
                   (c < d4 ? a.fls : a.flb) + (c % d4) * 4, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  for (int m = blockIdx.x * V5_WARPS + warp; m < a.B; m += gridDim.x * V5_WARPS) {
    float4 v[V5_RV];
    float* keep = a.hres;
    bf16* out = a.xq;
    const size_t row = (size_t)m * D;
    if (kind == V5_EMBED) {
      const int* tok = (t == 0 ? a.tok0 : a.tokens + (size_t)(t - 1) * a.B * a.NF) +
                       (size_t)m * a.NF;
#pragma unroll
      for (int u = 0; u < V5_RV; ++u) v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int f = 0; f < a.NF; ++f) {
        const float4* e = (const float4*)(a.m + (size_t)(a.fa.off[f] + __ldcg(tok + f)) * D);
#pragma unroll
        for (int u = 0; u < V5_RV; ++u)
          if (lane + 32 * u < d4) v[u] = add4(v[u], e[lane + 32 * u]);
      }
      const float4* bin = (const float4*)a.bin;
      const float4* pe = (const float4*)(a.pe + (size_t)t * D);
#pragma unroll
      for (int u = 0; u < V5_RV; ++u)
        if (lane + 32 * u < d4) v[u] = add4(add4(v[u], bin[lane + 32 * u]), pe[lane + 32 * u]);
    } else if (skipped) {
#pragma unroll
      for (int u = 0; u < V5_RV; ++u)
        v[u] = lane + 32 * u < d4 ? __ldcg((const float4*)(a.hres + row) + lane + 32 * u)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const bool ln1 = kind == V5_LN1;
      const int ph = ln1 ? V5_O : V5_F2;
      const float* res = (ln1 ? a.hres : a.h1) + row;
      v5_sum_row(a.part[ph] + row, a.ks[ph], plane, D, v);
#pragma unroll
      for (int u = 0; u < V5_RV; ++u) {
        const int i = lane + 32 * u;
        if (i < d4) {
          const float4 h = __ldcg((const float4*)res + i);
          const int k = 4 * i;
          const float4 b = make_float4(ld(vec + k), ld(vec + k + 1), ld(vec + k + 2),
                                       ld(vec + k + 3));
          v[u] = ln1 ? add4(add4(h, v[u]), b) : add4(h, add4(v[u], b));
        }
      }
      v5_ln(v, D, vec + D, vec + 2 * D);
      if (ln1) {
        keep = a.h1;
        out = a.x1;
      }
    }
    if (kind == V5_FINAL) {
      v5_ln(v, D, fls, flb);
      keep = nullptr;
    }
#pragma unroll
    for (int u = 0; u < V5_RV; ++u) {
      const int i = lane + 32 * u;
      if (i < d4) {
        if (keep != nullptr) __stcg((float4*)(keep + row) + i, v[u]);
        v5_put2<PL>(out + row + 4 * i, plane, v[u].x, v[u].y);
        v5_put2<PL>(out + row + 4 * i + 2, plane, v[u].z, v[u].w);
      }
    }
  }
}

// One product phase of layer l: sums = in @ W, in the (B, K) planes a row
// phase or the state phase stored, W the product's planes.  Items: (row
// tile of bm songs, 64 columns, depth slice) over K / ks depths, every
// slice's f32 sum stored apart (part[ph]), so no sum is split where ks is
// 1; FFN1 (never split) stores gelu_exact(sum + b1) as FFN2's input planes
// instead.  The block's 8 warps take 16 rows x 32 columns each, 2 bm / 16
// of them covering the tile and WK = 4 / (bm / 16) splitting each stage's
// four depth steps of 16 (warp wk the steps congruent to wk mod WK), each
// step in mma.sync.m16n8k16 (one product with one plane; six, summed
// afresh and added in f32, with three); the block adds the WK sums in
// order.  Operand tiles of 64 depths reach shared memory by cp.async
// through ns stages, ns - 1 of them in flight while a stage multiplies;
// rows past B are zeros.  A sum's order follows (B, K, N, the SM count)
// alone.
template <typename TW>
__device__ void v5_product(const V5Args& a, int ph, int l, unsigned char* sm, const V5Smem& L) {
  constexpr int PL = V5T<TW>::PL;
  const int D = a.D, DI = a.DI, B = a.B, bm = a.bm, ns = a.ns, ks = a.ks[ph];
  const int K = ph == V5_F2 ? DI : D;
  const int N = ph == V5_Q ? 3 * D : ph == V5_F1 ? DI : ph == V5_H ? a.NF * VF_PAD : D;
  const bf16* w = a.wp[ph] + (ph == V5_H ? 0 : (size_t)l * K * N);
  const bf16* ain = ph == V5_O ? a.att : ph == V5_F1 ? a.x1 : ph == V5_F2 ? a.y : a.xq;
  const size_t wpl = a.wpl[ph], apl = (size_t)B * K;
  const int WM = bm >> 4, WK = 4 / WM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & (WM - 1), wn = (warp / WM) & 1, wk = warp / (2 * WM);
  const int n_ct = N / V5_BN, items = (B + bm - 1) / bm * n_ct * ks, nk = K / V5_BK / ks;
  const int a_stage = PL * bm * V5_RS, a_plane = bm * V5_RS, w_stage = PL * V5_BK * V5_WS;
  bf16* as = (bf16*)(sm + L.a);
  bf16* ws = (bf16*)(sm + L.w);
  float* red = (float*)(sm + L.a);           // the warps' sums, over the input stages
  // this thread's 16-byte pieces of a stage: weight rows pr and pr + 32 at
  // column pc, input rows pr and pr + 32 (those below bm) at depth pc
  const int pr = tid >> 3, pc = (tid & 7) * 8;
  const TW* b1 = (const TW*)a.w[B_F1] + (size_t)l * DI;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int sl = it % ks, tile = it / ks, m0 = tile / n_ct * bm, n0 = tile % n_ct * V5_BN;
    const int k0 = sl * nk * V5_BK;
    const bf16* wsrc = w + (size_t)(k0 + pr) * N + n0 + pc;
    const bool a0 = pr < bm && m0 + pr < B, a1 = pr + 32 < bm && m0 + pr + 32 < B;
    const bf16* asrc0 = a0 ? ain + (size_t)(m0 + pr) * K + k0 + pc : ain;
    const bf16* asrc1 = a1 ? ain + (size_t)(m0 + pr + 32) * K + k0 + pc : ain;
    auto load = [&](int kc, int slot) {     // depths kc 64 .. of the slice into stage slot
      bf16* wd = ws + slot * w_stage + pr * V5_WS + pc;
      const bf16* src = wsrc + (size_t)kc * V5_BK * N;
#pragma unroll
      for (int pl = 0; pl < PL; ++pl) {
        cp_async16(wd + pl * V5_BK * V5_WS, src + pl * wpl, true);
        cp_async16(wd + pl * V5_BK * V5_WS + 32 * V5_WS, src + pl * wpl + 32 * (size_t)N, true);
      }
      bf16* ad = as + slot * a_stage + pr * V5_RS + pc;
      if (pr < bm) {
#pragma unroll
        for (int pl = 0; pl < PL; ++pl)
          cp_async16(ad + pl * a_plane, asrc0 + (a0 ? kc * V5_BK + pl * apl : 0), a0);
      }
      if (pr + 32 < bm) {
#pragma unroll
        for (int pl = 0; pl < PL; ++pl)
          cp_async16(ad + pl * a_plane + 32 * V5_RS, asrc1 + (a1 ? kc * V5_BK + pl * apl : 0),
                     a1);
      }
    };
    int ls = 0, cs = 0;                      // the stage to load next, to multiply next
    for (int kc = 0; kc < ns - 1; ++kc) {
      if (kc < nk) load(kc, ls);
      ls = ls + 1 == ns ? 0 : ls + 1;
      cp_async_commit();
    }
    // FFN1's bias at this thread's epilogue columns (fixed within the item)
    const int ec = (tid & 31) * 2;
    const float eb0 = ph == V5_F1 ? ld(b1 + n0 + ec) : 0.f;
    const float eb1 = ph == V5_F1 ? ld(b1 + n0 + ec + 1) : 0.f;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait_n(ns - 2);
      __syncthreads();                      // stage kt is in; stage kt - 1 is free
      if (kt + ns - 1 < nk) load(kt + ns - 1, ls);
      ls = ls + 1 == ns ? 0 : ls + 1;
      cp_async_commit();
      const bf16* asl = as + cs * a_stage + (wm * 16 + (lane & 15)) * V5_RS + (lane >> 4) * 8;
      const bf16* wsl = ws + cs * w_stage + (lane & 15) * V5_WS + wn * 32 + (lane >> 4) * 8;
      cs = cs + 1 == ns ? 0 : cs + 1;
      for (int kk = wk; kk < V5_STEPS; kk += WK) {
        uint32_t af[PL][4];
#pragma unroll
        for (int pl = 0; pl < PL; ++pl) ldmatrix_x4(af[pl], asl + pl * a_plane + kk * 16);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t bq[PL][4];
#pragma unroll
          for (int pl = 0; pl < PL; ++pl)
            ldmatrix_x4_trans(bq[pl], wsl + pl * V5_BK * V5_WS + kk * 16 * V5_WS + p * 16);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int o = 2 * half, j = 2 * p + half;
            if constexpr (PL == 1) {
              mma_bf16(acc[j], af[0], &bq[0][o]);
            } else {
              // planes 0, 1, 2 = hi, mid, lo: this depth's six products in
              // a fresh sum, then one f32 add (the tensor cores truncate
              // what they add to a running sum): kernel B's order
              float c[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(c, af[2], &bq[0][o]);
              mma_bf16(c, af[0], &bq[2][o]);
              mma_bf16(c, af[1], &bq[1][o]);
              mma_bf16(c, af[1], &bq[0][o]);
              mma_bf16(c, af[0], &bq[1][o]);
              mma_bf16(c, af[0], &bq[0][o]);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[j][q] += c[q];
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();                          // every warp is done with the stages
    float* rw = red + warp * 16 * V5_RED;
    const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      st2(rw + g * V5_RED + j * 8 + t2, acc[j][0], acc[j][1]);
      st2(rw + (g + 8) * V5_RED + j * 8 + t2, acc[j][2], acc[j][3]);
    }
    __syncthreads();
    float* out = a.part[ph] + ((size_t)sl * B + m0) * N + n0;
    for (int o = tid; o < bm * 32; o += LT_THREADS) {   // output pairs (r, ec), (r, ec + 1)
      const int r = o >> 5;
      if (m0 + r >= B) break;
      const float* rq = red + ((r >> 4) + WM * (ec >> 5)) * 16 * V5_RED + (r & 15) * V5_RED +
                        (ec & 31);
      float v0 = 0.f, v1 = 0.f;
      for (int q = 0; q < WK; ++q) {         // the depth split's sums, in order
        v0 += rq[q * 2 * WM * 16 * V5_RED];
        v1 += rq[q * 2 * WM * 16 * V5_RED + 1];
      }
      if (ph == V5_F1)
        v5_put2<PL>(a.y + (size_t)(m0 + r) * DI + n0 + ec, (size_t)B * DI,
                    gelu_exact(v0 + eb0), gelu_exact(v1 + eb1));
      else
        st2(out + (size_t)r * N + ec, v0, v1);
    }
    __syncthreads();                         // the sums and the stages are free again
  }
}

// The state phase of layer l: one item per (song b, head hd, column
// split cs), the item's E x E / ncs block of S (rows D values apart) and z
// (E) of v5's layout, taken by a warp: nss warps of each block take items
// in turn, each with its slot of shared memory, so nss items a block are
// in flight at once (ncs > 1 splits a head's columns where the batch
// leaves the grid's warps without items).  The warp's lanes bring the
// item's S columns, its q, k, v partial rows and z into the slot by
// 16-byte cp.async; q = phi(sum + bq), k = phi(sum + bk), v = sum + bv
// (the slices in order); S += k v^T is written back with 16-byte
// streaming stores, and z += k by the item of the first columns; num =
// q^T S (a lane 4 columns over the rows of its row group, the groups
// added in a fixed butterfly), den = q.z + eps over the whole head
// (attn_slice's order), att = num / den as O's input planes.  S and z are
// read and written once.  Honours a.ablate.
template <int PL, typename TW>
__device__ void v5_state(const V5Args& a, int l, unsigned char* sm, const V5Smem& L) {
  const int B = a.B, D = a.D, H = a.H, E = D / H, E4 = E / 4, ksq = a.ks[V5_Q], ncs = a.ncs;
  const int CW = E / ncs, C4 = CW / 4;                   // an item's columns, its quads
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nw = a.nss;
  const int lg = __ffs(E4) - 1, lc = __ffs(C4) - 1;      // E4, C4 are powers of two
  const int n4 = E * C4, np = n4 + (3 * ksq + 1) * E4, slotf = v5_slot_floats(E, ksq, ncs);
  const int rgw = C4 < 32 ? 32 / C4 : 1;                 // a warp's row groups
  float* bias = (float*)(sm + L.misc);                   // the layer's qkv bias (3 D)
  float* q = bias + 5 * D + warp * 3 * E;                // this warp's q, k, v
  float* k = q + E;
  float* v = k + E;
  const bool upd = a.ablate != ABLATE_ATTN;
  const TW* bq = (const TW*)a.w[B_QKV] + (size_t)l * 3 * D;
  for (int i = tid; i < 3 * D; i += LT_THREADS) bias[i] = ld(bq + i);
  __syncthreads();
  if (warp >= nw) return;
  float* slot = (float*)(sm + L.a) + (size_t)warp * slotf;
  const float* pq = a.part[V5_Q];
  const int u = (lane & (C4 - 1)) * 4, r0 = lane >> lc;
  for (int j = blockIdx.x * nw + warp; j < B * H * ncs; j += gridDim.x * nw) {
    const int cs = j % ncs, b = j / ncs / H, hd = j / ncs % H, c0 = hd * E + cs * CW;
    float* sp = a.s + (((size_t)l * B + b) * E) * D + c0;
    float* zp = a.z + ((size_t)l * B + b) * D + hd * E;
    for (int c = lane; c < np; c += 32) {
      const float* src;
      if (c < n4) {
        src = sp + (size_t)(c >> lc) * D + (c & (C4 - 1)) * 4;
      } else {
        const int r = (c - n4) >> lg, uu = ((c - n4) & (E4 - 1)) * 4;   // 3 slice + part, or z
        src = r < 3 * ksq ? pq + ((size_t)(r / 3) * B + b) * 3 * D + (r % 3) * D + hd * E + uu
                          : zp + uu;
      }
      cp_async16(slot + 4 * c, src, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    const float* qkv = slot + E * CW;
    const float* zs = qkv + 3 * ksq * E;
    for (int i = lane; i < E; i += 32) {
      float sq = 0.f, sk = 0.f, sv = 0.f;
      for (int s = 0; s < ksq; ++s) {
        sq += qkv[3 * s * E + i];
        sk += qkv[(3 * s + 1) * E + i];
        sv += qkv[(3 * s + 2) * E + i];
      }
      q[i] = phi(sq + bias[hd * E + i]);
      k[i] = phi(sk + bias[D + hd * E + i]);
      v[i] = sv + bias[2 * D + hd * E + i];
    }
    __syncwarp();
    float num[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 < E) {
      const float* vu = v + cs * CW + u;
      const float v0 = vu[0], v1 = vu[1], v2 = vu[2], v3 = vu[3];
      for (int r = r0; r < E; r += rgw) {
        float4 s4 = *(const float4*)(slot + r * CW + u);
        if (upd) {
          const float kr = k[r], qr = q[r];
          s4.x = fmaf(kr, v0, s4.x);
          s4.y = fmaf(kr, v1, s4.y);
          s4.z = fmaf(kr, v2, s4.z);
          s4.w = fmaf(kr, v3, s4.w);
          num[0] = fmaf(qr, s4.x, num[0]);
          num[1] = fmaf(qr, s4.y, num[1]);
          num[2] = fmaf(qr, s4.z, num[2]);
          num[3] = fmaf(qr, s4.w, num[3]);
        }
        __stcs((float4*)(sp + (size_t)r * D + u), s4);
      }
    }
    for (int off = C4; off < 32; off <<= 1)             // the row groups of a column quad
#pragma unroll
      for (int c = 0; c < 4; ++c) num[c] += __shfl_xor_sync(0xffffffffu, num[c], off);
    float d = 0.f;
    for (int i = lane; i < E; i += 32) d += q[i] * (zs[i] + k[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    const float den = d + a.eps;
    if (lane < C4) {
      bf16* o = a.att + (size_t)b * D + c0 + u;
      v5_put2<PL>(o, (size_t)B * D, upd ? num[0] / den : 0.f, upd ? num[1] / den : 0.f);
      v5_put2<PL>(o + 2, (size_t)B * D, upd ? num[2] / den : 0.f, upd ? num[3] / den : 0.f);
    }
    if (cs == 0)
      for (int i = lane; i < E; i += 32) __stcs(zp + i, upd ? zs[i] + k[i] : zs[i]);
    __syncwarp();                                        // the slot and q, k, v are free
  }
}

// ABLATE_STATE's layer: the state of layer l read and written back,
// nothing else.
__device__ void stream_state(const V5Args& a, int l, int g, int G) {
  const size_t nz = (size_t)a.B * a.D, ns = nz * (a.D / a.H);
  float* s = a.s + l * ns;
  float* z = a.z + l * nz;
  const size_t i0 = (size_t)g * blockDim.x + threadIdx.x, step = (size_t)G * blockDim.x;
  for (size_t i = i0; i < ns; i += step) __stcg(s + i, __ldcg(s + i));
  for (size_t i = i0; i < nz; i += step) __stcg(z + i, __ldcg(z + i));
}

// Development timing (-DV5_PROFILE builds only, scripts/
// profile_torch_v5_phases.py): block x's %globaltimer as each phase of the
// call's last token starts and ends, row l < L the layer's (Q, S, O, LN1,
// F1, F2, LN2: marks 2 p and 2 p + 1), row L the token's (embedding, final
// LN, heads, sampling).
#ifdef V5_PROFILE
constexpr int V5_MARKS = 14, V5_PROF_L = 17, V5_PROF_G = 160;
__device__ unsigned long long v5_marks[V5_PROF_L * V5_MARKS][V5_PROF_G];
#define V5_MARK(t, l, m)                                                                 \
  do {                                                                                   \
    if ((t) == a.T - 1 && threadIdx.x == 0 && (l) < V5_PROF_L && blockIdx.x < V5_PROF_G) { \
      unsigned long long t_;                                                             \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                             \
      v5_marks[(l) * V5_MARKS + (m)][blockIdx.x] = t_;                                   \
    }                                                                                    \
  } while (0)
#else
#define V5_MARK(t, l, m) \
  do {                   \
  } while (0)
#endif

// v5: T tokens of B songs in one cooperative launch of one block per SM.
// A token: the embedding rows, per layer Q, the state, O, LN1, F1, F2 and
// LN2 (after the last layer the final LN), the heads product and the
// sampling, a grid barrier after each: 7 L + 3 a token.
template <typename TW>
__global__ void __launch_bounds__(LT_THREADS, 1)
decode_v5_kernel(const __grid_constant__ V5Args a) {
  constexpr int PL = V5T<TW>::PL;
  cg::grid_group grid = cg::this_grid();
  const V5Smem L = v5_smem<TW>(a.bm, a.ns, a.nss, a.D, a.D / a.H, a.ks[V5_Q], a.ncs);
  float* red = (float*)(lt_smem + L.misc) + 5 * a.D + 3 * V5_WARPS * (a.D / a.H);
  const int nc = a.NF * VF_PAD, ksh = a.ks[V5_H];
  const size_t hslice = (size_t)a.B * nc;
  for (int t = 0; t < a.T; ++t) {
    V5_MARK(t, a.L, 0);
    v5_rows<PL, TW>(a, V5_EMBED, 0, t, lt_smem, L);
    V5_MARK(t, a.L, 1);
    grid.sync();
    for (int l = 0; l < a.L; ++l) {
      if (a.ablate == ABLATE_STATE) {
        stream_state(a, l, blockIdx.x, gridDim.x);
        grid.sync();
        continue;
      }
      V5_MARK(t, l, 0);
      v5_product<TW>(a, V5_Q, l, lt_smem, L);
      V5_MARK(t, l, 1);
      grid.sync();
      V5_MARK(t, l, 2);
      v5_state<PL, TW>(a, l, lt_smem, L);
      V5_MARK(t, l, 3);
      grid.sync();
      V5_MARK(t, l, 4);
      v5_product<TW>(a, V5_O, l, lt_smem, L);
      V5_MARK(t, l, 5);
      grid.sync();
      V5_MARK(t, l, 6);
      v5_rows<PL, TW>(a, V5_LN1, l, t, lt_smem, L);
      V5_MARK(t, l, 7);
      grid.sync();
      V5_MARK(t, l, 8);
      v5_product<TW>(a, V5_F1, l, lt_smem, L);
      V5_MARK(t, l, 9);
      grid.sync();
      V5_MARK(t, l, 10);
      v5_product<TW>(a, V5_F2, l, lt_smem, L);
      V5_MARK(t, l, 11);
      grid.sync();
      if (l + 1 < a.L) {
        V5_MARK(t, l, 12);
        v5_rows<PL, TW>(a, V5_LN2, l, t, lt_smem, L);
        V5_MARK(t, l, 13);
        grid.sync();
      }
    }
    V5_MARK(t, a.L, 2);
    v5_rows<PL, TW>(a, V5_FINAL, a.L - 1, t, lt_smem, L);
    V5_MARK(t, a.L, 3);
    grid.sync();
    V5_MARK(t, a.L, 4);
    v5_product<TW>(a, V5_H, 0, lt_smem, L);
    V5_MARK(t, a.L, 5);
    grid.sync();
    V5_MARK(t, a.L, 6);
    // sampling: the logit of (song b, field f, vocab index v) is the heads'
    // sum (its slices in order) + the head bias, times 1 / temperature
    for (int i = blockIdx.x; i < a.B * a.NF; i += gridDim.x) {
      const int b = i / a.NF, f = i % a.NF, col = f * VF_PAD + threadIdx.x;
      __syncthreads();                       // red is free
      const float* lg = a.part[V5_H] + (size_t)b * nc + col;
      float p[V5_MAX_KS];
#pragma unroll
      for (int s = 0; s < V5_MAX_KS; ++s) p[s] = s < ksh ? __ldcg(lg + s * hslice) : 0.f;
      float acc = p[0];
#pragma unroll
      for (int s = 1; s < V5_MAX_KS; ++s)
        if (s < ksh) acc += p[s];
      const float x = (acc + a.hb[col]) * a.fa.tinv[f];
      const int tok = sample_logit(x, a.fa, b, f, t, a.seed, a.greedy, red, (int*)(red + 32));
      if (threadIdx.x == 0) a.tokens[((size_t)t * a.B + b) * a.NF + f] = tok;
    }
    V5_MARK(t, a.L, 7);
    if (t + 1 < a.T) grid.sync();
  }
}

// The launch's tiles, slices and stages for B songs on a grid of G blocks
// with max_smem shared bytes a block: product tiles of 16, 32 or 64 rows
// (following B, not bb) by 64 columns; a product's depths split in 2 or 4
// slices where its tiles would leave more than half of the grid without an
// item (never FFN1's: its gelu needs the whole sum), each slice at least
// one stage; as many stages and state slots as fit.  Returns the shared
// bytes, or 0 when none fits.
template <typename TW>
inline size_t v5_plan(int B, int D, int H, int DI, int NF, int G, int max_smem, V5Args* a) {
  const int E = D / H;
  const size_t cap = (size_t)max_smem;
  const int N[V5_NPROD] = {3 * D, D, DI, D, NF * VF_PAD};
  const int K[V5_NPROD] = {D, D, D, DI, D};
  a->bm = B <= 16 ? 16 : B <= 32 ? 32 : V5_MAX_BM;
  const int rt = (B + a->bm - 1) / a->bm;
  for (int p = 0; p < V5_NPROD; ++p) {
    const int items = rt * (N[p] / V5_BN);
    a->ks[p] = 1;
    while (p != V5_F1 && a->ks[p] < V5_MAX_KS && 2 * items * a->ks[p] <= G &&
           (K[p] / V5_BK) % (2 * a->ks[p]) == 0)
      a->ks[p] *= 2;
  }
  const int ksq = a->ks[V5_Q];
  // a head's columns split in 2, 4, ... (at least 16 a split) while the
  // state items would leave more than half of the grid's warps idle
  a->ncs = 1;
  while (a->ncs < E / 16 && 2 * B * H * a->ncs <= G * V5_WARPS) a->ncs *= 2;
  const int cs = a->ncs;
  while (a->bm > 16 && v5_smem<TW>(a->bm, 2, 1, D, E, ksq, cs).total > cap) a->bm /= 2;
  if (v5_smem<TW>(a->bm, 2, 1, D, E, ksq, cs).total > cap) return 0;
  // stages up to 4, then state warps up to 8, then stages up to V5_MAX_NS
  a->ns = 2;
  a->nss = 1;
  while (a->ns < 4 && v5_smem<TW>(a->bm, a->ns + 1, 1, D, E, ksq, cs).total <= cap) ++a->ns;
  while (a->nss < V5_WARPS && v5_smem<TW>(a->bm, a->ns, a->nss + 1, D, E, ksq, cs).total <= cap)
    ++a->nss;
  while (a->ns < V5_MAX_NS && v5_smem<TW>(a->bm, a->ns + 1, a->nss, D, E, ksq, cs).total <= cap)
    ++a->ns;
  return v5_smem<TW>(a->bm, a->ns, a->nss, D, E, ksq, cs).total;
}

inline bool v5_shape_ok(int B, int D, int H, int DI, int NF) {
  const int E = H > 0 ? D / H : 0;
  return B >= 1 && E * H == D && E >= 4 && E <= MAX_E && (E & (E - 1)) == 0 && D % 64 == 0 &&
         DI % 64 == 0 && D <= V5_MAX_D && NF >= 1 && NF <= MAX_NF;
}

// f32 scratch of v5 (v5_carve): the sums of Q (3 D), O (D), F2 (D) and the
// heads (NF VF_PAD) a song and slice; hres and h1; the PL planes of xq,
// att, x1 (D) and y (DI).
inline size_t v5_carve(float* base, const V5Args& plan, int B, int D, int DI, int NF, int PL,
                       V5Args* a) {
  const size_t bd = (size_t)B * D;
  const size_t sizes[10] = {plan.ks[V5_Q] * 3 * bd, plan.ks[V5_O] * bd, plan.ks[V5_F2] * bd,
                            (size_t)plan.ks[V5_H] * B * NF * VF_PAD, bd, bd,
                            (PL * bd + 1) / 2, (PL * bd + 1) / 2, (PL * bd + 1) / 2,
                            ((size_t)PL * B * DI + 1) / 2};
  float* p[10];
  size_t off = 0;
  for (int i = 0; i < 10; ++i) {
    p[i] = base ? base + off : nullptr;
    off += (sizes[i] + 3) / 4 * 4;
  }
  if (a) {
    a->part[V5_Q] = p[0];
    a->part[V5_O] = p[1];
    a->part[V5_F1] = nullptr;
    a->part[V5_F2] = p[2];
    a->part[V5_H] = p[3];
    a->hres = p[4];
    a->h1 = p[5];
    a->xq = (bf16*)p[6];
    a->att = (bf16*)p[7];
    a->x1 = (bf16*)p[8];
    a->y = (bf16*)p[9];
  }
  return off;
}

// The launch of a planned V5Args (v5_plan) with smem shared bytes a block.
template <typename TW>
int v5_run(const V5Args& a, int n_sm, size_t smem, cudaStream_t st) {
  const auto kern = decode_v5_kernel<TW>;
  const int rc = cooperative_ok(kern, n_sm, smem, n_sm);
  if (rc) return rc;
  void* args[] = {(void*)&a};
  return (int)cudaLaunchCooperativeKernel((const void*)kern, n_sm, LT_THREADS, args, smem, st);
}

// v5's plan on the current card into a (0 shared bytes: none fits, or a
// CUDA error in *rc).
inline size_t v5_plan_here(int B, int D, int H, int DI, int NF, int w_bf16, V5Args* a, int* n_sm,
                           int* rc) {
  int max_smem = 0;
  *rc = card(n_sm, &max_smem);
  if (*rc) return 0;
  return w_bf16 ? v5_plan<__nv_bfloat16>(B, D, H, DI, NF, *n_sm, max_smem, a)
                : v5_plan<float>(B, D, H, DI, NF, *n_sm, max_smem, a);
}

}  // namespace rlmg

extern "C" {

#ifdef LP_PROFILE
// The buffer v8's phase marks go to (LP_PROFILE_MARKS u64 a block).
void* lp_prof_buf = nullptr;
void rlmg_lp_set_prof(void* p) { lp_prof_buf = p; }
#endif

// f32 scratch floats the latency kernels (v8, v7) need.
long long rlmg_latency_scratch_floats(int B, int D, int H, int DI) {
  return (long long)rlmg::lp_carve(nullptr, B, D, H, DI, nullptr);
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

// v5's f32 scratch floats with bf16 (w_bf16) or f32 weights on the current
// card (its plan's slices set the sums' room); -1 for a shape it does not
// take.
long long rlmg_v5_scratch_floats(int B, int D, int H, int DI, int NF, int w_bf16) {
  if (!rlmg::v5_shape_ok(B, D, H, DI, NF)) return -1;
  rlmg::V5Args a;
  memset(&a, 0, sizeof a);
  int n_sm = 0, rc = 0;
  if (rlmg::v5_plan_here(B, D, H, DI, NF, w_bf16, &a, &n_sm, &rc) == 0) return -1;
  return (long long)rlmg::v5_carve(nullptr, a, B, D, DI, NF, w_bf16 ? 1 : 3, nullptr);
}

// v5's launch plan on the current card: out[0] rows a product tile, out[1]
// stages in flight, out[2] state warps, out[3..7] the depth slices of the
// Q, O, F1, F2 and heads products, out[8] shared bytes a block, out[9] the
// column splits of a state item.  Returns 0
// or a CUDA error code (cudaErrorInvalidValue: a shape the kernel does not
// take, or no plan fits a block's shared memory).
int rlmg_v5_plan(int B, int D, int H, int DI, int NF, int w_bf16, int* out) {
  if (!rlmg::v5_shape_ok(B, D, H, DI, NF)) return (int)cudaErrorInvalidValue;
  rlmg::V5Args a;
  memset(&a, 0, sizeof a);
  int n_sm = 0, rc = 0;
  const size_t smem = rlmg::v5_plan_here(B, D, H, DI, NF, w_bf16, &a, &n_sm, &rc);
  if (rc) return rc;
  if (smem == 0) return (int)cudaErrorInvalidValue;
  out[0] = a.bm;
  out[1] = a.ns;
  out[2] = a.nss;
  for (int p = 0; p < rlmg::V5_NPROD; ++p) out[3 + p] = a.ks[p];
  out[8] = (int)smem;
  out[9] = a.ncs;
  return 0;
}

// Decode T tokens of B songs with the v5 kernel, one cooperative launch.
// tok0 (B, NF) int32 is the first token fed; tokens (T, B, NF) int32
// receives the T successors.  s (L, B, E, H E) and z (L, B, H E) f32 are
// updated in place.  pe_rows (T, D) f32 are the fed tokens' positional
// rows; the Philox position of token t is t.  w: the 12 stacked layer
// leaves (one type, w_bf16); wp: the five products' weights (Wqkv, Wo, W1,
// W2 stacked over L, then the padded heads (D, NF VF_PAD)) as plane 0 of
// their bf16 planes, wpl[i] elements from one plane to the next (bf16
// weights: the leaves themselves, one plane; f32 weights: their three
// planes, ops/decode_kernel_v6.py weight_planes).  bb (8, 16 or 32,
// dividing B) names JAX's state block; the kernel's arithmetic does not
// depend on it.  ablate: ABLATE_* (0 for a real decode).  scratch:
// rlmg_v5_scratch_floats floats.  Other arguments as rlmg_latency_decode's.
int rlmg_decode_v5(const int* tok0, int* tokens, const float* m, const float* bin,
                   const float* pe_rows, const void* const* w, const void* const* wp,
                   const long long* wpl, const float* hb, const float* fls, const float* flb,
                   const int* off, const float* tinv, const float* topp, float* s, float* z,
                   float* scratch, int T, unsigned int seed, int greedy, int L, int B, int D,
                   int H, int DI, int NF, int bb, float eps, int w_bf16, int ablate,
                   void* stream) {
  if (!rlmg::v5_shape_ok(B, D, H, DI, NF) || T < 1 || L < 1 || (bb != 8 && bb != 16 && bb != 32) ||
      B % bb || ablate < 0 || ablate > 2)
    return (int)cudaErrorInvalidValue;
  rlmg::V5Args a;
  memset(&a, 0, sizeof a);
  int n_sm = 0, rc = 0;
  const size_t smem = rlmg::v5_plan_here(B, D, H, DI, NF, w_bf16, &a, &n_sm, &rc);
  if (rc) return rc;
  if (smem == 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < rlmg::N_WEIGHTS; ++i) a.w[i] = w[i];
  for (int i = 0; i < rlmg::V5_NPROD; ++i) {
    a.wp[i] = (const __nv_bfloat16*)wp[i];
    a.wpl[i] = (size_t)wpl[i];
  }
  a.m = m;
  a.bin = bin;
  a.pe = pe_rows;
  a.hb = hb;
  a.fls = fls;
  a.flb = flb;
  a.fa = rlmg::field_args(off, tinv, topp, NF);
  a.tok0 = tok0;
  a.tokens = tokens;
  a.s = s;
  a.z = z;
  rlmg::v5_carve(scratch, a, B, D, DI, NF, w_bf16 ? 1 : 3, &a);
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
  return w_bf16 ? rlmg::v5_run<__nv_bfloat16>(a, n_sm, smem, st)
                : rlmg::v5_run<float>(a, n_sm, smem, st);
}

#ifdef V5_PROFILE
// v5's phase marks of the last launch (V5_PROF_L x V5_MARKS x V5_PROF_G
// u64, see V5_MARK) into out, and cleared.
int rlmg_v5_marks(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, rlmg::v5_marks, sizeof rlmg::v5_marks);
  static unsigned long long zero[rlmg::V5_PROF_L * rlmg::V5_MARKS][rlmg::V5_PROF_G];
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(rlmg::v5_marks, zero, sizeof zero);
  return (int)e;
}
#endif

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
