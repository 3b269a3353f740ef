// A product tile on Hopper's warpgroup MMA (wgmma): C (M, N) = A (M, K)
// B^T (B stored (N, K)) + bias, with phi = elu + 1 on the first phi_cols
// columns, the output stored in the inputs' type and, where they are bf16,
// also in f32 before the rounding.  Kernel C's qkv projection (h Wqkv +
// b, attention_block.cu); written so that kernels D and G can take it.
// Plain C interface through the sources; no PyTorch headers.
//
// Arithmetic, as train_gemm_tc.cuh's (its header says why):
//   PL = 1 (bf16 tensors): one bf16 product with f32 sums, the running sum
//     kept in the tensor cores over the whole depth: JAX's f32 dot of the
//     bf16 values (its kernel casts them to f32 first).
//   PL = 3 (f32 tensors): each operand split x = hi + mid + lo (three bf16
//     planes), the six products whose terms reach 2^-16 (hi.hi, hi.mid,
//     mid.hi, hi.lo, lo.hi, mid.mid), each depth of 16 summed afresh in the
//     tensor cores and added to the running sum in registers by an f32 add.
// Operands reach the tile as bf16 planes in device memory, K contiguous:
// a bf16 h is its own plane; an f32 h and the weights (transposed to
// (N, K)) are split by one pass a call each (train_split.cuh's
// split_kernel, split_cols_kernel: the weights' planes are not kept
// across calls).
//
// The tile.  A block of two warpgroups owns 128 x 128 of C, each
// warpgroup 64 rows, its sums in registers (64 floats a thread; a second
// 64 for the fresh depth at PL = 3).  K runs in slices through a ring of
// shared-memory stages that thread 0 fills by TMA (one box a plane and
// operand, zeros past M, N and K, so K need only be a multiple of 8), a
// full mbarrier a stage counting its bytes and an empty one that both
// warpgroups mark when their products on it have ended: no block-wide
// barrier in the loop, so the warpgroups take turns on the tensor cores.
// PL = 1: slices of 64 bf16 (128-byte rows, TMA's and wgmma's 128-byte
// swizzle), 3 stages, two blocks an SM; PL = 3: slices of 32 (64-byte
// rows, the 64-byte swizzle), 4 stages, one block an SM.  (Without a
// swizzle wgmma's reads of the same row groups meet in the same banks:
// the tile took twice as long, measured on the card.)  Each 16-deep step
// is an m64n128k16 wgmma from shared memory through matrix descriptors.
//
// Bound at kernel C's shape (16384 x 512 @ 512 x 1536): 25.8 GFLOP, 0.026
// ms at 989 TFLOP/s in bf16, 0.157 ms at 989/6 for the f32 grade; the
// bytes (h, W, the outputs) 0.05-0.08 ms.

#pragma once

#include <cuda.h>

#include "decode_layers.cuh"
#include "tc_mma.cuh"
#include "train_split.cuh"

namespace rlmg {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, THREADS = 256;

// PL = 1: slices of 64 (128-byte rows), 3 stages (97 KB: two blocks an
// SM); PL = 3: slices of 32 (64-byte rows), 4 stages (193 KB: one block an
// SM); filled STAGES - 1 slices ahead.
template <int PL>
struct Cfg {
  static constexpr int BK = PL == 1 ? 64 : 32;     // 128- or 64-byte rows: the swizzle's width
  static constexpr int STAGES = PL == 1 ? 3 : 4, AHEAD = STAGES - 1;
  static constexpr int MINB = PL == 1 ? 2 : 1;
  static constexpr int TILE_A = BM * BK, TILE_B = BN * BK;    // bf16 a plane
  static constexpr int STAGE = PL * (TILE_A + TILE_B);
  static constexpr int BYTES = STAGES * STAGE * 2 + 1024;    // + the alignment to 1024
};

// An operand: the tensor maps of its planes (hi, mid, lo; hi alone at
// PL = 1), each a (rows, K) bf16 matrix in boxes of BK x 128, swizzled.
struct Maps {
  CUtensorMap a[3], b[3];
};

// The epilogue's tensors: bias (N) and out (M, N) in T; out32 (M, N) f32
// or null.
template <typename T>
struct Epi {
  const T* bias;
  T* out;
  float* out32;
  int phi_cols;
};


__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// A matrix descriptor of the K-major swizzled layout TMA writes: rows of
// BK bf16 (128 or 64 bytes: swizzle mode 1 or 2), 8-row groups 8 rows
// apart; a 16-deep step starts 32 bytes into the row.
template <int BK>
__device__ __forceinline__ uint64_t desc(const bf16* p) {
  constexpr uint64_t mode = BK == 64 ? 1 : 2, sbo = BK * 2 * 8;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | ((sbo >> 4) << 32) |
         (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the sums across the
// asynchronous products' start and wait.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d (64 x 128, this warpgroup's fragment) = A B^T + (scale_d ? d : 0),
// A 64 x 16 and B 128 x 16 bf16 in shared memory (descriptors).
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Block (bx, by): C's tile (by, bx) through the epilogue e.  Thread 0
// fills the ring by TMA, AHEAD slices ahead; a slice's full barrier counts
// its bytes; each warpgroup marks a slice's empty barrier once its
// products on it have ended, and thread 0 waits for both marks before it
// refills the stage.  At PL = 1 a warpgroup keeps the products of one
// slice in flight while it starts the next; at PL = 3 it waits for each
// depth's six (their fresh sum is then added in registers).
template <int PL, typename T>
__global__ void __launch_bounds__(THREADS, Cfg<PL>::MINB)
wg_gemm_kernel(const __grid_constant__ Maps tm, int M, int N, int K, Epi<T> e) {
  using C = Cfg<PL>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  constexpr int STAGES = C::STAGES, AHEAD = C::AHEAD;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // [stage][A planes][B planes], at a 1024-byte boundary (the swizzle's period)
  bf16* const sm = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(wg_smem) + 1023) &
                                           ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + C::BK - 1) / C::BK;

  auto fill = [&](int n) {
    const int st = n % STAGES;
    bf16* s = sm + st * C::STAGE;
    mbar_expect_tx(&full[st], C::STAGE * 2);
#pragma unroll
    for (int pl = 0; pl < PL; ++pl) {
      tma_load_2d(s + pl * C::TILE_A, &tm.a[pl], n * C::BK, m0, &full[st]);
      tma_load_2d(s + PL * C::TILE_A + pl * C::TILE_B, &tm.b[pl], n * C::BK, n0, &full[st]);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int n = 0; n < AHEAD && n < nk; ++n) fill(n);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int st = t % STAGES;
    mbar_wait(&full[st], (t / STAGES) & 1);
    const bf16* sa = sm + st * C::STAGE + wgi * 64 * C::BK;
    const bf16* sb = sm + st * C::STAGE + PL * C::TILE_A;
    if constexpr (PL == 1) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::BK / 16; ++ks)
        wgmma128(acc, desc<C::BK>(sa + ks * 16), desc<C::BK>(sb + ks * 16), 1);
      wgmma_commit();
      wgmma_wait<1>();        // slice t - 1's products have ended
      if (t > 0 && (tid & 127) == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
    } else {
#pragma unroll
      for (int ks = 0; ks < C::BK / 16; ++ks) {
        uint64_t da[3], db[3];
#pragma unroll
        for (int pl = 0; pl < 3; ++pl) {
          da[pl] = desc<C::BK>(sa + pl * C::TILE_A + ks * 16);
          db[pl] = desc<C::BK>(sb + pl * C::TILE_B + ks * 16);
        }
        // the six plane products of this depth, smallest first, summed
        // afresh; then one rounded f32 add to the running sum
        float fresh[64];
        wgmma_fence();
        wgmma128(fresh, da[2], db[0], 0);
        wgmma128(fresh, da[0], db[2], 1);
        wgmma128(fresh, da[1], db[1], 1);
        wgmma128(fresh, da[1], db[0], 1);
        wgmma128(fresh, da[0], db[1], 1);
        wgmma128(fresh, da[0], db[0], 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(fresh);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += fresh[i];
      }
      if ((tid & 127) == 0) mbar_arrive(&empty[st]);
    }
    if (tid == 0) {
      const int n = t + AHEAD;
      if (n < nk) {
        if (n >= STAGES) mbar_wait(&empty[n % STAGES], (n / STAGES - 1) & 1);
        fill(n);
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // fragment of warp w4 of the warpgroup: rows 16 w4 + g (+ 8), columns
  // 8 j + 2 t (+ 1) in acc[4 j + (0, 1)] (and + (2, 3) for the row + 8)
  const int lane = tid & 31, w4 = (tid >> 5) & 3, g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + j * 8 + t2;
    if (n >= N) continue;
    const float b0 = ld(e.bias + n), b1 = ld(e.bias + n + 1);
    const bool act = n < e.phi_cols;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + wgi * 64 + w4 * 16 + g + hr * 8;
      if (m >= M) continue;
      float v0 = acc[4 * j + 2 * hr] + b0, v1 = acc[4 * j + 2 * hr + 1] + b1;
      if (act) {
        v0 = phi(v0);
        v1 = phi(v1);
      }
      const size_t mn = (size_t)m * N + n;
      st2(e.out + mn, v0, v1);
      if (e.out32 != nullptr) st2(e.out32 + mn, v0, v1);
    }
  }
}

// w (K, N) row-major in T into the planes of w^T (N, K): PL of them (one,
// the bf16 value, for bf16 weights).  32 x 32 tiles through shared memory.
template <typename T, int PL>
__global__ void split_cols_kernel(const T* __restrict__ w, bf16* __restrict__ out, int K,
                                  int N) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32, tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < 32; r += blockDim.y) {
    const int k = k0 + r, n = n0 + tx;
    tile[r][tx] = k < K && n < N ? ld(w + (size_t)k * N + n) : 0.f;
  }
  __syncthreads();
  const size_t plane = (size_t)N * K;
  for (int r = ty; r < 32; r += blockDim.y) {
    const int n = n0 + r, k = k0 + tx;
    if (n >= N || k >= K) continue;
    const float v = tile[tx][r];
    const bf16 h = __float2bfloat16_rn(v);
    const size_t o = (size_t)n * K + k;
    out[o] = h;
    if (PL == 3) {
      const float rem = v - __bfloat162float(h);
      const bf16 m = __float2bfloat16_rn(rem);
      out[plane + o] = m;
      out[2 * plane + o] = __float2bfloat16_rn(rem - __bfloat162float(m));
    }
  }
}

// bf16 elements of the planes a call splits: h's three at f32 (none at
// bf16: h is its own plane) and W^T's (three at f32, one at bf16).
inline size_t plane_elems(int M, int N, int K, bool f32) {
  return f32 ? 3 * ((size_t)M * K + (size_t)N * K) : (size_t)N * K;
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

// The map of a (rows, K) row-major bf16 plane in boxes of BK x 128 rows,
// swizzled as the descriptors read it, zeros past its edges.
template <int BK>
inline int plane_map(CUtensorMap* m, const bf16* base, size_t rows, size_t K) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {K, rows}, strides[1] = {K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, 128}, es[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)base, dims, strides, box,
                        es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        BK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// out (M, N) = phi-epilogue(a (M, K) w (K, N) + bias) on the wgmma tile,
// a and w in T (f32: PL = 3 after one split pass each; bf16: PL = 1, a its
// own plane and w transposed by one pass); planes holds plane_elems.  a
// and planes 16-byte aligned, K a multiple of 8 (TMA's strides).
template <typename T>
int gemm(const T* a, const T* w, int M, int N, int K, const Epi<T>& e, bf16* planes,
         cudaStream_t st) {
  constexpr int PL = sizeof(T) == 4 ? 3 : 1;
  using C = Cfg<PL>;
  const bf16* ap[3] = {reinterpret_cast<const bf16*>(a), nullptr, nullptr};
  if constexpr (PL == 3) {
    const size_t ha = (size_t)M * K;
    if (ha > 0x7fffffff) return (int)cudaErrorInvalidValue;    // split_kernel's int index
    SplitJobs jobs;
    jobs.job[0] = SplitJob{reinterpret_cast<const float*>(a), {}, (int)ha};
    for (int pl = 0; pl < 3; ++pl) ap[pl] = jobs.job[0].planes.p[pl] = planes + pl * ha;
    jobs.count = 1;
    split_kernel<<<dim3((unsigned)((ha / 4 + 255) / 256), 1), 256, 0, st>>>(jobs);
    planes += 3 * ha;
  }
  split_cols_kernel<T, PL><<<dim3((N + 31) / 32, (K + 31) / 32), dim3(32, 8), 0, st>>>(
      w, planes, K, N);
  Maps tm;
  for (int pl = 0; pl < PL; ++pl) {
    int rc = plane_map<C::BK>(&tm.a[pl], ap[pl], M, K);
    if (!rc) rc = plane_map<C::BK>(&tm.b[pl], planes + pl * (size_t)N * K, N, K);
    if (rc) return rc;
  }
  cudaError_t err = cudaFuncSetAttribute((const void*)wg_gemm_kernel<PL, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return (int)err;
  wg_gemm_kernel<PL, T><<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM), THREADS, C::BYTES, st>>>(
      tm, M, N, K, e);
  return (int)cudaGetLastError();
}

}  // namespace wg
}  // namespace rlmg
