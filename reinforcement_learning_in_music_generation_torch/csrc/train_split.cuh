// The split of f32 tensors into the three bf16 planes of the f32-grade
// products (x = hi + mid + lo, each a bf16: the 24 bits of an f32 value),
// shared by the mma.sync tile (train_gemm_tc.cuh, kernels D and G) and the
// wgmma tile (train_gemm_wg.cuh, kernel C).  Plain C interface; no PyTorch
// headers.

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>

namespace rlmg {

using bf16 = __nv_bfloat16;

// Where a pass writes the planes of a later product's operand: none (p[0]
// null), hi = bf16(v) alone, or all three (p[1] set).
struct TtPlanes {
  bf16* p[3] = {nullptr, nullptr, nullptr};
};

// Each step's remainder is exact in f32 (it has at most 16 significant bits).
__device__ __forceinline__ void st_planes(const TtPlanes& t, size_t i, float v) {
  const bf16 h = __float2bfloat16_rn(v);
  t.p[0][i] = h;
  if (t.p[1] == nullptr) return;
  const float r = v - __bfloat162float(h);
  const bf16 m = __float2bfloat16_rn(r);
  t.p[1][i] = m;
  t.p[2][i] = __float2bfloat16_rn(r - __bfloat162float(m));
}
__device__ __forceinline__ void st_planes2(const TtPlanes& t, size_t i, float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(t.p[0] + i) = h;
  if (t.p[1] == nullptr) return;
  const float2 fh = __bfloat1622float2(h);
  a -= fh.x;
  b -= fh.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(t.p[1] + i) = m;
  const float2 fm = __bfloat1622float2(m);
  *reinterpret_cast<__nv_bfloat162*>(t.p[2] + i) = __floats2bfloat162_rn(a - fm.x, b - fm.y);
}

// The split of up to four f32 tensors into their three planes, one launch.
struct SplitJob {
  const float* x;
  TtPlanes planes;
  int n;               // values, a multiple of 4
};
struct SplitJobs {
  SplitJob job[4];
  int count = 0;
};

__global__ void split_kernel(SplitJobs jobs) {
  const SplitJob j = jobs.job[blockIdx.y];
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= j.n) return;
  const float4 v = *reinterpret_cast<const float4*>(j.x + i);
  st_planes2(j.planes, i, v.x, v.y);
  st_planes2(j.planes, i + 2, v.z, v.w);
}

}  // namespace rlmg
