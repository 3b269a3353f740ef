// What one grid-wide barrier costs on the card, for the latency kernels'
// design (csrc/latency_decode.cu): cooperative_groups' grid.sync() against
// a counter barrier (one thread a block: red.release.gpu add, then
// ld.acquire.gpu polling), 2000 barriers in one cooperative launch of one
// block of 256 threads per SM; and 12 cooperative launches (v7's layer
// launches) from a stream, from a captured CUDA graph, and from a graph
// whose launches are programmatic dependents of the one before.
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -o build/bench_grid_barrier \
//       scripts/bench_grid_barrier.cu && build/bench_grid_barrier

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdio>

namespace cg = cooperative_groups;

#define CK(x)                                                                      \
  do {                                                                             \
    const cudaError_t e_ = (x);                                                    \
    if (e_ != cudaSuccess) {                                                       \
      printf("%s: %s (line %d)\n", #x, cudaGetErrorString(e_), __LINE__);          \
      return 1;                                                                    \
    }                                                                              \
  } while (0)

__global__ void grid_syncs(int reps) {
  cg::grid_group g = cg::this_grid();
  for (int r = 0; r < reps; ++r) g.sync();
}

__global__ void counter_syncs(unsigned int* count, int reps) {
  for (int r = 0; r < reps; ++r) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned int target = (unsigned int)(r + 1) * gridDim.x;
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
      unsigned int v;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(count) : "memory");
      } while (v < target);
    }
    __syncthreads();
  }
}

// one layer launch's skeleton: wait for the launch before, one grid barrier
__global__ void layer_like(int* buf, int n) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  cg::grid_group g = cg::this_grid();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = i < n ? buf[i] : 0;
  g.sync();
  if (i < n) buf[(i + 1) % n] = v + 1;
}

static int launch(cudaStream_t st, int* buf, int n, int n_sm, bool pdl) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = n_sm;
  cfg.blockDim = 256;
  cfg.stream = st;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeCooperative;
  at[0].val.cooperative = 1;
  at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = pdl ? 2 : 1;
  return (int)cudaLaunchKernelEx(&cfg, layer_like, buf, n);
}

static float elapsed(cudaEvent_t a, cudaEvent_t b) {
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}

int main() {
  int n_sm = 0;
  CK(cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, 0));
  cudaStream_t st;
  CK(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));
  cudaEvent_t a, b;
  CK(cudaEventCreate(&a));
  CK(cudaEventCreate(&b));
  int reps = 2000;
  unsigned int* count;
  CK(cudaMalloc(&count, 4));
  for (int warm = 0; warm < 2; ++warm) {
    void* args[] = {(void*)&reps};
    CK(cudaEventRecord(a, st));
    CK(cudaLaunchCooperativeKernel((void*)grid_syncs, n_sm, 256, args, 0, st));
    CK(cudaEventRecord(b, st));
    CK(cudaEventSynchronize(b));
    const float gs = elapsed(a, b);
    CK(cudaMemsetAsync(count, 0, 4, st));
    void* cargs[] = {(void*)&count, (void*)&reps};
    CK(cudaEventRecord(a, st));
    CK(cudaLaunchCooperativeKernel((void*)counter_syncs, n_sm, 256, cargs, 0, st));
    CK(cudaEventRecord(b, st));
    CK(cudaEventSynchronize(b));
    if (warm)
      printf("grid barrier, %d blocks of 256: grid.sync() %.3f us, counter barrier %.3f us\n",
             n_sm, gs / reps * 1e3, elapsed(a, b) / reps * 1e3);
  }
  const int n = n_sm * 256;
  int* buf;
  CK(cudaMalloc(&buf, n * 4));
  for (int pdl = 0; pdl < 2; ++pdl) {
    cudaGraph_t g;
    cudaGraphExec_t ex;
    CK(cudaStreamBeginCapture(st, cudaStreamCaptureModeThreadLocal));
    for (int l = 0; l < 12; ++l) CK((cudaError_t)launch(st, buf, n, n_sm, pdl));
    CK(cudaStreamEndCapture(st, &g));
    CK(cudaGraphInstantiateWithFlags(&ex, g, 0));
    CK(cudaGraphLaunch(ex, st));
    CK(cudaEventRecord(a, st));
    for (int r = 0; r < 100; ++r) CK(cudaGraphLaunch(ex, st));
    CK(cudaEventRecord(b, st));
    CK(cudaEventSynchronize(b));
    const float gms = elapsed(a, b) / 100;
    CK(cudaEventRecord(a, st));
    for (int r = 0; r < 100; ++r)
      for (int l = 0; l < 12; ++l) CK((cudaError_t)launch(st, buf, n, n_sm, pdl));
    CK(cudaEventRecord(b, st));
    CK(cudaEventSynchronize(b));
    printf("12 cooperative launches%s: from a graph %.2f us a launch, from the stream %.2f us "
           "a launch\n", pdl ? " as programmatic dependents" : "", gms / 12 * 1e3,
           elapsed(a, b) / 100 / 12 * 1e3);
    CK(cudaGraphExecDestroy(ex));
    CK(cudaGraphDestroy(g));
  }
  return 0;
}
