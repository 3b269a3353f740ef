// qkv projection + chunked causal linear attention, forward and backward:
// the CUDA counterpart of
// reinforcement_learning_in_music_generation_tpu/ops/attention_block.py
// qkv_attention_block (its Pallas bodies _fwd_kernel, _bwd_dq_kernel and
// _bwd_dkv_kernel).
//
// Forward: one GEMM (train_gemm.cuh) writes pqkv = [phi(q) | phi(k) | v]
// with the bias and phi = elu+1 in its epilogue; pqkv is the backward
// residual, as on the TPU.  Then the causal recurrence of
// linear_attention.cuh runs one
// block per (sequence, head) that walks the sequence in tiles of AT_T = 64
// rows with the running state S = sum phi(k) v^T (E x E) and z = sum phi(k)
// in shared memory, in place of the TPU's sequential grid axis.  The tile
// length is a numerics-free choice; the wrapper still checks the caller's
// chunk against the sequence length, as the TPU kernel does.  Backward,
// that header's two passes over the same blocks (the TPU's two passes),
// reading q, k, v from pqkv through PqkvIO below, with phi' recovered from
// the stored phi as min(phi, 1).  They write dqkv (N, 3D);
// dh = dqkv W^T, dW = h^T dqkv and db stay outside, as on the TPU.
// The TPU kernel packed two heads per program and masked half-lanes to
// fill 128-lane rows; that has no purpose here and is dropped.
//
// Bound on the card (PERF.md).  At N = 16384 rows, D = 512, 8 heads of 64:
// the projection is 2 N D 3D = 25.8 GFLOP and the attention 3.2 GFLOP (the
// causal half of each score tile), and the forward moves ~0.2 GB, so
// operations bind (about 0.43 ms at 67 TFLOP/s, f32 outside the tensor
// cores).  What the design does about it: the qkv
// product is a register-blocked tile GEMM; every attention product is a 4x4
// register-blocked outer product from shared memory, and the (C, C) score
// tiles and the states never leave shared memory.  No tensor cores yet.

#include "linear_attention.cuh"

namespace rlmg {

// q, k, v of row i of head h packed in pqkv (N, 3D) = [phi(q) | phi(k) | v];
// att, g (N, D); den (N, H) f32; dqkv (N, 3D) gets phi' = min(phi, 1)
// folded into d phi(q) and d phi(k).
template <typename T>
struct PqkvIO {
  const T* pqkv;
  T* att;
  float* dens;
  const T* grad;
  T* dqkv;
  int S, D, H, E;
  __device__ __forceinline__ size_t row(int b, int i) const { return (size_t)b * S + i; }
  __device__ __forceinline__ size_t col(int h, int e) const { return (size_t)h * E + e; }
  __device__ __forceinline__ float q(int b, int h, int i, int e) const {
    return ld(pqkv + row(b, i) * 3 * D + col(h, e));
  }
  __device__ __forceinline__ float k(int b, int h, int i, int e) const {
    return ld(pqkv + row(b, i) * 3 * D + D + col(h, e));
  }
  __device__ __forceinline__ float v(int b, int h, int i, int e) const {
    return ld(pqkv + row(b, i) * 3 * D + 2 * D + col(h, e));
  }
  __device__ __forceinline__ float g(int b, int h, int i, int f) const {
    return ld(grad + row(b, i) * D + col(h, f));
  }
  __device__ __forceinline__ float out(int b, int h, int i, int f) const {
    return ld(att + row(b, i) * D + col(h, f));
  }
  __device__ __forceinline__ float den(int b, int h, int i) const {
    return dens[row(b, i) * H + h];
  }
  __device__ __forceinline__ void put_out(int b, int h, int i, int f, float x) const {
    st(att + row(b, i) * D + col(h, f), x);
  }
  __device__ __forceinline__ void put_den(int b, int h, int i, float x) const {
    dens[row(b, i) * H + h] = x;
  }
  __device__ __forceinline__ void put_dq(int b, int h, int i, int e, float x) const {
    st(dqkv + row(b, i) * 3 * D + col(h, e), x * fminf(q(b, h, i, e), 1.f));
  }
  __device__ __forceinline__ void put_dk(int b, int h, int i, int e, float x) const {
    st(dqkv + row(b, i) * 3 * D + D + col(h, e), x * fminf(k(b, h, i, e), 1.f));
  }
  __device__ __forceinline__ void put_dv(int b, int h, int i, int f, float x) const {
    st(dqkv + row(b, i) * 3 * D + 2 * D + col(h, f), x);
  }
};

template <typename T>
int qkv_attn_fwd(const T* h, const T* w, const T* bias, T* pqkv, T* att, float* den, int N,
                 int n_seq, int D, int H, float eps, cudaStream_t st) {
  const int E = D / H, S = N / n_seq;
  Epi<T, T> e;
  e.out = pqkv;
  e.bias = bias;
  e.act = ACT_PHI;
  e.phi_cols = 2 * D;
  int rc = gemm<false, false>(h, w, N, 3 * D, D, e, st);
  if (rc) return rc;
  const PqkvIO<T> io{pqkv, att, den, nullptr, nullptr, S, D, H, E};
  return la_forward(io, n_seq, H, S, E, eps, st);
}

template <typename T>
int qkv_attn_bwd(const T* pqkv, const T* g, const T* att, const float* den, T* dqkv, int N,
                 int n_seq, int D, int H, float eps, cudaStream_t st) {
  const int E = D / H, S = N / n_seq;
  const PqkvIO<T> io{pqkv, const_cast<T*>(att), const_cast<float*>(den), g, dqkv, S, D, H, E};
  return la_backward(io, n_seq, H, S, E, eps, st);
}

inline bool attn_shape_ok(int N, int n_seq, int D, int H) {
  if (H <= 0 || n_seq <= 0 || D % H || N % n_seq) return false;
  const int E = D / H;
  return E % 4 == 0 && E <= AT_MAX_E;
}

}  // namespace rlmg

extern "C" {

// h (N, D), w (D, 3D), b (3D) in one type (bf16 = 1: bfloat16, else f32).
// Writes pqkv (N, 3D) and att (N, D) in that type and den (N, H) f32.
// N = n_seq sequences of N / n_seq rows.  Returns 0 or a CUDA error code.
int rlmg_qkv_attn_fwd(const void* h, const void* w, const void* b, void* pqkv, void* att,
                      float* den, int N, int n_seq, int D, int H, float eps, int bf16,
                      void* stream) {
  using namespace rlmg;
  using bf = __nv_bfloat16;
  if (!attn_shape_ok(N, n_seq, D, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return qkv_attn_fwd<bf>((const bf*)h, (const bf*)w, (const bf*)b, (bf*)pqkv, (bf*)att, den, N,
                            n_seq, D, H, eps, st);
  return qkv_attn_fwd<float>((const float*)h, (const float*)w, (const float*)b, (float*)pqkv,
                             (float*)att, den, N, n_seq, D, H, eps, st);
}

// From the forward's pqkv, att, den and the upstream gradient g (N, D),
// writes dqkv (N, 3D) = [d phi(q) * phi'(q) | d phi(k) * phi'(k) | dv].
int rlmg_qkv_attn_bwd(const void* pqkv, const void* g, const void* att, const float* den,
                      void* dqkv, int N, int n_seq, int D, int H, float eps, int bf16,
                      void* stream) {
  using namespace rlmg;
  using bf = __nv_bfloat16;
  if (!attn_shape_ok(N, n_seq, D, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return qkv_attn_bwd<bf>((const bf*)pqkv, (const bf*)g, (const bf*)att, den, (bf*)dqkv, N,
                            n_seq, D, H, eps, st);
  return qkv_attn_bwd<float>((const float*)pqkv, (const float*)g, (const float*)att, den,
                             (float*)dqkv, N, n_seq, D, H, eps, st);
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
