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
// any batch / head / row strides and a unit last stride, so the (B, H, S, E)
// views of (B, S, H, E) projections go in and come out without copies; den
// (B, H, S) contiguous.  E <= 64, a multiple of 4.
//
// The passes are linear_attention.cuh's, shared with kernel C: a forward
// that walks each (sequence, head) in 64-row tiles carrying (S, z); a dq
// pass in forward order carrying (S, z) and a dk/dv pass in reverse order
// carrying (G, gz), where the TPU carried S_aug = [S | z] and G_aug with a
// ones column appended to v (its 3-D full-trailing-dim blocks needed it; a
// separate z costs nothing here).  The backward's prologue, dnum = g / (den
// + eps) and dden = -sum(g * out) / (den + eps), runs inside both passes
// (plain jnp outside the Pallas calls on the TPU).  The TPU padded S to its
// 128-row chunk with zero rows; here rows at or past S load as zeros and are
// never written, so nothing is padded or copied.  Deterministic: no atomics.
//
// Bound on the card (PERF.md).  At B = 32, H = 8, S = 512, E = 64 the forward
// is about 4.3 GFLOP (the causal half of each 128-row score tile plus the
// state products) against about 134 MB moved, so f32 operations bind
// (0.064 ms at 67 TFLOP/s outside the tensor cores); the backward about 12
// GFLOP (0.18 ms).  At DQN's B = 30, S = 50 the work is a few microseconds,
// bound by bytes, and the launch dominates.  What the design does about it:
// every product runs from shared memory in 4x4 register blocks and the score
// tiles and the states never leave shared memory.  No tensor cores yet.

#include "linear_attention.cuh"

namespace rlmg {

// A (B, H, S, E) tensor: base and strides in elements (batch, head, row).
struct Bhse {
  float* p;
  long long sb, sh, ss;
  __device__ __forceinline__ float* at(int b, int h, int i, int e) const {
    return p + b * sb + h * sh + i * ss + e;
  }
};

struct BhseIO {
  Bhse pq, pk, vv, o, gr, dq, dk, dv;
  float* dens;   // (B, H, S) contiguous
  int H, S;
  __device__ __forceinline__ float q(int b, int h, int i, int e) const { return *pq.at(b, h, i, e); }
  __device__ __forceinline__ float k(int b, int h, int i, int e) const { return *pk.at(b, h, i, e); }
  __device__ __forceinline__ float v(int b, int h, int i, int e) const { return *vv.at(b, h, i, e); }
  __device__ __forceinline__ float g(int b, int h, int i, int f) const { return *gr.at(b, h, i, f); }
  __device__ __forceinline__ float out(int b, int h, int i, int f) const {
    return *o.at(b, h, i, f);
  }
  __device__ __forceinline__ float den(int b, int h, int i) const {
    return dens[((size_t)b * H + h) * S + i];
  }
  __device__ __forceinline__ void put_out(int b, int h, int i, int f, float x) const {
    *o.at(b, h, i, f) = x;
  }
  __device__ __forceinline__ void put_den(int b, int h, int i, float x) const {
    dens[((size_t)b * H + h) * S + i] = x;
  }
  __device__ __forceinline__ void put_dq(int b, int h, int i, int e, float x) const {
    *dq.at(b, h, i, e) = x;
  }
  __device__ __forceinline__ void put_dk(int b, int h, int i, int e, float x) const {
    *dk.at(b, h, i, e) = x;
  }
  __device__ __forceinline__ void put_dv(int b, int h, int i, int f, float x) const {
    *dv.at(b, h, i, f) = x;
  }
};

inline Bhse bhse(const void* p, const long long* s) {
  return Bhse{(float*)p, s[0], s[1], s[2]};
}

inline bool shape_ok(int B, int H, int S, int E) {
  return B > 0 && B <= 65535 && H > 0 && S > 0 && E > 0 && E % 4 == 0 && E <= AT_MAX_E;
}

}  // namespace rlmg

extern "C" {

// phi(q), phi(k), v (B, H, S, E) f32 -> out (B, H, S, E) and den (B, H, S).
// strides: (batch, head, row) of phi(q), phi(k), v, out, in elements.
// Returns 0 or a CUDA error code.
int rlmg_causal_product_fwd(const void* pq, const void* pk, const void* v, void* out, float* den,
                            const long long* strides, int B, int H, int S, int E, float eps,
                            void* stream) {
  using namespace rlmg;
  if (!shape_ok(B, H, S, E)) return (int)cudaErrorInvalidValue;
  BhseIO io{};
  io.pq = bhse(pq, strides);
  io.pk = bhse(pk, strides + 3);
  io.vv = bhse(v, strides + 6);
  io.o = bhse(out, strides + 9);
  io.dens = den;
  io.H = H;
  io.S = S;
  return la_forward(io, B, H, S, E, eps, (cudaStream_t)stream);
}

// From the forward's inputs, out and den and the upstream gradient g,
// writes d phi(q), d phi(k), dv.  strides: (batch, head, row) of phi(q),
// phi(k), v, out, g, dq, dk, dv.
int rlmg_causal_product_bwd(const void* pq, const void* pk, const void* v, const void* out,
                            const float* den, const void* g, void* dq, void* dk, void* dv,
                            const long long* strides, int B, int H, int S, int E, float eps,
                            void* stream) {
  using namespace rlmg;
  if (!shape_ok(B, H, S, E)) return (int)cudaErrorInvalidValue;
  BhseIO io{};
  io.pq = bhse(pq, strides);
  io.pk = bhse(pk, strides + 3);
  io.vv = bhse(v, strides + 6);
  io.o = bhse(out, strides + 9);
  io.gr = bhse(g, strides + 12);
  io.dq = bhse(dq, strides + 15);
  io.dk = bhse(dk, strides + 18);
  io.dv = bhse(dv, strides + 21);
  io.dens = const_cast<float*>(den);
  io.H = H;
  io.S = S;
  return la_backward(io, B, H, S, E, eps, (cudaStream_t)stream);
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
