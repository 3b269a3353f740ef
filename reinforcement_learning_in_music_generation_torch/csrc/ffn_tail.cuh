// The post-LN1 half of a training layer, forward and backward, as one
// sequence of train_gemm.cuh launches shared by attn_tail.cu (kernel D,
// after its Wo + LN1 head) and ffn_block.cu (kernel G, alone):
//
//   r   = h + drop3(drop2(gelu(h @ W1 + b1)) @ W2 + b2)      out = LN2(r)
//
// Forward:
//   gemm  d2 = drop2(gelu(h @ W1 + b1))      (x1 = h @ W1 + b1 kept for the backward)
//   gemm  r  = h + drop3(d2 @ W2 + b2)
// Backward, from the upstream gradient dout at LN2's output:
//   ln_bwd  dr, dx2 = dr * m3, dLN2            colsum db2, gemm_tn dW2 = d2^T dx2
//   gemm    dx1 = (dx2 @ W2^T) * m2 * gelu'(x1) colsum db1, gemm_tn dW1 = h^T dx1
//   gemm    dh  = dx1 @ W1^T + dr
// The weight gradients are products with K = rows, split along K and added
// in a fixed order (no atomics: bit-reproducible).  LN2's forward is the
// caller's (ln_fwd of r into its output).

#pragma once

#include "train_gemm.cuh"

namespace rlmg {

inline Drop site(const int* seed, int s, float p, float inv) {
  return p > 0.f ? Drop{seed, s, p, inv} : Drop{seed, 0, 0.f, 1.f};
}

// The FFN's parameters, in the order of the JAX ffn_block signature.
struct FfnW {
  const float *w1, *b1, *w2, *b2, *ln_s, *ln_b;
};

// Their gradients, and dh, the gradient at the FFN's input h.
struct FfnG {
  float *dh, *dw1, *db1, *dw2, *db2, *dln_s, *dln_b;
};

// Scratch floats of the K-split partial sums of ffn_backward.
inline size_t ffn_part_floats(int N, int D, int DI) {
  size_t p = 0;
  const size_t c[4] = {tn_part_floats(D, DI, N), tn_part_floats(DI, D, N),
                       colsum_part_floats(N, DI), ln_bwd_part_floats(N, D)};
  for (size_t v : c) p = v > p ? v : p;
  return p;
}

// d2 (N, DI) and r (N, D) of h (N, D); x1 (N, DI) stored when not null.
// mid_drop = 0 skips site 2 (the Longformer layer's convention).
inline int ffn_forward(const float* h, const FfnW& w, float* x1, float* d2, float* r,
                       const int* seed, float p, float inv, int mid_drop, int N, int D, int DI,
                       cudaStream_t st) {
  Epi<float, float> e2;
  e2.out = d2;
  e2.bias = w.b1;
  e2.pre = x1;
  e2.act = ACT_GELU;
  e2.drop = site(seed, mid_drop ? 2 : 0, mid_drop ? p : 0.f, inv);
  int rc = gemm<false, false>(h, w.w1, N, DI, D, e2, st);
  if (rc) return rc;
  Epi<float, float> e3;
  e3.out = r;
  e3.bias = w.b2;
  e3.drop = site(seed, 3, p, inv);
  e3.resid = h;
  return gemm<false, false>(d2, w.w2, N, D, DI, e3, st);
}

// Every gradient of LN2(r) back to h, from ffn_forward's x1, d2 and r.
// dr, dx2 (N, D) and dx1 (N, DI) are scratch; part holds ffn_part_floats.
inline int ffn_backward(const float* h, const FfnW& w, const float* x1, const float* d2,
                        const float* r, const float* dout, const FfnG& g, float* dr, float* dx2,
                        float* dx1, float* part, const int* seed, float p, float inv, int mid_drop,
                        int N, int D, int DI, cudaStream_t st) {
  // LN2, dropout 3, FFN2
  int rc = ln_bwd(r, dout, w.ln_s, dr, dx2, site(seed, 3, p, inv), g.dln_s, g.dln_b, N, D, part,
                  st);
  if (rc) return rc;
  if ((rc = colsum(dx2, g.db2, N, D, part, st))) return rc;
  if ((rc = gemm_tn(d2, dx2, g.dw2, DI, D, N, part, st))) return rc;
  // dropout 2, gelu, FFN1
  Epi<float, float> e;
  e.out = dx1;
  e.drop = site(seed, mid_drop ? 2 : 0, mid_drop ? p : 0.f, inv);
  e.dgelu_x = x1;
  if ((rc = gemm<false, true>(dx2, w.w2, N, DI, D, e, st))) return rc;
  if ((rc = colsum(dx1, g.db1, N, DI, part, st))) return rc;
  if ((rc = gemm_tn(h, dx1, g.dw1, D, DI, N, part, st))) return rc;
  Epi<float, float> e2;
  e2.out = g.dh;
  e2.resid = dr;
  return gemm<false, true>(dx1, w.w1, N, D, DI, e2, st);
}

}  // namespace rlmg
