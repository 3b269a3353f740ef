// The post-LN1 half of a training layer, forward and backward, as one
// sequence of train_gemm_tc.cuh launches shared by attn_tail.cu (kernel D,
// after its Wo + LN1 head) and ffn_block.cu (kernel G, alone):
//
//   r   = h + drop3(drop2(gelu(h @ W1 + b1)) @ W2 + b2)      out = LN2(r)
//
// Forward:
//   gemm  d2 = drop2(gelu(h @ W1 + b1))      (x1 = h @ W1 + b1 kept for the backward)
//   gemm  r  = h + drop3(d2 @ W2 + b2)
// Backward, from the upstream gradient dout at LN2's output:
//   ln_bwd  dr, dx2 = dr * m3, dLN2            colsum db2, gemm dW2 = d2^T dx2
//   gemm    dx1 = (dx2 @ W2^T) * m2 * gelu'(x1) colsum db1, gemm dW1 = h^T dx1
//   gemm    dh  = dx1 @ W1^T + dr
// Every product on the tensor cores (train_gemm_tc.cuh), its operands as
// bf16 planes: three a tensor for f32 tensors (T = float, the split
// arithmetic), one for bf16 ones (T = bf16, JAX's arithmetic).  The weight
// gradients are products with K = rows, split along K and added in a fixed
// order (no atomics: bit-reproducible).  Storage: x1, r, dr, dx2, dx1 in
// f32 (gelu', the residuals, LN2's input and the bias sums read them in
// f32); d2 only as planes, since its only readers are the FFN2 and dW2
// products; dx2 and dx1 also as planes.  h is the FFN's input (kernel D:
// LN1's f32 output; kernel G: the input), given as its type TH for the
// residual and as its operand planes.  LN2's forward is the caller's
// (ln_fwd of r into its output).

#pragma once

#include "train_gemm_tc.cuh"

namespace rlmg {

inline Drop site(const int* seed, int s, float p, float inv) {
  return p > 0.f ? Drop{seed, s, p, inv} : Drop{seed, 0, 0.f, 1.f};
}

// Planes an operand of tensors of type T: 3 for f32 (the split), 1 for bf16.
template <typename T>
constexpr int planes_of() {
  return std::is_same<T, float>::value ? 3 : 1;
}

// Carves the f32 scratch of a call into buffers, 16-byte aligned; with a
// null base it only counts (the size the wrapper allocates), so one layout
// function serves both.
struct Scratch {
  float* base;
  size_t used = 0;
  float* take(size_t n) {
    float* p = base != nullptr ? base + used : nullptr;
    used += (n + 3) & ~(size_t)3;
    return p;
  }
  // room for the operand planes of n values (n a multiple of 8): hi, and
  // mid and lo with split
  TtPlanes planes(size_t n, bool split) {
    bf16* p = reinterpret_cast<bf16*>(take(split ? 3 * n / 2 : n / 2));
    TtPlanes t;
    t.p[0] = p;
    if (split && p != nullptr) {
      t.p[1] = p + n;
      t.p[2] = p + 2 * n;
    }
    return t;
  }
};

inline TtOp op(const TtPlanes& t) { return {{t.p[0], t.p[1], t.p[2]}}; }

// A tensor as a product's operand: a bf16 tensor is its own plane; an f32
// one is split into three planes in the scratch by the call's split_kernel
// launch (a job of `jobs`).
inline TtOp operand(const bf16* x, Scratch&, size_t, SplitJobs&) {
  return {{x, nullptr, nullptr}};
}
inline TtOp operand(const float* x, Scratch& sc, size_t n, SplitJobs& jobs) {
  const TtPlanes t = sc.planes(n, true);
  jobs.job[jobs.count++] = {x, t, (int)n};
  return op(t);
}

// The FFN's parameters, in the order of the JAX ffn_block signature.
template <typename T>
struct FfnW {
  const T *w1, *b1, *w2, *b2, *ln_s, *ln_b;
};

// Their gradients, in the parameters' type.
template <typename T>
struct FfnG {
  T *dw1, *db1, *dw2, *db2, *dln_s, *dln_b;
};

// The FFN's buffers: its weights as operands, the forward's intermediates,
// the backward's scratch (null in a forward).
struct FfnBufs {
  TtOp w1, w2;
  float* x1;                 // (N, DI) before the gelu
  TtPlanes d2;               // (N, DI) after dropout 2: FFN2's and dW2's operand
  float* r;                  // (N, D) LN2's input
  float *dr, *dx2, *dx1;     // (N, D), (N, D), (N, DI)
  TtPlanes dx2p, dx1p;       // dx2 and dx1 as operands
};

template <typename T>
FfnBufs ffn_layout(Scratch& sc, SplitJobs& jobs, const FfnW<T>& w, int N, int D, int DI,
                   bool backward) {
  constexpr bool split = planes_of<T>() == 3;
  const size_t nd = (size_t)N * D, ndi = (size_t)N * DI;
  FfnBufs b = {};
  b.w1 = operand(w.w1, sc, (size_t)D * DI, jobs);
  b.w2 = operand(w.w2, sc, (size_t)DI * D, jobs);
  b.x1 = backward ? sc.take(ndi) : nullptr;
  b.d2 = sc.planes(ndi, split);
  b.r = sc.take(nd);
  if (backward) {
    b.dr = sc.take(nd);
    b.dx2 = sc.take(nd);
    b.dx1 = sc.take(ndi);
    b.dx2p = sc.planes(nd, split);
    b.dx1p = sc.planes(ndi, split);
  }
  return b;
}

// f32 scratch of the partial sums of ffn_forward and ffn_backward.
inline size_t ffn_part_floats(int N, int D, int DI) {
  size_t p = 0;
  const size_t c[7] = {tt_part_floats(N, DI, D), tt_part_floats(N, D, DI),
                       tt_part_floats(DI, D, N), tt_part_floats(D, DI, N),
                       colsum_part_floats(N, DI), colsum_part_floats(N, D),
                       ln_bwd_part_floats(N, D)};
  for (size_t v : c) p = v > p ? v : p;
  return p;
}

// b.d2, b.r (and b.x1 when set) of h (N, D): hop its operand planes, h
// itself for the residual.  mid_drop = 0 skips site 2 (the Longformer
// layer's convention).
template <typename T, typename TH>
int ffn_forward(const TtOp& hop, const TH* h, const FfnW<T>& w, const FfnBufs& b, float* part,
                const int* seed, float p, float inv, int mid_drop, int N, int D, int DI,
                cudaStream_t st) {
  constexpr int PL = planes_of<T>();
  TcEpi<T, float, TH> e2;
  e2.planes = b.d2;
  e2.bias = w.b1;
  e2.pre = b.x1;
  e2.act = ACT_GELU;
  e2.drop = site(seed, mid_drop ? 2 : 0, mid_drop ? p : 0.f, inv);
  int rc = tt_gemm<false, false, PL>(hop, b.w1, N, DI, D, e2, part, st);
  if (rc) return rc;
  TcEpi<T, float, TH> e3;
  e3.out = b.r;
  e3.bias = w.b2;
  e3.drop = site(seed, 3, p, inv);
  e3.resid = h;
  return tt_gemm<false, false, PL>(op(b.d2), b.w2, N, D, DI, e3, part, st);
}

// Every gradient of LN2(r) back to h, from ffn_forward's buffers: dh (TD:
// kernel D's f32 dh1, kernel G's output) and the parameters' g.  part holds
// ffn_part_floats.
template <typename T, typename TD>
int ffn_backward(const TtOp& hop, const FfnW<T>& w, const FfnBufs& b, const T* dout, TD* dh,
                 const FfnG<T>& g, float* part, const int* seed, float p, float inv,
                 int mid_drop, int N, int D, int DI, cudaStream_t st) {
  constexpr int PL = planes_of<T>();
  // LN2, dropout 3, FFN2
  int rc = ln_bwd(b.r, dout, w.ln_s, b.dr, b.dx2, b.dx2p, site(seed, 3, p, inv), g.dln_s,
                  g.dln_b, N, D, part, st);
  if (rc) return rc;
  if ((rc = colsum(b.dx2, g.db2, N, D, part, st))) return rc;
  TcEpi<T, T, float> ew2;
  ew2.out = g.dw2;
  if ((rc = tt_gemm<true, false, PL>(op(b.d2), op(b.dx2p), DI, D, N, ew2, part, st))) return rc;
  // dropout 2, gelu, FFN1
  TcEpi<T, float, float> e;
  e.out = b.dx1;
  e.planes = b.dx1p;
  e.drop = site(seed, mid_drop ? 2 : 0, mid_drop ? p : 0.f, inv);
  e.dgelu_x = b.x1;
  if ((rc = tt_gemm<false, true, PL>(op(b.dx2p), b.w2, N, DI, D, e, part, st))) return rc;
  if ((rc = colsum(b.dx1, g.db1, N, DI, part, st))) return rc;
  TcEpi<T, T, float> ew1;
  ew1.out = g.dw1;
  if ((rc = tt_gemm<true, false, PL>(hop, op(b.dx1p), D, DI, N, ew1, part, st))) return rc;
  TcEpi<T, TD, float> e2;
  e2.out = dh;
  e2.resid = b.dr;
  return tt_gemm<false, true, PL>(op(b.dx1p), b.w1, N, D, DI, e2, part, st);
}

}  // namespace rlmg
