// T decode tokens per call, with the sampling on the card: the CUDA
// counterpart of
// reinforcement_learning_in_music_generation_tpu/ops/decode_kernel_v6.py
// fused_decode_v6 (its Pallas body _v6_kernel).
//
// The computation is ported, not the TPU layout: v6 carried the network
// transposed (batch on the 128 lanes) to dodge lane<->sublane relayouts on
// the TPU's vector unit; here every tensor is batch-major and the state
// keeps the DecodeState layout S (L,B,H,E,E), z (L,B,H,E).
//
// One route for both weight types (decode_chunk_tc.cuh): every product
// on the tensor cores at v6's arithmetic, bf16 inputs with bf16 weights and
// f32 grade (three bf16 planes an operand, six products) with f32 weights.
// One token is 7 L + 3 kernels (embedding; per layer the qkv product, the
// state pass, Wo, LN1, FFN1, FFN2, LN2; the heads product and the sampling
// pass), captured as a CUDA graph, one for each shape and weight type,
// that reads the call's position, seed and sampling settings from a block
// on the card; a call launches one small kernel (tok0 and those values
// onto the card) and the graph T times.
// (embed_row, heads_sample_row and sample_logit are in decode_sample.cuh,
// shared with latency_decode.cu; rlmg_heads_sample runs heads_sample_row
// alone, the latency kernels' heads + sampling pass.)
//
// Random bits: Philox4x32-10 keyed by (seed, PHILOX_KEY1) at counter
// (absolute position, field, vocab index, song).  The stream depends only
// on the position, so one call of 64 tokens and two of 32 emit the same
// tokens.  ops/decode_common.py philox_bits draws the same bits in torch.
//
// Bound on the card, agent_config width, B=128, T=128 with bf16 weights:
// the products take 2 B (L (4 D^2 + 2 D DI) + D NF VF_PAD) operations a
// token, 1.29e12 a call, 1.30 ms at 989 TFLOP/s (bf16 tensor cores), over
// the 282 MB of bytes the call must move (weights 77 MB once, the bf16
// state 204 MB in and out once).  But the state (102 MB at B=128) does not
// fit the card's 50 MB of L2, so every design streams it every token: 282
// MB a token, 0.084 ms, about 10.8 ms a call, the floor this route aims at.
// The state pass reads and writes it in 16-byte pieces; the products
// stream the weights over K-split tiles on every SM.  With f32 weights the
// products take six bf16 products each: 7.8 ms a call at 989/6 TFLOP/s,
// under the floor of streaming the f32 weights (151 MB) and the state
// every token, about 13.7 ms a call; the route streams the weights' bf16
// planes, 226 MB a token.

#include <stdint.h>
#include <string.h>

#include <mutex>

#include "decode_chunk_tc.cuh"

namespace rlmg {

// One block of VF_PAD threads per (song b, field f).
template <typename TW>
__global__ void __launch_bounds__(VF_PAD)
heads_sample_kernel(const float* __restrict__ h, const float* __restrict__ fls,
                    const float* __restrict__ flb, const TW* __restrict__ hw,
                    const float* __restrict__ hb, FieldArgs fa, int* __restrict__ tok_out,
                    int NF, int D, int pos, uint32_t seed, int greedy) {
  __shared__ float hf[MAX_D];
  __shared__ float red[32];
  __shared__ int redi[32];
  const int b = blockIdx.x / NF, f = blockIdx.x % NF;
  const int tok = heads_sample_row<TW>(h + (size_t)b * D, fls, flb, hw, hb, fa, b, f, NF, D,
                                       pos, seed, greedy, hf, red, redi);
  if (threadIdx.x == 0) tok_out[(size_t)b * NF + f] = tok;
}

inline int heads_sample(const float* h, const float* fls, const float* flb, const void* hw,
                        const float* hb, const FieldArgs& fa, int* tok_out, int B, int NF,
                        int D, int pos, uint32_t seed, int greedy, int w_bf16,
                        cudaStream_t st) {
  if (w_bf16) {
    heads_sample_kernel<__nv_bfloat16><<<B * NF, VF_PAD, 0, st>>>(
        h, fls, flb, (const __nv_bfloat16*)hw, hb, fa, tok_out, NF, D, pos, seed, greedy);
  } else {
    heads_sample_kernel<float><<<B * NF, VF_PAD, 0, st>>>(h, fls, flb, (const float*)hw, hb,
                                                          fa, tok_out, NF, D, pos, seed, greedy);
  }
  RLMG_CHECK();
  return 0;
}

// One instantiated token graph per shape (TcArgs: device, L, B, D, H, DI,
// NF, state type, weight type), holding the pointers of the call that last
// ran it.  The per-call values (position, seed, sampling settings) are read from TcCtrl
// on the card, so a call with the same pointers launches the graph as it
// is; a call with other pointers (another state, weights or buffers)
// captures its token again and updates the graph in place
// (cudaGraphExecUpdate: the same kernels with new arguments).
struct TcGraph {
  bool used;
  TcArgs args;
  cudaGraphExec_t exec;
  int kernels;
};
constexpr int TC_SHAPES = 8, TC_MAX_DEVICES = 64;
static TcGraph tc_graphs[TC_SHAPES];
static int tc_next = 0;
static cudaStream_t tc_capture_streams[TC_MAX_DEVICES];
static std::mutex tc_mutex;

template <typename TS, typename TW>
int tc_capture(const TcArgs& a, cudaStream_t cs, cudaGraph_t* g, int* kernels) {
  cudaError_t e = cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return (int)e;
  const int n = tc_enqueue_token<TS, TW>(a, cs);
  *g = nullptr;
  e = cudaStreamEndCapture(cs, g);
  if (n < 0 || e != cudaSuccess) {
    if (*g) cudaGraphDestroy(*g);
    *g = nullptr;
    cudaGetLastError();
    return n < 0 ? -n : (int)e;
  }
  *kernels = n;
  return 0;
}

// The graph for a, brought up to a's pointers.  *how: 0 launched as it
// was, 1 updated in place, 2 instantiated by this call.  Called under
// tc_mutex.
inline int tc_graph(const TcArgs& a, TcGraph** out, int* how) {
  TcGraph* slot = nullptr;
  for (TcGraph& c : tc_graphs)
    if (c.used && tc_same_shape(c.args, a)) slot = &c;
  if (slot != nullptr && memcmp(&slot->args, &a, sizeof(TcArgs)) == 0) {
    *out = slot;
    *how = 0;
    return 0;
  }
  if (a.dev < 0 || a.dev >= TC_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  cudaStream_t& cs = tc_capture_streams[a.dev];
  if (cs == nullptr) {
    const cudaError_t e = cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking);
    if (e != cudaSuccess) return (int)e;
  }
  int rc = a.w_f32 ? tc_gemm_prepare<float>() : tc_gemm_prepare<bf16>();
  if (rc) return rc;
  cudaGraph_t g = nullptr;
  int n = 0;
  if (a.w_f32)
    rc = a.s_bf16 ? tc_capture<bf16, float>(a, cs, &g, &n)
                  : tc_capture<float, float>(a, cs, &g, &n);
  else
    rc = a.s_bf16 ? tc_capture<bf16, bf16>(a, cs, &g, &n)
                  : tc_capture<float, bf16>(a, cs, &g, &n);
  if (rc) return rc;
  cudaError_t e = cudaErrorUnknown;
  if (slot != nullptr) {
    // updates apply to later launches; those already queued keep theirs
    cudaGraphExecUpdateResultInfo res;
    e = cudaGraphExecUpdate(slot->exec, g, &res);
    if (e == cudaSuccess) {
      *how = 1;
    } else {
      cudaGetLastError();
      cudaGraphExecDestroy(slot->exec);   // freed when its launches end
      slot->used = false;
    }
  }
  if (e != cudaSuccess) {
    if (slot == nullptr) {
      slot = &tc_graphs[tc_next];
      tc_next = (tc_next + 1) % TC_SHAPES;
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
  memcpy(&slot->args, &a, sizeof(TcArgs));
  slot->kernels = n;
  *out = slot;
  return 0;
}

}  // namespace rlmg

extern "C" {

// The SIMT heads + sampling pass alone (heads_sample_row: v8's and v7's),
// on a given final hidden state h (B,D) (before the final LN), for
// position pos.
int rlmg_heads_sample(const float* h, const void* hw, const float* hb, const float* fls,
                      const float* flb, const float* tinv, const float* topp, int* tok_out,
                      int B, int D, int NF, int pos, unsigned int seed, int greedy, int w_bf16,
                      void* stream) {
  if (NF > rlmg::MAX_NF || NF < 1 || D > rlmg::MAX_D) return (int)cudaErrorInvalidValue;
  const rlmg::FieldArgs fa = rlmg::field_args(nullptr, tinv, topp, NF);
  return rlmg::heads_sample(h, fls, flb, hw, hb, fa, tok_out, B, NF, D, pos, seed, greedy,
                            w_bf16, (cudaStream_t)stream);
}

long long rlmg_tc_workspace_bytes(int B, int D, int DI, int NF, int w_f32) {
  rlmg::TcBufs o;
  return (long long)rlmg::tc_carve(nullptr, B, D, DI, NF, w_f32 ? 3 : 1, &o);
}

// Decode T tokens.  tok0 (B,NF) int32 is fed at position t0; tokbuf (rows
// >= T+1, B, NF) int32 receives tok0 in row 0 and the token emitted at t0+t
// in row t+1 (row t+1 is fed at t0+t+1 by the next step or call).  s, z
// are updated in place.  off, tinv, topp are host arrays of NF values.  pe
// is the whole (max_len, D) f32 table; rows t0..t0+T-1 are read.  w: the
// N_WEIGHTS stacked layer weights and hw the padded heads, bf16 (w_f32 =
// 0) or f32 (w_f32 = 1); with f32 weights planes holds the products'
// weights as three bf16 planes each (TC_PRODUCTS x 3 pointers, rows padded
// to a multiple of 8 values; decode_chunk_tc.cuh TcArgs::wp).  work
// (rlmg_tc_workspace_bytes) is the caller's device buffer.  info[0]: the
// launches this call issued (one kernel, then the token graph T times);
// info[1]: kernels in the graph; info[2]: 0 if the shape's graph was
// launched as it was, 1 if it was updated to this call's pointers, 2 if it
// was instantiated.
int rlmg_decode_chunk_tc(const int* tok0, int* tokbuf, const float* m, const float* bin,
                         const float* pe, const void* const* w, const void* hw,
                         const void* const* planes, const float* hb, const float* fls,
                         const float* flb, const int* off, const float* tinv, const float* topp,
                         void* s, void* z, void* work, int T, int t0, unsigned int seed,
                         int greedy, int L, int B, int D, int H, int DI, int NF, float eps,
                         int s_bf16, int w_f32, void* stream, int* info) {
  if (!rlmg::tc_shape_ok(D, H, DI, w_f32) || (w_f32 && planes == nullptr) ||
      NF > rlmg::MAX_NF || NF < 1 || B < 1 || T < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  rlmg::TcArgs a;
  memset(&a, 0, sizeof a);
  a.tokbuf = tokbuf;
  a.m = m;
  a.bin = bin;
  a.pe = pe;
  a.head_b = hb;
  a.fls = fls;
  a.flb = flb;
  for (int i = 0; i < rlmg::N_WEIGHTS; ++i) a.w[i] = w[i];
  using rlmg::bf16;
  if (w_f32) {
    for (int i = 0; i < rlmg::TC_PRODUCTS; ++i)
      for (int p = 0; p < 3; ++p) a.wp[i][p] = (const bf16*)planes[3 * i + p];
  } else {                                  // bf16 weights are their own plane
    const int mats[4] = {rlmg::W_QKV, rlmg::W_O, rlmg::W_F1, rlmg::W_F2};
    for (int i = 0; i < 4; ++i) a.wp[i][0] = (const bf16*)w[mats[i]];
    a.wp[rlmg::TC_HEADS][0] = (const bf16*)hw;
  }
  a.s = s;
  a.z = z;
  a.work = (char*)work;
  a.L = L;
  a.B = B;
  a.D = D;
  a.H = H;
  a.DI = DI;
  a.NF = NF;
  a.s_bf16 = s_bf16;
  a.w_f32 = w_f32;
  a.eps = eps;
  cudaError_t e = cudaGetDevice(&a.dev);
  if (e != cudaSuccess) return (int)e;
  rlmg::TcCtrl c;
  memset(&c, 0, sizeof c);
  c.t0 = t0;
  c.seed = seed;
  c.greedy = greedy;
  c.fa = rlmg::field_args(off, tinv, topp, NF);
  rlmg::TcBufs o;
  rlmg::tc_carve(a.work, B, D, DI, NF, w_f32 ? 3 : 1, &o);
  const int n = B * NF;
  rlmg::tc_begin_kernel<<<(n + 255) / 256, 256, 0, st>>>(tok0, tokbuf, o.ctrl, c, n);
  RLMG_CHECK();
  // held until the launches are queued, so no other call updates the graph
  // between them
  std::lock_guard<std::mutex> lock(rlmg::tc_mutex);
  rlmg::TcGraph* g = nullptr;
  const int rc = rlmg::tc_graph(a, &g, &info[2]);
  if (rc) return rc;
  for (int t = 0; t < T; ++t) {
    e = cudaGraphLaunch(g->exec, st);
    if (e != cudaSuccess) return (int)e;
  }
  info[0] = 1 + T;
  info[1] = g->kernels;
  return 0;
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
