// One decode token through all L layers of the causal linear-attention
// transformer: the CUDA counterpart of
// reinforcement_learning_in_music_generation_tpu/ops/decode_kernel_v4.py
// fused_stack_step_v4 (its Pallas body _pair_kernel).  The kernel is
// decode_stack_tc.cuh's stack_tc_kernel (shared with v3, decode_aug.cu):
// one cooperative launch a token, four grid barriers a layer, every product
// on the tensor cores at f32 grade (three bf16 products a product with bf16
// weights, six with f32 weights), LN1 of (h + att Wo) + bo as the TPU
// kernel.  That header's note gives the design and the bound.
//
// The TPU kernel's head-pair packing (a fix for 128-lane rows) is not
// carried over: the state keeps the DecodeState layout S (L,B,H,E,E),
// z (L,B,H,E).
//
// Bound on the card.  Per token the step must read every layer's weights
// once, L*(4*D*D + 2*D*DI) values (12 layers at D=512, DI=2048: 37.7M, i.e.
// 151 MB in f32 or 75 MB in bf16), and read and write the state once,
// 2*L*B*H*E*E values (at B=128 in bf16: 201 MB).  It does 2*B*L*(4*D*D +
// 2*D*DI) operations (B * 75.5 MFLOP).  At the songs of the per-step path
// (B <= 64) the bytes bind.

#include "decode_stack_tc.cuh"

extern "C" {

// f32 scratch floats rlmg_stack_tc_step needs at batch B.
long long rlmg_stack_tc_scratch_floats(int B, int D, int DI) {
  return rlmg::stack_tc_scratch_floats(B, D, DI);
}

// Whether the kernel takes d_model D, H heads and d_inner DI (1 or 0).
int rlmg_stack_tc_shape_ok(int D, int H, int DI) { return rlmg::stack_tc_shape_ok(D, H, DI); }

// Launches of the kernel that ran to their end since the last reset, as the
// kernel counts them (waits for the card); reset zeroes the count after
// the read.  Negative: minus a CUDA error code.
long long rlmg_stack_tc_runs(int reset) { return rlmg::stack_tc_runs(reset); }

// h_in (B, D) f32 is read; h_out (B, D) f32 gets the step's output.  w: the
// four packed matrices (Wqkv, Wo, W1, W2; ops/decode_kernel_v4.py
// pack_fragments), v: the eight stacked vectors (qkv bias, Wo bias, LN1
// scale and shift, FFN1 bias, FFN2 bias, LN2 scale and shift), all in one
// type (w_bf16); s, z share one type (s_bf16) and are updated in place.
// scratch: rlmg_stack_tc_scratch_floats(B, D, DI) floats; cnt: (B + 15) / 16
// zeroed ints, left zeroed.  *launched gets the CUDA launches issued.
// Returns 0 or the first CUDA error code.
int rlmg_stack_tc_step(const void* const* w, const void* const* v, void* s, void* z,
                       const float* h_in, float* h_out, float* scratch, unsigned int* cnt,
                       int L, int B, int D, int H, int DI, float eps, int w_bf16, int s_bf16,
                       void* stream, int* launched) {
  *launched = 0;
  if (L < 1 || B < 1 || !rlmg::stack_tc_shape_ok(D, H, DI)) return (int)cudaErrorInvalidValue;
  const rlmg::StackTcArgs a =
      rlmg::stack_tc_args(w, v, s, z, h_in, h_out, scratch, cnt, L, B, D, H, DI, eps, 0);
  using bf = __nv_bfloat16;
  const cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (w_bf16)
    rc = s_bf16 ? rlmg::stack_tc_launch<bf, bf, bf, false>(a, st)
                : rlmg::stack_tc_launch<bf, bf, float, false>(a, st);
  else
    rc = s_bf16 ? rlmg::stack_tc_launch<float, float, bf, false>(a, st)
                : rlmg::stack_tc_launch<float, float, float, false>(a, st);
  if (rc == 0) *launched = 1;
  return rc;
}

#ifdef SK_PROFILE
// The marks of the launches since the last clear (-DSK_PROFILE builds):
// out gets SK_MAX_L * SK_MARKS * SK_MAX_G values, then the marks are
// zeroed.  Returns the grid's size.
int rlmg_stack_tc_marks(unsigned long long* out) {
  constexpr size_t n = (size_t)rlmg::SK_MAX_L * rlmg::SK_MARKS * rlmg::SK_MAX_G;
  static unsigned long long zeros[n];
  cudaMemcpyFromSymbol(out, rlmg::sk_marks, n * sizeof(unsigned long long));
  cudaMemcpyToSymbol(rlmg::sk_marks, zeros, n * sizeof(unsigned long long));
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  return n_sm;
}
#endif

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
