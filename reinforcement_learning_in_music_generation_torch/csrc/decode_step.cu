// One decode token through all L layers of the causal linear-attention
// transformer: the CUDA counterpart of
// reinforcement_learning_in_music_generation_tpu/ops/decode_kernel_v4.py
// fused_stack_step_v4 (its Pallas body _pair_kernel).  The kernels are in
// decode_layers.cuh, shared with decode_chunk.cu; this file is the
// one-token entry point.
//
// The TPU kernel's head-pair packing (a fix for 128-lane rows) is not
// carried over: the state keeps the DecodeState layout S (L,B,H,E,E),
// z (L,B,H,E).
//
// Bound on the card.  Per token the step must read every layer's weights
// once, L*(4*D*D + 2*D*DI) values (12 layers at D=512, DI=2048: 37.7M, i.e.
// 151 MB in f32 or 75 MB in bf16), and read and write the state once,
// 2*L*B*H*E*E values (at B=128 in bf16: 201 MB).  It does 2*B*L*(4*D*D +
// 2*D*DI) operations (B * 75.5 MFLOP).  At the 5-song batch of the default
// `generate` that is bytes-bound (3.35 TB/s: ~47 us); at B=128 with f32
// weights the f32 FMAs (67 TFLOP/s without tensor cores) bind.  What this
// design does about it: every product is K-split until about 1024 blocks
// are in flight, so the weight stream is spread over all SMs even at B=5;
// the state kernel streams S exactly once in and once out; intermediates
// live in one small f32 scratch buffer.  It does not yet use tensor cores
// or one persistent launch per token (about 100 launches per token now):
// those are the next steps (PERF.md).

#include "decode_layers.cuh"

extern "C" {

// f32 scratch floats rlmg_decode_stack_step needs at batch B.
long long rlmg_stack_scratch_floats(int B, int D, int DI) {
  return (long long)rlmg::stack_scratch_floats(B, D, DI);
}

// h (B, D) f32 is read as the step's input and overwritten with its output.
// w: 12 stacked weight pointers in rlmg::W_QKV..LN2_B order, one type
// (w_bf16); s, z share one type (s_bf16) and are updated in place.
// Returns 0 or the first CUDA error code (cudaGetLastError after each launch).
int rlmg_decode_stack_step(float* h, const void* const* w, void* s, void* z,
                           float* scratch, int L, int B, int D, int H, int DI,
                           float eps, int w_bf16, int s_bf16, void* stream) {
  if (!rlmg::stack_shape_ok(D, H)) return (int)cudaErrorInvalidValue;
  return rlmg::stack_step_any(h, w, s, z, scratch, L, B, D, H, DI, eps, w_bf16, s_bf16,
                              (cudaStream_t)stream);
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
