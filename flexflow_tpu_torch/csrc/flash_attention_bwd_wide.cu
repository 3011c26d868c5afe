// Flash-attention backward at head dims 80, 96 and 256 on the CUDA cores:
// the dq and dk/dv kernels of flash_attention_bwd_simt.cuh instantiated
// here for f32 (and in flash_attention_bwd_wide_bf16.cu for bf16), apart
// from flash_attention_bwd.cu's head dims, so that the three compile in
// parallel (see flash_attention_bwd.cu for what they compute and their
// design). Replaces, for these head dims, the JAX package's Pallas
// backward flash_attention_bwd_pallas
// (flexflow_tpu/ops/pallas_kernels.py:335).
#include "flash_attention_bwd_simt.cuh"

namespace ffk {
namespace simt {

cudaError_t flash_bwd_wide(int d, int dtype, const void* q, const void* k,
                           const void* v, const float* lse, const void* dout,
                           const float* delta, const float* dlse, void* dq,
                           void* dk, void* dv, int b, int sq, int sk, int h,
                           float scale, int causal, cudaStream_t stream) {
  if (dtype == kF32)
    return launch_simt_wide<float>(d, q, k, v, lse, dout, delta, dlse, dq, dk, dv, b, sq, sk, h, scale, causal, stream);
  if (dtype == kBF16)
    return flash_bwd_wide_bf16(d, q, k, v, lse, dout, delta, dlse, dq, dk, dv, b, sq, sk, h, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace simt
}  // namespace ffk
