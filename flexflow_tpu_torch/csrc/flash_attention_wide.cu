// Flash-attention forward at head dims 80, 96 and 256 on the CUDA cores,
// f32 and bf16: the kernel of flash_attention_simt.cuh instantiated here,
// apart from flash_attention.cu's head dims, so that the two compile in
// parallel (see flash_attention.cu for what it computes and its design).
// Replaces, for these head dims, the JAX package's Pallas kernel
// flash_attention_fwd_pallas (flexflow_tpu/ops/pallas_kernels.py:180).
#include "flash_attention_simt.cuh"

namespace {

template <typename T>
cudaError_t launch_wide(int d, const void* q, const void* k, const void* v,
                        void* o, float* lse, int b, int sq, int sk, int h,
                        int kvh, float scale, int causal,
                        cudaStream_t stream) {
  switch (d) {
    case 80: return launch<T, 80>(q, k, v, o, lse, b, sq, sk, h, kvh, scale, causal, stream);
    case 96: return launch<T, 96>(q, k, v, o, lse, b, sq, sk, h, kvh, scale, causal, stream);
    case 256: return launch<T, 256>(q, k, v, o, lse, b, sq, sk, h, kvh, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace ffk {
namespace simt {

cudaError_t flash_fwd_wide(int d, int dtype, const void* q, const void* k,
                           const void* v, void* o, float* lse, int b, int sq,
                           int sk, int h, int kvh, float scale, int causal,
                           cudaStream_t stream) {
  if (dtype == kF32)
    return launch_wide<float>(d, q, k, v, o, lse, b, sq, sk, h, kvh, scale, causal, stream);
  if (dtype == kBF16)
    return launch_wide<__nv_bfloat16>(d, q, k, v, o, lse, b, sq, sk, h, kvh, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace simt
}  // namespace ffk
