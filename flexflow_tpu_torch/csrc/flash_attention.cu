// Flash-attention forward for Hopper (sm_90a), CUDA C++: the f32 route on
// the CUDA cores. bf16 runs on the tensor cores (flash_attention_wgmma.cu)
// at head dims 32, 64 and 128 and on this kernel at 80, 96 and 256; the C
// entry point below chooses by dtype and head dim. The kernel lives in
// flash_attention_simt.cuh: this file instantiates it at 32, 64 and 128,
// flash_attention_wide.cu at 80, 96 and 256. f32 stays
// here because TF32 wgmma keeps ~10 mantissa bits, far outside the f32
// checks that hold the port to the JAX package.
//
// Replaces the JAX package's Pallas kernel flash_attention_fwd_pallas
// (flexflow_tpu/ops/pallas_kernels.py:180, kernel _flash_fwd_kernel :124).
// With a non-null lse pointer it also writes the logsumexp residual the
// backward needs (flash_attention_bwd.cu), one f32 per (b, h, q row) in a
// plain (B, H, Sq) layout — not the Pallas kernel's 8-lane padded one. The
// serving prefill passes null and does no extra work.
//
// Computes o = softmax(scale * q k^T + mask) v on (B, S, H, D) tensors,
// with the causal mask aligned bottom-right (query row i attends keys
// j <= i + (sk - sq), the JAX _causal_mask rule). Grouped-query attention
// reads k/v with KVH heads directly: query head h uses kv head
// h / (H / KVH), so the jnp.repeat broadcast of the JAX dense path is never
// materialised.
//
// Design. The Pallas kernel runs a sequential (q tile, k tile) grid on one
// TPU core, carrying the online-softmax state in VMEM scratch across the
// inner grid axis. Here a block owns one (batch*head, 64-row q tile) and
// loops over 32-row K/V tiles itself; the running max m, sum l and the
// output accumulator stay in registers in f32. K tiles past the causal
// diagonal are never loaded (the loop ends at the last live tile), and the
// ragged edge of both sequences is masked, so any S works. Head dims 32, 64,
// 80, 96, 128 and 256 are built (any multiple of 16 fits the thread grid; at
// 256 the tiles take 137.5 KB of shared memory). 256 threads form
// a 16 x 16 grid: thread (ty, tx) owns query rows ty + 16 i (i < 4) and, in
// the score tile, key columns tx + 16 j (j < 2), in the output tile head-dim
// columns tx + 16 j (j < D / 16). Row reductions are 16-lane shuffles.
//
// Bound on the H100: at the training shape (B = 8, S = 512, H = 32, D = 128,
// non-causal, bf16) the function does 4 B H S^2 D = 34.4 GFLOP, ~35 us at
// 989 TFLOP/s, and moves ~135 MB (q, k, v read once, o and lse written
// once), ~40 us at 3.35 TB/s; at the serving prefill shape (B = 1, S = 512,
// H = 32, KVH = 8, D = 128, causal) it moves ~10.5 MB, ~3.1 us, and does
// ~2.2 GFLOP, ~2.2 us. Both are bytes bound by a small margin. This kernel
// runs its products in f32 on the CUDA cores from shared memory (no wgmma,
// no TMA), so it sits far from that bound; its measured times are in
// PERF.md.
#include "flash_attention_simt.cuh"

namespace {

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     void* o, float* lse, int b, int sq, int sk, int h,
                     int kvh, float scale, int causal, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, lse, b, sq, sk, h, kvh, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, b, sq, sk, h, kvh, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, b, sq, sk, h, kvh, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, KVH, D), o (B, Sq, H, D); all contiguous,
// one dtype. lse: (B, H, Sq) f32, or null to skip it. f32 runs the CUDA-core
// kernel above at every head dim; bf16 runs the tensor-core kernel (16-byte
// aligned tensors) at head dims 32, 64 and 128 and the CUDA-core kernel at
// 80, 96 and 256 (the wgmma tiles swizzle whole 64-column boxes, and at 256
// the accumulators and a K/V stage outgrow a consumer's registers and the
// block's shared memory). A call the chosen kernel refuses returns an
// error, never another route. Returns a cudaError_t.
extern "C" int ff_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int dtype, int b, int sq, int sk, int h,
                                      int kvh, int d, float scale, int causal,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (d == 80 || d == 96 || d == 256)
    return simt::flash_fwd_wide(d, dtype, q, k, v, o, l, b, sq, sk, h, kvh, scale, causal, st);
  if (dtype == kF32)
    return launch_d<float>(d, q, k, v, o, l, b, sq, sk, h, kvh, scale, causal, st);
  if (dtype == kBF16)
    return sm90::flash_fwd_wgmma(d, q, k, v, o, l, b, sq, sk, h, kvh, scale, causal, st);
  return cudaErrorInvalidValue;
}
