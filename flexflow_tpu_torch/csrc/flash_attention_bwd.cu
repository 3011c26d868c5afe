// Flash-attention backward for Hopper (sm_90a), CUDA C++: the delta kernel
// of both routes and the f32 route's dq and dk/dv kernels on the CUDA
// cores. bf16 runs its dq and dk/dv on the tensor cores
// (flash_attention_bwd_wgmma.cu) at head dims 32, 64 and 128 and on these
// kernels at 80, 96 and 256; the C entry point chooses by dtype and head
// dim. The kernels live in flash_attention_bwd_simt.cuh: this file
// instantiates dq and dk/dv at 32, 64 and 128, flash_attention_bwd_wide.cu
// at 80, 96 and 256.
//
// Replaces the JAX package's Pallas backward flash_attention_bwd_pallas
// (flexflow_tpu/ops/pallas_kernels.py:335): its delta term (:358-366, plain
// JAX there), the dq kernel _flash_bwd_dq_kernel (:252) and the dk/dv kernel
// _flash_bwd_dkv_kernel (:290). FlashAttention-2 arithmetic on (B, S, H, D)
// tensors with kv heads == heads (the dense path broadcasts GQA's kv heads
// before attention, as the JAX package does):
//
//   p  = exp(scale * q k^T + mask - lse)      recomputed per tile, f32
//   dp = dO v^T,  delta = rowsum(dO * O) - dlse,  ds = p * (dp - delta)
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T dO
//
// ds and p enter the last three products rounded to the input dtype, as in
// the Pallas kernels (ds.astype(k.dtype), p.astype(do.dtype)); every sum is
// f32. The causal mask is aligned bottom-right (key j is live for query i
// when j <= i + sk - sq, the JAX _causal_mask rule), which needs sq <= sk.
//
// The entry point also takes the Pallas wrapper's dlse and
// delta_precomputed arguments (:335-366): a caller's delta (B, H, Sq) skips
// the delta kernel; an lse cotangent dlse (B, H, Sq) is subtracted from
// delta where the dq and dk/dv kernels read it.
//
// Design. The Pallas kernels run sequential grids on one TPU core and carry
// their accumulators in VMEM scratch across the inner grid axis. Here three
// launches on one stream:
//   1. delta: one warp per (b, q row, head) writes rowsum(dO * O) in f32
//      into a (B, H, Sq) buffer beside the forward's lse (unless the caller
//      gave delta).
//   2. dq: one block per (b * h, 64-row q tile) stages its q and dO rows
//      once and loops over 32-row K/V tiles, dq in f32 registers.
//   3. dk/dv: one block per (b * h, 64-row k tile) stages its K and V rows
//      once and loops over 32-row q / dO tiles, dk and dv in f32 registers.
// Tiles the causal mask kills entirely are never loaded: the dq loop ends
// at the last live K tile, the dk/dv loop starts at the first live q tile.
// The ragged edges of both sequences are masked inside the block, so any S
// works. Head dims 32, 64, 80, 96, 128 and 256 are built (bf16 takes these
// kernels at 80, 96 and 256; at 256 the dq and dk/dv blocks use 201 and
// 209.5 KB of shared memory). Each block is 256 threads in a 16 x 16 grid: thread (ty, tx) owns
// rows ty + 16 i of its block's own tile and columns tx + 16 j of the
// streamed tile (score tiles) or of the head dim (accumulators). Shared
// memory rows are padded by one float, so the strided reads of the score
// products hit 16 distinct banks.
//
// Bound on the H100: at the training shape (B = 8, S = 512, H = 32, D = 128,
// non-causal, bf16) the five products a backward needs are 10 B H S^2 D =
// 85.9 GFLOP, ~87 us at 989 TFLOP/s; the bytes (q, k, v, o, dO, lse read,
// dq, dk, dv written) are ~269 MB, ~80 us — operations bound. This kernel
// recomputes q k^T and dO v^T in both passes (seven products) and runs them
// in f32 on the CUDA cores from shared memory (no mma/wgmma, no TMA), far
// from that bound. Its measured time is in PERF.md.
#include "flash_attention_bwd_simt.cuh"

namespace {

template <typename T>
cudaError_t launch_simt_d(int d, const void* q, const void* k, const void* v,
                          const float* lse, const void* dout,
                          const float* delta, const float* dlse, void* dq,
                          void* dk, void* dv, int b, int sq, int sk, int h,
                          float scale, int causal, cudaStream_t st) {
  switch (d) {
    case 32: return launch_simt<T, 32>(q, k, v, lse, dout, delta, dlse, dq, dk, dv, b, sq, sk, h, scale, causal, st);
    case 64: return launch_simt<T, 64>(q, k, v, lse, dout, delta, dlse, dq, dk, dv, b, sq, sk, h, scale, causal, st);
    case 128: return launch_simt<T, 128>(q, k, v, lse, dout, delta, dlse, dq, dk, dv, b, sq, sk, h, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, H, D); all contiguous,
// one dtype. lse (the forward's) and delta are (B, H, Sq) f32: with
// compute_delta the delta kernel writes rowsum(dO * O) into delta first,
// without it delta is the caller's. dlse, (B, H, Sq) f32 or null, is
// subtracted from delta. f32 runs the CUDA-core kernels above at every head
// dim; bf16 runs the tensor-core kernels (16-byte aligned tensors) at head
// dims 32, 64 and 128 and the CUDA-core kernels at 80, 96 and 256 (as the
// forward does). A call the chosen kernel refuses returns an error, never
// another route. Returns a cudaError_t.
extern "C" int ff_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* dout,
                                      void* delta, const void* dlse,
                                      void* dq, void* dk, void* dv, int dtype,
                                      int b, int sq, int sk, int h, int d,
                                      float scale, int causal,
                                      int compute_delta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const float* dls = static_cast<const float*>(dlse);
  const bool wgmma = d == 32 || d == 64 || d == 128;
  if ((dtype != kF32 && dtype != kBF16) ||
      (!wgmma && d != 80 && d != 96 && d != 256))
    return cudaErrorInvalidValue;
  if (compute_delta) {
    const cudaError_t err =
        dtype == kF32 ? launch_delta<float>(o, dout, dl, b, sq, h, d, st)
                      : launch_delta<__nv_bfloat16>(o, dout, dl, b, sq, h, d, st);
    if (err != cudaSuccess) return err;
  }
  if (!wgmma)
    return simt::flash_bwd_wide(d, dtype, q, k, v, l, dout, dl, dls, dq, dk, dv, b, sq, sk, h, scale, causal, st);
  if (dtype == kBF16)
    return sm90::flash_bwd_wgmma(d, q, k, v, dout, l, dl, dls, dq, dk, dv, b,
                                 sq, sk, h, scale, causal, st);
  return launch_simt_d<float>(d, q, k, v, l, dout, dl, dls, dq, dk, dv, b, sq, sk, h, scale, causal, st);
}
