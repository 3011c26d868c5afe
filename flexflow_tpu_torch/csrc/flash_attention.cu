// Flash-attention forward for Hopper (sm_90a), CUDA C++: the f32 route on
// the CUDA cores. bf16 runs on the tensor cores (flash_attention_wgmma.cu);
// the C entry point below chooses between the two by dtype alone. f32 stays
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
// ragged edge of both sequences is masked, so any S works. 256 threads form
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
#include "hopper.cuh"

using namespace ffk;

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // key rows per K/V tile
constexpr int kThreads = 256;  // 16 x 16

template <int D>
constexpr size_t flash_smem_bytes() {
  // q [BQ][D+1], k^T [D][BK+1], v [BK][D], p [BQ][BK+1], all f32; the +1
  // pads keep the strided reads free of bank conflicts
  return sizeof(float) *
         (kBQ * (D + 1) + D * (kBK + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int h, int kvh,
                 float scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBQ][D + 1]
  float* kt = qs + kBQ * (D + 1);     // [D][kBK + 1]  (k transposed)
  float* vs = kt + D * (kBK + 1);     // [kBK][D]
  float* ps = vs + kBK * D;           // [kBQ][kBK + 1]

  constexpr int DJ = D / 16;          // output columns per thread
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / h;
  const int hh = blockIdx.y % h;
  const int kh = hh / (h / kvh);
  const int offset = sk - sq;         // bottom-right causal alignment

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qp = q0 + r;
    float x = 0.f;
    if (qp < sq) x = to_f32(q[((static_cast<size_t>(b) * sq + qp) * h + hh) * D + d]);
    qs[r * (D + 1) + d] = x;
  }

  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    // the last live key of this q tile is (last row) + offset
    const int q_last = min(q0 + kBQ, sq) - 1;
    n_tiles = min(n_tiles, (q_last + offset) / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's P.V reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int kp = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (kp < sk) {
        const size_t off = ((static_cast<size_t>(b) * sk + kp) * kvh + kh) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      kt[d * (kBK + 1) + c] = kx;
      vs[c * D + d] = vx;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = kt[d * (kBK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
      bool live[2];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + tx + 16 * j;
        live[j] = kp < sk && (!causal || kp <= qp + offset);
        s[i][j] *= scale;
        if (live[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = warp_max(mx, 16);  // the 16 lanes sharing row r
      const float m_new = fmaxf(m[i], mx);
      // m_new = -inf: no live key yet for this row (a padding row past
      // sq); keep the state untouched instead of forming exp(-inf + inf)
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        ps[r * (kBK + 1) + tx + 16 * j] = round_to<T>(p);
      }
      psum = warp_sum(psum, 16);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= sq) continue;
    // every real row has >= 1 live key (key 0: causal needs sk >= sq,
    // which the wrapper checks), so l > 0
    T* orow = o + ((static_cast<size_t>(b) * sq + qp) * h + hh) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / l[i]);
    // m is the running max of the scaled logits, l their shifted sum
    if (lse != nullptr && tx == 0)
      lse[static_cast<size_t>(blockIdx.y) * sq + qp] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int sk, int h, int kvh,
                   float scale, int causal, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_fwd_simt_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  flash_fwd_simt_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, h, kvh,
      scale, causal);
  return cudaGetLastError();
}

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
// kernel above, bf16 the tensor-core kernel (16-byte aligned tensors); a
// call either refuses returns an error, never the other route. Returns a
// cudaError_t.
extern "C" int ff_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int dtype, int b, int sq, int sk, int h,
                                      int kvh, int d, float scale, int causal,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == kF32)
    return launch_d<float>(d, q, k, v, o, l, b, sq, sk, h, kvh, scale, causal, st);
  if (dtype == kBF16)
    return sm90::flash_fwd_wgmma(d, q, k, v, o, l, b, sq, sk, h, kvh, scale, causal, st);
  return cudaErrorInvalidValue;
}
