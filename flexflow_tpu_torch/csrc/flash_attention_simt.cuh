// The CUDA-core flash-attention forward kernel (see flash_attention.cu):
// the f32 route at every head dim and the bf16 route at head dims 80, 96
// and 256. flash_attention.cu instantiates it at 32, 64 and 128 (f32) and
// flash_attention_wide.cu at 80, 96 and 256 (f32 and bf16), so that the
// two compile in parallel.
#pragma once

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

}  // namespace

namespace ffk {
namespace simt {

// the kernel above at head dims 80, 96 and 256, f32 or bf16 (dtype code):
// flash_attention_wide.cu
cudaError_t flash_fwd_wide(int d, int dtype, const void* q, const void* k,
                           const void* v, void* o, float* lse, int b, int sq,
                           int sk, int h, int kvh, float scale, int causal,
                           cudaStream_t stream);

}  // namespace simt
}  // namespace ffk
