// Fused residual add + LayerNorm forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernel fused_add_layernorm_fwd_pallas
// (flexflow_tpu/ops/pallas_kernels.py:461, kernel _add_ln_fwd_kernel :437).
// On (N, D) rows:
//
//   s = x + r                        (written in x's dtype)
//   y = (s - mean) * rstd * scale + bias,   rstd = 1 / sqrt(var + eps)
//
// with mean and the two-pass variance E[(s - mean)^2] taken in f32 over the
// rounded s, as the Pallas kernel does; optionally mean and rstd are
// written as (N,) f32 for the backward (the Pallas kernel's 8-lane padded
// (N, 8) layout is not carried over). The backward is torch arithmetic
// (ops/kernels.py, the JAX package's _add_ln_bwd_rule :517).
//
// Design. One block per row, of the fewest threads (32 to 1024) that hold
// the row in four 16-byte vectors each (8 bf16 or 4 f32). A thread issues
// all its loads of x and r at once, writes s back, and keeps the rounded
// sum in registers as f32, so the second pass (variance) and the third
// (normalise, scale, shift) never touch device memory again: x and r are
// read once, s and y written once. Row reductions are warp shuffles, then
// one shared-memory step across the block's warps. At D = 4096 in bf16 a
// block is 128 threads, so 16 rows are in flight on an SM.
//
// Bound on the H100: bytes. At the training shape (N = 4096 rows of
// D = 4096, bf16) the kernel reads x and r and writes s and y, 4 N D 2 B =
// 134 MB, ~40 us at 3.35 TB/s; its arithmetic (~10 N D operations) is
// negligible beside that.
#include "common.cuh"

using namespace ffk;

namespace {

constexpr int kVecs = 4;  // 16-byte vectors of the row a thread holds

// Sum of v over the block of NW warps, returned to every thread. red: NW
// floats of shared memory, reusable across calls.
template <int NW>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v, 32);
  if (NW == 1) return v;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // red's previous readers are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < NW ? red[lane] : 0.f;
  return warp_sum(v, 32);
}

template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads)
add_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const T* __restrict__ scale, const T* __restrict__ bias,
                  T* __restrict__ s_out, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int d, float eps) {
  constexpr int NW = kThreads / 32;
  constexpr int V = 16 / sizeof(T);           // elements per 16-byte vector
  __shared__ float red[NW];
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const int nvec = d / V;
  const uint4* xv = reinterpret_cast<const uint4*>(x + base);
  const uint4* rv = reinterpret_cast<const uint4*>(r + base);
  uint4* sv = reinterpret_cast<uint4*>(s_out + base);
  uint4* yv = reinterpret_cast<uint4*>(y + base);

  uint4 xa[kVecs], ra[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < nvec) {
      xa[j] = xv[i];
      ra[j] = rv[i];
    }
  }
  float row[kVecs][V];                        // s, rounded to T, as f32
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < nvec) {
      float b[V];
      unpack16<T>(xa[j], row[j]);
      unpack16<T>(ra[j], b);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        row[j][e] = round_to<T>(row[j][e] + b[e]);  // s in x's dtype
        sum += row[j][e];
      }
      sv[i] = pack16<T>(row[j]);
    }
  }
  const float mean = block_sum<NW>(sum, red) / d;

  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    if (threadIdx.x + j * kThreads < nvec) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float c = row[j][e] - mean;
        sq += c * c;
      }
    }
  }
  const float rstd = rsqrtf(block_sum<NW>(sq, red) / d + eps);

  const uint4* scv = reinterpret_cast<const uint4*>(scale);
  const uint4* biv = reinterpret_cast<const uint4*>(bias);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < nvec) {
      float sc[V], bi[V];
      unpack16<T>(scv[i], sc);
      unpack16<T>(biv[i], bi);
#pragma unroll
      for (int e = 0; e < V; ++e)
        row[j][e] = (row[j][e] - mean) * rstd * sc[e] + bi[e];
      yv[i] = pack16<T>(row[j]);
    }
  }
  if (threadIdx.x == 0 && mean_out != nullptr) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }
}

template <typename T, int kThreads>
cudaError_t launch_t(const void* x, const void* r, const void* scale,
                     const void* bias, void* s, void* y, float* mean,
                     float* rstd, int n, int d, float eps,
                     cudaStream_t stream) {
  add_ln_fwd_kernel<T, kThreads><<<n, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(s), static_cast<T*>(y), mean, rstd, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* r, const void* scale,
                   const void* bias, void* s, void* y, float* mean,
                   float* rstd, int n, int d, float eps, cudaStream_t stream) {
  const int nvec = d / (16 / static_cast<int>(sizeof(T)));
  // the fewest threads that hold the row in kVecs vectors each
  if (nvec <= 32 * kVecs)
    return launch_t<T, 32>(x, r, scale, bias, s, y, mean, rstd, n, d, eps, stream);
  if (nvec <= 64 * kVecs)
    return launch_t<T, 64>(x, r, scale, bias, s, y, mean, rstd, n, d, eps, stream);
  if (nvec <= 128 * kVecs)
    return launch_t<T, 128>(x, r, scale, bias, s, y, mean, rstd, n, d, eps, stream);
  if (nvec <= 256 * kVecs)
    return launch_t<T, 256>(x, r, scale, bias, s, y, mean, rstd, n, d, eps, stream);
  if (nvec <= 512 * kVecs)
    return launch_t<T, 512>(x, r, scale, bias, s, y, mean, rstd, n, d, eps, stream);
  if (nvec <= 1024 * kVecs)
    return launch_t<T, 1024>(x, r, scale, bias, s, y, mean, rstd, n, d, eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, r, s, y (N, D); scale, bias (D,); all contiguous, one dtype, 16-byte
// aligned, D a multiple of 8 and at most 4096 vectors of 16 bytes.
// mean/rstd: (N,) f32, or both null to skip them. Returns a cudaError_t.
extern "C" int ff_fused_add_layernorm_fwd(const void* x, const void* r,
                                          const void* scale, const void* bias,
                                          void* s, void* y, void* mean,
                                          void* rstd, int dtype, int n, int d,
                                          float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  if (dtype == kF32)
    return launch<float>(x, r, scale, bias, s, y, m, rs, n, d, eps, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, r, scale, bias, s, y, m, rs, n, d, eps, st);
  return cudaErrorInvalidValue;
}
