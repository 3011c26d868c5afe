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
// Bound on the H100: bytes. At the training shape (N = 4096 rows of
// D = 4096, bf16) the kernel reads x and r and writes s and y, 4 N D 2 B =
// 134 MB, ~40 us at 3.35 TB/s; its arithmetic (~10 N D operations) is
// negligible beside that.
//
// Design: a persistent grid that keeps the loads of the next row in
// flight while the current one reduces.
// - Blocks of the fewest threads (32 to 1024) that hold a row in four
//   16-byte vectors each (8 bf16 or 4 f32); at D = 4096 in bf16, 128.
//   The grid is as many blocks as fit on the card at once (the occupancy
//   API times the SM count), capped at N; block i takes rows i, i + grid,
//   i + 2 grid, ...
// - Each thread owns the same column vectors in every row, so it loads its
//   slices of scale and bias once, into registers, before the row loop.
// - A row's x and r are loaded as 16-byte streaming loads into registers;
//   with up to 256 threads a block, the next row's loads are issued before
//   the current row's reductions (a register double buffer), so an SM
//   always has rows arriving while others reduce and store. (Blocks of 512
//   or 1024 threads, rows wider than 8192 bf16 or 4096 f32 values, load
//   the next row after the current one: a second buffer would not fit
//   their register budget.)
// - s is rounded to x's dtype and kept packed in registers: the variance
//   pass and the normalise pass never touch device memory again, so x and r
//   are read once and s and y written once, as streaming stores that do not
//   evict rows still to be read.
// - Each of a row's two reductions is warp shuffles, then one shared-memory
//   step behind one barrier: the mean and the variance use two buffers in
//   turn, so a buffer is written again only after a barrier that every
//   reader of its previous value has passed.
#include "common.cuh"

using namespace ffk;

namespace {

constexpr int kVecs = 4;  // 16-byte vectors of the row a thread holds

// Sum of v over the block of NW warps, returned to every thread (each adds
// the warps' partial sums in the same order). red: NW floats of shared
// memory that no thread reads again before the block's next barrier.
template <int NW>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v, 32);
  if (NW == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) t += red[w];
  return t;
}

template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads)
add_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const T* __restrict__ scale, const T* __restrict__ bias,
                  T* __restrict__ s_out, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int n, int d, float eps) {
  constexpr int NW = kThreads / 32;
  constexpr int V = 16 / sizeof(T);           // elements per 16-byte vector
  constexpr bool kPrefetch = kThreads <= 256;
  __shared__ float red[2][NW];
  const int nvec = d / V;
  int col[kVecs];                             // this thread's vectors
  bool own[kVecs];
  uint4 sc[kVecs], bi[kVecs];                 // scale and bias, kept
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    col[j] = threadIdx.x + j * kThreads;
    own[j] = col[j] < nvec;
    if (own[j]) {
      sc[j] = __ldg(reinterpret_cast<const uint4*>(scale) + col[j]);
      bi[j] = __ldg(reinterpret_cast<const uint4*>(bias) + col[j]);
    }
  }
  uint4 xa[kVecs], ra[kVecs];                 // the current row's x and r
  auto load = [&](int row, uint4 (&xo)[kVecs], uint4 (&ro)[kVecs]) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * d);
    const uint4* rv = reinterpret_cast<const uint4*>(r + static_cast<size_t>(row) * d);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (own[j]) {
        xo[j] = __ldcs(xv + col[j]);
        ro[j] = __ldcs(rv + col[j]);
      }
    }
  };

  int row = blockIdx.x;
  if (row < n) load(row, xa, ra);
  for (; row < n; row += gridDim.x) {
    const int next = row + gridDim.x;
    uint4 xn[kVecs], rn[kVecs];
    if (kPrefetch && next < n) load(next, xn, rn);  // in flight from here
    uint4* sv = reinterpret_cast<uint4*>(s_out + static_cast<size_t>(row) * d);
    uint4* yv = reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * d);

    uint4 sp[kVecs];                          // s, rounded to T, packed
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (own[j]) {
        float a[V], b[V];
        unpack16<T>(xa[j], a);
        unpack16<T>(ra[j], b);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          a[e] = round_to<T>(a[e] + b[e]);   // s in x's dtype
          sum += a[e];
        }
        sp[j] = pack16<T>(a);
        __stcs(sv + col[j], sp[j]);
      }
    }
    const float mean = block_sum<NW>(sum, red[0]) / d;

    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (own[j]) {
        float a[V];
        unpack16<T>(sp[j], a);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float c = a[e] - mean;
          sq += c * c;
        }
      }
    }
    const float rstd = rsqrtf(block_sum<NW>(sq, red[1]) / d + eps);

#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (own[j]) {
        float a[V], g[V], o[V];
        unpack16<T>(sp[j], a);
        unpack16<T>(sc[j], g);
        unpack16<T>(bi[j], o);
#pragma unroll
        for (int e = 0; e < V; ++e) a[e] = (a[e] - mean) * rstd * g[e] + o[e];
        __stcs(yv + col[j], pack16<T>(a));
      }
    }
    if (threadIdx.x == 0 && mean_out != nullptr) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
    if (next < n) {
      if (kPrefetch) {
#pragma unroll
        for (int j = 0; j < kVecs; ++j) {
          xa[j] = xn[j];
          ra[j] = rn[j];
        }
      } else {
        load(next, xa, ra);
      }
    }
  }
}

template <typename T, int kThreads>
cudaError_t launch_t(const void* x, const void* r, const void* scale,
                     const void* bias, void* s, void* y, float* mean,
                     float* rstd, int n, int d, float eps,
                     cudaStream_t stream) {
  // the persistent grid: every block the card holds at once, at most n
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, add_ln_fwd_kernel<T, kThreads>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int grid = max(1, min(n, sms * max(per_sm, 1)));
  add_ln_fwd_kernel<T, kThreads><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(s), static_cast<T*>(y), mean, rstd, n, d, eps);
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
