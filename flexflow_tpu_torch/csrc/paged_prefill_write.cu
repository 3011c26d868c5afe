// Paged prefill write for Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernel paged_prefill_write_pallas
// (flexflow_tpu/ops/pallas_kernels.py:779, inline kernel :843) for every
// pool: the copy into a native pool, the cast into a bf16 pool under f32
// compute, and the quantization into an int8 / fp8 pool (:843-852).
//
// Scatters a prefilled (1, S, KVH, D) k slab and v slab into the pool pages
// pages[0 .. n): slab position t * page_size + r lands in pool page
// pages[t], row r. Rows past S in the last page are written as zeros, as
// the JAX oracle's jnp.pad does, so the pool is bitwise the oracle's.
//
// Native pools. Blocks (listed page, k-or-v, slice of the page) copy one
// page-sized tile between them, each thread keeping four independent loads
// in flight. The copy moves raw bits in the widest unit the row size and
// the pointers' alignment allow (16, 4, 2 or 1 bytes), so any dtype copies
// exactly.
//
// Quantized pools. One block per (listed page, k-or-v) makes two passes
// over the page's slab tile. Pass 1 reduces |x| to a max per kv head over
// (page_size, D) — the zero tail of the last page takes part, as in JAX —
// and sets scale = amax / qmax. Pass 2 quantizes every value,
// x / max(scale, 1e-12) clipped to +-qmax, rounded half to even into int8
// (__float2int_rn) or to nearest even into fp8 e4m3fn (saturating cvt), and
// writes 16 payload bytes a thread. Both divisions are IEEE divisions and
// the build has no fast-math flag, so payload and scales are bitwise the
// plain version's (and the Pallas kernel's): a reciprocal multiply would
// not be. The cast into a bf16 pool is pass 2 with a round-to-nearest-even
// conversion and no scale.
//
// The pool (and the scale planes) are updated IN PLACE: the JAX kernel
// aliased them input to output so untouched pages survived; here nothing
// but the listed pages is touched, which saves a copy of the whole pool
// per prefill.
//
// Bound on the H100: at S = 512, KVH = 8, D = 128 in bf16 the function
// reads the two 1 MB slabs and writes 4 pages of k and of v (2 MB; 1 MB
// into an int8 / fp8 pool, plus 256 bytes of scales), ~4.2 MB (~3.1 MB) in
// all, ~1.3 us (~0.9 us) at 3.35 TB/s; bytes bound.
#include <initializer_list>

#include "common.cuh"

using namespace ffk;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // independent loads in flight per thread

template <typename U>
__global__ void __launch_bounds__(kThreads)
prefill_write_kernel(const U* __restrict__ kslab, const U* __restrict__ vslab,
                     U* __restrict__ kpool, U* __restrict__ vpool,
                     const int* __restrict__ pages, int s, int ps,
                     int k_row, int v_row) {
  const int t = blockIdx.x;
  const bool is_v = blockIdx.y == 1;
  const U* src = is_v ? vslab : kslab;
  U* dst = is_v ? vpool : kpool;
  const size_t row = static_cast<size_t>(is_v ? v_row : k_row);  // units per position
  const size_t page_units = row * ps;
  const size_t base = page_units * t;        // this page's first slab unit
  const size_t slab_units = row * s;
  U* page = dst + static_cast<size_t>(pages[t]) * page_units;
  const size_t first = static_cast<size_t>(blockIdx.z) * kThreads * kUnroll + threadIdx.x;
  U x[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const size_t e = first + static_cast<size_t>(u) * kThreads;
    x[u] = U{};  // zero bits: the pad tail
    if (e < page_units && base + e < slab_units) x[u] = src[base + e];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const size_t e = first + static_cast<size_t>(u) * kThreads;
    if (e < page_units) page[e] = x[u];
  }
}

template <typename U>
cudaError_t launch(const void* ks, const void* vs, void* kp, void* vp,
                   const int* pages, int n_pages, int s, int ps,
                   int k_row_bytes, int v_row_bytes, cudaStream_t stream) {
  const int k_row = k_row_bytes / static_cast<int>(sizeof(U));
  const int v_row = v_row_bytes / static_cast<int>(sizeof(U));
  const size_t page_units = static_cast<size_t>(max(k_row, v_row)) * ps;
  const size_t per_block = static_cast<size_t>(kThreads) * kUnroll;
  const dim3 grid(n_pages, 2, static_cast<unsigned>((page_units + per_block - 1) / per_block));
  prefill_write_kernel<U><<<grid, kThreads, 0, stream>>>(
      static_cast<const U*>(ks), static_cast<const U*>(vs),
      static_cast<U*>(kp), static_cast<U*>(vp), pages, s, ps, k_row, v_row);
  return cudaGetLastError();
}

bool fits(size_t unit, int k_row_bytes, int v_row_bytes,
          std::initializer_list<const void*> ptrs) {
  if (k_row_bytes % unit || v_row_bytes % unit) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % unit) return false;
  return true;
}

// ---- quantizing / casting write ----------------------------------------

constexpr int kQThreads = 256;
constexpr int kQVec = 16;  // values a thread moves per step: 16 output bytes (one-byte pools)

// 16 slab values (f32 or bf16, 16-byte aligned) as f32
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int v = 0; v < kQVec / kPer; ++v)
    unpack16<T>(reinterpret_cast<const uint4*>(p)[v], out + v * kPer);
}

// 16 already-clipped values into storage O
template <typename O>
__device__ __forceinline__ void store16(O* dst, const float* x);
template <>
__device__ __forceinline__ void store16<int8_t>(int8_t* dst, const float* x) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kQVec; ++i) {
    const unsigned byte = static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(x[i])));
    w[i / 4] |= byte << (8 * (i % 4));
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}
template <>
__device__ __forceinline__ void store16<__nv_fp8_e4m3>(__nv_fp8_e4m3* dst, const float* x) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kQVec; ++i) {
    const unsigned byte = __nv_cvt_float_to_fp8(x[i], __NV_SATFINITE, __NV_E4M3);
    w[i / 4] |= byte << (8 * (i % 4));
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}
template <>
__device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* dst, const float* x) {
  reinterpret_cast<uint4*>(dst)[0] = pack16<__nv_bfloat16>(x);
  reinterpret_cast<uint4*>(dst)[1] = pack16<__nv_bfloat16>(x + 8);
}

// One block per (listed page, k-or-v); dynamic shared memory: KVH words
// (the running |x| max of each kv head as float bits, then its scale).
template <typename T, typename O>
__global__ void __launch_bounds__(kQThreads)
prefill_quant_kernel(const T* __restrict__ kslab, const T* __restrict__ vslab,
                     O* __restrict__ kpool, O* __restrict__ vpool,
                     float* __restrict__ kscale, float* __restrict__ vscale,
                     const int* __restrict__ pages, int s, int ps, int kvh,
                     int d, float qmax) {
  constexpr bool kQuant = sizeof(O) == 1;
  extern __shared__ unsigned head_s[];  // [kvh]
  const int t = blockIdx.x;
  const bool is_v = blockIdx.y == 1;
  const T* src = is_v ? vslab : kslab;
  O* dst = is_v ? vpool : kpool;
  float* scale = is_v ? vscale : kscale;
  const int tid = threadIdx.x;
  const int page_id = pages[t];
  const size_t row = static_cast<size_t>(kvh) * d;  // values per position
  const size_t base = row * ps * t;                 // the page's first slab value
  const size_t slab_n = row * s;

  if (kQuant) {
    // pass 1: amax per kv head over (ps, D); |x| >= 0, so the float bits
    // order as the values do and an unsigned max reduces them
    for (int i = tid; i < kvh; i += kQThreads) head_s[i] = 0u;
    __syncthreads();
    const int per_row = d / kQVec;  // vectors per (position, head)
    for (int hh = 0; hh < kvh; ++hh) {
      float m = 0.f;
      for (int c = tid; c < ps * per_row; c += kQThreads) {
        const size_t e = base + static_cast<size_t>(c / per_row) * row +
                         static_cast<size_t>(hh) * d + (c % per_row) * kQVec;
        if (e < slab_n) {  // rows past S are the zero tail
          float x[kQVec];
          load16<T>(src + e, x);
#pragma unroll
          for (int k = 0; k < kQVec; ++k) m = fmaxf(m, fabsf(x[k]));
        }
      }
      m = warp_max(m, 32);
      if ((tid & 31) == 0) atomicMax(&head_s[hh], __float_as_uint(m));
    }
    __syncthreads();
    for (int i = tid; i < kvh; i += kQThreads) {
      const float sc = __fdiv_rn(__uint_as_float(head_s[i]), qmax);
      scale[static_cast<size_t>(page_id) * kvh + i] = sc;
      head_s[i] = __float_as_uint(fmaxf(sc, 1e-12f));  // the divisor
    }
    __syncthreads();
  }

  // pass 2: quantize (or cast) the page tile, 16 values a thread a step
  O* page = dst + static_cast<size_t>(page_id) * row * ps;
  const size_t n_vec = row * ps / kQVec;
  for (size_t c = tid; c < n_vec; c += kQThreads) {
    const size_t e = c * kQVec;  // offset inside the page tile
    float x[kQVec];
    if (base + e < slab_n) {
      load16<T>(src + base + e, x);
    } else {
#pragma unroll
      for (int k = 0; k < kQVec; ++k) x[k] = 0.f;
    }
    if (kQuant) {
      const float den = __uint_as_float(head_s[(e / d) % kvh]);
#pragma unroll
      for (int k = 0; k < kQVec; ++k)
        x[k] = fminf(fmaxf(__fdiv_rn(x[k], den), -qmax), qmax);
    }
    store16<O>(page + e, x);
  }
}

template <typename T, typename O>
cudaError_t launch_quant(const void* ks, const void* vs, void* kp, void* vp,
                         void* ksc, void* vsc, const int* pages, int n_pages,
                         int s, int ps, int kvh, int d, float qmax,
                         cudaStream_t stream) {
  const dim3 grid(n_pages, 2);
  prefill_quant_kernel<T, O><<<grid, kQThreads, sizeof(unsigned) * kvh, stream>>>(
      static_cast<const T*>(ks), static_cast<const T*>(vs), static_cast<O*>(kp),
      static_cast<O*>(vp), static_cast<float*>(ksc), static_cast<float*>(vsc),
      pages, s, ps, kvh, d, qmax);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_quant_pool(int pool_dtype, const void* ks, const void* vs,
                              void* kp, void* vp, void* ksc, void* vsc,
                              const int* pages, int n_pages, int s, int ps,
                              int kvh, int d, cudaStream_t st) {
  switch (pool_dtype) {
    case ffk::kI8:
      return launch_quant<T, int8_t>(ks, vs, kp, vp, ksc, vsc, pages, n_pages, s, ps, kvh, d, 127.f, st);
    case ffk::kFP8:
      return launch_quant<T, __nv_fp8_e4m3>(ks, vs, kp, vp, ksc, vsc, pages, n_pages, s, ps, kvh, d, 448.f, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// k/v slabs (1, S, KVH, D*) and pools (P, page_size, KVH, D*), contiguous,
// same dtype; pages (n_pages,) int32 on the device; *_row_bytes = KVH *
// D* * element size. Returns a cudaError_t.
extern "C" int ff_paged_prefill_write(const void* kslab, const void* vslab,
                                      void* kpool, void* vpool,
                                      const void* pages, int n_pages, int s,
                                      int ps, int k_row_bytes,
                                      int v_row_bytes, void* stream) {
  if (n_pages <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pg = static_cast<const int*>(pages);
  const auto ptrs = {kslab, vslab, static_cast<const void*>(kpool),
                     static_cast<const void*>(vpool)};
  if (fits(16, k_row_bytes, v_row_bytes, ptrs))
    return launch<uint4>(kslab, vslab, kpool, vpool, pg, n_pages, s, ps, k_row_bytes, v_row_bytes, st);
  if (fits(4, k_row_bytes, v_row_bytes, ptrs))
    return launch<uint32_t>(kslab, vslab, kpool, vpool, pg, n_pages, s, ps, k_row_bytes, v_row_bytes, st);
  if (fits(2, k_row_bytes, v_row_bytes, ptrs))
    return launch<uint16_t>(kslab, vslab, kpool, vpool, pg, n_pages, s, ps, k_row_bytes, v_row_bytes, st);
  return launch<uint8_t>(kslab, vslab, kpool, vpool, pg, n_pages, s, ps, k_row_bytes, v_row_bytes, st);
}

// k/v slabs (1, S, KVH, D) of slab_dtype (f32 or bf16) into pools
// (P, page_size, KVH, D) of pool_dtype: int8 / fp8 with (P, KVH) f32 scale
// planes (quantize), or bf16 from an f32 slab with null scales (cast).
// Contiguous, 16-byte aligned, D a multiple of 16; pages (n_pages,) int32
// on the device. Returns a cudaError_t.
extern "C" int ff_paged_prefill_write_quant(
    const void* kslab, const void* vslab, void* kpool, void* vpool,
    void* kscale, void* vscale, const void* pages, int n_pages, int s,
    int ps, int kvh, int d, int slab_dtype, int pool_dtype, void* stream) {
  if (n_pages <= 0) return cudaSuccess;
  if (d % kQVec) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pg = static_cast<const int*>(pages);
  const bool quant = pool_dtype == ffk::kI8 || pool_dtype == ffk::kFP8;
  if (quant != (kscale != nullptr && vscale != nullptr)) return cudaErrorInvalidValue;
  if (!quant) {  // the cast: f32 slab into a bf16 pool
    if (slab_dtype != ffk::kF32 || pool_dtype != ffk::kBF16) return cudaErrorInvalidValue;
    return launch_quant<float, __nv_bfloat16>(kslab, vslab, kpool, vpool, nullptr, nullptr, pg,
                                              n_pages, s, ps, kvh, d, 0.f, st);
  }
  if (slab_dtype == ffk::kF32)
    return launch_quant_pool<float>(pool_dtype, kslab, vslab, kpool, vpool, kscale, vscale, pg, n_pages, s, ps, kvh, d, st);
  if (slab_dtype == ffk::kBF16)
    return launch_quant_pool<__nv_bfloat16>(pool_dtype, kslab, vslab, kpool, vpool, kscale, vscale, pg, n_pages, s, ps, kvh, d, st);
  return cudaErrorInvalidValue;
}
