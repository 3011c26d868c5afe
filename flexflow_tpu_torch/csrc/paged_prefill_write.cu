// Paged prefill write for Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernel paged_prefill_write_pallas
// (flexflow_tpu/ops/pallas_kernels.py:779, inline kernel :843) for native
// (unquantized) pools.
//
// Scatters a prefilled (1, S, KVH, D) k slab and v slab into the pool pages
// pages[0 .. n): slab position t * page_size + r lands in pool page
// pages[t], row r. Rows past S in the last page are written as zeros, as
// the JAX oracle's jnp.pad does, so the pool is bitwise the oracle's.
//
// Design. Blocks (listed page, k-or-v, slice of the page) copy one page-
// sized tile between them, each thread keeping four independent loads in
// flight.
// The pool is updated IN PLACE: the JAX kernel aliased the whole pool
// input to its output so untouched pages survived; here nothing but the
// listed pages is touched, which saves a copy of the whole pool per
// prefill. The copy moves raw bits in the widest unit the row size and the
// pointers' alignment allow (16, 4, 2 or 1 bytes), so any dtype copies
// exactly.
//
// Bound on the H100: at S = 512, KVH = 8, D = 128 in bf16 the function
// reads the two 1 MB slabs and writes 4 pages of k and of v (2 MB), ~4.2 MB
// in all, ~1.3 us at 3.35 TB/s; bytes bound (no arithmetic).
#include <initializer_list>

#include "common.cuh"

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
