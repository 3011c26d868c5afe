// Paged prefill write for Hopper (sm_90a), CUDA C++: every layer of a
// prefill in one launch.
//
// Replaces the JAX package's Pallas kernel paged_prefill_write_pallas
// (flexflow_tpu/ops/pallas_kernels.py:779, inline kernel :843) for every
// pool: the copy into a native pool, the cast into a bf16 pool under f32
// compute, and the quantization into an int8 / fp8 pool (:843-852).
//
// Each layer scatters a prefilled (1, S, KVH, D) k slab and v slab into
// its pools' pages pages[0 .. n): slab position t * page_size + r lands in
// pool page pages[t], row r. Rows past S in the last page are written as
// zeros, as the JAX oracle's jnp.pad does, so the pool is bitwise the
// oracle's. The serving engine holds every layer's slab when it writes a
// prefill, so one launch writes them all: the layers' pointers travel by
// value in the kernel's parameters (a Layers table, up to kMaxLayers
// layers: 3 KB of the 4 KB parameter space), with no pointer table copied
// to the device. All layers share S, the page size, KVH, D, the dtypes and
// the page list.
//
// Native pools. Blocks (layer, k-or-v, listed page, slice of the page)
// copy one page-sized tile between them, each thread issuing its four
// loads before its first store. The copy moves raw bits in the widest unit
// the row sizes and every layer's pointers allow (16, 4, 2 or 1 bytes), so
// any dtype copies exactly.
//
// Quantized pools, in one pass. A work item is a tile (layer, listed page,
// kv head, k-or-v): page_size x D values, whose amax sets the (page, kv
// head) scale. One CTA holds a tile of up to 16384 values (a 128-row page
// of D = 128) in its registers; a larger tile's rows are split over the
// C = 2, 4 or 8 CTAs of a thread block cluster. Each
// thread issues every 16-byte load of its share of the tile before it
// uses one (a (position, head) row is D contiguous values, so consecutive
// threads read consecutive bytes), rows past S counting as zeros. |x| is
// reduced in registers, then by warp shuffles, then across the CTA's warps
// in shared memory, then across the cluster's CTAs through distributed
// shared memory. The scale amax / qmax is computed once; the tile is
// quantized from the registers, x / max(scale, 1e-12) clipped to +-qmax,
// rounded half to even into int8 or to nearest even into fp8 e4m3fn
// (saturating cvt), and stored 16 payload bytes at a time. The
// slab is read once; max is order-free, so any reduction order gives the
// same amax. Both divisions are IEEE divisions (__fdiv_rn) and the build
// has no fast-math flag, so payload and scales are bitwise the plain
// version's (and the Pallas kernel's given its scales): a reciprocal
// multiply would not be. The cast into a bf16 pool is the same pass with a
// round-to-nearest-even conversion and no scale.
//
// The pools (and the scale planes) are updated IN PLACE: the JAX kernel
// aliased them input to output so untouched pages survived; here nothing
// but the listed pages (and their scales) is touched, which saves a copy
// of every pool per prefill.
//
// Bound on the H100: bytes. At S = 512, KVH = 8, D = 128 in bf16 a layer
// reads the two 1 MB slabs and writes 4 pages of k and of v (2 MB; 1 MB
// into an int8 / fp8 pool, plus 256 bytes of scales): ~4.2 MB (~3.1 MB)
// a layer, ~1.3 us (~0.9 us) at 3.35 TB/s, 32 layers ~40 us (~30 us).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace ffk;

namespace {

// layers one launch takes; ops/kernels.py PREFILL_WRITE_MAX_LAYERS
constexpr int kMaxLayers = 64;

// every layer's pointers, [k = 0 or v = 1][layer], passed by value
struct Layers {
  const void* slab[2][kMaxLayers];
  void* pool[2][kMaxLayers];
  float* scale[2][kMaxLayers];
};

// ---- the native copy ----------------------------------------------------

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // independent loads in flight per thread

// blockIdx.x = ((layer * 2 + kv) * n_pages + t) * slices + slice
template <typename U>
__global__ void __launch_bounds__(kThreads)
prefill_copy_kernel(const __grid_constant__ Layers lay,
                    const int* __restrict__ pages, int n_pages, int slices,
                    int s, int ps, int k_row, int v_row) {
  int b = blockIdx.x;
  const int slice = b % slices;
  b /= slices;
  const int t = b % n_pages;
  b /= n_pages;
  const int kv = b & 1;
  const int layer = b >> 1;
  const U* src = static_cast<const U*>(lay.slab[kv][layer]);
  U* dst = static_cast<U*>(lay.pool[kv][layer]);
  const size_t row = static_cast<size_t>(kv ? v_row : k_row);  // units per position
  const size_t page_units = row * ps;
  const size_t base = page_units * t;  // this page's first slab unit
  const size_t slab_units = row * s;
  U* page = dst + static_cast<size_t>(pages[t]) * page_units;
  const size_t first = static_cast<size_t>(slice) * kThreads * kUnroll + threadIdx.x;
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
cudaError_t launch_copy(const Layers& lay, int n_layers, const int* pages,
                        int n_pages, int s, int ps, int k_row_bytes,
                        int v_row_bytes, cudaStream_t stream) {
  const int k_row = k_row_bytes / static_cast<int>(sizeof(U));
  const int v_row = v_row_bytes / static_cast<int>(sizeof(U));
  const size_t page_units = static_cast<size_t>(max(k_row, v_row)) * ps;
  const size_t per_block = static_cast<size_t>(kThreads) * kUnroll;
  const int slices = static_cast<int>((page_units + per_block - 1) / per_block);
  const size_t blocks = static_cast<size_t>(n_layers) * 2 * n_pages * slices;
  if (blocks > 0x7fffffffu) return cudaErrorInvalidValue;
  prefill_copy_kernel<U><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      lay, pages, n_pages, slices, s, ps, k_row, v_row);
  return cudaGetLastError();
}

bool fits(size_t unit, int k_row_bytes, int v_row_bytes, const Layers& lay,
          int n_layers) {
  if (k_row_bytes % unit || v_row_bytes % unit) return false;
  for (int kv = 0; kv < 2; ++kv)
    for (int l = 0; l < n_layers; ++l)
      if (reinterpret_cast<uintptr_t>(lay.slab[kv][l]) % unit ||
          reinterpret_cast<uintptr_t>(lay.pool[kv][l]) % unit)
        return false;
  return true;
}

// ---- the quantizing / casting write -------------------------------------

constexpr int kQThreads = 256;
constexpr int kQVec = 16;   // values in a unit: 16 output bytes (one-byte pools)
constexpr int kQUnits = 4;  // units a thread holds: a CTA holds 1024 units
constexpr int kQWarps = kQThreads / 32;

// 16 already-clipped values into storage O. The conversions run on the
// SM's quarter-rate pipe, which the IEEE divisions also use: int8 rounds
// by adding 1.5 * 2^23 instead (in [2^23, 2^24) floats are the integers,
// so the add rounds |x| <= 127 half to even, as __float2int_rn does, and
// the sum's low mantissa bits are the integer: full-rate FADD and IADD);
// fp8 converts two values an instruction.
template <typename O>
__device__ __forceinline__ void store16(O* dst, const float* x);
template <>
__device__ __forceinline__ void store16<int8_t>(int8_t* dst, const float* x) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kQVec; ++i) {
    const unsigned byte = (__float_as_uint(x[i] + 12582912.f) - 0x4b400000u) & 0xffu;
    w[i / 4] |= byte << (8 * (i % 4));
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}
template <>
__device__ __forceinline__ void store16<__nv_fp8_e4m3>(__nv_fp8_e4m3* dst, const float* x) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kQVec; i += 2) {
    const unsigned pair =
        __nv_cvt_float2_to_fp8x2(make_float2(x[i], x[i + 1]), __NV_SATFINITE, __NV_E4M3);
    w[i / 4] |= pair << (8 * (i % 4));  // x[i] in the low byte
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}
template <>
__device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* dst, const float* x) {
  reinterpret_cast<uint4*>(dst)[0] = pack16<__nv_bfloat16>(x);
  reinterpret_cast<uint4*>(dst)[1] = pack16<__nv_bfloat16>(x + 8);
}

// One unit (16 values of T, 16-byte aligned) from its raw 16-byte words
template <typename T>
__device__ __forceinline__ void unpack_unit(const uint4* raw, float* x) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int v = 0; v < kQVec / kPer; ++v) unpack16<T>(raw[v], x + v * kPer);
}

// One tile (layer, listed page, kv head, k-or-v) per cluster of C CTAs
// (C = 1: no cluster). A CTA's loads and its arithmetic (the IEEE
// divisions and conversions, on the SM's quarter-rate pipe) run one after
// the other, so a bf16 slab's kernel is held to 80 registers (a few bytes
// spill) for three CTAs an SM, letting one's loads overlap another's
// arithmetic (two CTAs an SM at ~90 registers read 7% slower on the H100);
// blockIdx.x / C = ((layer * 2 + kv) * n_pages + t) * kvh + h, and CTA
// rank r of the cluster takes the tile's rows [r ps / C, (r + 1) ps / C).
// The wrapper keeps a CTA's share within kQThreads * kQUnits units.
template <typename T, typename O, int C>
__global__ void __launch_bounds__(kQThreads, sizeof(T) == 2 ? 3 : 2)
prefill_quant_kernel(const __grid_constant__ Layers lay,
                     const int* __restrict__ pages, int n_pages, int s,
                     int ps, int kvh, int d, float qmax) {
  constexpr bool kQuant = sizeof(O) == 1;
  constexpr int kRaw = kQVec * sizeof(T) / 16;  // 16-byte words a unit
  __shared__ float warp_s[kQWarps];
  __shared__ float amax_s[2];  // this CTA's amax, then the tile's
  int b = blockIdx.x / C;
  const int rank = blockIdx.x % C;  // the CTA's rank in its (C, 1, 1) cluster
  const int h = b % kvh;
  b /= kvh;
  const int t = b % n_pages;
  b /= n_pages;
  const int kv = b & 1;
  const int layer = b >> 1;
  const T* src = static_cast<const T*>(lay.slab[kv][layer]);
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(kvh) * d;  // values per position
  const int upr = d / kQVec;                        // units per (position, head)
  const int r0 = rank * ps / C;
  const int n_units = ((rank + 1) * ps / C - r0) * upr;
  const int page_id = pages[t];

  // 1. every load in flight before any is used; rows past S are zeros
  uint4 raw[kQUnits][kRaw];
#pragma unroll
  for (int j = 0; j < kQUnits; ++j) {
    const int u = tid + j * kQThreads;
    const int pos = t * ps + r0 + u / upr;
    if (u < n_units && pos < s) {
      const uint4* p = reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(pos) * row + static_cast<size_t>(h) * d + (u % upr) * kQVec);
#pragma unroll
      for (int i = 0; i < kRaw; ++i) raw[j][i] = __ldg(p + i);
    } else {
#pragma unroll
      for (int i = 0; i < kRaw; ++i) raw[j][i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // 2. the tile's amax: registers, warp shuffles, the CTA's warps, the
  //    cluster's CTAs; then the scale, once
  float den = 1.f;
  if constexpr (kQuant) {
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < kQUnits; ++j) {
      float x[kQVec];
      unpack_unit<T>(raw[j], x);
#pragma unroll
      for (int k = 0; k < kQVec; ++k) m = fmaxf(m, fabsf(x[k]));
    }
    m = warp_max(m, 32);
    if ((tid & 31) == 0) warp_s[tid >> 5] = m;
    __syncthreads();
    if (tid < 32) {
      m = warp_max(tid < kQWarps ? warp_s[tid] : 0.f, 32);
      if (tid == 0) amax_s[0] = m;
    }
    if constexpr (C > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // every CTA's amax_s[0] is written
      if (tid < 32) {
        m = tid < C ? *cluster.map_shared_rank(&amax_s[0], tid) : 0.f;
        m = warp_max(m, 32);
        if (tid == 0) amax_s[1] = m;
      }
      cluster.sync();  // no CTA leaves while another reads its amax
    } else {
      if (tid == 0) amax_s[1] = amax_s[0];
      __syncthreads();
    }
    const float scale = __fdiv_rn(amax_s[1], qmax);
    den = fmaxf(scale, 1e-12f);  // the divisor
    if (rank == 0 && tid == 0)
      lay.scale[kv][layer][static_cast<size_t>(page_id) * kvh + h] = scale;
  }

  // 3. quantize (or cast) from the registers, 16 values a unit
  O* page = static_cast<O*>(lay.pool[kv][layer]) + static_cast<size_t>(page_id) * ps * row;
#pragma unroll
  for (int j = 0; j < kQUnits; ++j) {
    const int u = tid + j * kQThreads;
    if (u < n_units) {
      float x[kQVec];
      unpack_unit<T>(raw[j], x);
      if constexpr (kQuant) {
#pragma unroll
        for (int k = 0; k < kQVec; ++k)
          x[k] = fminf(fmaxf(__fdiv_rn(x[k], den), -qmax), qmax);
      }
      store16<O>(page + static_cast<size_t>(r0 + u / upr) * row + static_cast<size_t>(h) * d +
                     (u % upr) * kQVec,
                 x);
    }
  }
}

template <typename T, typename O, int C>
cudaError_t launch_quant_c(const Layers& lay, int n_layers, const int* pages,
                           int n_pages, int s, int ps, int kvh, int d,
                           float qmax, cudaStream_t stream) {
  const size_t blocks = static_cast<size_t>(n_layers) * 2 * n_pages * kvh * C;
  if (blocks > 0x7fffffffu) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kQThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, prefill_quant_kernel<T, O, C>, lay, pages,
                                             n_pages, s, ps, kvh, d, qmax);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, typename O>
cudaError_t launch_quant(const Layers& lay, int n_layers, const int* pages,
                         int n_pages, int s, int ps, int kvh, int d,
                         float qmax, int cluster, cudaStream_t st) {
  switch (cluster) {
    case 1: return launch_quant_c<T, O, 1>(lay, n_layers, pages, n_pages, s, ps, kvh, d, qmax, st);
    case 2: return launch_quant_c<T, O, 2>(lay, n_layers, pages, n_pages, s, ps, kvh, d, qmax, st);
    case 4: return launch_quant_c<T, O, 4>(lay, n_layers, pages, n_pages, s, ps, kvh, d, qmax, st);
    case 8: return launch_quant_c<T, O, 8>(lay, n_layers, pages, n_pages, s, ps, kvh, d, qmax, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_quant_pool(int pool_dtype, const Layers& lay, int n_layers,
                              const int* pages, int n_pages, int s, int ps,
                              int kvh, int d, int cluster, cudaStream_t st) {
  switch (pool_dtype) {
    case ffk::kI8:
      return launch_quant<T, int8_t>(lay, n_layers, pages, n_pages, s, ps, kvh, d, 127.f, cluster, st);
    case ffk::kFP8:
      return launch_quant<T, __nv_fp8_e4m3>(lay, n_layers, pages, n_pages, s, ps, kvh, d, 448.f,
                                            cluster, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// n_layers (1 .. 64) layers' k/v slabs (1, S, KVH, D*) and pools
// (P, page_size, KVH, D*), contiguous, every layer alike: kslab[l],
// vslab[l], kpool[l], vpool[l] are layer l's pointers, kscale / vscale
// arrays of its (P, KVH) f32 scale planes or null. pages (n_pages,) int32
// on the device, shared by the layers.
//   pool_dtype < 0: the copy (slab and pool of one dtype, elem_bytes each;
//     dk and dv may differ; no scales).
//   otherwise slab_dtype (f32 or bf16) into pool_dtype: int8 / fp8 with
//     scales (quantize), or bf16 from an f32 slab with null scales (cast);
//     dk == dv a multiple of 16, 16-byte aligned pointers; each tile's
//     rows split over `cluster` (1, 2, 4 or 8) CTAs of a cluster, a CTA
//     holding at most 1024 16-value units.
// Returns a cudaError_t.
extern "C" int ff_paged_prefill_write_layers(
    const void* const* kslab, const void* const* vslab, void* const* kpool,
    void* const* vpool, void* const* kscale, void* const* vscale, int n_layers,
    const void* pages, int n_pages, int s, int ps, int kvh, int dk, int dv,
    int elem_bytes, int slab_dtype, int pool_dtype, int cluster, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  if (n_pages <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pg = static_cast<const int*>(pages);
  Layers lay = {};
  for (int l = 0; l < n_layers; ++l) {
    lay.slab[0][l] = kslab[l];
    lay.slab[1][l] = vslab[l];
    lay.pool[0][l] = kpool[l];
    lay.pool[1][l] = vpool[l];
    lay.scale[0][l] = kscale ? static_cast<float*>(kscale[l]) : nullptr;
    lay.scale[1][l] = vscale ? static_cast<float*>(vscale[l]) : nullptr;
  }
  if (pool_dtype < 0) {  // the copy
    const int kb = kvh * dk * elem_bytes, vb = kvh * dv * elem_bytes;
    if (fits(16, kb, vb, lay, n_layers))
      return launch_copy<uint4>(lay, n_layers, pg, n_pages, s, ps, kb, vb, st);
    if (fits(4, kb, vb, lay, n_layers))
      return launch_copy<uint32_t>(lay, n_layers, pg, n_pages, s, ps, kb, vb, st);
    if (fits(2, kb, vb, lay, n_layers))
      return launch_copy<uint16_t>(lay, n_layers, pg, n_pages, s, ps, kb, vb, st);
    return launch_copy<uint8_t>(lay, n_layers, pg, n_pages, s, ps, kb, vb, st);
  }
  const int d = dk;
  if (dk != dv || d % kQVec || cluster < 1 || cluster > 8) return cudaErrorInvalidValue;
  if ((ps + cluster - 1) / cluster * (d / kQVec) > kQThreads * kQUnits) return cudaErrorInvalidValue;
  const bool quant = pool_dtype == ffk::kI8 || pool_dtype == ffk::kFP8;
  if (quant != (kscale != nullptr && vscale != nullptr)) return cudaErrorInvalidValue;
  if (!quant) {  // the cast: f32 slab into a bf16 pool
    if (slab_dtype != ffk::kF32 || pool_dtype != ffk::kBF16) return cudaErrorInvalidValue;
    return launch_quant<float, __nv_bfloat16>(lay, n_layers, pg, n_pages, s, ps, kvh, d, 0.f,
                                              cluster, st);
  }
  if (slab_dtype == ffk::kF32)
    return launch_quant_pool<float>(pool_dtype, lay, n_layers, pg, n_pages, s, ps, kvh, d, cluster, st);
  if (slab_dtype == ffk::kBF16)
    return launch_quant_pool<__nv_bfloat16>(pool_dtype, lay, n_layers, pg, n_pages, s, ps, kvh, d,
                                            cluster, st);
  return cudaErrorInvalidValue;
}
