// The optimizer update of up to kMaxLeaves weights of one storage dtype in
// one launch, for Hopper (sm_90a), CUDA C++.
//
// The port's own kernel, not a TPU kernel's: the JAX package's FusedUpdate
// (flexflow_tpu/runtime/optimizer.py:40) flattens every weight of one
// storage dtype into one vector and leaves the update to XLA's fusion. Here
// the weights, their gradients and their optimizer state stay where they
// are: the leaf table holds a pointer to each leaf's weight, gradient and
// state (m Adam only, v SGD with momentum and Adam). FusedUpdate passes
// pointers into its flat per-bucket state vectors at each leaf's offset;
// the per-leaf optimizer passes its own state tensors. Both optimizers'
// card update is this kernel, one launch a dtype bucket per kMaxLeaves
// leaves (ops/kernels.py fused_update):
//
//   SGD:       g = g + wd w;  v = mom v + g;  step = nesterov ? g + mom v : v
//              (plain: step = g);  w = w - lr step
//   Adam:      g = g + wd w;  m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
//              w = w - (lr m) / (sqrt(v) + eps),   lr = alpha_t
//
// in f32 on values read from f32 or bf16 storage; the results are rounded
// to the storage dtype once. The term g + wd w is skipped when wd is 0 (in
// this kernel and in the per-leaf update alike).
//
// Bitwise identity with the per-leaf torch update (optimizer.py
// apply_update_plain, kernels.py update_math) is the contract, as JAX's
// docstring states it for its fused update. nvcc contracts a * b + c into a
// fused multiply-add unless told not to, and the per-leaf update rounds
// after every operation, so every operation here is an explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn) in the
// per-leaf formula's order, and bf16 rounds to nearest even. Vector access
// changes no rounding: each element's arithmetic is the scalar one.
//
// lr (the scheduled learning rate, or Adam's bias-corrected alpha_t) is
// read from a device f32 scalar, so a step captured as a CUDA graph
// replays with the current value. An optional device flag `finite` (the
// divergence guard's verdict) makes the launch write nothing when false.
// The leaf table rides by value in a __grid_constant__ parameter struct,
// so a captured graph holds it too.
//
// Bound on the H100: bytes. Each element reads w and g and writes w (6 B
// in bf16), plus v (SGD with momentum, 10 B) or m and v (Adam, 14 B): at
// the flagship's 1.21 B bf16 weights, 2.2 / 3.6 / 5.1 ms at 3.35 TB/s.
// Adam's IEEE division and square root are long instruction sequences
// (~1-2 ms of instruction time at that size), hidden only if enough elements are
// in flight; they stay, since bitwise identity is the contract.
//
// Design (toward the bytes bound):
// - 16-byte vectors: every access to w, g, m and v is one 16-byte load or
//   store (8 bf16 or 4 f32 values; an f32 gradient of bf16 weights takes
//   two 16-byte loads for 8 elements), with streaming hints (__ldcs /
//   __stcs: each value is touched once).
// - Leaf-aligned chunks: a leaf is cut into chunks of kThreads x kUnroll
//   vectors (4096 bf16 or 2048 f32 elements); no chunk spans two leaves.
//   The table carries the prefix sums of the leaves' chunk counts, and a
//   block finds its chunk's leaf by a binary search (<= 7 steps at 128
//   leaves) and loads the leaf's pointers once a chunk.
// - Edges: a leaf's pointers may sit off a 16-byte boundary (a view with a
//   storage offset, a slice of a flat state vector) and its size need not
//   be a multiple of the vector. The host computes each leaf's head (the
//   elements before its weight pointer reaches a 16-byte boundary) and
//   whether every pointer of the leaf is aligned there (ops/kernels.py
//   fused_update_plan): chunk 0 updates the head element by element, the
//   body goes in vectors, the last chunk updates the tail (< one vector)
//   element by element. A leaf whose pointers cannot all be aligned at
//   one element is updated element by element throughout.
// - Several vectors in flight: each thread starts the loads of all kUnroll
//   vectors of its chunk (w, g and the state of 4 x 8 elements) before any
//   arithmetic: 16-40 KB of loads a block of 128 threads, 3-5 blocks an SM
//   (98-158 registers a thread).
// - A persistent grid: SMs x resident blocks (the occupancy calculator,
//   cached per device), striding over the chunks. Blocks of 128 threads
//   rather than 256 let Adam's 158-register kernel hold 3 blocks an SM
//   instead of 1 (1.8% faster on the H100, no change for SGD).
// Indices are 64-bit: the flagship's bucket is past 2^31 bytes.
// An optional device counter (vec_count) gathers the elements the 16-byte
// path stored, one atomic a thread at the end of the launch: what share of
// the bytes really went through vectors is read off the card, not the plan.
//
// kMaxLeaves = 128 leaves of four pointers each make a ~5.9 KB parameter
// struct, past the classic 4 KB limit: kernel parameters up to 32764 bytes
// need CUDA 12.1 or later, in nvcc and at run time (the card's machine
// has nvcc 12.9). ops/kernels.py FUSED_UPDATE_MAX_LEAVES follows kMaxLeaves.
#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace ffk;

constexpr int kMaxLeaves = 128;
constexpr int kThreads = 128;
constexpr int kUnroll = 4;
constexpr int kMaxDevices = 64;

enum Kind : int { kSGD = 0, kMomentum = 1, kNesterov = 2, kAdam = 3 };
// leaf flags, shared with ops/kernels.py (fused_update's launch)
enum LeafFlag : unsigned { kGradF32 = 1, kVector = 2 };

struct Leaves {
  void* w[kMaxLeaves];
  const void* g[kMaxLeaves];
  void* m[kMaxLeaves];
  void* v[kMaxLeaves];
  long long numel[kMaxLeaves];
  int chunk_end[kMaxLeaves];         // prefix sums of the leaves' chunk counts
  unsigned char head[kMaxLeaves];    // elements before the vector body
  unsigned char flags[kMaxLeaves];   // kGradF32 | kVector
  int n;
};
static_assert(sizeof(Leaves) <= 32764, "kernel parameters past 32764 bytes");

struct Hyper {
  float wd, mom, b1, c1, b2, c2, eps;  // c1 = 1 - b1, c2 = 1 - b2
};

// One element's update in f32: returns the new weight; m and v in and out
// (unrounded: the caller rounds them to storage once).
template <int KIND, bool WD>
__device__ __forceinline__ float update_one(float w, float g, float& m, float& v,
                                            const Hyper& hp, float lr) {
  if (WD) g = __fadd_rn(g, __fmul_rn(hp.wd, w));
  if constexpr (KIND == kSGD) {
    return __fsub_rn(w, __fmul_rn(lr, g));
  } else if constexpr (KIND == kMomentum || KIND == kNesterov) {
    v = __fadd_rn(__fmul_rn(hp.mom, v), g);
    const float step = KIND == kNesterov ? __fadd_rn(g, __fmul_rn(hp.mom, v)) : v;
    return __fsub_rn(w, __fmul_rn(lr, step));
  } else {
    m = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.c1, g));
    v = __fadd_rn(__fmul_rn(hp.b2, v), __fmul_rn(__fmul_rn(hp.c2, g), g));
    return __fsub_rn(w, __fdiv_rn(__fmul_rn(lr, m), __fadd_rn(__fsqrt_rn(v), hp.eps)));
  }
}

// Element j of one leaf, scalar loads and stores (heads, tails, and leaves
// whose pointers cannot all be aligned).
template <int KIND, typename T, bool WD>
__device__ __forceinline__ void update_scalar(T* w, const void* g, bool g_f32, T* m, T* v,
                                              long long j, const Hyper& hp, float lr) {
  const float wf = to_f32(w[j]);
  const float gf = g_f32 ? static_cast<const float*>(g)[j]
                         : to_f32(static_cast<const T*>(g)[j]);
  float mf = 0.f, vf = 0.f;
  if constexpr (KIND == kAdam) mf = to_f32(m[j]);
  if constexpr (KIND != kSGD) vf = to_f32(v[j]);
  const float wn = update_one<KIND, WD>(wf, gf, mf, vf, hp, lr);
  if constexpr (KIND == kAdam) m[j] = from_f32<T>(mf);
  if constexpr (KIND != kSGD) v[j] = from_f32<T>(vf);
  w[j] = from_f32<T>(wn);
}

// The vector body of one chunk: nvec 16-byte vectors of T from element a
// (aligned for every pointer), vector i of the chunk taken by thread
// i % kThreads. Every load of the thread's kUnroll vectors is started before
// any arithmetic. Returns the vectors this thread stored.
template <int KIND, typename T, bool WD, bool GF32>
__device__ __forceinline__ int update_vectors(T* w, const void* g_raw, T* m, T* v,
                                               long long a, int nvec, const Hyper& hp,
                                               float lr) {
  constexpr int kVec = 16 / sizeof(T);
  using G = typename std::conditional<GF32, float, T>::type;
  constexpr int kGPer = 16 / sizeof(G);      // gradient values a 16-byte load
  constexpr int kGLoads = kVec / kGPer;      // 1, or 2 for f32 grads of bf16
  const G* g = static_cast<const G*>(g_raw);
  uint4 rw[kUnroll], rg[kUnroll][kGLoads], rm[kUnroll], rv[kUnroll];
  int stored = 0;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = u * kThreads + static_cast<int>(threadIdx.x);
    if (i < nvec) {
      const long long e = a + static_cast<long long>(i) * kVec;
      rw[u] = __ldcs(reinterpret_cast<const uint4*>(w + e));
#pragma unroll
      for (int q = 0; q < kGLoads; ++q)
        rg[u][q] = __ldcs(reinterpret_cast<const uint4*>(g + e + q * kGPer));
      if constexpr (KIND == kAdam) rm[u] = __ldcs(reinterpret_cast<const uint4*>(m + e));
      if constexpr (KIND != kSGD) rv[u] = __ldcs(reinterpret_cast<const uint4*>(v + e));
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = u * kThreads + static_cast<int>(threadIdx.x);
    if (i < nvec) {
      const long long e = a + static_cast<long long>(i) * kVec;
      float wf[kVec], gf[kVec], mf[kVec], vf[kVec];
      unpack16<T>(rw[u], wf);
#pragma unroll
      for (int q = 0; q < kGLoads; ++q) unpack16<G>(rg[u][q], gf + q * kGPer);
      if constexpr (KIND == kAdam) unpack16<T>(rm[u], mf);
      if constexpr (KIND != kSGD) unpack16<T>(rv[u], vf);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        wf[k] = update_one<KIND, WD>(wf[k], gf[k], mf[k], vf[k], hp, lr);
      if constexpr (KIND == kAdam) __stcs(reinterpret_cast<uint4*>(m + e), pack16<T>(mf));
      if constexpr (KIND != kSGD) __stcs(reinterpret_cast<uint4*>(v + e), pack16<T>(vf));
      __stcs(reinterpret_cast<uint4*>(w + e), pack16<T>(wf));
      ++stored;
    }
  }
  return stored;
}

template <int KIND, typename T, bool WD>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const __grid_constant__ Leaves lv, const Hyper hp,
                    const float* __restrict__ lr_p, const bool* __restrict__ finite,
                    unsigned long long* __restrict__ vec_count) {
  if (finite != nullptr && !*finite) return;
  constexpr int kVec = 16 / sizeof(T);
  constexpr long long kChunk = static_cast<long long>(kThreads) * kUnroll * kVec;
  const float lr = *lr_p;
  const int chunks = lv.chunk_end[lv.n - 1];
  long long vectors = 0;  // this thread's vector stores (for vec_count)
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    // the chunk's leaf: the first whose chunk prefix sum passes c
    int lo = 0, hi = lv.n - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (lv.chunk_end[mid] > c) hi = mid;
      else lo = mid + 1;
    }
    const int leaf = lo;
    const long long k = c - (leaf ? lv.chunk_end[leaf - 1] : 0);
    const long long n = lv.numel[leaf];
    const long long head = lv.head[leaf];
    const unsigned flags = lv.flags[leaf];
    // the chunk's elements: [s0, a) one by one, [a, b) in vectors, [b, e)
    // one by one (ops/kernels.py fused_update_chunk_spans)
    long long s0, a, b, e;
    if (flags & kVector) {
      s0 = k == 0 ? 0 : head + k * kChunk;
      a = k == 0 ? (head < n ? head : n) : s0;
      e = head + (k + 1) * kChunk;
      e = e < n ? e : n;
      b = a + (e - a) / kVec * kVec;
    } else {
      s0 = k * kChunk;
      a = b = s0;
      e = s0 + kChunk < n ? s0 + kChunk : n;
    }
    T* w = static_cast<T*>(lv.w[leaf]);
    const void* g = lv.g[leaf];
    T* m = static_cast<T*>(lv.m[leaf]);
    T* v = static_cast<T*>(lv.v[leaf]);
    const bool g_f32 = flags & kGradF32;
    for (long long j = s0 + threadIdx.x; j < a; j += kThreads)
      update_scalar<KIND, T, WD>(w, g, g_f32, m, v, j, hp, lr);
    if (b > a) {
      const int nvec = static_cast<int>((b - a) / kVec);
      vectors += g_f32 ? update_vectors<KIND, T, WD, true>(w, g, m, v, a, nvec, hp, lr)
                       : update_vectors<KIND, T, WD, false>(w, g, m, v, a, nvec, hp, lr);
    }
    for (long long j = b + threadIdx.x; j < e; j += kThreads)
      update_scalar<KIND, T, WD>(w, g, g_f32, m, v, j, hp, lr);
  }
  if (vec_count != nullptr && vectors > 0)
    atomicAdd(vec_count, static_cast<unsigned long long>(vectors * kVec));
}

// Blocks a launch: SMs x the blocks an SM holds at once, found once per
// (kernel, device) by the occupancy calculator; fewer if there are fewer
// chunks.
template <int KIND, typename T, bool WD>
cudaError_t launch_t(const Leaves& lv, const Hyper& hp, const float* lr, const bool* finite,
                     unsigned long long* count, cudaStream_t stream) {
  static std::atomic<int> resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int slots = resident[dev].load(std::memory_order_relaxed);
  if (slots == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_update_kernel<KIND, T, WD>, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    slots = (per_sm > 0 ? per_sm : 1) * sms;
    resident[dev].store(slots, std::memory_order_relaxed);
  }
  const int chunks = lv.chunk_end[lv.n - 1];
  const int grid = chunks < slots ? chunks : slots;
  fused_update_kernel<KIND, T, WD><<<grid, kThreads, 0, stream>>>(lv, hp, lr, finite,
                                                                          count);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int kind, bool wd_on, const Leaves& lv, const Hyper& hp, const float* lr,
                   const bool* finite, unsigned long long* count, cudaStream_t st) {
#define FF_UPDATE_KIND(K)                                                  \
  case K:                                                                  \
    return wd_on ? launch_t<K, T, true>(lv, hp, lr, finite, count, st)     \
                 : launch_t<K, T, false>(lv, hp, lr, finite, count, st);
  switch (kind) {
    FF_UPDATE_KIND(kSGD)
    FF_UPDATE_KIND(kMomentum)
    FF_UPDATE_KIND(kNesterov)
    FF_UPDATE_KIND(kAdam)
  }
#undef FF_UPDATE_KIND
  return cudaErrorInvalidValue;
}

}  // namespace

// One launch over n_leaves (1..128) leaves of one storage dtype (f32 or
// bf16). Leaf i: w[i], g[i] its weight and gradient (numel[i] elements
// each, contiguous), m[i] and v[i] its state in the weight dtype (m Adam
// only, v SGD with momentum and Adam; the arrays m / v may be null when
// the rule has none); flags[i]: 1 the gradient is f32 rather than the
// weight's dtype, 2 the leaf's body takes 16-byte vectors from element
// head[i] on; chunk_end[i]: the prefix sum of the leaves' chunk counts
// (ops/kernels.py fused_update_plan). chunk: the elements of a chunk the
// plan assumed, which must be this build's. kind: 0 SGD, 1 SGD with
// momentum, 2 nesterov, 3 Adam. lr: device f32 scalar; finite: device bool
// scalar or null. vec_count: null, or a device u64 to which the launch adds
// the elements its 16-byte path stored (a measurement: the callers on the
// training path pass null). Returns a cudaError_t.
extern "C" int ff_fused_update(void* const* w, const void* const* g, void* const* m,
                               void* const* v, const long long* numel, const int* flags,
                               const int* head, const int* chunk_end, int n_leaves,
                               long long chunk, int dtype, int kind, int wd_on, float wd,
                               float mom, float b1, float c1, float b2, float c2, float eps,
                               const void* lr, const void* finite, void* vec_count,
                               void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return cudaErrorInvalidValue;
  const int elem = dtype == kF32 ? 4 : dtype == kBF16 ? 2 : 0;
  if (elem == 0 || chunk != static_cast<long long>(kThreads) * kUnroll * (16 / elem))
    return cudaErrorInvalidValue;
  if ((kind == kAdam && m == nullptr) || (kind != kSGD && v == nullptr))
    return cudaErrorInvalidValue;
  Leaves lv;
  for (int i = 0; i < kMaxLeaves; ++i) {
    const bool live = i < n_leaves;
    lv.w[i] = live ? w[i] : nullptr;
    lv.g[i] = live ? g[i] : nullptr;
    lv.m[i] = live && kind == kAdam ? m[i] : nullptr;
    lv.v[i] = live && kind != kSGD ? v[i] : nullptr;
    lv.numel[i] = live ? numel[i] : 0;
    lv.chunk_end[i] = chunk_end[live ? i : n_leaves - 1];
    lv.head[i] = static_cast<unsigned char>(live ? head[i] : 0);
    lv.flags[i] = static_cast<unsigned char>(live ? flags[i] : 0);
  }
  lv.n = n_leaves;
  if (lv.chunk_end[n_leaves - 1] == 0) return cudaSuccess;
  const Hyper hp{wd, mom, b1, c1, b2, c2, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lr_p = static_cast<const float*>(lr);
  const bool* fin = static_cast<const bool*>(finite);
  auto* count = static_cast<unsigned long long*>(vec_count);
  if (dtype == kF32) return launch<float>(kind, wd_on != 0, lv, hp, lr_p, fin, count, st);
  return launch<__nv_bfloat16>(kind, wd_on != 0, lv, hp, lr_p, fin, count, st);
}
