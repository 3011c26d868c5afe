// The optimizer update of one dtype bucket of weights in one launch, for
// Hopper (sm_90a), CUDA C++.
//
// The port's own kernel, not a TPU kernel's: the JAX package's FusedUpdate
// (flexflow_tpu/runtime/optimizer.py:40) flattens every weight of one
// storage dtype into one vector and leaves the update to XLA's fusion. Here
// the weights and their gradients stay separate tensors (no concatenation
// pass) and the optimizer state is one flat vector a bucket, as JAX stores
// it. One launch walks every leaf of the bucket (up to kMaxLeaves, more in
// several launches) as a multi-tensor apply:
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
// apply_update, kernels.py update_math) is the contract, as JAX's
// docstring states it for its fused update. nvcc contracts a * b + c into a
// fused multiply-add unless told not to, and the per-leaf update rounds
// after every operation, so every operation here is an explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn) in the
// per-leaf formula's order, and bf16 rounds with __float2bfloat16_rn.
//
// lr (the scheduled learning rate, or Adam's bias-corrected alpha_t) is
// read from a device f32 scalar, so a step captured as a CUDA graph
// replays with the current value. An optional device flag `finite` (the
// divergence guard's verdict) makes the launch write nothing when false.
//
// Bound on the H100: bytes. Each element reads w and g and writes w (6 B
// in bf16), plus v (SGD with momentum, 10 B) or m and v (Adam, 14 B): at
// the flagship's 1.21 B bf16 weights, 2.2 / 3.6 / 5.1 ms at 3.35 TB/s.
//
// Design (simple first): a grid-stride loop over tiles of 2048 elements of
// the bucket; a thread takes elements threadIdx.x + k blockDim.x of a
// tile, so a warp reads 32 consecutive elements of one leaf. Each thread
// finds its leaf by walking the table's prefix sums forward (its element
// index only grows). Indices are 64-bit: the flagship's bucket is past
// 2^31 bytes. Vector loads and a persistent grid are later work.
#include "common.cuh"

namespace {

using namespace ffk;

// leaves a launch: the table rides in the kernel's parameter space (the
// classic 4 KB limit), so a captured graph holds it by value
constexpr int kMaxLeaves = 128;
constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr long long kTile = static_cast<long long>(kThreads) * kPerThread;

enum Kind : int { kSGD = 0, kMomentum = 1, kNesterov = 2, kAdam = 3 };

struct Leaves {
  void* w[kMaxLeaves];
  const void* g[kMaxLeaves];
  long long end[kMaxLeaves];      // prefix sums of the leaves' sizes
  unsigned char g_f32[kMaxLeaves];  // 1: the grad is f32, 0: the weight's dtype
  int n;
};

struct Hyper {
  float wd, mom, b1, c1, b2, c2, eps;  // c1 = 1 - b1, c2 = 1 - b2
};

template <typename T>
__device__ __forceinline__ T round_rn(float x);
template <>
__device__ __forceinline__ float round_rn<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 round_rn<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int KIND, typename T, bool WD>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const __grid_constant__ Leaves lv, T* __restrict__ m,
                    T* __restrict__ v, long long state_base, Hyper hp,
                    const float* __restrict__ lr_p,
                    const bool* __restrict__ finite) {
  if (finite != nullptr && !*finite) return;
  const float lr = *lr_p;
  const long long total = lv.end[lv.n - 1];
  int leaf = 0;
  for (long long base = static_cast<long long>(blockIdx.x) * kTile;
       base < total; base += static_cast<long long>(gridDim.x) * kTile) {
#pragma unroll 1
    for (int k = 0; k < kPerThread; ++k) {
      const long long i = base + static_cast<long long>(k) * kThreads + threadIdx.x;
      if (i >= total) break;
      while (lv.end[leaf] <= i) ++leaf;
      const long long j = i - (leaf ? lv.end[leaf - 1] : 0);
      T* w = static_cast<T*>(lv.w[leaf]);
      const float wf = to_f32(w[j]);
      float g = lv.g_f32[leaf] ? static_cast<const float*>(lv.g[leaf])[j]
                               : to_f32(static_cast<const T*>(lv.g[leaf])[j]);
      if (WD) g = __fadd_rn(g, __fmul_rn(hp.wd, wf));
      const long long s = state_base + i;
      float wn;
      if (KIND == kSGD) {
        wn = __fsub_rn(wf, __fmul_rn(lr, g));
      } else if (KIND == kMomentum || KIND == kNesterov) {
        const float vf = __fadd_rn(__fmul_rn(hp.mom, to_f32(v[s])), g);
        v[s] = round_rn<T>(vf);
        const float step = KIND == kNesterov ? __fadd_rn(g, __fmul_rn(hp.mom, vf)) : vf;
        wn = __fsub_rn(wf, __fmul_rn(lr, step));
      } else {
        const float mf = __fadd_rn(__fmul_rn(hp.b1, to_f32(m[s])), __fmul_rn(hp.c1, g));
        const float vf =
            __fadd_rn(__fmul_rn(hp.b2, to_f32(v[s])), __fmul_rn(__fmul_rn(hp.c2, g), g));
        m[s] = round_rn<T>(mf);
        v[s] = round_rn<T>(vf);
        wn = __fsub_rn(wf, __fdiv_rn(__fmul_rn(lr, mf), __fadd_rn(__fsqrt_rn(vf), hp.eps)));
      }
      w[j] = round_rn<T>(wn);
    }
  }
}

template <int KIND, typename T>
cudaError_t launch_t(const Leaves& lv, void* m, void* v, long long state_base,
                     bool wd_on, const Hyper& hp, const float* lr,
                     const bool* finite, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (lv.end[lv.n - 1] + kTile - 1) / kTile;
  const int grid = static_cast<int>(tiles < 16LL * sms ? tiles : 16LL * sms);
  T* mp = static_cast<T*>(m);
  T* vp = static_cast<T*>(v);
  if (wd_on)
    fused_update_kernel<KIND, T, true>
        <<<grid, kThreads, 0, stream>>>(lv, mp, vp, state_base, hp, lr, finite);
  else
    fused_update_kernel<KIND, T, false>
        <<<grid, kThreads, 0, stream>>>(lv, mp, vp, state_base, hp, lr, finite);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int kind, const Leaves& lv, void* m, void* v, long long state_base,
                   bool wd_on, const Hyper& hp, const float* lr, const bool* finite,
                   cudaStream_t st) {
  switch (kind) {
    case kSGD: return launch_t<kSGD, T>(lv, m, v, state_base, wd_on, hp, lr, finite, st);
    case kMomentum:
      return launch_t<kMomentum, T>(lv, m, v, state_base, wd_on, hp, lr, finite, st);
    case kNesterov:
      return launch_t<kNesterov, T>(lv, m, v, state_base, wd_on, hp, lr, finite, st);
    case kAdam: return launch_t<kAdam, T>(lv, m, v, state_base, wd_on, hp, lr, finite, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// One launch over n_leaves (1..128) leaves of one storage dtype (f32 or
// bf16): w[i] and g[i] point at leaf i's weight and gradient (numel[i]
// elements each, contiguous; g_f32[i] = 1 when the gradient is f32 rather
// than the weight's dtype). m and v are the bucket's flat state vectors in
// the weight dtype (m Adam only, v SGD with momentum and Adam; null
// otherwise); this launch's leaves start at element state_base of them.
// kind: 0 SGD, 1 SGD with momentum, 2 nesterov, 3 Adam. lr: device f32
// scalar; finite: device bool scalar or null. Returns a cudaError_t.
extern "C" int ff_fused_update(void* const* w, const void* const* g,
                               const long long* numel, const int* g_f32,
                               int n_leaves, long long state_base, void* m,
                               void* v, int dtype, int kind, int wd_on,
                               float wd, float mom, float b1, float c1,
                               float b2, float c2, float eps, const void* lr,
                               const void* finite, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return cudaErrorInvalidValue;
  Leaves lv;
  long long end = 0;
  for (int i = 0; i < n_leaves; ++i) {
    lv.w[i] = w[i];
    lv.g[i] = g[i];
    end += numel[i];
    lv.end[i] = end;
    lv.g_f32[i] = static_cast<unsigned char>(g_f32[i] != 0);
  }
  for (int i = n_leaves; i < kMaxLeaves; ++i) {
    lv.w[i] = nullptr;
    lv.g[i] = nullptr;
    lv.end[i] = end;
    lv.g_f32[i] = 0;
  }
  lv.n = n_leaves;
  if (end == 0) return cudaSuccess;
  const Hyper hp{wd, mom, b1, c1, b2, c2, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lr_p = static_cast<const float*>(lr);
  const bool* fin = static_cast<const bool*>(finite);
  if (dtype == kF32)
    return launch<float>(kind, lv, m, v, state_base, wd_on != 0, hp, lr_p, fin, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(kind, lv, m, v, state_base, wd_on != 0, hp, lr_p, fin, st);
  return cudaErrorInvalidValue;
}
