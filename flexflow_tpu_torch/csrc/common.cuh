// Shared helpers of the hand-written Hopper kernels (flexflow_tpu_torch/csrc).
//
// Every kernel is built by ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into one shared library with a plain C interface, loaded with ctypes.
// Each C entry launches on the stream it is given and returns
// cudaGetLastError(), which the Python wrapper turns into an exception.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace ffk {

// dtype codes, shared with ops/kernels.py (_DTYPE_CODES); int8 and fp8
// (e4m3fn) are quantized KV-pool storage only
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// x rounded to T and back: the probabilities enter the P.V product in the
// value dtype, as in the Pallas kernels (p.astype(v.dtype))
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// One 16-byte vector of T (4 floats or 8 bfloat16) unpacked to f32; a
// bfloat16 is the high half of the float with the same bits.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* out);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& u, float* out) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u, float* out) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 one-byte quantized values (int8, or fp8 e4m3fn: exact in f32)
template <>
__device__ __forceinline__ void unpack16<int8_t>(const uint4& u, float* out) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    out[i] = static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
}
template <>
__device__ __forceinline__ void unpack16<__nv_fp8_e4m3>(const uint4& u, float* out) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    __nv_fp8_e4m3 v;
    v.__x = static_cast<__nv_fp8_storage_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu);
    out[i] = static_cast<float>(v);
  }
}

// The inverse of unpack16: 16 bytes of T from f32 values (rounded to
// nearest even for bfloat16).
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* in);
template <>
__device__ __forceinline__ uint4 pack16<float>(const float* in) {
  return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]),
                    __float_as_uint(in[2]), __float_as_uint(in[3]));
}
template <>
__device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float* in) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16(in[2 * i]));
    const unsigned hi = __bfloat16_as_ushort(__float2bfloat16(in[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float warp_max(float x, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel and device.
// The opt-in persists, so it is made once per (kernel, device) and raised
// only when a launch asks for more: making it on every launch costs host
// time, which a host-bound decode step pays once per layer.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  struct Opted {
    const void* fn;
    int dev;
    size_t bytes;
  };
  static std::mutex mu;
  static Opted opted[256];
  static int n_opted = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  Opted* o = nullptr;
  for (int i = 0; i < n_opted; ++i)
    if (opted[i].fn == fn && opted[i].dev == dev) o = &opted[i];
  if (o != nullptr && o->bytes >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (o != nullptr) {
    o->bytes = bytes;
  } else if (n_opted < 256) {
    opted[n_opted++] = {fn, dev, bytes};
  }
  return cudaSuccess;
}

}  // namespace ffk
