// Flash-attention backward for Hopper (sm_90a), CUDA C++: the delta kernel
// of both routes and the f32 route's dq and dk/dv kernels on the CUDA
// cores. bf16 runs its dq and dk/dv on the tensor cores
// (flash_attention_bwd_wgmma.cu); the C entry point chooses by dtype alone.
//
// Replaces the JAX package's Pallas backward flash_attention_bwd_pallas
// (flexflow_tpu/ops/pallas_kernels.py:335): its delta term (:358-366, plain
// JAX there), the dq kernel _flash_bwd_dq_kernel (:252) and the dk/dv kernel
// _flash_bwd_dkv_kernel (:290). FlashAttention-2 arithmetic on (B, S, H, D)
// tensors with kv heads == heads (the dense path broadcasts GQA's kv heads
// before attention, as the JAX package does):
//
//   p  = exp(scale * q k^T + mask - lse)      recomputed per tile, f32
//   dp = dO v^T,  delta = rowsum(dO * O) - dlse,  ds = p * (dp - delta)
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T dO
//
// ds and p enter the last three products rounded to the input dtype, as in
// the Pallas kernels (ds.astype(k.dtype), p.astype(do.dtype)); every sum is
// f32. The causal mask is aligned bottom-right (key j is live for query i
// when j <= i + sk - sq, the JAX _causal_mask rule), which needs sq <= sk.
//
// The entry point also takes the Pallas wrapper's dlse and
// delta_precomputed arguments (:335-366): a caller's delta (B, H, Sq) skips
// the delta kernel; an lse cotangent dlse (B, H, Sq) is subtracted from
// delta where the dq and dk/dv kernels read it.
//
// Design. The Pallas kernels run sequential grids on one TPU core and carry
// their accumulators in VMEM scratch across the inner grid axis. Here three
// launches on one stream:
//   1. delta: one warp per (b, q row, head) writes rowsum(dO * O) in f32
//      into a (B, H, Sq) buffer beside the forward's lse (unless the caller
//      gave delta).
//   2. dq: one block per (b * h, 64-row q tile) stages its q and dO rows
//      once and loops over 32-row K/V tiles, dq in f32 registers.
//   3. dk/dv: one block per (b * h, 64-row k tile) stages its K and V rows
//      once and loops over 32-row q / dO tiles, dk and dv in f32 registers.
// Tiles the causal mask kills entirely are never loaded: the dq loop ends
// at the last live K tile, the dk/dv loop starts at the first live q tile.
// The ragged edges of both sequences are masked inside the block, so any S
// works. Each block is 256 threads in a 16 x 16 grid: thread (ty, tx) owns
// rows ty + 16 i of its block's own tile and columns tx + 16 j of the
// streamed tile (score tiles) or of the head dim (accumulators). Shared
// memory rows are padded by one float, so the strided reads of the score
// products hit 16 distinct banks.
//
// Bound on the H100: at the training shape (B = 8, S = 512, H = 32, D = 128,
// non-causal, bf16) the five products a backward needs are 10 B H S^2 D =
// 85.9 GFLOP, ~87 us at 989 TFLOP/s; the bytes (q, k, v, o, dO, lse read,
// dq, dk, dv written) are ~269 MB, ~80 us — operations bound. This kernel
// recomputes q k^T and dO v^T in both passes (seven products) and runs them
// in f32 on the CUDA cores from shared memory (no mma/wgmma, no TMA), far
// from that bound. Its measured time is in PERF.md.
#include "hopper.cuh"

using namespace ffk;

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kQ = 64;         // dq kernel: q rows per block
constexpr int kK = 32;         // dq kernel: K/V rows per streamed tile
constexpr int kKB = 64;        // dk/dv kernel: k rows per block
constexpr int kQB = 32;        // dk/dv kernel: q rows per streamed tile

// ------------------------------------------------------------------ delta

template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int rows, int sq, int h, int d) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;  // warp id
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const size_t base = static_cast<size_t>(row) * d;
  float acc = 0.f;
  for (int i = lane; i < d; i += 32)
    acc = fmaf(to_f32(dout[base + i]), to_f32(o[base + i]), acc);
  acc = warp_sum(acc, 32);
  if (lane == 0) {
    // row = (b * sq + qp) * h + hh of the (B, Sq, H, D) tensors
    const int hh = row % h;
    const int qp = (row / h) % sq;
    const int b = row / (h * sq);
    delta[(static_cast<size_t>(b) * h + hh) * sq + qp] = acc;
  }
}

// ---------------------------------------------------------------------- dq

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, dO [kQ][D+1]; k, v [kK][D+1]; ds [kQ][kK+1]; all f32
  return sizeof(float) *
         (2 * kQ * (D + 1) + 2 * kK * (D + 1) + kQ * (kK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const float* __restrict__ dlse, T* __restrict__ dq, int sq, int sk, int h, float scale,
          int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [kQ][D + 1]
  float* dos = qs + kQ * (D + 1);    // [kQ][D + 1]
  float* ks = dos + kQ * (D + 1);    // [kK][D + 1]
  float* vs = ks + kK * (D + 1);     // [kK][D + 1]
  float* dss = vs + kK * (D + 1);    // [kQ][kK + 1]

  constexpr int DJ = D / 16;         // accumulator columns per thread
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kQ;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh % h;
  const int offset = sk - sq;        // bottom-right causal alignment

  for (int i = tid; i < kQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qp = q0 + r;
    float xq = 0.f, xo = 0.f;
    if (qp < sq) {
      const size_t off = ((static_cast<size_t>(b) * sq + qp) * h + hh) * D + c;
      xq = to_f32(q[off]);
      xo = to_f32(dout[off]);
    }
    qs[r * (D + 1) + c] = xq;
    dos[r * (D + 1) + c] = xo;
  }
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    row_lse[i] = qp < sq ? lse[static_cast<size_t>(bh) * sq + qp] : 0.f;
    const size_t at = static_cast<size_t>(bh) * sq + qp;
    row_delta[i] = qp < sq ? delta[at] - (dlse ? dlse[at] : 0.f) : 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  int n_tiles = (sk + kK - 1) / kK;
  if (causal) {
    // the last live key of this q tile is (last row) + offset
    const int q_last = min(q0 + kQ, sq) - 1;
    n_tiles = min(n_tiles, (q_last + offset) / kK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kK;
    __syncthreads();  // q/dO staged; the previous tile's ds.k reads done
    for (int i = tid; i < kK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int kp = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (kp < sk) {
        const size_t off = ((static_cast<size_t>(b) * sk + kp) * h + hh) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[c * (D + 1) + d] = kx;
      vs[c * (D + 1) + d] = vx;
    }
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[2], vv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * (D + 1) + d];
        ov[i] = dos[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
        vv[j] = vs[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        const bool live = qp < sq && kp < sk && (!causal || kp <= qp + offset);
        const float p = live ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        dss[r * (kK + 1) + c] = round_to<T>(p * (dp[i][j] - row_delta[i]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kK; ++c) {
      float kv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dss[(ty + 16 * i) * (kK + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= sq) continue;
    T* row = dq + ((static_cast<size_t>(b) * sq + qp) * h + hh) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

// ------------------------------------------------------------------- dk/dv

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v [kKB][D+1]; q, dO [kQB][D+1]; p, ds [kKB][kQB+1]; lse, delta [kQB]
  return sizeof(float) * (2 * kKB * (D + 1) + 2 * kQB * (D + 1) +
                          2 * kKB * (kQB + 1) + 2 * kQB);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ dlse, T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int h,
           float scale, int causal) {
  extern __shared__ float smem[];
  float* ks = smem;                    // [kKB][D + 1]
  float* vs = ks + kKB * (D + 1);      // [kKB][D + 1]
  float* qs = vs + kKB * (D + 1);      // [kQB][D + 1]
  float* dos = qs + kQB * (D + 1);     // [kQB][D + 1]
  float* ps = dos + kQB * (D + 1);     // [kKB][kQB + 1]  p^T
  float* dss = ps + kKB * (kQB + 1);   // [kKB][kQB + 1]  ds^T
  float* lses = dss + kKB * (kQB + 1); // [kQB]
  float* deltas = lses + kQB;          // [kQB]

  constexpr int DJ = D / 16;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kKB;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh % h;
  const int offset = sk - sq;

  for (int i = tid; i < kKB * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int kp = k0 + r;
    float kx = 0.f, vx = 0.f;
    if (kp < sk) {
      const size_t off = ((static_cast<size_t>(b) * sk + kp) * h + hh) * D + c;
      kx = to_f32(k[off]);
      vx = to_f32(v[off]);
    }
    ks[r * (D + 1) + c] = kx;
    vs[r * (D + 1) + c] = vx;
  }

  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // causal: query rows before k0 - offset see none of this tile's keys
  const int first_q = causal ? max(k0 - offset, 0) : 0;
  const int n_tiles = (sq + kQB - 1) / kQB;

  for (int t = first_q / kQB; t < n_tiles; ++t) {
    const int q0 = t * kQB;
    __syncthreads();  // k/v staged; the previous tile's reads done
    for (int i = tid; i < kQB * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int qp = q0 + r;
      float xq = 0.f, xo = 0.f;
      if (qp < sq) {
        const size_t off = ((static_cast<size_t>(b) * sq + qp) * h + hh) * D + c;
        xq = to_f32(q[off]);
        xo = to_f32(dout[off]);
      }
      qs[r * (D + 1) + c] = xq;
      dos[r * (D + 1) + c] = xo;
    }
    if (tid < kQB) {
      const int qp = q0 + tid;
      lses[tid] = qp < sq ? lse[static_cast<size_t>(bh) * sq + qp] : 0.f;
      const size_t at = static_cast<size_t>(bh) * sq + qp;
      deltas[tid] = qp < sq ? delta[at] - (dlse ? dlse[at] : 0.f) : 0.f;
    }
    __syncthreads();

    // transposed score tiles: rows are this block's keys, columns queries
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[2], ov[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(ty + 16 * i) * (D + 1) + d];
        vv[i] = vs[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        qv[j] = qs[(tx + 16 * j) * (D + 1) + d];
        ov[j] = dos[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int kp = k0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        const int qp = q0 + c;
        const bool live = qp < sq && kp < sk && (!causal || kp <= qp + offset);
        const float p = live ? expf(s[i][j] * scale - lses[c]) : 0.f;
        ps[r * (kQB + 1) + c] = round_to<T>(p);
        dss[r * (kQB + 1) + c] = round_to<T>(p * (dp[i][j] - deltas[c]));
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kQB; ++c) {
      float ov[DJ], qv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ov[j] = dos[c * (D + 1) + tx + 16 * j];
        qv[j] = qs[c * (D + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * (kQB + 1) + c];
        const float ds = dss[(ty + 16 * i) * (kQB + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          acc_v[i][j] = fmaf(p, ov[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(ds, qv[j], acc_k[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= sk) continue;
    const size_t off = ((static_cast<size_t>(b) * sk + kp) * h + hh) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 16 * j] = from_f32<T>(acc_k[i][j] * scale);
      dv[off + tx + 16 * j] = from_f32<T>(acc_v[i][j]);
    }
  }
}

// ------------------------------------------------------------------ launch

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int b, int sq, int h, int d, cudaStream_t stream) {
  const int rows = b * sq * h;
  delta_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                    stream>>>(static_cast<const T*>(o),
                              static_cast<const T*>(dout), delta, rows, sq, h,
                              d);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const float* lse, const void* dout,
                        const float* delta, const float* dlse, void* dq,
                        void* dk, void* dv, int b, int sq, int sk, int h,
                        float scale, int causal, cudaStream_t stream) {
  using T = float;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const size_t smem_q = dq_smem_bytes<D>();
  cudaError_t err = allow_smem(dq_simt_kernel<T, D>, smem_q);
  if (err != cudaSuccess) return err;
  dq_simt_kernel<T, D><<<dim3((sq + kQ - 1) / kQ, b * h), kThreads, smem_q,
                         stream>>>(qt, kt, vt, dot, lse, delta, dlse,
                                   static_cast<T*>(dq), sq, sk, h, scale,
                                   causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = dkv_smem_bytes<D>();
  err = allow_smem(dkv_simt_kernel<T, D>, smem_kv);
  if (err != cudaSuccess) return err;
  dkv_simt_kernel<T, D><<<dim3((sk + kKB - 1) / kKB, b * h), kThreads,
                          smem_kv, stream>>>(
      qt, kt, vt, dot, lse, delta, dlse, static_cast<T*>(dk),
      static_cast<T*>(dv), sq, sk, h, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, H, D); all contiguous,
// one dtype. lse (the forward's) and delta are (B, H, Sq) f32: with
// compute_delta the delta kernel writes rowsum(dO * O) into delta first,
// without it delta is the caller's. dlse, (B, H, Sq) f32 or null, is
// subtracted from delta. f32 runs the CUDA-core kernels above, bf16 the
// tensor-core kernels (16-byte aligned tensors); a call either refuses
// returns an error, never the other route. Returns a cudaError_t.
extern "C" int ff_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* dout,
                                      void* delta, const void* dlse,
                                      void* dq, void* dk, void* dv, int dtype,
                                      int b, int sq, int sk, int h, int d,
                                      float scale, int causal,
                                      int compute_delta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const float* dls = static_cast<const float*>(dlse);
  if ((dtype != kF32 && dtype != kBF16) || (d != 32 && d != 64 && d != 128))
    return cudaErrorInvalidValue;
  if (compute_delta) {
    const cudaError_t err =
        dtype == kF32 ? launch_delta<float>(o, dout, dl, b, sq, h, d, st)
                      : launch_delta<__nv_bfloat16>(o, dout, dl, b, sq, h, d, st);
    if (err != cudaSuccess) return err;
  }
  if (dtype == kBF16)
    return sm90::flash_bwd_wgmma(d, q, k, v, dout, l, dl, dls, dq, dk, dv, b,
                                 sq, sk, h, scale, causal, st);
  switch (d) {
    case 32: return launch_simt<32>(q, k, v, l, dout, dl, dls, dq, dk, dv, b, sq, sk, h, scale, causal, st);
    case 64: return launch_simt<64>(q, k, v, l, dout, dl, dls, dq, dk, dv, b, sq, sk, h, scale, causal, st);
    default: return launch_simt<128>(q, k, v, l, dout, dl, dls, dq, dk, dv, b, sq, sk, h, scale, causal, st);
  }
}
