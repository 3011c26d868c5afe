// Paged decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernel paged_attention_fwd_pallas
// (flexflow_tpu/ops/pallas_kernels.py:689, kernel _paged_attn_kernel :592)
// for every pool it serves: native pools (the compute dtype), the
// mixed-width pool (bf16 storage under f32 queries, :655-660) and quantized
// pools (int8 or fp8 e4m3fn payload with one f32 scale per (pool page, kv
// head), dequantized per tile, :650-654).
//
// q (B, S, H, D) attends the paged KV pool k/v (P, page_size, KVH, D)
// through per-slot page tables (B, pages_per_slot): logical position j of
// slot b lives in pool page page_table[b, j / page_size] at row
// j % page_size. Slab position i of slot b sees position j when
//   j < row_len[b]  or  prompt_pad[b] <= j <= write_pos[b, i]
// (the serving engine's live rule). Query head h reads kv head
// h / (H / KVH). Decode runs S = 1; any S works.
//
// Design. A block owns one (slot, kv head) and walks the slot's logical
// positions 0 .. max(max_i write_pos[b, i], row_len[b] - 1) in chunks of 32
// (one warp's width), so pages past the write frontier are never read. The
// bucket padding [row_len, prompt_pad) is dead for every row: its positions
// are not loaded, and a chunk that lies wholly inside it is skipped. It
// loads its page-table row into shared memory itself (the TPU kernel had
// it scalar-prefetched). K/V rows move as 16-byte vectors (4 f32, 8 bf16 or
// 16 one-byte values), and the next chunk's loads are issued before the
// current chunk is scored, so memory latency overlaps the arithmetic. Each
// chunk's K and V rows are staged once in shared memory as f32 and shared
// by all S * (H / KVH) query rows of the group — the point of the kernel:
// the group's K/V bytes cross HBM once per step. Staging is where the pool
// types differ: a quantized value is converted in registers and multiplied
// by the scale of the pool page its position lies in (looked up per
// position, so page_size need not be a multiple of 32), and the products
// then run in f32, as the Pallas kernel's do. For each query row a warp
// scores the 32 positions (lane = position), folds them into the row's
// online softmax (running max / sum in shared memory, f32), then all
// threads add P.V into the f32 accumulator. The probabilities enter P.V in
// the value dtype of the Pallas kernel: rounded to bf16 for a native bf16
// pool, f32 for the mixed-width and quantized pools (their tiles are f32
// after the upcast or the dequantization).
//
// Inactive slots carry write_pos 0, row_len 0, prompt_pad 0 and an all-zero
// page-table row: they read scratch page 0 position 0, which their live
// rule admits (0 <= 0 <= 0), so every row has a live key and l > 0.
//
// Bound on the H100: decode with 4 slots holding ~620 live positions each
// at KVH = 8, D = 128 moves ~10.2 MB of bf16 K/V per layer, ~3.0 us at
// 3.35 TB/s, and half that from an int8 or fp8 pool; bytes bound (the
// products are ~0.02 GFLOP). One block per (slot, kv head) puts only
// B * KVH blocks on 132 SMs, which caps the bandwidth this first kernel can
// draw; its measured times are in PERF.md.
#include <type_traits>

#include "common.cuh"

using namespace ffk;

namespace {

constexpr int kTK = 32;        // positions per chunk (= warp width)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <int D>
size_t paged_smem_bytes(int rows, int s, int pps) {
  // q [R][D], k [TK][D+1], v [TK][D], p [R][TK], acc [R][D],
  // m / l / alpha [R] (f32), write_pos [S] and the page-table row [P] (int)
  return sizeof(float) * (static_cast<size_t>(rows) * D + kTK * (D + 1) + kTK * D +
                          rows * kTK + rows * D + 3 * rows) +
         sizeof(int) * (s + pps);
}

// T: the query / output dtype; S: the pool's storage dtype (T, bf16 under
// f32 queries, int8 or fp8). Quantized pools pass their (P, KVH) f32 scales.
template <typename T, typename S, int D>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const S* __restrict__ kpool,
                  const S* __restrict__ vpool, const float* __restrict__ kscale,
                  const float* __restrict__ vscale,
                  const int* __restrict__ page_table,
                  const int* __restrict__ write_pos,
                  const int* __restrict__ row_len,
                  const int* __restrict__ prompt_pad, T* __restrict__ out,
                  int s, int h, int kvh, int ps, int pps, float scale) {
  constexpr bool kQuant = sizeof(S) == 1;
  constexpr bool kNative = std::is_same<T, S>::value;
  // K/V rows move as 16-byte vectors: each thread keeps kLoads of them per
  // chunk in registers, so the next chunk's loads are in flight while the
  // current chunk is scored
  constexpr int kVec = 16 / sizeof(S);            // elements per vector
  constexpr int kNV = D / kVec;                   // vectors per position row
  constexpr int kChunkVecs = kTK * kNV;           // vectors per chunk
  constexpr int kLoads = (kChunkVecs + kThreads - 1) / kThreads;
  static_assert(D % kVec == 0, "a position row splits into whole vectors");

  extern __shared__ float smem[];
  const int grp = h / kvh;
  const int rows = s * grp;  // row r = slab position r / grp, head kh*grp + r % grp
  float* qs = smem;                    // [rows][D]
  float* ks = qs + rows * D;           // [kTK][D + 1]
  float* vs = ks + kTK * (D + 1);      // [kTK][D]
  float* pw = vs + kTK * D;            // [rows][kTK]
  float* acc = pw + rows * kTK;        // [rows][D]
  float* m_s = acc + rows * D;         // [rows]
  float* l_s = m_s + rows;             // [rows]
  float* a_s = l_s + rows;             // [rows]
  int* wp_s = reinterpret_cast<int*>(a_s + rows);  // [s]
  int* tbl_s = wp_s + s;                           // [pps]

  const int b = blockIdx.x / kvh;
  const int kh = blockIdx.x % kvh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rl = row_len[b];
  const int pp = prompt_pad[b];

  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int pos = r / grp, hh = kh * grp + r % grp;
    qs[i] = to_f32(q[((static_cast<size_t>(b) * s + pos) * h + hh) * D + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  for (int i = tid; i < s; i += kThreads) wp_s[i] = write_pos[b * s + i];
  for (int i = tid; i < pps; i += kThreads)
    tbl_s[i] = page_table[static_cast<size_t>(b) * pps + i];
  __syncthreads();

  // the slot's last live position: its furthest write frontier or the
  // prompt's tail, whichever is later (capped at the table's reach)
  int last = rl - 1;
  for (int i = 0; i < s; ++i) last = max(last, wp_s[i]);
  const int n_pos = min(last + 1, pps * ps);

  uint4 kreg[kLoads], vreg[kLoads];
  float ksc[kLoads], vsc[kLoads];  // the vectors' page scales (quantized)
  auto issue = [&](int j0) {  // start the loads of chunk [j0, j0 + kTK)
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      const int j = j0 + i / kNV;
      const int c = (i % kNV) * kVec;
      kreg[u] = make_uint4(0u, 0u, 0u, 0u);
      vreg[u] = make_uint4(0u, 0u, 0u, 0u);
      ksc[u] = vsc[u] = 0.f;
      if (i < kChunkVecs && j < n_pos && (j < rl || j >= pp)) {  // not dead padding
        const int page = tbl_s[j / ps];
        const size_t row = (static_cast<size_t>(page) * ps + j % ps) * kvh + kh;
        kreg[u] = *reinterpret_cast<const uint4*>(kpool + row * D + c);
        vreg[u] = *reinterpret_cast<const uint4*>(vpool + row * D + c);
        if (kQuant) {
          ksc[u] = kscale[static_cast<size_t>(page) * kvh + kh];
          vsc[u] = vscale[static_cast<size_t>(page) * kvh + kh];
        }
      }
    }
  };
  auto stage = [&]() {  // registers -> shared memory, as f32 (dequantized)
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      if (i >= kChunkVecs) continue;
      const int t = i / kNV;
      const int c = (i % kNV) * kVec;
      float kx[kVec], vx[kVec];
      unpack16<S>(kreg[u], kx);
      unpack16<S>(vreg[u], vx);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ks[t * (D + 1) + c + e] = kQuant ? kx[e] * ksc[u] : kx[e];
        vs[t * D + c + e] = kQuant ? vx[e] * vsc[u] : vx[e];
      }
    }
  };

  // the first chunk at or after j0 holding a position outside the padding
  // [rl, pp); chunk starts are multiples of kTK
  auto next_chunk = [&](int j0) {
    return (j0 >= rl && j0 + kTK <= pp) ? pp - pp % kTK : j0;
  };

  int j0 = next_chunk(0);
  if (j0 < n_pos) issue(j0);
  while (j0 < n_pos) {
    __syncthreads();  // the previous chunk's P.V reads are done
    stage();
    __syncthreads();
    const int j_next = next_chunk(j0 + kTK);
    if (j_next < n_pos) issue(j_next);  // prefetch, overlapping the math

    const int j = j0 + lane;
    for (int r = warp; r < rows; r += kWarps) {
      const int pos = r / grp;
      float sc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) sc = fmaf(qs[r * D + d], ks[lane * (D + 1) + d], sc);
      sc *= scale;
      const bool live = j < n_pos && (j < rl || (j >= pp && j <= wp_s[pos]));
      const float mx = warp_max(live ? sc : -INFINITY, 32);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
      const float p = live ? expf(sc - m_new) : 0.f;
      const float psum = warp_sum(p, 32);
      pw[r * kTK + lane] = kNative ? round_to<T>(p) : p;
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, c = i % D;
      float a = acc[i] * a_s[r];
#pragma unroll 8
      for (int t = 0; t < kTK; ++t) a = fmaf(pw[r * kTK + t], vs[t * D + c], a);
      acc[i] = a;
    }
    j0 = j_next;
  }

  // each thread reads back only the acc entries it wrote; l_s was
  // published before the last P.V pass
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int pos = r / grp, hh = kh * grp + r % grp;
    out[((static_cast<size_t>(b) * s + pos) * h + hh) * D + c] =
        from_f32<T>(acc[i] / l_s[r]);
  }
}

struct Args {
  const void *q, *k, *v;
  const float *ksc, *vsc;
  const int *table, *wp, *rl, *pp;
  void* out;
  int b, s, h, kvh, ps, pps;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename S, int D>
cudaError_t launch(const Args& a) {
  const size_t smem = paged_smem_bytes<D>(a.s * (a.h / a.kvh), a.s, a.pps);
  cudaError_t err = allow_smem(paged_attn_kernel<T, S, D>, smem);
  if (err != cudaSuccess) return err;
  paged_attn_kernel<T, S, D><<<a.b * a.kvh, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const S*>(a.k),
      static_cast<const S*>(a.v), a.ksc, a.vsc, a.table, a.wp, a.rl, a.pp,
      static_cast<T*>(a.out), a.s, a.h, a.kvh, a.ps, a.pps, a.scale);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_d(int d, const Args& a) {
  switch (d) {
    case 32: return launch<T, S, 32>(a);
    case 64: return launch<T, S, 64>(a);
    case 128: return launch<T, S, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_pool(int pool_dtype, int d, const Args& a) {
  switch (pool_dtype) {
    case kBF16: return launch_d<T, __nv_bfloat16>(d, a);
    case kI8: return launch_d<T, int8_t>(d, a);
    case kFP8: return launch_d<T, __nv_fp8_e4m3>(d, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, D); k/v pools (P, page_size, KVH, D) of pool_dtype; k/v
// scales (P, KVH) f32 for an int8 / fp8 pool, else null; page_table
// (B, pages_per_slot) int32; write_pos (B, S) int32; row_len, prompt_pad
// (B,) int32; out (B, S, H, D) of q_dtype. All contiguous. Pools: q_dtype,
// bf16 under f32 q, int8 or fp8 (with scales). Returns a cudaError_t.
extern "C" int ff_paged_attention_fwd(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* page_table, const void* write_pos,
    const void* row_len, const void* prompt_pad, void* out, int q_dtype,
    int pool_dtype, int b, int s, int h, int kvh, int d, int ps, int pps,
    float scale, void* stream) {
  const bool quant = pool_dtype == kI8 || pool_dtype == kFP8;
  if (quant != (k_scale != nullptr && v_scale != nullptr)) return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table),
               static_cast<const int*>(write_pos),
               static_cast<const int*>(row_len),
               static_cast<const int*>(prompt_pad), out, b, s, h, kvh, ps, pps,
               scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == kF32)
    return pool_dtype == kF32 ? launch_d<float, float>(d, a)
                              : launch_pool<float>(pool_dtype, d, a);
  if (q_dtype == kBF16 && pool_dtype != kF32)
    return launch_pool<__nv_bfloat16>(pool_dtype, d, a);
  return cudaErrorInvalidValue;
}
