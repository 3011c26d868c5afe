// Paged decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernel paged_attention_fwd_pallas
// (flexflow_tpu/ops/pallas_kernels.py:689, kernel _paged_attn_kernel :592)
// for native (unquantized) pools.
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
// it scalar-prefetched). K/V rows move as 16-byte vectors, and the next
// chunk's loads are issued before the current chunk is scored, so memory
// latency overlaps the arithmetic. Each chunk's K and V rows are staged once in shared
// memory and shared by all S * (H / KVH) query rows of the group — the
// point of the kernel: the group's K/V bytes cross HBM once per step. For
// each query row a warp scores the 32 positions (lane = position), folds
// them into the row's online softmax (running max / sum in shared memory,
// f32), then all threads add P.V into the f32 accumulator.
//
// Inactive slots carry write_pos 0, row_len 0, prompt_pad 0 and an all-zero
// page-table row: they read scratch page 0 position 0, which their live
// rule admits (0 <= 0 <= 0), so every row has a live key and l > 0.
//
// Bound on the H100: decode with 4 slots holding ~620 live positions each
// at KVH = 8, D = 128 moves ~10.2 MB of K/V per layer, ~3.0 us at 3.35 TB/s;
// bytes bound (the products are ~0.02 GFLOP). One block per (slot, kv
// head) puts only B * KVH blocks on 132 SMs, which caps the bandwidth this
// first kernel can draw; its measured time is in PERF.md.
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                  const T* __restrict__ vpool, const int* __restrict__ page_table,
                  const int* __restrict__ write_pos,
                  const int* __restrict__ row_len,
                  const int* __restrict__ prompt_pad, T* __restrict__ out,
                  int s, int h, int kvh, int ps, int pps, float scale) {
  // K/V rows move as 16-byte vectors: each thread keeps kLoads of them per
  // chunk in registers, so the next chunk's loads are in flight while the
  // current chunk is scored
  constexpr int kVec = 16 / sizeof(T);          // elements per vector
  constexpr int kNV = D / kVec;                 // vectors per position row
  constexpr int kLoads = kTK * kNV / kThreads;  // vectors per thread per chunk
  static_assert(kTK * kNV % kThreads == 0, "chunk must split evenly");

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
  auto issue = [&](int j0) {  // start the loads of chunk [j0, j0 + kTK)
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      const int j = j0 + i / kNV;
      const int c = (i % kNV) * kVec;
      if (j < n_pos && (j < rl || j >= pp)) {  // not in the dead padding
        const size_t row =
            (static_cast<size_t>(tbl_s[j / ps]) * ps + j % ps) * kvh + kh;
        kreg[u] = *reinterpret_cast<const uint4*>(kpool + row * D + c);
        vreg[u] = *reinterpret_cast<const uint4*>(vpool + row * D + c);
      } else {
        kreg[u] = make_uint4(0u, 0u, 0u, 0u);
        vreg[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  auto stage = [&]() {  // registers -> shared memory, as f32
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      const int t = i / kNV;
      const int c = (i % kNV) * kVec;
      float kx[kVec], vx[kVec];
      unpack16<T>(kreg[u], kx);
      unpack16<T>(vreg[u], vx);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ks[t * (D + 1) + c + e] = kx[e];
        vs[t * D + c + e] = vx[e];
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
      pw[r * kTK + lane] = round_to<T>(p);
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* table, const int* wp, const int* rl,
                   const int* pp, void* out, int b, int s, int h, int kvh,
                   int ps, int pps, float scale, cudaStream_t stream) {
  const size_t smem = paged_smem_bytes<D>(s * (h / kvh), s, pps);
  cudaError_t err = allow_smem(paged_attn_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  paged_attn_kernel<T, D><<<b * kvh, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, wp, rl, pp, static_cast<T*>(out), s,
      h, kvh, ps, pps, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     const int* table, const int* wp, const int* rl,
                     const int* pp, void* out, int b, int s, int h, int kvh,
                     int ps, int pps, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, table, wp, rl, pp, out, b, s, h, kvh, ps, pps, scale, stream);
    case 64: return launch<T, 64>(q, k, v, table, wp, rl, pp, out, b, s, h, kvh, ps, pps, scale, stream);
    case 128: return launch<T, 128>(q, k, v, table, wp, rl, pp, out, b, s, h, kvh, ps, pps, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, D); k/v pools (P, page_size, KVH, D); page_table
// (B, pages_per_slot) int32; write_pos (B, S) int32; row_len, prompt_pad
// (B,) int32; out (B, S, H, D). All contiguous. Returns a cudaError_t.
extern "C" int ff_paged_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* page_table,
                                      const void* write_pos,
                                      const void* row_len,
                                      const void* prompt_pad, void* out,
                                      int dtype, int b, int s, int h, int kvh,
                                      int d, int ps, int pps, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* table = static_cast<const int*>(page_table);
  const int* wp = static_cast<const int*>(write_pos);
  const int* rl = static_cast<const int*>(row_len);
  const int* pp = static_cast<const int*>(prompt_pad);
  if (dtype == kF32)
    return launch_d<float>(d, q, k, v, table, wp, rl, pp, out, b, s, h, kvh, ps, pps, scale, st);
  if (dtype == kBF16)
    return launch_d<__nv_bfloat16>(d, q, k, v, table, wp, rl, pp, out, b, s, h, kvh, ps, pps, scale, st);
  return cudaErrorInvalidValue;
}
