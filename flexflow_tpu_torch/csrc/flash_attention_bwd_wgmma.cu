// Flash-attention backward on the H100's tensor cores (sm_90a): the bf16
// route of ff_flash_attention_bwd (flash_attention_bwd.cu, which keeps the
// delta kernel and the f32 CUDA-core kernels).
//
// Replaces the JAX package's Pallas kernels _flash_bwd_dq_kernel
// (flexflow_tpu/ops/pallas_kernels.py:252) and _flash_bwd_dkv_kernel (:290)
// of flash_attention_bwd_pallas (:335) for bf16, kv heads == heads:
//
//   p  = exp(scale * q k^T + mask - lse),  dp = dO v^T
//   ds = p * (dp - delta),  delta = rowsum(dO * O) - dlse
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T dO
//
// p and ds enter the products that consume them rounded to bf16, as the
// Pallas kernels round them; every sum is f32 (wgmma accumulators).
//
// Design. The Pallas split is kept: each output tile is written exactly
// once, by one block, with no atomics, so the result is deterministic.
// Both kernels are warp-specialised like the forward (flash_attention_
// wgmma.cu): 384 threads, two consumer warpgroups of 64 rows (232
// registers a thread, setmaxnreg) and a producer warpgroup (40) whose first
// lane loads the block's resident tiles once and streams the others
// through a ring of TMA stages on full / empty mbarriers.
//   dq:    one block per (batch * head, 128-row q tile); q and dO resident,
//          K/V streamed (64-row tiles at D = 128, 128 below). Per tile:
//          S = Q K^T and dP = dO V^T (wgmma, both operands K-major in shared
//          memory), dS in registers, dQ += dS K with dS as the register A
//          operand and K read MN-major through the transpose bit.
//   dk/dv: one block per (batch * head, 128-row k tile); K and V resident,
//          q / dO streamed in 64-row tiles. Each
//          warpgroup computes the transposed tiles directly, S^T = K Q^T and
//          dP^T = V dO^T, so P^T and dS^T come out of the accumulators in
//          the register A layout of dV += P^T dO and dK += dS^T Q (dO and Q
//          MN-major): no transpose goes through shared memory.
// That is seven products against the five the bound counts: S and dP are
// recomputed in both kernels, the price of writing each output once with
// no atomics. Causal: the dq loop ends at the last live K tile, the dk/dv
// loop starts at the first live q tile; ragged edges are masked in
// registers. lse, delta and dlse are read per row (dq) or per column
// (dk/dv) straight from device memory.
// Registers: dk/dv holds dK and dV (2 x D / 2 f32 a thread) across the
// whole q loop beside the two score tiles, which is why the consumers take
// the producer warpgroup's registers.
//
// Bound on the H100 (flash_attention_bwd.cu): operations, by a small margin
// over the bytes, at the training shape.
#include "hopper.cuh"

using namespace ffk;
using namespace ffk::sm90;

namespace {

constexpr int kRows = 128;      // resident rows a block (two warpgroups of 64)
constexpr int kThreads = 384;   // 2 consumer warpgroups + 1 producer
constexpr int kConsumers = 256;
constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int dq_bk() { return D == 128 ? 64 : 128; }   // streamed K/V rows
template <int D>
__host__ __device__ constexpr int dkv_bq() { return 64; }   // streamed q/dO rows

// two resident tiles and kStages stages of two streamed tiles, plus 1 KB of
// slack to align the tiles to the swizzle pattern's 1024 bytes
template <int D>
__host__ __device__ constexpr size_t bwd_smem_bytes(int streamed_rows) {
  return 1024 + 2 * Tile<D>::bytes(kRows) +
         kStages * 2 * Tile<D>::bytes(streamed_rows);
}

// The producer lane of both kernels: the two resident tiles on `rbar`, then
// n streamed tile pairs through the ring.
template <int D>
__device__ __forceinline__ void produce(
    const CUtensorMap* ra, const CUtensorMap* rb, const CUtensorMap* sa,
    const CUtensorMap* sb, uint32_t res, uint32_t ring, uint32_t rbar,
    uint32_t full0, uint32_t empty0, int head, int b, int res_row,
    int first, int n, int srows) {
  using T = Tile<D>;
  mbar_expect_tx(rbar, 2 * T::bytes(kRows));
  tma_tile<D>(res, ra, rbar, kRows, head, res_row, b);
  tma_tile<D>(res + T::bytes(kRows), rb, rbar, kRows, head, res_row, b);
  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    if (j >= kStages) mbar_wait(empty0 + 8 * s, (j / kStages - 1) & 1);
    const uint32_t dst = ring + s * 2 * T::bytes(srows);
    const int row = (first + j) * srows;
    mbar_expect_tx(full0 + 8 * s, 2 * T::bytes(srows));
    tma_tile<D>(dst, sa, full0 + 8 * s, srows, head, row, b);
    tma_tile<D>(dst + T::bytes(srows), sb, full0 + 8 * s, srows, head, row, b);
  }
}

__device__ __forceinline__ void init_barriers(uint32_t full0, uint32_t empty0,
                                              uint32_t rbar) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_init(rbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// delta - dlse of row i (dlse optional)
__device__ __forceinline__ float row_delta(const float* delta,
                                           const float* dlse, size_t i) {
  return dlse != nullptr ? delta[i] - dlse[i] : delta[i];
}

// ---------------------------------------------------------------------- dq

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ dlse,
                          __nv_bfloat16* __restrict__ dq, int sq, int sk,
                          int h, float scale, int causal) {
  using T = Tile<D>;
  constexpr int BK = dq_bk<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t do_tile = base + T::bytes(kRows);
  const uint32_t ring = base + 2 * T::bytes(kRows);
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[kStages]);
  const uint32_t rbar = smem_u32(&bars[2 * kStages]);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh % h;
  const int offset = sk - sq;
  int n_tiles = (sk + BK - 1) / BK;
  if (causal) {
    const int q_last = min(q0 + kRows, sq) - 1;
    n_tiles = min(n_tiles, (q_last + offset) / BK + 1);
  }
  init_barriers(full0, empty0, rbar);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= kConsumers / 32) {
    producer_regs();
    if (warp == kConsumers / 32 && lane == 0)
      produce<D>(&tq, &tdo, &tk, &tv, q_tile, ring, rbar, full0, empty0, hh,
                 b, q0, 0, n_tiles, BK);
    return;
  }

  consumer_regs();
  const int wg = warp / 4;
  const int qw0 = q0 + wg * 64;
  const int row_a = qw0 + (warp % 4) * 16 + lane / 4;
  const int rows[2] = {row_a, row_a + 8};
  const int tcol = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t i = static_cast<size_t>(bh) * sq + rows[r];
    // a padding row gets p = exp2(-inf) = 0
    lse2[r] = rows[r] < sq ? lse[i] * kLog2e : INFINITY;
    dl[r] = rows[r] < sq ? row_delta(delta, dlse, i) : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(rbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t k_tile = ring + s * 2 * T::bytes(BK);
    const uint32_t v_tile = k_tile + T::bytes(BK);
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);

    float sc[BK / 2], dp[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<BK>(sc, kmajor_desc<D>(q_tile, kRows, wg * 64, ks),
                   kmajor_desc<D>(k_tile, BK, 0, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<BK>(dp, kmajor_desc<D>(do_tile, kRows, wg * 64, ks),
                   kmajor_desc<D>(v_tile, BK, 0, ks), ks > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);

    const int k0 = t * BK;
    const bool mask = k0 + BK > sk || (causal && k0 + BK - 1 > qw0 + offset);
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int col = k0 + 8 * i + tcol + (e % 2);
        float p = exp2f(fmaf(sc[4 * i + e], scale_log2, -lse2[r]));
        if (mask && (col >= sk || (causal && col > rows[r] + offset))) p = 0.f;
        dp[4 * i + e] = p * (dp[4 * i + e] - dl[r]);
      }
    uint32_t dsa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<BK>(dp, kk, dsa[kk]);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(acc, dsa[kk], mnmajor_desc<D>(k_tile, BK, kk), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    __nv_bfloat16* out =
        dq + ((static_cast<size_t>(b) * sq + rows[r]) * h + hh) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * i + tcol) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] * scale,
                                acc[4 * i + 2 * r + 1] * scale);
  }
}

// ------------------------------------------------------------------- dk/dv

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const float* __restrict__ dlse,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int sq, int sk,
                           int h, float scale, int causal) {
  using T = Tile<D>;
  constexpr int BQ = dkv_bq<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_tile = base;
  const uint32_t v_tile = base + T::bytes(kRows);
  const uint32_t ring = base + 2 * T::bytes(kRows);
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[kStages]);
  const uint32_t rbar = smem_u32(&bars[2 * kStages]);

  // in order: under a causal mask the first k tiles see the most queries
  const int k0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh % h;
  const int offset = sk - sq;
  // causal: query rows before k0 - offset see none of this block's keys
  const int first = causal ? max(k0 - offset, 0) / BQ : 0;
  const int n_tiles = (sq + BQ - 1) / BQ - first;
  init_barriers(full0, empty0, rbar);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= kConsumers / 32) {
    producer_regs();
    if (warp == kConsumers / 32 && lane == 0)
      produce<D>(&tk, &tv, &tq, &tdo, k_tile, ring, rbar, full0, empty0, hh,
                 b, k0, first, n_tiles, BQ);
    return;
  }

  consumer_regs();
  const int wg = warp / 4;
  const int kw0 = k0 + wg * 64;
  const int row_a = kw0 + (warp % 4) * 16 + lane / 4;
  const int rows[2] = {row_a, row_a + 8};   // this thread's two keys
  const int tcol = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  const size_t lrow = static_cast<size_t>(bh) * sq;

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  mbar_wait(rbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t q_tile = ring + s * 2 * T::bytes(BQ);
    const uint32_t do_tile = q_tile + T::bytes(BQ);
    const int q0 = (first + j) * BQ;
    mbar_wait(full0 + 8 * s, (j / kStages) & 1);

    // transposed tiles: rows are this warpgroup's keys, columns queries
    float st[BQ / 2], dpt[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<BQ>(st, kmajor_desc<D>(k_tile, kRows, wg * 64, ks),
                   kmajor_desc<D>(q_tile, BQ, 0, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<BQ>(dpt, kmajor_desc<D>(v_tile, kRows, wg * 64, ks),
                   kmajor_desc<D>(do_tile, BQ, 0, ks), ks > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(st);
    fence_regs(dpt);

    const bool mask = q0 + BQ > sq || (causal && kw0 + 63 > q0 + offset);
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = q0 + 8 * i + tcol + c;
        const bool in = col < sq;
        const float l2 = in ? lse[lrow + col] * kLog2e : INFINITY;
        const float dl = in ? row_delta(delta, dlse, lrow + col) : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 4 * i + 2 * r + c;
          float p = exp2f(fmaf(st[e], scale_log2, -l2));
          if (mask && (!in || (causal && rows[r] > col + offset))) p = 0.f;
          st[e] = p;
          dpt[e] = p * (dpt[e] - dl);
        }
      }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      acc_to_a<BQ>(st, kk, pa[kk]);
      acc_to_a<BQ>(dpt, kk, dsa[kk]);
    }
    wgmma_fence();
    fence_regs(acc_v);
    fence_regs(acc_k);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<D>(acc_v, pa[kk], mnmajor_desc<D>(do_tile, BQ, kk), 1);
      wgmma_rs<D>(acc_k, dsa[kk], mnmajor_desc<D>(q_tile, BQ, kk), 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc_v);
    fence_regs(acc_k);
    mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sk) continue;
    const size_t off = ((static_cast<size_t>(b) * sk + rows[r]) * h + hh) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int c = 8 * i + tcol;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + c) =
          __floats2bfloat162_rn(acc_k[4 * i + 2 * r] * scale,
                                acc_k[4 * i + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + c) =
          __floats2bfloat162_rn(acc_v[4 * i + 2 * r],
                                acc_v[4 * i + 2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const float* dlse, void* dq, void* dk, void* dv, int b,
                   int sq, int sk, int h, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int BK = dq_bk<D>();
  constexpr int BQ = dkv_bq<D>();
  // q / dO / k / v with the block's resident rows, and with the streamed
  // rows of the other kernel
  CUtensorMap mq, mdo, mk, mv, sq_map, sdo, sk_map, sv;
  cudaError_t err = encode_map(&mq, q, b, sq, h, D, kRows);
  if (err == cudaSuccess) err = encode_map(&mdo, dout, b, sq, h, D, kRows);
  if (err == cudaSuccess) err = encode_map(&mk, k, b, sk, h, D, kRows);
  if (err == cudaSuccess) err = encode_map(&mv, v, b, sk, h, D, kRows);
  if (err == cudaSuccess) err = encode_map(&sq_map, q, b, sq, h, D, BQ);
  if (err == cudaSuccess) err = encode_map(&sdo, dout, b, sq, h, D, BQ);
  if (err == cudaSuccess) err = encode_map(&sk_map, k, b, sk, h, D, BK);
  if (err == cudaSuccess) err = encode_map(&sv, v, b, sk, h, D, BK);
  if (err != cudaSuccess) return err;

  const size_t smem_q = bwd_smem_bytes<D>(BK);
  err = allow_smem(flash_bwd_dq_wgmma_kernel<D>, smem_q);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<D>
      <<<dim3((sq + kRows - 1) / kRows, b * h), kThreads, smem_q, stream>>>(
          mq, mdo, sk_map, sv, lse, delta, dlse,
          static_cast<__nv_bfloat16*>(dq), sq, sk, h, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = bwd_smem_bytes<D>(BQ);
  err = allow_smem(flash_bwd_dkv_wgmma_kernel<D>, smem_kv);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wgmma_kernel<D>
      <<<dim3((sk + kRows - 1) / kRows, b * h), kThreads, smem_kv, stream>>>(
          mk, mv, sq_map, sdo, lse, delta, dlse,
          static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
          sq, sk, h, scale, causal);
  return cudaGetLastError();
}

}  // namespace

namespace ffk {
namespace sm90 {

cudaError_t flash_bwd_wgmma(int d, const void* q, const void* k,
                            const void* v, const void* dout, const float* lse,
                            const float* delta, const float* dlse, void* dq,
                            void* dk, void* dv, int b, int sq, int sk, int h,
                            float scale, int causal, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<32>(q, k, v, dout, lse, delta, dlse, dq, dk, dv, b, sq, sk, h, scale, causal, stream);
    case 64: return launch<64>(q, k, v, dout, lse, delta, dlse, dq, dk, dv, b, sq, sk, h, scale, causal, stream);
    case 128: return launch<128>(q, k, v, dout, lse, delta, dlse, dq, dk, dv, b, sq, sk, h, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace ffk
