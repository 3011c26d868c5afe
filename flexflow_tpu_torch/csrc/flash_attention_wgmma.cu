// Flash-attention forward on the H100's tensor cores (sm_90a): the bf16
// route of ff_flash_attention_fwd (flash_attention.cu; f32 keeps the
// CUDA-core kernel there, since TF32 wgmma would round f32 inputs to ~10
// mantissa bits).
//
// Replaces the JAX package's Pallas kernel flash_attention_fwd_pallas
// (flexflow_tpu/ops/pallas_kernels.py:180, kernel _flash_fwd_kernel :124)
// for bf16: o = softmax(scale * q k^T + mask) v on (B, S, H, D) tensors,
// causal mask aligned bottom-right (key j is live for query i when
// j <= i + sk - sq), GQA's kv head h / (H / KVH) read in place, and with a
// non-null lse pointer the (B, H, Sq) f32 logsumexp the backward needs.
//
// Design (the FlashAttention-3 shape). A block owns one (batch * head,
// 128-row q tile) and runs 384 threads: two consumer warpgroups of 64 q
// rows each and one producer warpgroup, which hands most of its registers
// to the consumers (setmaxnreg: 40 against 232 a thread).
//   - The producer's first lane loads the q tile once and then keeps a ring
//     of K/V stages in flight with TMA (cp.async.bulk.tensor over a 4-D
//     (D, heads, S, B) tensor map, so rows past S read as zeros inside their
//     own batch), each stage's arrival counted in bytes on a "full"
//     mbarrier; the consumers release a stage on its "empty" mbarrier.
//   - A consumer warpgroup issues S = Q K^T as wgmma m64nBKk16 with Q and K
//     from shared memory (K-major descriptors, 128-byte swizzle at D >= 64,
//     64-byte at D = 32), f32 accumulators in registers; runs the online
//     softmax on those registers in the log2 domain (a row is spread over
//     the four threads of a quad: max and sum are two xor shuffles); then
//     O += P V as wgmma with P as the register A operand, packed to bf16 in
//     place (the Pallas kernel's p.astype(v.dtype)), V read MN-major through
//     the transpose bit.
//   - Causal: K/V tiles past the diagonal are never loaded; only a tile
//     that crosses a warpgroup's diagonal, or the ragged end of the keys,
//     is masked. Blocks run the heaviest (last) q tiles first.
//   - The lse is written from the final running max and sum.
// Tiles: K/V stages of 128 rows; 3 stages at D <= 64, 2 at D = 128 (q 32 KB
// + 2 x 64 KB of K/V = 160 KB of shared memory, one block per SM).
//
// Bound on the H100 (see flash_attention.cu): bytes by a small margin at
// the training and serving shapes. This kernel runs the two products on
// the tensor cores with the next K/V tile's copy in flight; the softmax
// between them is not overlapped with the tensor cores (no ping-pong of the
// two warpgroups, no intra-warpgroup pipelining yet), and the output is
// stored from registers, not through TMA.
#include "hopper.cuh"

using namespace ffk;
using namespace ffk::sm90;

namespace {

constexpr int kBQ = 128;          // q rows a block (two warpgroups of 64)
constexpr int kBK = 128;          // K/V rows a stage
constexpr int kThreads = 384;     // 2 consumer warpgroups + 1 producer
constexpr int kConsumers = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
__host__ __device__ constexpr int fwd_stages() { return D == 128 ? 2 : 3; }

template <int D>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  // 1 KB of slack to align the tiles to the swizzle pattern's 1024 bytes
  return 1024 + Tile<D>::bytes(kBQ) + fwd_stages<D>() * 2 * Tile<D>::bytes(kBK);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int sq, int sk, int h, int kvh, float scale_log2,
                       int causal) {
  using T = Tile<D>;
  constexpr int NS = fwd_stages<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * NS + 1];  // full, empty, q
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t kv0 = base + T::bytes(kBQ);
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[NS]);
  const uint32_t qbar = smem_u32(&bars[2 * NS]);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh % h;
  const int kh = hh / (h / kvh);
  const int offset = sk - sq;  // bottom-right causal alignment
  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    const int q_last = min(q0 + kBQ, sq) - 1;
    n_tiles = min(n_tiles, (q_last + offset) / kBK + 1);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= kConsumers / 32) {
    // ---------------------------------------------------------- producer
    producer_regs();
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect_tx(qbar, T::bytes(kBQ));
      tma_tile<D>(q_tile, &tq, qbar, kBQ, hh, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % NS;
        if (t >= NS) mbar_wait(empty0 + 8 * s, (t / NS - 1) & 1);
        const uint32_t k_tile = kv0 + s * 2 * T::bytes(kBK);
        mbar_expect_tx(full0 + 8 * s, 2 * T::bytes(kBK));
        tma_tile<D>(k_tile, &tk, full0 + 8 * s, kBK, kh, t * kBK, b);
        tma_tile<D>(k_tile + T::bytes(kBK), &tv, full0 + 8 * s, kBK, kh,
                    t * kBK, b);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  consumer_regs();
  const int wg = warp / 4;
  const int qw0 = q0 + wg * 64;              // this warpgroup's first row
  const int row_a = qw0 + (warp % 4) * 16 + lane / 4;
  const int rows[2] = {row_a, row_a + 8};    // this thread's two q rows
  const int tcol = 2 * (lane % 4);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's share of the sum

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % NS;
    const uint32_t k_tile = kv0 + s * 2 * T::bytes(kBK);
    const uint32_t v_tile = k_tile + T::bytes(kBK);
    mbar_wait(full0 + 8 * s, (t / NS) & 1);

    float sc[kBK / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<kBK>(sc, kmajor_desc<D>(q_tile, kBQ, wg * 64, ks),
                    kmajor_desc<D>(k_tile, kBK, 0, ks), ks > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);

    const int k0 = t * kBK;
    const bool mask = k0 + kBK > sk || (causal && k0 + kBK - 1 > qw0 + offset);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int col = k0 + 8 * i + tcol + (e % 2);
        float x = sc[4 * i + e] * scale_log2;
        if (mask && (col >= sk || (causal && col > rows[r] + offset)))
          x = -INFINITY;
        sc[4 * i + e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2], msub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // no live key yet in this row (a padding row): keep the state at 0
      // instead of forming -inf - -inf
      msub[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2f(m[r] - msub[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[4 * i + e] - msub[e / 2]);
        sc[4 * i + e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * i + e] *= alpha[e / 2];

    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) acc_to_a<kBK>(sc, kk, pa[kk]);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs<D>(acc, pa[kk], mnmajor_desc<D>(v_tile, kBK, kk), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] >= sq) continue;
    // every real row has >= 1 live key (key 0; causal needs sk >= sq, which
    // the wrapper checks), so l > 0
    const float inv = 1.f / l[r];
    __nv_bfloat16* orow =
        o + ((static_cast<size_t>(b) * sq + rows[r]) * h + hh) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + tcol) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] * inv,
                                acc[4 * i + 2 * r + 1] * inv);
    if (lse != nullptr && lane % 4 == 0)
      lse[static_cast<size_t>(bh) * sq + rows[r]] =
          (m[r] + log2f(l[r])) * kLn2;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int sk, int h, int kvh,
                   float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_map(&tq, q, b, sq, h, D, kBQ);
  if (err == cudaSuccess) err = encode_map(&tk, k, b, sk, kvh, D, kBK);
  if (err == cudaSuccess) err = encode_map(&tv, v, b, sk, kvh, D, kBK);
  if (err != cudaSuccess) return err;
  const size_t smem = fwd_smem_bytes<D>();
  err = allow_smem(flash_fwd_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, sq, sk, h, kvh,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

}  // namespace

namespace ffk {
namespace sm90 {

cudaError_t encode_map(CUtensorMap* map, const void* ptr, int b, int s,
                       int heads, int d, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t e = 2;  // bytes of a bf16
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {d * e, heads * d * e,
                                 static_cast<cuuint64_t>(s) * heads * d * e};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(d >= 64 ? 64 : 32), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      d >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t flash_fwd_wgmma(int d, const void* q, const void* k,
                            const void* v, void* o, float* lse, int b, int sq,
                            int sk, int h, int kvh, float scale, int causal,
                            cudaStream_t stream) {
  switch (d) {
    case 32: return launch<32>(q, k, v, o, lse, b, sq, sk, h, kvh, scale, causal, stream);
    case 64: return launch<64>(q, k, v, o, lse, b, sq, sk, h, kvh, scale, causal, stream);
    case 128: return launch<128>(q, k, v, o, lse, b, sq, sk, h, kvh, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace ffk
