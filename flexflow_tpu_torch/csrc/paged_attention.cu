// Paged decode attention for Hopper (sm_90a), CUDA C++: split-KV
// ("flash-decoding"), one launch.
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
// h / (H / KVH). Decode runs S = 1, speculative verify S = K + 1; any S
// works.
//
// Bound on the H100: bytes. Decode with 4 slots holding ~620 live
// positions each at KVH = 8, D = 128 moves ~10.2 MB of bf16 K/V per layer,
// ~3.0 us at 3.35 TB/s, and half that from an int8 or fp8 pool; at ~8000
// live positions a slot, ~134 MB and ~40 us. The products are ~4 flops a
// byte of bf16 K/V, far below the tensor cores' ridge — but not far below
// what the CUDA cores issue once every value is converted, multiplied and
// reduced by shuffles (see the two kernels below).
//
// Grid. (slot x kv head x row chunk, split). A row chunk is up to 16 of the
// group's S * (H / KVH) query rows. A split is a run of whole pages of the
// slot's logical positions; the wrapper picks the number of splits from the
// shapes and the SM count alone (ops/kernels.py paged_attention_plan), so
// the host never reads row_len or write_pos. A block loads its split's
// page-table entries (and, for a quantized pool, one k and one v scale a
// page) into shared memory, reads the slot's bounds on the device, and
// walks only the live part of its split: tiles past the write frontier, or
// wholly inside the bucket padding [row_len, prompt_pad), are never loaded;
// a split with no live tile leaves an empty partial. K/V tiles stream into
// shared memory as 16-byte cp.async copies through a 3-stage pipeline
// (positions outside the live range zero-fill), in the pool's storage type.
//
// bf16 queries (native bf16, int8 and fp8 pools: the serving paths) run on
// the tensor cores (paged_attn_mma_kernel): a stage is 64 positions, 16 a
// warp; each warp holds the chunk's 16 query rows as mma.sync A fragments
// and computes S = Q K^T (m16n8k16, bf16 in, f32 out), keeps the online
// softmax of its rows in registers, and adds P V with P as the next A
// fragment (V by ldmatrix.trans for bf16). int8 and fp8 values are exact in
// bf16, so the raw payload enters the products unscaled and every product
// is exact with f32 sums: a position's score is multiplied by its page's k
// scale, and its probability by its page's v scale; over a quantized pool
// the probability enters P V as two bf16 terms (its rounding and the
// residue: 16 significant bits), keeping the f32 products of the Pallas
// kernel's quantized body to ~1e-5 relative. f32 queries (f32 pools and the
// mixed-width pool, whose products must stay f32) run on the CUDA cores
// (paged_attn_simt_kernel): 32-position tiles, each warp a quarter of the
// rows, lanes holding D / 32 values of a row, a transposing butterfly of 31
// shuffles leaving position t's score in lane t, P V by shuffle broadcast.
// Probabilities enter P V in the value dtype of the Pallas kernel: bf16 for
// a native bf16 pool, f32 for the f32 and mixed-width pools.
//
// Merge. The block's warps merge their states in shared memory. With one
// split the block then normalizes and writes its rows. Otherwise each split
// writes a partial (m, l, acc[D]) in f32 to a workspace, and the last block
// of each (slot, kv head, row chunk) to finish — chosen by an atomic
// ticket, which it then resets to 0 for the next launch — merges the
// partials in split order, so the result does not depend on which block
// came last and repeat launches are bitwise equal. Empty partials (m = -inf)
// contribute nothing.
//
// Inactive slots carry write_pos 0, row_len 0, prompt_pad 0 and an all-zero
// page-table row: they read scratch page 0 position 0, which their live
// rule admits (0 <= 0 <= 0), so every row has a live key and l > 0.
#include "common.cuh"

using namespace ffk;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;        // query rows a block (ops/kernels.py PAGED_ROWS)
constexpr int kStages = 3;       // cp.async pipeline depth
constexpr int kSimtTile = 32;    // positions a CUDA-core tile (= warp width)
constexpr int kMmaTile = 64;     // positions a tensor-core stage, 16 a warp
constexpr int kMaxSplits = 32;   // ops/kernels.py PAGED_MAX_SPLITS
// the small shared arrays after the tiles: per (warp, row) max, sum and
// merge weight; per row the block's max and sum, the partials' merged sum;
// the last-block flag
constexpr int kSmallFloats = 3 * kWarps * kRows + 3 * kRows + 1;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N values of S read as one vector (N * sizeof(S) bytes, aligned) and
// converted to f32
template <typename S, int N>
struct alignas(N * sizeof(S)) Pack {
  S v[N];
};

template <typename S, int N>
__device__ __forceinline__ void load_f32(const S* p, float (&out)[N]) {
  const Pack<S, N> pk = *reinterpret_cast<const Pack<S, N>*>(p);
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = to_f32(pk.v[e]);
}

struct Params {
  const void *q, *k, *v;
  const float *ksc, *vsc;  // (P, KVH) f32 for a quantized pool, else null
  const int *table, *wp, *rl, *pp;
  void* out;
  float* ws_acc;   // [grid.x][splits][kRows][D] partial sums (splits > 1)
  float2* ws_ml;   // [grid.x][splits][kRows] partial (max, sum)
  int* tickets;    // [grid.x], 0 on entry and left 0
  int s, h, kvh, ps, pps, split_pages, row_chunks;
  float scale;
};

// Shared memory of a block: `scratch` bytes of tiles (reused for the
// warps' states after the walk), then the split's page-table entries and
// page scales, the slab's write frontiers and the small arrays.
struct Smem {
  unsigned char* scratch;
  int* tbl;
  float *ksc, *vsc;
  int* wp;
  float *wm, *wl, *wt;      // [kWarps][kRows]
  float *m, *l, *lt;   // [kRows]
  int* last;
};

__device__ __forceinline__ Smem carve(unsigned char* base, size_t scratch,
                                      const Params& p) {
  Smem s;
  s.scratch = base;
  s.tbl = reinterpret_cast<int*>(base + scratch);
  s.ksc = reinterpret_cast<float*>(s.tbl + p.split_pages);
  s.vsc = s.ksc + p.split_pages;
  s.wp = reinterpret_cast<int*>(s.vsc + p.split_pages);
  s.wm = reinterpret_cast<float*>(s.wp + p.s);
  s.wl = s.wm + kWarps * kRows;
  s.wt = s.wl + kWarps * kRows;
  s.m = s.wt + kWarps * kRows;
  s.l = s.m + kRows;
  s.lt = s.l + kRows;
  s.last = reinterpret_cast<int*>(s.lt + kRows);
  return s;
}

size_t smem_bytes(size_t scratch, const Params& p) {
  return scratch + sizeof(int) * (3 * p.split_pages + p.s + kSmallFloats);
}

// x / page_size for 0 <= x < 2^31 by a multiply-high (magic = 2^32 / ps
// rounded up), corrected to the exact quotient
struct PageDiv {
  int ps;
  unsigned magic;
  __device__ explicit PageDiv(int page_size)
      : ps(page_size), magic(page_size == 1 ? 0u : 0xffffffffu / page_size + 1u) {}
  __device__ __forceinline__ int operator()(int x) const {
    if (ps == 1) return x;
    int q = static_cast<int>(__umulhi(static_cast<unsigned>(x), magic));
    if (q * ps > x) --q;
    if ((q + 1) * ps <= x) ++q;
    return q;
  }
};

// A block's split: its slot, kv head and rows, the slot's live bounds, and
// the live tiles of `tile` positions in [j_lo, j_hi): run A, the tiles
// starting before row_len; run B, from the first tile reaching past
// prompt_pad. Tiles between lie wholly in the dead padding.
struct Split {
  int b, kh, row0, rows, rl, pp, n_pages, j_lo, j_hi, n_a, k_b, n_tiles, tile;
  __device__ __forceinline__ int tile_start(int i) const {
    return j_lo + tile * (i < n_a ? i : k_b + i - n_a);
  }
  __device__ __forceinline__ bool loaded(int j) const {
    return j < j_hi && (j < rl || j >= pp);
  }
};

// The block's slot, kv head, rows and pages (no shared memory yet, so the
// caller can issue its query loads before the first barrier).
__device__ __forceinline__ Split locate(const Params& p, int tile) {
  Split sp;
  const int bx = blockIdx.x;
  sp.b = bx / p.row_chunks / p.kvh;
  sp.kh = bx / p.row_chunks % p.kvh;
  sp.row0 = bx % p.row_chunks * kRows;
  sp.rows = min(kRows, p.s * (p.h / p.kvh) - sp.row0);
  sp.rl = p.rl[sp.b];
  sp.pp = p.pp[sp.b];
  sp.tile = tile;
  sp.j_lo = blockIdx.y * p.split_pages * p.ps;
  sp.n_pages = min(p.split_pages, p.pps - blockIdx.y * p.split_pages);
  return sp;
}

// Loads the split's page-table entries and the slab's write frontiers into
// shared memory (ends with a barrier), then finds the live tiles.
__device__ void bound(const Params& p, const Smem& sm, Split& sp) {
  const int page0 = blockIdx.y * p.split_pages;
  for (int i = threadIdx.x; i < p.s; i += kThreads) sm.wp[i] = p.wp[sp.b * p.s + i];
  for (int i = threadIdx.x; i < sp.n_pages; i += kThreads)
    sm.tbl[i] = p.table[static_cast<size_t>(sp.b) * p.pps + page0 + i];
  __syncthreads();
  // the slot's last live position: its furthest write frontier or the
  // prompt's tail, whichever is later (capped at the table's reach)
  int last = sp.rl - 1;
  for (int i = 0; i < p.s; ++i) last = max(last, sm.wp[i]);
  const int n_pos = min(last + 1, p.pps * p.ps);
  const int tile = sp.tile;
  sp.j_hi = min(sp.j_lo + sp.n_pages * p.ps, n_pos);
  const int k_end = sp.j_hi > sp.j_lo ? (sp.j_hi - sp.j_lo + tile - 1) / tile : 0;
  sp.n_a = min(k_end, sp.rl > sp.j_lo ? (sp.rl - sp.j_lo + tile - 1) / tile : 0);
  sp.k_b = max(sp.n_a, sp.pp > sp.j_lo ? (sp.pp - sp.j_lo) / tile : 0);
  sp.n_tiles = sp.n_a + max(0, k_end - sp.k_b);
}

// A quantized pool's k and v scales of the split's pages into shared
// memory; read after the next barrier.
__device__ __forceinline__ void load_scales(const Params& p, const Smem& sm,
                                            const Split& sp) {
  for (int i = threadIdx.x; i < sp.n_pages; i += kThreads) {
    const size_t at = static_cast<size_t>(sm.tbl[i]) * p.kvh + sp.kh;
    sm.ksc[i] = p.ksc[at];
    sm.vsc[i] = p.vsc[at];
  }
}

// Query row r of the chunk -> its element offset in q / out, (B, S, H, D)
template <int D>
__device__ __forceinline__ size_t row_offset(const Params& p, const Split& sp, int r) {
  const int grp = p.h / p.kvh;
  const int g = sp.row0 + r;
  const int pos = g / grp, hh = sp.kh * grp + g % grp;
  return ((static_cast<size_t>(sp.b) * p.s + pos) * p.h + hh) * D;
}

// The block's result for its rows — sm.m, sm.l and acc [kRows][D] f32 in
// shared memory (m = -inf: no live key in this split) — to the output with
// one split, else to this split's partial; the last block of the (slot, kv
// head, row chunk) merges the partials in split order.
template <typename T, int D>
__device__ void finish(const Params& p, const Smem& sm, const Split& sp,
                       const float* acc) {
  const int tid = threadIdx.x;
  const int splits = gridDim.y;
  T* out = static_cast<T*>(p.out);
  if (splits == 1) {
    for (int e = tid; e < sp.rows * D; e += kThreads) {
      const int r = e / D;
      out[row_offset<D>(p, sp, r) + e % D] = from_f32<T>(acc[e] / sm.l[r]);
    }
    return;
  }
  const size_t base = static_cast<size_t>(blockIdx.x) * splits;
  const size_t slot = base + blockIdx.y;
  for (int r = tid; r < sp.rows; r += kThreads)
    p.ws_ml[slot * kRows + r] = make_float2(sm.m[r], sm.l[r]);
  for (int e = tid; e < sp.rows * D; e += kThreads)
    if (sm.m[e / D] != -INFINITY) p.ws_acc[slot * kRows * D + e] = acc[e];
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  if (tid == 0) *sm.last = atomicAdd(p.tickets + blockIdx.x, 1) == splits - 1;
  __syncthreads();
  if (!*sm.last) return;
  __threadfence();
  if (tid == 0) p.tickets[blockIdx.x] = 0;  // ready for the next launch

  // every partial's (m, l) into the tiles' space (free now; kMaxSplits *
  // kRows pairs fit every kernel's), all loads in flight at once; then per
  // row the partials' weights exp(m_split - m_max), kept in place of m
  float2* ml = reinterpret_cast<float2*>(sm.scratch);  // [splits][kRows]
  for (int i = tid; i < splits * sp.rows; i += kThreads) {
    const int s = i / sp.rows, r = i % sp.rows;
    ml[s * kRows + r] = __ldcg(&p.ws_ml[(base + s) * kRows + r]);
  }
  __syncthreads();
  for (int r = tid; r < sp.rows; r += kThreads) {
    float mt = -INFINITY;
    for (int s = 0; s < splits; ++s) mt = fmaxf(mt, ml[s * kRows + r].x);
    float lt = 0.f;
    for (int s = 0; s < splits; ++s) {
      float2& x = ml[s * kRows + r];
      x.x = x.x == -INFINITY ? 0.f : expf(x.x - mt);
      lt += x.y * x.x;
    }
    sm.lt[r] = lt;
  }
  __syncthreads();
  // the outputs, four a thread at a time, each a sum over the splits in
  // split order; the loads of eight splits issued together
  const int n_el = sp.rows * D;
  for (int e0 = tid; e0 < n_el; e0 += 4 * kThreads) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < splits; s0 += 8) {
      float v[4][8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = e0 + k * kThreads;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int s = s0 + u;
          v[k][u] = e < n_el && s < splits && ml[s * kRows + e / D].x != 0.f
                        ? __ldcg(&p.ws_acc[(base + s) * kRows * D + e])
                        : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = e0 + k * kThreads;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (e < n_el && s0 + u < splits) a[k] += v[k][u] * ml[(s0 + u) * kRows + e / D].x;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * kThreads;
      if (e < n_el)
        out[row_offset<D>(p, sp, e / D) + e % D] = from_f32<T>(a[k] / sm.lt[e / D]);
    }
  }
}

// ------------------------------------------------------------------ f32 q

// One step of the transposing butterfly: lanes holding bit W keep the upper
// W of their 2W partial sums and send the lower W to their partner, which
// does the opposite. After W = 16, 8, 4, 2, 1, part[0] of lane t is the
// warp's total for position t.
template <int W>
__device__ __forceinline__ void fold(float (&part)[kSimtTile], int lane) {
  const bool up = lane & W;
#pragma unroll
  for (int t = 0; t < W; ++t) {
    const float send = up ? part[t] : part[t + W];
    const float keep = up ? part[t + W] : part[t];
    part[t] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

template <typename S, int D>
__host__ __device__ constexpr int simt_scratch() {
  return kStages * 2 * kSimtTile * D * static_cast<int>(sizeof(S)) > kRows * D * 4
             ? kStages * 2 * kSimtTile * D * static_cast<int>(sizeof(S))
             : kRows * D * 4;
}

// f32 queries over an f32, bf16 (mixed-width), int8 or fp8 pool, on the
// CUDA cores in f32.
template <typename S, int D>
__global__ void __launch_bounds__(kThreads) paged_attn_simt_kernel(const Params p) {
  using T = float;
  constexpr bool kQuant = sizeof(S) == 1;
  constexpr int kRowsPerWarp = kRows / kWarps;
  constexpr int N = D / 32;                     // row values a lane holds
  constexpr int kVecsPerRow = D * sizeof(S) / 16;
  constexpr int kTileVecs = kSimtTile * kVecsPerRow;
  constexpr int kTileBytes = kSimtTile * D * sizeof(S);
  constexpr int kIssue = (2 * kTileVecs + kThreads - 1) / kThreads;
  static_assert(D % 32 == 0 && kVecsPerRow >= 1, "a row splits into vectors");

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = carve(smem, simt_scratch<S, D>(), p);
  Split sp = locate(p, kSimtTile);
  bound(p, sm, sp);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const PageDiv div(p.ps);

  const S* kpool = static_cast<const S*>(p.k);
  const S* vpool = static_cast<const S*>(p.v);
  auto issue = [&](int i) {  // tile i -> stage i % kStages
    unsigned char* st = sm.scratch + (i % kStages) * 2 * kTileBytes;
    const int t0 = sp.tile_start(i);
#pragma unroll
    for (int it = 0; it < kIssue; ++it) {
      const int u = tid + it * kThreads;
      if (u < 2 * kTileVecs) {
        const bool is_v = u >= kTileVecs;
        const int w = is_v ? u - kTileVecs : u;
        const int j = t0 + w / kVecsPerRow;
        const bool ld = sp.loaded(j);
        const S* pool = is_v ? vpool : kpool;
        const S* src = pool;
        if (ld) {
          const int x = j - sp.j_lo, pg = div(x);
          const size_t row =
              (static_cast<size_t>(sm.tbl[pg]) * p.ps + (x - pg * p.ps)) * p.kvh + sp.kh;
          src = pool + row * D + (w % kVecsPerRow) * (16 / sizeof(S));
        }
        cp_async16(st + (is_v ? kTileBytes : 0) + w * 16, src, ld);
      }
    }
  };

  // this warp's rows (block row warp + kWarps * i) in registers
  const T* q = static_cast<const T*>(p.q);
  float qr[kRowsPerWarp][N], acc[kRowsPerWarp][N];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  int wpr[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    m[i] = -INFINITY;
    l[i] = 0.f;
    wpr[i] = -1;
#pragma unroll
    for (int e = 0; e < N; ++e) qr[i][e] = acc[i][e] = 0.f;
    if (r < sp.rows) {
      load_f32<T, N>(q + row_offset<D>(p, sp, r) + lane * N, qr[i]);
      wpr[i] = sm.wp[(sp.row0 + r) / (p.h / p.kvh)];
    }
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < sp.n_tiles) issue(i);
    cp_async_commit();
  }
  if (kQuant) load_scales(p, sm, sp);
  for (int it = 0; it < sp.n_tiles; ++it) {
    if (it + kStages - 1 < sp.n_tiles) issue(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile it has landed (this thread's copies)
    __syncthreads();               // ... and every other thread's
    const unsigned char* st = sm.scratch + (it % kStages) * 2 * kTileBytes;
    const S* ks = reinterpret_cast<const S*>(st);
    const S* vs = reinterpret_cast<const S*>(st + kTileBytes);
    const int j = sp.tile_start(it) + lane;  // the position lane scores
    const bool loaded = sp.loaded(j);
    float kq = 1.f, vq = 1.f;  // the scales of j's page (quantized pools)
    if (kQuant && loaded) {
      const int pg = div(j - sp.j_lo);
      kq = sm.ksc[pg];
      vq = sm.vsc[pg];
    }
    float pr[kRowsPerWarp];  // lane's probability (times vq) per row
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      pr[i] = 0.f;
      if (warp + kWarps * i >= sp.rows) continue;  // warp-uniform
      float part[kSimtTile];
#pragma unroll
      for (int t = 0; t < kSimtTile; ++t) {
        float kx[N];
        load_f32<S, N>(ks + t * D + lane * N, kx);
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < N; ++e) a = fmaf(qr[i][e], kx[e], a);
        part[t] = a;
      }
      fold<16>(part, lane);
      fold<8>(part, lane);
      fold<4>(part, lane);
      fold<2>(part, lane);
      fold<1>(part, lane);
      const float sc = part[0] * kq * p.scale;
      const bool live = loaded && (j < sp.rl || j <= wpr[i]);
      const float m_new = fmaxf(m[i], warp_max(live ? sc : -INFINITY, 32));
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      const float pv = live ? expf(sc - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(pv, 32);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < N; ++e) acc[i][e] *= alpha;
      pr[i] = pv * vq;
    }
#pragma unroll 8
    for (int t = 0; t < kSimtTile; ++t) {
      float vx[N];
      load_f32<S, N>(vs + t * D + lane * N, vx);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (warp + kWarps * i >= sp.rows) continue;
        const float pt = __shfl_sync(0xffffffffu, pr[i], t);
#pragma unroll
        for (int e = 0; e < N; ++e) acc[i][e] = fmaf(pt, vx[e], acc[i][e]);
      }
    }
    __syncthreads();  // the stage is refilled by a later iteration
  }
  cp_async_wait<0>();
  __syncthreads();

  float* acc_s = reinterpret_cast<float*>(sm.scratch);  // [kRows][D]
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r >= sp.rows) continue;
    if (lane == 0) {
      sm.m[r] = m[i];
      sm.l[r] = l[i];
    }
#pragma unroll
    for (int e = 0; e < N; ++e) acc_s[r * D + lane * N + e] = acc[i][e];
  }
  __syncthreads();
  finish<T, D>(p, sm, sp, acc_s);
}

// ----------------------------------------------------------------- bf16 q

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed: lane L gives the row address of
// matrix L / 8, and receives (rows 2c, 2c+1; column g) of each.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// two f32 as bf16, rounded to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the low and the high bf16 of a pair, as f32
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// two one-byte values (int8 or fp8 e4m3, byte 0 in the low half) as bf16:
// both are exact in bf16
template <typename S>
__device__ __forceinline__ uint32_t bf16x2_of(unsigned two);
// int8: the byte, offset by 128, as the low mantissa bits of 2^23, less
// 2^23 + 128 — exact, and two integer ops and an add instead of a
// quarter-rate int-to-float conversion
__device__ __forceinline__ float int8_f32(unsigned byte) {
  return __uint_as_float(0x4b000000u | ((byte ^ 0x80u) & 0xffu)) - 8388736.f;
}
template <>
__device__ __forceinline__ uint32_t bf16x2_of<int8_t>(unsigned two) {
  return pack_bf16(int8_f32(two), int8_f32(two >> 8));
}
template <>
__device__ __forceinline__ uint32_t bf16x2_of<__nv_fp8_e4m3>(unsigned two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  return pack_bf16(f.x, f.y);
}

// K^T as an mma B fragment: elements d, d + 1 of a position's row, as bf16
template <typename S>
__device__ __forceinline__ uint32_t k_pair(const unsigned char* row, int d) {
  if constexpr (sizeof(S) == 2) {
    return *reinterpret_cast<const uint32_t*>(row + 2 * d);
  } else {
    return bf16x2_of<S>(*reinterpret_cast<const unsigned short*>(row + d));
  }
}

template <typename S, int D>
__host__ __device__ constexpr int mma_stride() {  // a padded smem row
  return D * static_cast<int>(sizeof(S)) + 16;
}

template <typename S, int D>
__host__ __device__ constexpr int mma_scratch() {
  return kStages * 2 * kMmaTile * mma_stride<S, D>() > kWarps * kRows * D * 4
             ? kStages * 2 * kMmaTile * mma_stride<S, D>()
             : kWarps * kRows * D * 4;
}

// the last block's merge keeps its weights in the tiles' space
static_assert(simt_scratch<int8_t, 32>() >= kMaxSplits * kRows * 8 &&
                  mma_scratch<int8_t, 32>() >= kMaxSplits * kRows * 8,
              "merge weights fit the smallest scratch");

// bf16 queries over a bf16, int8 or fp8 pool, on the tensor cores.
template <typename S, int D>
__global__ void __launch_bounds__(kThreads) paged_attn_mma_kernel(const Params p) {
  using T = __nv_bfloat16;
  constexpr bool kQuant = sizeof(S) == 1;
  constexpr int kStride = mma_stride<S, D>();
  constexpr int kVecsPerRow = D * sizeof(S) / 16;
  constexpr int kStageBytes = 2 * kMmaTile * kStride;   // K rows, then V rows
  constexpr int kSteps = D / 16;                        // k steps of Q K^T
  constexpr int kNT = D / 8;                            // n tiles of P V
  constexpr int kIssue = kMmaTile * kVecsPerRow / kThreads;  // copies a thread
  static_assert(kMmaTile * kVecsPerRow % kThreads == 0 && D % 16 == 0, "tile shapes");

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = carve(smem, mma_scratch<S, D>(), p);
  Split sp = locate(p, kMmaTile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;  // mma fragment row group, column pair
  const PageDiv div(p.ps);

  // the chunk's rows g and g + 8 as A fragments, loaded while the split's
  // table is
  const T* q = static_cast<const T*>(p.q);
  uint32_t qa[kSteps][4];
  bool valid[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = g + 8 * h2;
    valid[h2] = r < sp.rows;
    const T* qrow = q + (valid[h2] ? row_offset<D>(p, sp, r) : 0);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int d = ks * 16 + 2 * c;
      qa[ks][h2] = valid[h2] ? *reinterpret_cast<const uint32_t*>(qrow + d) : 0u;
      qa[ks][2 + h2] = valid[h2] ? *reinterpret_cast<const uint32_t*>(qrow + d + 8) : 0u;
    }
  }
  bound(p, sm, sp);
  int wpr[2];  // the rows' write frontiers
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2)
    wpr[h2] = valid[h2] ? sm.wp[(sp.row0 + g + 8 * h2) / (p.h / p.kvh)] : -1;

  // the K/V copies: consecutive threads take consecutive 16-byte vectors of
  // a stage's rows, so a warp's copies cover whole 128-byte lines
  const S* kpool = static_cast<const S*>(p.k);
  const S* vpool = static_cast<const S*>(p.v);
  auto issue = [&](int i) {
    unsigned char* st = sm.scratch + (i % kStages) * kStageBytes;
    const int t0 = sp.tile_start(i);
#pragma unroll
    for (int it = 0; it < kIssue; ++it) {
      const int u = tid + it * kThreads;
      const int t = u / kVecsPerRow, v = u % kVecsPerRow;
      const int j = t0 + t;
      const bool ld = sp.loaded(j);
      size_t off = static_cast<size_t>(v) * (16 / sizeof(S));
      if (ld) {
        const int x = j - sp.j_lo, pg = div(x);
        off += ((static_cast<size_t>(sm.tbl[pg]) * p.ps + (x - pg * p.ps)) * p.kvh + sp.kh) * D;
      }
      cp_async16(st + t * kStride + v * 16, kpool + off, ld);
      cp_async16(st + (kMmaTile + t) * kStride + v * 16, vpool + off, ld);
    }
  };

  float acc[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < sp.n_tiles) issue(i);
    cp_async_commit();
  }
  if (kQuant) load_scales(p, sm, sp);
  for (int it = 0; it < sp.n_tiles; ++it) {
    if (it + kStages - 1 < sp.n_tiles) issue(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    // this warp's 16 positions of the stage
    const unsigned char* ks_s =
        sm.scratch + (it % kStages) * kStageBytes + warp * 16 * kStride;
    const unsigned char* vs_s = ks_s + kMmaTile * kStride;
    const int j0 = sp.tile_start(it) + warp * 16;

    // S = Q K^T over two n tiles of 8 positions
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const unsigned char* row = ks_s + (nt * 8 + g) * kStride;
        mma_bf16(sc[nt], qa[ks], k_pair<S>(row, ks * 16 + 2 * c),
                 k_pair<S>(row, ks * 16 + 2 * c + 8));
      }
    }
    // this thread's positions j0 + nt * 8 + 2c + e, their page scales
    bool ldp[2][2];
    float kq[2][2], vq[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + nt * 8 + 2 * c + e;
        ldp[nt][e] = sp.loaded(j);
        kq[nt][e] = vq[nt][e] = 1.f;
        if (kQuant && ldp[nt][e]) {
          const int pg = div(j - sp.j_lo);
          kq[nt][e] = sm.ksc[pg];
          vq[nt][e] = sm.vsc[pg];
        }
      }
    }
    // the online softmax of rows g (h2 = 0) and g + 8 (h2 = 1); P as the
    // A fragment of P V
    uint32_t pa[4], pl[4];  // P (bf16); for a quantized pool also P - bf16(P)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float s4[4];
      bool live4[4];
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + nt * 8 + 2 * c + e;
          const float s = sc[nt][2 * h2 + e] * kq[nt][e] * p.scale;
          const bool live = valid[h2] && ldp[nt][e] && (j < sp.rl || j <= wpr[h2]);
          s4[2 * nt + e] = s;
          live4[2 * nt + e] = live;
          mx = fmaxf(mx, live ? s : -INFINITY);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h2], mx);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[h2] - m_new);
      float pr[4], psum = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float pv = live4[u] ? expf(s4[u] - m_new) : 0.f;
        psum += pv;
        pr[u] = pv * vq[u / 2][u % 2];
      }
      l[h2] = l[h2] * alpha + psum;  // this thread's share; the quad sums at the end
      m[h2] = m_new;
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        acc[i][2 * h2] *= alpha;
        acc[i][2 * h2 + 1] *= alpha;
      }
      pa[h2] = pack_bf16(pr[0], pr[1]);      // k 2c, 2c+1: n tile 0
      pa[2 + h2] = pack_bf16(pr[2], pr[3]);  // k 2c+8, 2c+9: n tile 1
      if (kQuant) {  // the rounding residue, so P enters with 16 significant bits
        pl[h2] = pack_bf16(pr[0] - bf16_lo(pa[h2]), pr[1] - bf16_hi(pa[h2]));
        pl[2 + h2] = pack_bf16(pr[2] - bf16_lo(pa[2 + h2]), pr[3] - bf16_hi(pa[2 + h2]));
      }
    }

    // O += P V, two n tiles of 8 columns at a time
#pragma unroll
    for (int i2 = 0; i2 < kNT / 2; ++i2) {
      if constexpr (sizeof(S) == 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs_s + (((lane >> 3) & 1) * 8 + (lane & 7)) * kStride +
                             (i2 * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(acc[2 * i2], pa, b[0], b[1]);
        mma_bf16(acc[2 * i2 + 1], pa, b[2], b[3]);
      } else {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = i2 * 16 + half * 8 + g;
          const unsigned char* v0 = vs_s + 2 * c * kStride + col;
          const uint32_t b0 = bf16x2_of<S>(v0[0] | (v0[kStride] << 8));
          const uint32_t b1 = bf16x2_of<S>(v0[8 * kStride] | (v0[9 * kStride] << 8));
          mma_bf16(acc[2 * i2 + half], pa, b0, b1);
          mma_bf16(acc[2 * i2 + half], pl, b0, b1);
        }
      }
    }
    __syncthreads();  // the stage is refilled by a later iteration
  }
  cp_async_wait<0>();
  __syncthreads();

  // each warp's state into shared memory, then the block's merge of them
  float* wacc = reinterpret_cast<float*>(sm.scratch);  // [kWarps][kRows][D]
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
    const int r = g + 8 * h2;
    if (c == 0) {
      sm.wm[warp * kRows + r] = m[h2];
      sm.wl[warp * kRows + r] = l[h2];
    }
    float* dst = wacc + (warp * kRows + r) * D + 2 * c;
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      dst[i * 8] = acc[i][2 * h2];
      dst[i * 8 + 1] = acc[i][2 * h2 + 1];
    }
  }
  __syncthreads();
  for (int r = tid; r < sp.rows; r += kThreads) {
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, sm.wm[w * kRows + r]);
    float lb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm.wm[w * kRows + r];
      const float wt = mw == -INFINITY ? 0.f : expf(mw - mb);
      sm.wt[w * kRows + r] = wt;
      lb += sm.wl[w * kRows + r] * wt;
    }
    sm.m[r] = mb;
    sm.l[r] = lb;
  }
  __syncthreads();
  for (int e = tid; e < sp.rows * D; e += kThreads) {
    const int r = e / D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += wacc[w * kRows * D + e] * sm.wt[w * kRows + r];
    wacc[e] = a;  // warp 0's slot of (r, e % D), read only by this thread
  }
  __syncthreads();
  finish<T, D>(p, sm, sp, wacc);
}

// ----------------------------------------------------------------- launch

template <typename S, int D>
cudaError_t launch(const Params& p, int q_dtype, int slots, int splits,
                   cudaStream_t stream) {
  const dim3 grid(slots * p.kvh * p.row_chunks, splits);
  if (q_dtype == kBF16) {
    if constexpr (sizeof(S) == 4) {
      return cudaErrorInvalidValue;
    } else {
      const size_t smem = smem_bytes(mma_scratch<S, D>(), p);
      cudaError_t err = allow_smem(paged_attn_mma_kernel<S, D>, smem);
      if (err != cudaSuccess) return err;
      paged_attn_mma_kernel<S, D><<<grid, kThreads, smem, stream>>>(p);
      return cudaGetLastError();
    }
  }
  const size_t smem = smem_bytes(simt_scratch<S, D>(), p);
  cudaError_t err = allow_smem(paged_attn_simt_kernel<S, D>, smem);
  if (err != cudaSuccess) return err;
  paged_attn_simt_kernel<S, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_d(int d, const Params& p, int q_dtype, int slots, int splits,
                     cudaStream_t st) {
  switch (d) {
    case 32: return launch<S, 32>(p, q_dtype, slots, splits, st);
    case 64: return launch<S, 64>(p, q_dtype, slots, splits, st);
    case 128: return launch<S, 128>(p, q_dtype, slots, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, D); k/v pools (P, page_size, KVH, D) of pool_dtype; k/v
// scales (P, KVH) f32 for an int8 / fp8 pool, else null; page_table
// (B, pages_per_slot) int32; write_pos (B, S) int32; row_len, prompt_pad
// (B,) int32; out (B, S, H, D) of q_dtype. All contiguous, q and the pools
// 16-byte aligned. Pools: q_dtype, bf16 under f32 q, int8 or fp8 (with
// scales). The grid is (B * KVH * ceil(S * H / KVH / 16), splits), each
// split split_pages pages (splits = ceil(pages_per_slot / split_pages),
// at most 32);
// with splits > 1, ws_acc holds grid.x * splits * 16 * D f32, ws_ml
// grid.x * splits * 16 (m, l) pairs, and tickets grid.x int32 zeros (left
// zero). Returns a cudaError_t.
extern "C" int ff_paged_attention_fwd(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* page_table, const void* write_pos,
    const void* row_len, const void* prompt_pad, void* out, void* ws_acc,
    void* ws_ml, void* tickets, int q_dtype, int pool_dtype, int b, int s,
    int h, int kvh, int d, int ps, int pps, int split_pages, float scale,
    void* stream) {
  const bool quant = pool_dtype == kI8 || pool_dtype == kFP8;
  if (quant != (k_scale != nullptr && v_scale != nullptr)) return cudaErrorInvalidValue;
  if (split_pages < 1 || split_pages > pps || h % kvh) return cudaErrorInvalidValue;
  const int splits = (pps + split_pages - 1) / split_pages;
  if (splits > kMaxSplits) return cudaErrorInvalidValue;
  if (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr || tickets == nullptr))
    return cudaErrorInvalidValue;
  const Params p{q, k, v, static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale),
                 static_cast<const int*>(page_table),
                 static_cast<const int*>(write_pos),
                 static_cast<const int*>(row_len),
                 static_cast<const int*>(prompt_pad), out,
                 static_cast<float*>(ws_acc), static_cast<float2*>(ws_ml),
                 static_cast<int*>(tickets), s, h, kvh, ps, pps, split_pages,
                 (s * (h / kvh) + kRows - 1) / kRows, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // bf16 queries take a bf16, int8 or fp8 pool; f32 queries any of the
  // four (bf16: the mixed-width pool)
  if (q_dtype != kF32 && q_dtype != kBF16) return cudaErrorInvalidValue;
  switch (pool_dtype) {
    case kF32:
      return q_dtype == kF32 ? launch_d<float>(d, p, q_dtype, b, splits, st)
                             : cudaErrorInvalidValue;
    case kBF16: return launch_d<__nv_bfloat16>(d, p, q_dtype, b, splits, st);
    case kI8: return launch_d<int8_t>(d, p, q_dtype, b, splits, st);
    case kFP8: return launch_d<__nv_fp8_e4m3>(d, p, q_dtype, b, splits, st);
    default: return cudaErrorInvalidValue;
  }
}
