// Kernel K1: the fused dense + lexical scan with top-1-per-group candidates.
//
// Replaces: cadence_rag_tpu/ops/pallas_fused.py — _kernel, fused_candidates
// and pallas_fused_topk, the TPU kernel that streams the embedding and the
// lexical-signature matrices through VMEM in 1024-row blocks and keeps one
// winner per strided group. The partition is kept exactly: a block is 1024
// rows, and group g of block b is the 8 rows b*1024 + w*128 + g (w = 0..7);
// the earliest w wins a tie (strict '>', pallas_fused.py:57). Candidate
// b*128 + g carries the group's best value and row. A ragged last block of
// r rows has min(r, 128) groups; rows past N score -inf.
//
// Beyond the TPU kernel it also applies, as the serving lanes do:
//   - has_emb[row] on the dense lane (ops/fused.py:46);
//   - the 1/127 scale for int8 embeddings (ops/topk.py:48), in the epilogue;
//     the query is rounded to bf16, never cast to int8;
//   - the lexical query in f32 against int8 values (ops/lexical.py:31);
//   - a flag that skips the dense half (exact-mode batches).
//
// What bounds it on an H100: the bytes, where the lexical query allows. At
// batch 128 over 1M rows the corpus is ~6.4 GB (2 GB bf16 embeddings, 4 GB
// int8 signatures, 128 MB of mask): ~1.9 ms at 3.35 TB/s. The lexical query
// is f32 and reaches the tensor cores as up to three 16-bit pieces, h, m =
// q - h and l = q - h - m, each rounded (every piece x int8 product is exact
// in the f32 accumulator, and the three rebuild q within 2^-24 |q|):
//   - fp16 pieces when they rebuild every element of the batch that well and
//     nothing overflows fp16 (the served query: sums of f16 idf weights,
//     ops/pack.py); a bucket that holds one f16 weight is h alone, so m and l
//     are zero outside the few buckets two features of a query share;
//   - else bf16 pieces (an f32 query), m and l nonzero nearly everywhere.
// A 32-wide K slab issues h, and m or l only where some query of the CTA's
// tile has it nonzero. With all three: 2*128*1M*(1024 + 3*4096) = 3.57
// TFLOP, ~3.6 ms at 989 TFLOP/s, above the bytes; the served query issues
// 1.0-1.1 pieces a slab: ~1.4 ms, under them. Then what is left beside the
// bytes is moving them: the row copies, the query slabs from L2 (each
// 128-row M tile pair re-reads them) and the candidates' stores.
//
// What the design does about it:
//   - A small kernel ahead of the scan (query_split_kernel) rounds the
//     dense query to bf16 and splits the lexical query both ways, each in
//     the scan's K order, and writes, per query tile and slab, which
//     residual pieces are nonzero and whether the fp16 pieces fall short.
//     Every scan CTA reads all those bytes at its start, so the route is
//     the grid's, decided on the device: the host never waits.
//   - wgmma (sm_90a) with the corpus rows as M and the queries as N. A 64-row
//     M tile holds 8 whole groups: tile row m is row w*128 + g with
//     g = tile*8 + m/8, w = m%8. In the wgmma accumulator the 8 rows of a
//     group sit in 8 lanes of one warp (lane/4 = w), so the per-group winner
//     (earliest w on a tie) is a three-round shuffle reduce-scatter across
//     those lanes and no state crosses tiles.
//   - N is the batch: one CTA covers up to 256 queries (a 64-, 128- or
//     256-wide instruction), so at batch <= 256 every row block is read from
//     HBM once. Larger batches take more 256-query tiles.
//   - The rows are the register (A) operand: read from shared memory and,
//     for int8, widened exactly in registers to the route's type (bf16, or
//     fp16 by 0x6400 | (x + 128) less 1152); the lexical pieces share one A
//     fragment. The split kernel permutes each 32-wide K slab of the queries
//     so that one 16- (bf16) or 8-byte (int8) load per row gives a thread
//     both 16-wide K steps of its fragment, conflict-free.
//   - The query slabs are the shared-memory (B) operand, brought by one TMA
//     load per piece and stage in the 64-byte swizzle wgmma reads; a piece
//     a slab does not issue is neither loaded nor multiplied. At batch <=
//     128 each consumer warpgroup runs two M tiles (256 rows a stage for the
//     CTA), so each query slab read from L2 serves 256 rows.
//   - Warp specialisation: a producer warpgroup fills a multi-stage ring in
//     dynamic shared memory (queries by TMA; rows by TMA too, one 4-d box of
//     8 w x the stage's groups, in the order the M tiles want, and by
//     cp.async only in a ragged last block: 16-byte copies from rows 4 KB
//     apart cost the load/store unit a request each, which bounded the scan
//     once the lexical pieces fell; mbarrier hand-off) and, from one more
//     thread, stages each (queries x 256 rows) filter-mask tile by TMA; two
//     consumer warpgroups issue the products of a stage and retire the
//     previous stage's (wgmma.wait_group 1), so the tensor cores never wait
//     on the fragment loads. setmaxnreg gives the consumers 240 registers
//     (the producer keeps 24): the two tiles' f32 accumulators take 128 of
//     them; ptxas reports 12 bytes of spill.
//   - Only the N/8 candidates per lane and query reach device memory,
//     staged in shared memory so that a store covers a query's 8 groups of
//     an M tile (32 bytes) rather than one group of 32 queries.

#include "hopper.cuh"

namespace {

constexpr int kBlockRows = 1024;                  // K1 candidate block
constexpr int kGroups = 128;                      // groups per block
constexpr int kTileRows = 64;                     // one wgmma M tile: 8 groups x 8 w
constexpr int kQRowBytes = kKS * 2;               // a query's slab row: 64 B, swizzled
constexpr int kLexPieces = 3;                     // h, m, l: the slots of a stage
constexpr int kSplitThreads = 256;
constexpr int kProducerThreads = 128;
constexpr int kCopyThreads = 96;                  // warps 0-2: the ring; then the mask thread
constexpr int kConsumerThreads = 256;
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kThreads = kProducerThreads + kConsumerThreads;
constexpr int kAlign = 1024;                      // swizzled TMA tiles want 512 B
constexpr int kBarrierBytes = 1024;
constexpr int kSmemMax = 232448;                  // 227 KB opt-in per block
constexpr int kMaxStages = 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLexThreshold = 1e-3f;            // ops/lexical.py
constexpr int kOutStride = 9;                     // a staged query's 8 groups + 1 pad

// a (query tile, K slab)'s byte of query_split_kernel's output: which residual
// pieces some query of the tile has nonzero there, per route, and whether
// the fp16 pieces fall short of the query anywhere in it
constexpr uint32_t kRest = 0x3;                   // bit 0: m, bit 1: l (bf16)
constexpr int kF16Shift = 2;                      // the same for fp16, shifted
constexpr uint32_t kF16Short = 0x10;

static_assert(kProducerRegs * kProducerThreads + kConsumerRegs * kConsumerThreads
              <= 65536, "register split");

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

template <int N>
struct Cfg {
  static constexpr int kTiles = N <= 128 ? 2 : 1;              // M tiles per warpgroup
  static constexpr int kStageRows = 2 * kTiles * kTileRows;    // rows a stage holds
  static constexpr int kStageGroups = kStageRows / 8;
  static constexpr int kMaskBytes = N * kStageRows;            // [query][w][group]
  static constexpr int kPieceBytes = N * kQRowBytes;           // one query piece's slab
  // each consumer warpgroup's candidates of one M tile, [query][8 groups +
  // 1 pad] values then rows, staged for coalesced stores
  static constexpr int kOutWgBytes = N * kOutStride * 8;
  static constexpr int kOutBytes = 2 * kOutWgBytes;
  // a stage: the query pieces, then the row slab (bf16 or int8 rows)
  static constexpr int kStageBytes = cmax(kPieceBytes + kStageRows * kKS * 2,
                                          kLexPieces * kPieceBytes + kStageRows * kKS);
  static constexpr int kStages = cmin(
      (kSmemMax - kAlign - kBarrierBytes - kMaskBytes - kOutBytes) / kStageBytes, kMaxStages);
  static constexpr int kSmemBytes =
      kAlign + kBarrierBytes + kMaskBytes + kOutBytes + kStages * kStageBytes;
  static_assert(kStages >= 2, "ring depth");
  static_assert(kStageBytes % kAlign == 0 && kMaskBytes % kAlign == 0
                && kOutBytes % kAlign == 0, "alignment");
};

struct Params {
  const void* emb;             // (n, dim) bf16 or int8
  const int8_t* lex;           // (n, lex_dim)
  const bool* has_emb;         // (n,)
  const uint8_t* slab_bits;    // (query tiles, n_slabs), query_split_kernel's
  unsigned long long* counters;  // launches bf16 / fp16, pieces issued, slabs
  int n_slabs;
  long long n;
  long long n_cand;
  int batch, dim, lex_dim, do_dense;
  float emb_scale;
  float* d_vals;
  int* d_idx;
  float* l_vals;
  int* l_idx;
};

// -- A fragments --------------------------------------------------------------
// The m64k16 A fragment of thread (warp wp, lane l) covers rows
// r = wp*16 + l/4 and r + 8, columns 2c, 2c+1 (registers 0, 1) and 2c+8,
// 2c+9 (registers 2, 3), c = l%4. query_split_kernel stores each 32-wide K
// slab of the queries permuted so that logical column 16s + 2c + b + 8h of
// a slab holds element 8c + 4s + 2h + b (slab_source): thread c then takes
// elements [8c, 8c+8) of each of its rows, for both K steps s, in one load.
__device__ __forceinline__ int slab_source(int c) {
  const int col = c % 16;
  return 8 * ((col % 8) / 2) + 4 * (c / 16) + 2 * (col / 8) + col % 2;
}

// 4 int8 values -> 2 bf16x2 (exact): 2^23 + (x + 128) as f32, minus 2^23 + 128;
// with kF16 -> 2 f16x2 (exact): 0x6400 | (x + 128) is the f16 1024 + (x + 128),
// minus 1152 (0x6480), two values a subtraction
template <bool kF16>
__device__ __forceinline__ void widen_i8x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  if constexpr (kF16) {
    asm("sub.f16x2 %0, %1, %2;" : "=r"(lo) : "r"(__byte_perm(u, 0x64u, 0x4140)), "r"(0x64806480u));
    asm("sub.f16x2 %0, %1, %2;" : "=r"(hi) : "r"(__byte_perm(u, 0x64u, 0x4342)), "r"(0x64806480u));
  } else {
    const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
    const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
    const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
    const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
    const __nv_bfloat162 a = __floats2bfloat162_rn(f0, f1);
    const __nv_bfloat162 b = __floats2bfloat162_rn(f2, f3);
    lo = *reinterpret_cast<const uint32_t*>(&a);
    hi = *reinterpret_cast<const uint32_t*>(&b);
  }
}

// a[s] = the fragment of K step s; p = this thread's bytes of row r; kF16:
// the product's type (bf16 rows take the bf16 product)
template <bool kF16>
__device__ __forceinline__ void load_a(const uint8_t* p, __nv_bfloat16,
                                       uint32_t (&a)[2][4]) {
  static_assert(!kF16, "bf16 rows");
  constexpr int kRowBytes = kKS * 2;
  const uint4 r0 = *reinterpret_cast<const uint4*>(p);
  const uint4 r1 = *reinterpret_cast<const uint4*>(p + 8 * kRowBytes);
  a[0][0] = r0.x; a[0][1] = r1.x; a[0][2] = r0.y; a[0][3] = r1.y;
  a[1][0] = r0.z; a[1][1] = r1.z; a[1][2] = r0.w; a[1][3] = r1.w;
}

template <bool kF16>
__device__ __forceinline__ void load_a(const uint8_t* p, int8_t, uint32_t (&a)[2][4]) {
  constexpr int kRowBytes = kKS;
  const uint2 r0 = *reinterpret_cast<const uint2*>(p);
  const uint2 r1 = *reinterpret_cast<const uint2*>(p + 8 * kRowBytes);
  widen_i8x4<kF16>(r0.x, a[0][0], a[0][2]);
  widen_i8x4<kF16>(r1.x, a[0][1], a[0][3]);
  widen_i8x4<kF16>(r0.y, a[1][0], a[1][2]);
  widen_i8x4<kF16>(r1.y, a[1][1], a[1][3]);
}

// -- the ring -----------------------------------------------------------------
template <int N>
struct Ring {
  uint8_t* base;     // stage 0
  uint32_t full0;    // barrier addresses: full[i] = full0 + 8i
  uint32_t empty0;
  int stage = 0;
  uint32_t phase = 0;

  __device__ uint8_t* stage_ptr() const { return base + stage * Cfg<N>::kStageBytes; }
  __device__ uint32_t full() const { return full0 + 8 * stage; }
  __device__ uint32_t empty() const { return empty0 + 8 * stage; }
  __device__ void advance() {
    if (++stage == Cfg<N>::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// -- the producer ---------------------------------------------------------------
// One lane's K loop over part `part` of row block `blk` (its groups
// [part*kStageGroups, (part+1)*kStageGroups)): each stage gets the query
// pieces' slab (one TMA box of 32 K x N queries a piece, into the piece's
// slot of kPieces) and the row slab, staged row s (w = s % 8) holding row
// blk*1024 + w*128 + part*kStageGroups + s/8: one TMA box from `rows_map`
// for a whole block, else (the ragged last block) 16-byte cp.async copies,
// zero past n. The lexical lane passes its tile's slab bytes and the
// route's shift: a stage loads h, then m and l where their bit is set. A
// stage's full barrier counts thread 0's expect_tx and one arrival a copy
// warp.
template <int N, typename T, int kPieces>
__device__ __forceinline__ void produce_lane(Ring<N>& ring, const T* rows,
                                             const CUtensorMap* rows_map, int k_dim,
                                             const CUtensorMap* qmap,
                                             const uint8_t* slab_bits, int shift,
                                             long long blk, int part, int q0,
                                             long long n, int ptid) {
  using C = Cfg<N>;
  constexpr int kChunks = kKS * static_cast<int>(sizeof(T)) / 16;   // per row
  constexpr int kRowBytes = kKS * static_cast<int>(sizeof(T));
  const long long row0 = blk * kBlockRows + part * C::kStageGroups;
  const bool whole = (blk + 1) * kBlockRows <= n;
  for (int k0 = 0; k0 < k_dim; k0 += kKS) {
    const uint32_t rest = (kPieces > 1 && ptid == 0)
                              ? (__ldg(slab_bits + k0 / kKS) >> shift) & kRest : 0u;
    mbar_wait(ring.empty(), ring.phase ^ 1);
    uint8_t* st = ring.stage_ptr();
    uint8_t* slab = st + kPieces * C::kPieceBytes;
    if (ptid == 0) {
      mbar_expect_tx(ring.full(), (1 + __popc(rest)) * C::kPieceBytes
                                      + (whole ? C::kStageRows * kRowBytes : 0));
      tma_load_3d(smem_addr(st), qmap, ring.full(), k0, q0, 0);
#pragma unroll
      for (int p = 1; p < kPieces; ++p) {
        if ((rest >> (p - 1)) & 1u) {
          tma_load_3d(smem_addr(st + p * C::kPieceBytes), qmap, ring.full(), k0, q0, p);
        }
      }
      if (whole) {
        tma_load_4d(smem_addr(slab), rows_map, ring.full(), k0, 0, part * C::kStageGroups,
                    static_cast<int>(blk));
      }
    }
    if (!whole) {
      for (int i = ptid; i < C::kStageRows * kChunks; i += kCopyThreads) {
        const int s = i / kChunks;
        const int ch = i % kChunks;
        const long long row = row0 + (s % 8) * kGroups + s / 8;
        const bool valid = row < n;
        const T* src = rows + (valid ? row : 0) * k_dim + k0 + ch * (16 / sizeof(T));
        cp16(smem_addr(slab + s * kRowBytes + ch * 16), src, valid);
      }
      cp_async_hold(ring.full());
    }
    warp_arrive(ring.full());
    ring.advance();
  }
}

// -- the consumers --------------------------------------------------------------
// The products of one stage: h, then the residual pieces kRestMask names,
// each K step's in the order h, m, l.
template <int N, bool kF16, uint32_t kRestMask>
__device__ __forceinline__ void issue_stage(float (&d)[Cfg<N>::kTiles][N / 2],
                                            uint32_t (&cur)[Cfg<N>::kTiles][2][4],
                                            uint32_t qs, bool first) {
  using C = Cfg<N>;
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < C::kTiles; ++t) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      wgmma_rs<kF16>(d[t], cur[t][s], desc_sw64(qs + s * 32), first && s == 0 ? 0 : 1);
      if constexpr ((kRestMask & 1u) != 0) {
        wgmma_rs<kF16>(d[t], cur[t][s], desc_sw64(qs + C::kPieceBytes + s * 32), 1);
      }
      if constexpr ((kRestMask & 2u) != 0) {
        wgmma_rs<kF16>(d[t], cur[t][s], desc_sw64(qs + 2 * C::kPieceBytes + s * 32), 1);
      }
    }
  }
}

// One stage: load this warpgroup's A fragments into `cur`, issue its
// products (h, and the residual pieces whose bit `rest` sets: one of four
// straight runs of products, so that no branch falls between two of them),
// then retire the previous stage's (whose fragments are `prev`) and release
// that stage to the producer. kF16: the route's product type.
template <int N, typename T, bool kF16, int kPieces>
__device__ __forceinline__ void consume_stage(
    Ring<N>& ring, int a_off, bool first, uint32_t rest,
    float (&d)[Cfg<N>::kTiles][N / 2],
    uint32_t (&cur)[Cfg<N>::kTiles][2][4], uint32_t (&prev)[Cfg<N>::kTiles][2][4],
    uint32_t& prev_empty) {
  using C = Cfg<N>;
  constexpr int kRowBytes = kKS * static_cast<int>(sizeof(T));
  mbar_wait(ring.full(), ring.phase);
  const uint8_t* st = ring.stage_ptr();
  const uint8_t* slab = st + kPieces * C::kPieceBytes + a_off;
#pragma unroll
  for (int t = 0; t < C::kTiles; ++t) {
    load_a<kF16>(slab + t * kTileRows * kRowBytes, T(), cur[t]);
  }
  const uint32_t qs = smem_addr(st);
  if constexpr (kPieces == 1) {
    issue_stage<N, kF16, 0u>(d, cur, qs, first);
  } else {
    switch (rest) {
      case 0: issue_stage<N, kF16, 0u>(d, cur, qs, first); break;
      case 1: issue_stage<N, kF16, 1u>(d, cur, qs, first); break;
      case 2: issue_stage<N, kF16, 2u>(d, cur, qs, first); break;
      default: issue_stage<N, kF16, 3u>(d, cur, qs, first); break;
    }
  }
  wgmma_commit();
  wgmma_wait<1>();
#pragma unroll
  for (int t = 0; t < C::kTiles; ++t)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_reg(prev[t][s][i]);
  if (prev_empty != 0) warp_arrive(prev_empty);
  prev_empty = ring.empty();
  ring.advance();
}

// One lane's full K loop for this warpgroup's tiles -> d (kTiles x 64 rows x
// N); the lexical lane passes its tile's slab bytes and the route's shift.
template <int N, typename T, bool kF16, int kPieces>
__device__ __forceinline__ void consume_lane(Ring<N>& ring, int k_dim, const uint8_t* slab_bits,
                                             int shift, int wg, int wtid,
                                             float (&d)[Cfg<N>::kTiles][N / 2]) {
  using C = Cfg<N>;
  constexpr int kRowBytes = kKS * static_cast<int>(sizeof(T));
  const int lane = wtid % 32;
  const int a_off = (wg * C::kTiles * kTileRows + (wtid / 32) * 16 + lane / 4) * kRowBytes
                    + (lane % 4) * 8 * static_cast<int>(sizeof(T));
  uint32_t fa[C::kTiles][2][4] = {};
  uint32_t fb[C::kTiles][2][4] = {};
  uint32_t prev_empty = 0;
  const int nk = k_dim / kKS;
  // broadcast from lane 0, so that the compiler knows the branches around
  // the residual products to be uniform and keeps the products in flight
  const auto rest = [&](int k) -> uint32_t {
    return kPieces > 1
        ? __shfl_sync(0xffffffffu, (__ldg(slab_bits + k) >> shift) & kRest, 0) : 0u;
  };
  for (int k = 0; k < nk; k += 2) {
    consume_stage<N, T, kF16, kPieces>(ring, a_off, k == 0, rest(k), d, fa, fb, prev_empty);
    if (k + 1 < nk) {
      consume_stage<N, T, kF16, kPieces>(ring, a_off, false, rest(k + 1), d, fb, fa,
                                         prev_empty);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < C::kTiles; ++t) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_reg(d[t][i]);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fence_reg(fa[t][s][i]);
        fence_reg(fb[t][s][i]);
      }
  }
  warp_arrive(prev_empty);
}

// the 128 threads of consumer warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// The winner of (v, w) and (ov, ow): the larger value, the earlier w on a
// tie (selects, no branch).
__device__ __forceinline__ void take_best(float& v, int& w, float ov, int ow) {
  const bool better = (ov > v) | ((ov == v) & (ow < w));
  v = better ? ov : v;
  w = better ? ow : w;
}

// Mask, has_emb / threshold, and the per-group fold of one tile's scores;
// writes the tile's 8 candidates per query. A group's 8 rows sit in the 8
// lanes l with l % 4 == c (w = l / 4), each holding the same cells: for its
// groups h = 0, 1 and query column j, accumulator cells 4j + 2h + e are
// query 8j + 2c + e. The folds go 8 at a time (4 columns, both e; few live
// registers beside the other tile's accumulators) as a reduce-scatter over
// the three w bits: each round a lane keeps half of its folds and takes the
// partner's value for them, so after three rounds lane w holds fold w of
// the 8. The tile's candidates are staged in the warpgroup's part of
// `out_s`, then stored a query's 8 groups (32 bytes) at a time: from the
// lanes directly, each store would land in 32 query rows, n_cand apart.
template <int N>
__device__ __forceinline__ void epilogue(const float (&d)[N / 2], const uint8_t* mask_s,
                                         uint8_t* out_s, bool lexical, float scale,
                                         const Params& P, long long blk, int part, int tile,
                                         long long groups_here, int q0, int wg, int wtid,
                                         float* out_vals, int* out_idx) {
  using C = Cfg<N>;
  constexpr int kFolds = 8;
  const int lane = wtid % 32;
  const int wp = wtid / 32;
  const int c = lane % 4;
  const int w = lane / 4;
  const int gq = tile * 8 + 2 * wp;                    // group of h = 0 in the part
  const int g0 = part * C::kStageGroups + gq;          // ... in the block
  const uint8_t* m = mask_s + w * C::kStageGroups + gq;
  float* vals_s = reinterpret_cast<float*>(out_s + wg * C::kOutWgBytes);
  int* rows_s = reinterpret_cast<int*>(out_s + wg * C::kOutWgBytes + N * kOutStride * 4);
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = blk * kBlockRows + w * kGroups + g0 + h;
    row_ok[h] = row < P.n && (lexical || P.has_emb[row]);
  }
#pragma unroll
  for (int j0 = 0; j0 < N / 8; j0 += kFolds / 2) {
    // the mask bytes of both groups (bits0: h = 0, bits1: h = 1), bit i for
    // fold i = 2(j - j0) + e
    uint32_t bits0 = 0, bits1 = 0;
#pragma unroll
    for (int i = 0; i < kFolds; ++i) {
      const int qc = 8 * (j0 + i / 2) + 2 * c + i % 2;
      const uint32_t both = *reinterpret_cast<const uint16_t*>(m + qc * C::kStageRows);
      bits0 |= static_cast<uint32_t>((both & 0xffu) != 0) << i;
      bits1 |= static_cast<uint32_t>((both >> 8) != 0) << i;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t bits = h ? bits1 : bits0;
      float v[kFolds];
#pragma unroll
      for (int i = 0; i < kFolds; ++i) {
        const float s = d[4 * (j0 + i / 2) + 2 * h + i % 2] * scale;
        bool ok = row_ok[h] && ((bits >> i) & 1u);
        if (lexical) ok = ok && s > kLexThreshold;
        v[i] = ok ? s : neg_inf();
      }
      // w bit 2 (lane xor 16): every cell of a lane still has the lane's own w
      const bool hi1 = (w >> 2) & 1;
      float v1[kFolds / 2];
      int w1[kFolds / 2];
#pragma unroll
      for (int i = 0; i < kFolds / 2; ++i) {
        const float send = hi1 ? v[i] : v[i + kFolds / 2];
        v1[i] = hi1 ? v[i + kFolds / 2] : v[i];
        w1[i] = w;
        take_best(v1[i], w1[i], __shfl_xor_sync(0xffffffffu, send, 16), w ^ 4);
      }
      // w bit 1 (lane xor 8)
      const bool hi2 = (w >> 1) & 1;
      float v2[kFolds / 4];
      int w2[kFolds / 4];
#pragma unroll
      for (int i = 0; i < kFolds / 4; ++i) {
        const float send_v = hi2 ? v1[i] : v1[i + kFolds / 4];
        const int send_w = hi2 ? w1[i] : w1[i + kFolds / 4];
        v2[i] = hi2 ? v1[i + kFolds / 4] : v1[i];
        w2[i] = hi2 ? w1[i + kFolds / 4] : w1[i];
        take_best(v2[i], w2[i], __shfl_xor_sync(0xffffffffu, send_v, 8),
                  __shfl_xor_sync(0xffffffffu, send_w, 8));
      }
      // w bit 0 (lane xor 4), then write the lane's two finished folds
      const bool hi3 = w & 1;
      const int g = g0 + h;
#pragma unroll
      for (int i = 0; i < kFolds / 8; ++i) {
        const float send_v = hi3 ? v2[i] : v2[i + kFolds / 8];
        const int send_w = hi3 ? w2[i] : w2[i + kFolds / 8];
        float best = hi3 ? v2[i + kFolds / 8] : v2[i];
        int best_w = hi3 ? w2[i + kFolds / 8] : w2[i];
        take_best(best, best_w, __shfl_xor_sync(0xffffffffu, send_v, 4),
                  __shfl_xor_sync(0xffffffffu, send_w, 4));
        const int fold = (kFolds / 8) * w + i;
        const int qc = 8 * (j0 + fold / 2) + 2 * c + fold % 2;
        vals_s[qc * kOutStride + 2 * wp + h] = best;
        rows_s[qc * kOutStride + 2 * wp + h] =
            static_cast<int>(blk * kBlockRows + best_w * kGroups + g);
      }
    }
  }
  wg_sync(wg);
  for (int e = wtid; e < N * 8; e += kConsumerThreads / 2) {
    const int q = e / 8;
    const int g = part * C::kStageGroups + tile * 8 + e % 8;
    if (g < groups_here && q0 + q < P.batch) {
      const long long at = static_cast<long long>(q0 + q) * P.n_cand + blk * kGroups + g;
      out_vals[at] = vals_s[q * kOutStride + e % 8];
      out_idx[at] = rows_s[q * kOutStride + e % 8];
    }
  }
  wg_sync(wg);
}

// -- the queries' pieces ------------------------------------------------------
// grid (lexical K slabs + dense K slabs, query tiles of N). A CTA of a
// lexical slab splits that 32-wide slab of N queries both ways, h = rn(q),
// m = rn(q - h), l = rn(q - h - m) (both differences exact in f32), into
// `pieces` (6, batch, k_dim): bf16 h, m, l then fp16 h, m, l; and writes the
// tile's slab byte (kRest, kF16Shift, kF16Short) to slab_bits. A CTA of a
// dense slab rounds it to bf16 into `emb_piece` (batch, dim). Each slab in
// the scan's K order (slab_source).
template <int N>
__global__ void __launch_bounds__(kSplitThreads) query_split_kernel(
    const float* q, const float* q_emb, int batch, int k_dim, int dim, uint16_t* pieces,
    uint16_t* emb_piece, uint8_t* slab_bits) {
  __shared__ uint32_t tile_bits;
  const int n_slabs = k_dim / kKS;
  const int tile = blockIdx.y;
  if (static_cast<int>(blockIdx.x) >= n_slabs) {
    const int slab = blockIdx.x - n_slabs;
    for (int i = threadIdx.x; i < N * kKS; i += kSplitThreads) {
      const int query = tile * N + i / kKS;
      if (query >= batch) break;
      const size_t row = static_cast<size_t>(query) * dim + slab * kKS;
      emb_piece[row + i % kKS] =
          __bfloat16_as_ushort(__float2bfloat16_rn(q_emb[row + slab_source(i % kKS)]));
    }
    return;
  }
  const int slab = blockIdx.x;
  const size_t plane = static_cast<size_t>(batch) * k_dim;
  if (threadIdx.x == 0) tile_bits = 0;
  __syncthreads();
  uint32_t bits = 0;
  for (int i = threadIdx.x; i < N * kKS; i += kSplitThreads) {
    const int query = tile * N + i / kKS;
    if (query >= batch) break;
    const int c = i % kKS;
    const size_t row = static_cast<size_t>(query) * k_dim + slab * kKS;
    const float x = q[row + slab_source(c)];
    const __nv_bfloat16 bh = __float2bfloat16_rn(x);
    const float br = x - __bfloat162float(bh);
    const __nv_bfloat16 bm = __float2bfloat16_rn(br);
    const __nv_bfloat16 bl = __float2bfloat16_rn(br - __bfloat162float(bm));
    const __half hh = __float2half_rn(x);
    const float hr = x - __half2float(hh);
    const __half hm = __float2half_rn(hr);
    const float hr2 = hr - __half2float(hm);
    const __half hl = __float2half_rn(hr2);
    const uint16_t out[6] = {__bfloat16_as_ushort(bh), __bfloat16_as_ushort(bm),
                             __bfloat16_as_ushort(bl), __half_as_ushort(hh),
                             __half_as_ushort(hm), __half_as_ushort(hl)};
#pragma unroll
    for (int p = 0; p < 6; ++p) pieces[p * plane + row + c] = out[p];
    bits |= ((out[1] & 0x7fffu) != 0 ? 1u : 0u) | ((out[2] & 0x7fffu) != 0 ? 2u : 0u)
            | ((out[4] & 0x7fffu) != 0 ? 1u << kF16Shift : 0u)
            | ((out[5] & 0x7fffu) != 0 ? 2u << kF16Shift : 0u);
    // h finite; 2^-24 |x| is exact (a power of two), so is hr2 - hl; NaN fails
    const bool rebuilt = (out[3] & 0x7c00u) != 0x7c00u
                         && fabsf(hr2 - __half2float(hl)) <= fabsf(x) * 5.9604645e-8f;
    if (!rebuilt) bits |= kF16Short;
  }
  if (bits != 0) atomicOr(&tile_bits, bits);
  __syncthreads();
  if (threadIdx.x == 0) slab_bits[tile * n_slabs + slab] = static_cast<uint8_t>(tile_bits);
}

// -- the scan ---------------------------------------------------------------------
// grid (row blocks, query tiles of N); one CTA scans one 1024-row block for
// N queries: warpgroup 0 produces, warpgroups 1-2 consume. The lexical lane
// takes the fp16 pieces (q_lex_f16_map) unless query_split_kernel found one
// slab of one tile where they fall short, else the bf16 pieces.
template <int N, typename EmbT>
__global__ void __launch_bounds__(kThreads, 1) fused_scan_kernel(
    const __grid_constant__ CUtensorMap q_emb_map,
    const __grid_constant__ CUtensorMap q_lex_map,
    const __grid_constant__ CUtensorMap q_lex_f16_map,
    const __grid_constant__ CUtensorMap mask_map,
    const __grid_constant__ CUtensorMap emb_rows_map,
    const __grid_constant__ CUtensorMap lex_rows_map, const Params P) {
  using C = Cfg<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  // bars[0..kMaxStages): full, [kMaxStages..2kMaxStages): empty, then mask full/empty
  const uint32_t full0 = smem_addr(bars);
  const uint32_t empty0 = smem_addr(bars + kMaxStages);
  const uint32_t mask_full = smem_addr(bars + 2 * kMaxStages);
  const uint32_t mask_empty = smem_addr(bars + 2 * kMaxStages + 1);
  uint8_t* mask_s = smem + kBarrierBytes;
  uint8_t* out_s = mask_s + C::kMaskBytes;
  Ring<N> ring{out_s + C::kOutBytes, full0, empty0};

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(full0 + 8 * i, kCopyThreads / 32 + 1);   // the copy warps + the expect_tx
      mbar_init(empty0 + 8 * i, kConsumerWarps);
    }
    mbar_init(mask_full, 1);
    mbar_init(mask_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the route, from every tile's slab bytes: the same in every CTA
  bool short_f16 = false;
  for (int i = tid; i < P.n_slabs * static_cast<int>(gridDim.y); i += kThreads) {
    short_f16 |= (__ldg(P.slab_bits + i) & kF16Short) != 0;
  }
  // (broadcast from lane 0 as well, so that the compiler knows the branch
  // between the routes' products to be uniform and keeps them in flight)
  const bool f16 = __shfl_sync(0xffffffffu, __syncthreads_or(short_f16), 0) == 0;
  const uint8_t* tile_bits = P.slab_bits + static_cast<size_t>(blockIdx.y) * P.n_slabs;
  const int shift = f16 ? kF16Shift : 0;

  const long long blk = blockIdx.x;
  const int q0 = static_cast<int>(blockIdx.y) * N;
  const long long rows_here = P.n - blk * kBlockRows;
  const long long groups_here = rows_here < kGroups ? rows_here : kGroups;
  const int parts = static_cast<int>((groups_here + C::kStageGroups - 1) / C::kStageGroups);
  const EmbT* emb = static_cast<const EmbT*>(P.emb);

  if (tid < kProducerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (tid < kCopyThreads) {
      const CUtensorMap* lex_map = f16 ? &q_lex_f16_map : &q_lex_map;
      for (int part = 0; part < parts; ++part) {
        if (P.do_dense) {
          produce_lane<N, EmbT, 1>(ring, emb, &emb_rows_map, P.dim, &q_emb_map, nullptr, 0,
                                   blk, part, q0, P.n, tid);
        }
        produce_lane<N, int8_t, kLexPieces>(ring, P.lex, &lex_rows_map, P.lex_dim, lex_map,
                                            tile_bits, shift, blk, part, q0, P.n, tid);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      // the pieces a part of this tile issued (every part issues the same),
      // counted once a query tile (from row block 0), and one launch
      if (tid == 0 && blk == 0) {
        int issued = 0;
        for (int k = 0; k < P.n_slabs; ++k) {
          issued += 1 + __popc((__ldg(tile_bits + k) >> shift) & kRest);
        }
        atomicAdd(P.counters + 2, static_cast<unsigned long long>(issued));
        atomicAdd(P.counters + 3, static_cast<unsigned long long>(P.n_slabs));
        if (blockIdx.y == 0) atomicAdd(P.counters + (f16 ? 1 : 0), 1ull);
      }
    } else if (tid == kCopyThreads) {
      // each part's (N queries x 8 w x kStageGroups) mask tile
      uint32_t phase = 0;
      for (int part = 0; part < parts; ++part) {
        mbar_wait(mask_empty, phase ^ 1);
        mbar_expect_tx(mask_full, C::kMaskBytes);
        tma_load_3d(smem_addr(mask_s), &mask_map, mask_full, part * C::kStageGroups,
                    static_cast<int>(blk * 8), q0);
        phase ^= 1;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int wg = tid / kProducerThreads - 1;
    float d[C::kTiles][N / 2];
    uint32_t phase = 0;
    for (int part = 0; part < parts; ++part) {
      // offsets derived from the thread index are recomputed per part
      // rather than held live (and spilled) through the K loops
      int wtid = tid % kProducerThreads;
      asm volatile("" : "+r"(wtid));
      if (P.do_dense) {
        consume_lane<N, EmbT, false, 1>(ring, P.dim, nullptr, 0, wg, wtid, d);
        mbar_wait(mask_full, phase);
#pragma unroll
        for (int t = 0; t < C::kTiles; ++t) {
          epilogue<N>(d[t], mask_s, out_s, false, P.emb_scale, P, blk, part,
                      wg * C::kTiles + t, groups_here, q0, wg, wtid, P.d_vals, P.d_idx);
        }
      }
      if (f16) {
        consume_lane<N, int8_t, true, kLexPieces>(ring, P.lex_dim, tile_bits, kF16Shift, wg,
                                                  wtid, d);
      } else {
        consume_lane<N, int8_t, false, kLexPieces>(ring, P.lex_dim, tile_bits, 0, wg, wtid, d);
      }
      mbar_wait(mask_full, phase);
#pragma unroll
      for (int t = 0; t < C::kTiles; ++t) {
        epilogue<N>(d[t], mask_s, out_s, true, 1.0f, P, blk, part, wg * C::kTiles + t,
                    groups_here, q0, wg, wtid, P.l_vals, P.l_idx);
      }
      warp_arrive(mask_empty);
      phase ^= 1;
    }
  }
}

// -- host side ------------------------------------------------------------------
// the (batch, mask_ld) bool mask as (128 groups, mask_ld / 128 sub-blocks,
// batch); box (stage groups, 8 w, n_box queries)
bool encode_mask(CUtensorMap* map, const void* mask, long long mask_ld, int batch,
                 int groups_box, int n_box) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kGroups),
                              static_cast<cuuint64_t>(mask_ld / kGroups),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(kGroups),
                                 static_cast<cuuint64_t>(mask_ld)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(groups_box), 8,
                             static_cast<cuuint32_t>(n_box)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(mask),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (n, k_dim) rows of `type` as (k_dim, 8 w, 128 g, whole blocks): row
// blk*1024 + w*128 + g; box (32 K, 8 w, groups_box g, one block), so that the
// staged row s = g*8 + w. Encoded over the whole blocks only (at least one:
// the map is not read without one).
bool encode_rows(CUtensorMap* map, const void* rows, CUtensorMapDataType type, int elem_bytes,
                 int k_dim, long long n, int groups_box) {
  const cuuint64_t row = static_cast<cuuint64_t>(k_dim) * elem_bytes;
  const long long blocks = n / kBlockRows;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(k_dim), 8, static_cast<cuuint64_t>(kGroups),
                              static_cast<cuuint64_t>(blocks > 0 ? blocks : 1)};
  const cuuint64_t strides[3] = {row * kGroups, row, row * kBlockRows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kKS), 8,
                             static_cast<cuuint32_t>(groups_box), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, type, 4, const_cast<void*>(rows), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the query tile: the batch's instruction width N
int query_tile(int batch) { return batch <= 64 ? 64 : batch <= 128 ? 128 : 256; }

// the scratch: the dense query's bf16 piece (with do_dense), the lexical
// query's six pieces (bf16 then fp16 h, m, l), then a byte per query tile
// and lexical K slab; every part a multiple of 64 bytes but the last
long long scratch_bytes(int batch, int dim, int lex_dim, int do_dense) {
  const long long tiles = (batch + query_tile(batch) - 1) / query_tile(batch);
  return (do_dense ? 2LL * batch * dim : 0) + 12LL * batch * lex_dim + tiles * (lex_dim / kKS);
}

// the split of the queries into `work`, then the scan
template <int N, typename EmbT>
cudaError_t launch(const float* q_emb, const float* q_lex, uint8_t* work, const void* mask,
                   long long mask_ld, Params P, long long n_blocks, cudaStream_t s) {
  using C = Cfg<N>;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const int tiles = (P.batch + N - 1) / N;
  const size_t plane_bytes = static_cast<size_t>(P.batch) * P.lex_dim * 2;
  uint8_t* emb_piece = work;
  uint8_t* pieces = emb_piece + (P.do_dense ? static_cast<size_t>(P.batch) * P.dim * 2 : 0);
  uint8_t* slab_bits = pieces + 6 * plane_bytes;
  P.slab_bits = slab_bits;
  const int dense_slabs = P.do_dense ? P.dim / kKS : 0;
  query_split_kernel<N><<<dim3(P.n_slabs + dense_slabs, tiles), kSplitThreads, 0, s>>>(
      q_lex, q_emb, P.batch, P.lex_dim, P.dim, reinterpret_cast<uint16_t*>(pieces),
      reinterpret_cast<uint16_t*>(emb_piece), slab_bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap q_lex_map, q_lex_f16_map, q_emb_map, mask_map;
  if (!encode_queries(&q_lex_map, pieces, kLexPieces, P.batch, P.lex_dim, N)
      || !encode_queries(&q_lex_f16_map, pieces + 3 * plane_bytes, kLexPieces, P.batch,
                         P.lex_dim, N, CU_TENSOR_MAP_DATA_TYPE_FLOAT16)
      || !encode_mask(&mask_map, mask, mask_ld, P.batch, C::kStageGroups, N)) {
    return cudaErrorInvalidValue;
  }
  constexpr bool kInt8Emb = sizeof(EmbT) == 1;
  CUtensorMap lex_rows_map, emb_rows_map;
  if (!encode_rows(&lex_rows_map, P.lex, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, P.lex_dim, P.n,
                   C::kStageGroups)) {
    return cudaErrorInvalidValue;
  }
  q_emb_map = q_lex_map;
  emb_rows_map = lex_rows_map;
  if (P.do_dense
      && (!encode_queries(&q_emb_map, emb_piece, 1, P.batch, P.dim, N)
          || !encode_rows(&emb_rows_map, P.emb,
                          kInt8Emb ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          sizeof(EmbT), P.dim, P.n, C::kStageGroups))) {
    return cudaErrorInvalidValue;
  }
  auto kernel = fused_scan_kernel<N, EmbT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>(tiles));
  kernel<<<grid, kThreads, C::kSmemBytes, s>>>(q_emb_map, q_lex_map, q_lex_f16_map, mask_map,
                                               emb_rows_map, lex_rows_map, P);
  return cudaGetLastError();
}

template <typename EmbT>
cudaError_t launch_for_batch(const float* q_emb, const float* q_lex, uint8_t* work,
                             const void* mask, long long mask_ld, const Params& P,
                             long long n_blocks, cudaStream_t s) {
  switch (query_tile(P.batch)) {
    case 64: return launch<64, EmbT>(q_emb, q_lex, work, mask, mask_ld, P, n_blocks, s);
    case 128: return launch<128, EmbT>(q_emb, q_lex, work, mask, mask_ld, P, n_blocks, s);
    default: return launch<256, EmbT>(q_emb, q_lex, work, mask, mask_ld, P, n_blocks, s);
  }
}

}  // namespace

// The query tile (the queries one scan CTA covers) for a batch, and the
// scratch ck_fused_scan needs: the wrapper sizes its buffer by these.
extern "C" int ck_fused_scan_tile(int batch) { return query_tile(batch); }

extern "C" long long ck_fused_scan_work_bytes(int batch, int dim, int lex_dim, int do_dense) {
  return scratch_bytes(batch, dim, lex_dim, do_dense);
}

// q_emb (batch, dim) f32 and q_lex (batch, lex_dim) f32, the queries as
// given (the split kernel rounds and orders them). work: scratch of
// ck_fused_scan_work_bytes; counters: 4 uint64 the kernel adds to
// (launches on the bf16 and the fp16 route, lexical pieces issued and K
// slabs, one count a query tile). emb (n, dim) bf16 or int8; lex (n, lex_dim) int8; mask (batch,
// mask_ld) bool with mask_ld a multiple of 128 and >= n (columns past n are
// never selected); has_emb (n,) bool. Outputs (batch, n_cand): values f32,
// rows int32. dim and lex_dim must be multiples of 32 and every pointer
// 16-byte aligned (the wrapper checks). Launches both kernels on `stream`,
// does not synchronize.
extern "C" int ck_fused_scan(
    const void* q_emb, const void* q_lex, void* work, long long work_bytes, void* counters,
    const void* emb, int emb_is_int8, const void* lex, const void* mask, long long mask_ld,
    const void* has_emb, long long n, int batch, int dim, int lex_dim, int do_dense,
    void* d_vals, void* d_idx, void* l_vals, void* l_idx, long long n_cand,
    void* stream) {
  if (n <= 0 || batch <= 0 || dim % kKS != 0 || lex_dim % kKS != 0
      || mask_ld % kGroups != 0 || mask_ld < n
      || work_bytes < scratch_bytes(batch, dim, lex_dim, do_dense)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_blocks = (n + kBlockRows - 1) / kBlockRows;
  if (n_blocks > 0x7fffffffLL || (batch + 255) / 256 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P;
  P.emb = emb;
  P.lex = static_cast<const int8_t*>(lex);
  P.has_emb = static_cast<const bool*>(has_emb);
  P.counters = static_cast<unsigned long long*>(counters);
  P.n_slabs = lex_dim / kKS;
  P.n = n;
  P.n_cand = n_cand;
  P.batch = batch;
  P.dim = dim;
  P.lex_dim = lex_dim;
  P.do_dense = do_dense;
  P.emb_scale = emb_is_int8 ? 1.0f / 127.0f : 1.0f;
  P.d_vals = static_cast<float*>(d_vals);
  P.d_idx = static_cast<int*>(d_idx);
  P.l_vals = static_cast<float*>(l_vals);
  P.l_idx = static_cast<int*>(l_idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qe = static_cast<const float*>(q_emb);
  const float* ql = static_cast<const float*>(q_lex);
  uint8_t* w = static_cast<uint8_t*>(work);
  const cudaError_t err = emb_is_int8
      ? launch_for_batch<int8_t>(qe, ql, w, mask, mask_ld, P, n_blocks, s)
      : launch_for_batch<__nv_bfloat16>(qe, ql, w, mask, mask_ld, P, n_blocks, s);
  return static_cast<int>(err);
}
