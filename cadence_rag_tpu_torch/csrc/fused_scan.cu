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
// What bounds it on an H100: the tensor work. At batch 128 over 1M rows the
// corpus is ~6.4 GB (2 GB bf16 embeddings, 4 GB int8 signatures, 128 MB of
// mask): ~1.9 ms at 3.35 TB/s. The lexical query is f32, so it reaches the
// bf16 tensor cores as three bf16 pieces (h = bf16(q), m = bf16(q - h),
// l = bf16(q - h - m), split by the wrapper; every piece x int8 product is
// exact and the split leaves ~2^-24 |q| per term): 2*128*1M*(1024 + 3*4096)
// = 3.57 TFLOP, ~3.6 ms at 989 TFLOP/s. Tensor work, not HBM, is the floor;
// next comes L2: every 128-row M tile re-reads the query slabs.
//
// What the design does about it:
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
//     for int8, widened to bf16 exactly in registers; the three lexical
//     pieces share one A fragment. The wrapper permutes each 32-wide K slab
//     of the queries so that one 16- (bf16) or 8-byte (int8) load per row
//     gives a thread both 16-wide K steps of its fragment, conflict-free.
//   - The query slabs are the shared-memory (B) operand, brought by one TMA
//     load per stage in the 64-byte swizzle wgmma reads. At batch <= 128
//     each consumer warpgroup runs two M tiles (256 rows a stage for the
//     CTA), so each query slab read from L2 serves 256 rows.
//   - Warp specialisation: a producer warpgroup fills a multi-stage ring in
//     dynamic shared memory (rows by cp.async, queries by TMA, mbarrier
//     hand-off) and, from one more thread, stages each (queries x 256 rows)
//     filter-mask tile by TMA; two consumer warpgroups issue the products of
//     a stage and retire the previous stage's (wgmma.wait_group 1), so the
//     tensor cores never wait on the fragment loads. setmaxnreg gives the
//     consumers 240 registers (the producer keeps 24): the two tiles' f32
//     accumulators take 128 of them, and ptxas reports no spills.
//   - Only the N/8 candidates per lane and query reach device memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 1024;                  // K1 candidate block
constexpr int kGroups = 128;                      // groups per block
constexpr int kTileRows = 64;                     // one wgmma M tile: 8 groups x 8 w
constexpr int kKS = 32;                           // K elements per ring stage
constexpr int kQRowBytes = kKS * 2;               // a query's slab row: 64 B, swizzled
constexpr int kLexPieces = 3;
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
  // a stage: the query pieces, then the row slab (bf16 or int8 rows)
  static constexpr int kStageBytes = cmax(kPieceBytes + kStageRows * kKS * 2,
                                          kLexPieces * kPieceBytes + kStageRows * kKS);
  static constexpr int kStages = cmin(
      (kSmemMax - kAlign - kBarrierBytes - kMaskBytes) / kStageBytes, kMaxStages);
  static constexpr int kSmemBytes =
      kAlign + kBarrierBytes + kMaskBytes + kStages * kStageBytes;
  static_assert(kStages >= 2, "ring depth");
  static_assert(kStageBytes % kAlign == 0 && kMaskBytes % kAlign == 0, "alignment");
};

struct Params {
  const void* emb;             // (n, dim) bf16 or int8
  const int8_t* lex;           // (n, lex_dim)
  const bool* has_emb;         // (n,)
  long long n;
  long long n_cand;
  int batch, dim, lex_dim, do_dense;
  float emb_scale;
  float* d_vals;
  int* d_idx;
  float* l_vals;
  int* l_idx;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers and asynchronous copies ----------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// one warp's release of a barrier counted in warps
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// arrive on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// a 3-d TMA box global -> shared, completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(bar)
      : "memory");
}

// -- wgmma --------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}
// keeps the compiler from reusing or reading registers that an asynchronous
// wgmma still reads or writes
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r) :: "memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r) :: "memory"); }

// shared-memory descriptor of a K-major operand in the 64-byte swizzle:
// 64-byte rows, 8-row atoms of 512 bytes (SBO); LBO is unused
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(512 >> 4) << 32)
         | (static_cast<uint64_t>(2) << 62);
}

// D(64 x N, f32) (+)= A(64 x 16, bf16 registers) * B(16 x N, bf16 shared,
// K-major); scale_d == 0 overwrites D. One overload per N (64, 128, 256).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

// -- A fragments --------------------------------------------------------------
// The m64k16 A fragment of thread (warp wp, lane l) covers rows
// r = wp*16 + l/4 and r + 8, columns 2c, 2c+1 (registers 0, 1) and 2c+8,
// 2c+9 (registers 2, 3), c = l%4. The wrapper stores each 32-wide K slab of
// the queries permuted so that logical column 16s + 2c + b + 8h of a slab
// holds element 8c + 4s + 2h + b: thread c then takes elements [8c, 8c+8)
// of each of its rows, for both K steps s, in one load.

// 4 int8 values -> 2 bf16x2 (exact): 2^23 + (x + 128) as f32, minus 2^23 + 128
__device__ __forceinline__ void widen_i8x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
  const __nv_bfloat162 a = __floats2bfloat162_rn(f0, f1);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f2, f3);
  lo = *reinterpret_cast<const uint32_t*>(&a);
  hi = *reinterpret_cast<const uint32_t*>(&b);
}

// a[s] = the fragment of K step s; p = this thread's bytes of row r
__device__ __forceinline__ void load_a(const uint8_t* p, __nv_bfloat16,
                                       uint32_t (&a)[2][4]) {
  constexpr int kRowBytes = kKS * 2;
  const uint4 r0 = *reinterpret_cast<const uint4*>(p);
  const uint4 r1 = *reinterpret_cast<const uint4*>(p + 8 * kRowBytes);
  a[0][0] = r0.x; a[0][1] = r1.x; a[0][2] = r0.y; a[0][3] = r1.y;
  a[1][0] = r0.z; a[1][1] = r1.z; a[1][2] = r0.w; a[1][3] = r1.w;
}

__device__ __forceinline__ void load_a(const uint8_t* p, int8_t, uint32_t (&a)[2][4]) {
  constexpr int kRowBytes = kKS;
  const uint2 r0 = *reinterpret_cast<const uint2*>(p);
  const uint2 r1 = *reinterpret_cast<const uint2*>(p + 8 * kRowBytes);
  widen_i8x4(r0.x, a[0][0], a[0][2]);
  widen_i8x4(r1.x, a[0][1], a[0][3]);
  widen_i8x4(r0.y, a[1][0], a[1][2]);
  widen_i8x4(r1.y, a[1][1], a[1][3]);
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
// pieces' slab (one TMA box: 32 K x N queries x pieces) and the row slab,
// staged row s (w = s % 8) holding row blk*1024 + w*128 + part*kStageGroups
// + s/8.
template <int N, typename T>
__device__ __forceinline__ void produce_lane(Ring<N>& ring, const T* rows, int k_dim,
                                             const CUtensorMap* qmap, int pieces,
                                             long long blk, int part, int q0,
                                             long long n, int ptid) {
  using C = Cfg<N>;
  constexpr int kChunks = kKS * static_cast<int>(sizeof(T)) / 16;   // per row
  constexpr int kRowBytes = kKS * static_cast<int>(sizeof(T));
  const long long row0 = blk * kBlockRows + part * C::kStageGroups;
  for (int k0 = 0; k0 < k_dim; k0 += kKS) {
    mbar_wait(ring.empty(), ring.phase ^ 1);
    uint8_t* st = ring.stage_ptr();
    if (ptid == 0) {
      mbar_expect_tx(ring.full(), pieces * C::kPieceBytes);
      tma_load_3d(smem_addr(st), qmap, ring.full(), k0, q0, 0);
    }
    uint8_t* slab = st + pieces * C::kPieceBytes;
    for (int i = ptid; i < C::kStageRows * kChunks; i += kCopyThreads) {
      const int s = i / kChunks;
      const int ch = i % kChunks;
      const long long row = row0 + (s % 8) * kGroups + s / 8;
      const bool valid = row < n;
      const T* src = rows + (valid ? row : 0) * k_dim + k0 + ch * (16 / sizeof(T));
      cp16(smem_addr(slab + s * kRowBytes + ch * 16), src, valid);
    }
    cp_async_arrive(ring.full());
    ring.advance();
  }
}

// -- the consumers --------------------------------------------------------------
// One stage: load this warpgroup's A fragments into `cur`, issue its
// products, then retire the previous stage's (whose fragments are `prev`)
// and release that stage to the producer.
template <int N, typename T, int kPieces>
__device__ __forceinline__ void consume_stage(
    Ring<N>& ring, int a_off, bool first,
    float (&d)[Cfg<N>::kTiles][N / 2],
    uint32_t (&cur)[Cfg<N>::kTiles][2][4], uint32_t (&prev)[Cfg<N>::kTiles][2][4],
    uint32_t& prev_empty) {
  using C = Cfg<N>;
  constexpr int kRowBytes = kKS * static_cast<int>(sizeof(T));
  mbar_wait(ring.full(), ring.phase);
  const uint8_t* st = ring.stage_ptr();
  const uint8_t* slab = st + kPieces * C::kPieceBytes + a_off;
#pragma unroll
  for (int t = 0; t < C::kTiles; ++t) load_a(slab + t * kTileRows * kRowBytes, T(), cur[t]);
  wgmma_fence();
  const uint32_t qs = smem_addr(st);
#pragma unroll
  for (int t = 0; t < C::kTiles; ++t) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int p = 0; p < kPieces; ++p) {
        const bool overwrite = first && s == 0 && p == 0;
        wgmma_rs(d[t], cur[t][s], desc_sw64(qs + p * C::kPieceBytes + s * 32),
                 overwrite ? 0 : 1);
      }
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

// One lane's full K loop for this warpgroup's tiles -> d (kTiles x 64 rows x N).
template <int N, typename T, int kPieces>
__device__ __forceinline__ void consume_lane(Ring<N>& ring, int k_dim, int wg, int wtid,
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
  for (int k = 0; k < nk; k += 2) {
    consume_stage<N, T, kPieces>(ring, a_off, k == 0, d, fa, fb, prev_empty);
    if (k + 1 < nk) consume_stage<N, T, kPieces>(ring, a_off, false, d, fb, fa, prev_empty);
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
// the 8.
template <int N>
__device__ __forceinline__ void epilogue(const float (&d)[N / 2], const uint8_t* mask_s,
                                         bool lexical, float scale, const Params& P,
                                         long long blk, int part, int tile,
                                         long long groups_here, int q0, int wtid,
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
        if (g < groups_here && q0 + qc < P.batch) {
          const long long at = static_cast<long long>(q0 + qc) * P.n_cand + blk * kGroups + g;
          out_vals[at] = best;
          out_idx[at] = static_cast<int>(blk * kBlockRows + best_w * kGroups + g);
        }
      }
    }
  }
}

// grid (row blocks, query tiles of N); one CTA scans one 1024-row block for
// N queries: warpgroup 0 produces, warpgroups 1-2 consume.
template <int N, typename EmbT>
__global__ void __launch_bounds__(kThreads, 1) fused_scan_kernel(
    const __grid_constant__ CUtensorMap q_emb_map,
    const __grid_constant__ CUtensorMap q_lex_map,
    const __grid_constant__ CUtensorMap mask_map, const Params P) {
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
  Ring<N> ring{mask_s + C::kMaskBytes, full0, empty0};

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(full0 + 8 * i, kCopyThreads + 1);   // the row copiers + the TMA's expect_tx
      mbar_init(empty0 + 8 * i, kConsumerWarps);
    }
    mbar_init(mask_full, 1);
    mbar_init(mask_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long blk = blockIdx.x;
  const int q0 = static_cast<int>(blockIdx.y) * N;
  const long long rows_here = P.n - blk * kBlockRows;
  const long long groups_here = rows_here < kGroups ? rows_here : kGroups;
  const int parts = static_cast<int>((groups_here + C::kStageGroups - 1) / C::kStageGroups);
  const EmbT* emb = static_cast<const EmbT*>(P.emb);

  if (tid < kProducerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (tid < kCopyThreads) {
      for (int part = 0; part < parts; ++part) {
        if (P.do_dense) {
          produce_lane<N, EmbT>(ring, emb, P.dim, &q_emb_map, 1, blk, part, q0, P.n, tid);
        }
        produce_lane<N, int8_t>(ring, P.lex, P.lex_dim, &q_lex_map, kLexPieces, blk, part,
                                q0, P.n, tid);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
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
        consume_lane<N, EmbT, 1>(ring, P.dim, wg, wtid, d);
        mbar_wait(mask_full, phase);
#pragma unroll
        for (int t = 0; t < C::kTiles; ++t) {
          epilogue<N>(d[t], mask_s, false, P.emb_scale, P, blk, part, wg * C::kTiles + t,
                      groups_here, q0, wtid, P.d_vals, P.d_idx);
        }
      }
      consume_lane<N, int8_t, kLexPieces>(ring, P.lex_dim, wg, wtid, d);
      mbar_wait(mask_full, phase);
#pragma unroll
      for (int t = 0; t < C::kTiles; ++t) {
        epilogue<N>(d[t], mask_s, true, 1.0f, P, blk, part, wg * C::kTiles + t,
                    groups_here, q0, wtid, P.l_vals, P.l_idx);
      }
      warp_arrive(mask_empty);
      phase ^= 1;
    }
  }
}

// -- host side ------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime so
// that nothing links libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// (pieces, batch, k_dim) bf16 queries; box (32 K, n_box queries, pieces),
// 64-byte swizzle, queries past batch read as zeros
bool encode_queries(CUtensorMap* map, const void* q, int pieces, int batch, int k_dim,
                    int n_box) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k_dim), static_cast<cuuint64_t>(batch),
                              static_cast<cuuint64_t>(pieces)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(k_dim) * 2,
                                 static_cast<cuuint64_t>(batch) * k_dim * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kKS), static_cast<cuuint32_t>(n_box),
                             static_cast<cuuint32_t>(pieces)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(q),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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

template <int N, typename EmbT>
cudaError_t launch(const void* q_emb, const void* q_lex, const void* mask,
                   long long mask_ld, const Params& P, long long n_blocks,
                   cudaStream_t s) {
  using C = Cfg<N>;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_lex_map, q_emb_map, mask_map;
  if (!encode_queries(&q_lex_map, q_lex, kLexPieces, P.batch, P.lex_dim, N)
      || !encode_mask(&mask_map, mask, mask_ld, P.batch, C::kStageGroups, N)) {
    return cudaErrorInvalidValue;
  }
  q_emb_map = q_lex_map;
  if (P.do_dense && !encode_queries(&q_emb_map, q_emb, 1, P.batch, P.dim, N)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = fused_scan_kernel<N, EmbT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  static_cast<unsigned>((P.batch + N - 1) / N));
  kernel<<<grid, kThreads, C::kSmemBytes, s>>>(q_emb_map, q_lex_map, mask_map, P);
  return cudaGetLastError();
}

template <typename EmbT>
cudaError_t launch_for_batch(const void* q_emb, const void* q_lex, const void* mask,
                             long long mask_ld, const Params& P, long long n_blocks,
                             cudaStream_t s) {
  if (P.batch <= 64) return launch<64, EmbT>(q_emb, q_lex, mask, mask_ld, P, n_blocks, s);
  if (P.batch <= 128) return launch<128, EmbT>(q_emb, q_lex, mask, mask_ld, P, n_blocks, s);
  return launch<256, EmbT>(q_emb, q_lex, mask, mask_ld, P, n_blocks, s);
}

}  // namespace

// q_emb (batch, dim) bf16, the rounded query; q_lex (3, batch, lex_dim) bf16,
// the three pieces of the f32 lexical query; both with every 32-wide K slab
// in the kernel's order (ops/fused_scan.py). emb (n, dim) bf16 or int8; lex
// (n, lex_dim) int8; mask (batch, mask_ld) bool with mask_ld a multiple of
// 128 and >= n (columns past n are never selected); has_emb (n,) bool.
// Outputs (batch, n_cand): values f32, rows int32. dim and lex_dim must be
// multiples of 32 and every pointer 16-byte aligned (the wrapper checks).
// Launches on `stream`, does not synchronize.
extern "C" int ck_fused_scan(
    const void* q_emb, const void* q_lex, const void* emb, int emb_is_int8,
    const void* lex, const void* mask, long long mask_ld, const void* has_emb,
    long long n, int batch, int dim, int lex_dim, int do_dense,
    void* d_vals, void* d_idx, void* l_vals, void* l_idx, long long n_cand,
    void* stream) {
  if (n <= 0 || batch <= 0 || dim % kKS != 0 || lex_dim % kKS != 0
      || mask_ld % kGroups != 0 || mask_ld < n) {
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
  const cudaError_t err = emb_is_int8
      ? launch_for_batch<int8_t>(q_emb, q_lex, mask, mask_ld, P, n_blocks, s)
      : launch_for_batch<__nv_bfloat16>(q_emb, q_lex, mask, mask_ld, P, n_blocks, s);
  return static_cast<int>(err);
}
