// Kernel K2: the dense cosine scan with top-1-per-contiguous-group candidates.
//
// Replaces: cadence_rag_tpu/ops/pallas_topk.py — _kernel, pallas_candidates
// and pallas_cosine_topk, the TPU kernel that streams the embedding matrix
// through VMEM in block_n-row blocks and keeps one winner per group of
// width = block_n/128 CONTIGUOUS rows: group g of block b is the rows
// b*block_n + g*width + off (off = 0..width-1), the lowest offset winning a
// tie (jnp.argmax). Candidate b*128 + g carries the group's best value and
// row; a group whose rows are all masked carries -inf and its first row.
// block_n is a runtime multiple of 128 from 256 to 2048 (width 2..16).
//
// Defined beyond the TPU kernel, which asserts n % block_n == 0: a ragged
// last block of r rows has ceil(r/width) groups (a group is emitted only if
// it holds a row); rows past N score -inf.
//
// Precision: the query arrives rounded to bf16 (the Pallas kernel casts it
// to the bf16 storage dtype), rows are bf16, and wgmma sums the exact
// bf16 x bf16 products in f32: only the order of the sum differs from the
// TPU kernel. int8 rows are refused by the wrapper: the TPU kernel would
// cast the query to int8 and zero it.
//
// What bounds it on an H100: device memory. At batch 128 over 1M x 1024
// bf16 rows one pass reads 2.15 GB of rows and 134 MB of mask (~0.68 ms at
// 3.35 TB/s) for 275 GFLOP of bf16 products (~0.28 ms at 989 TFLOP/s).
//
// What the design does about it (K1's machinery, hopper.cuh):
//   - wgmma with the rows as M and the queries as N (64 or 128 a CTA), both
//     operands from shared memory: at batch <= 128 one CTA covers every
//     query of a block, so each row is read from device memory once.
//   - Sub-tile `off` of a block holds row g*width + off of each of its 128
//     groups, brought by ONE TMA box over a (K, width, groups) view of the
//     rows, in the 128-byte swizzle wgmma reads. Each consumer warpgroup's
//     64-row M tile is 64 whole groups, so every (query, group) cell stays in
//     the same accumulator register from one sub-tile to the next: the group
//     fold is a register max with a strict '>' in offset order, no shuffles,
//     for any width.
//   - Warp specialisation: one producer thread keeps a ring of (row slab,
//     query slab) pairs in flight by TMA with mbarrier hand-off, as deep as
//     shared memory allows (6 stages at 128 queries, 8 at 64);
//     three producer warps read the block's mask once, in 16-byte loads,
//     into one bit per offset for each (query, group) in shared memory; two
//     consumer warpgroups issue the products and retire the previous
//     stage's (wgmma.wait_group 1).
//   - Only the N/width candidates per query reach device memory.

#include "hopper.cuh"

namespace {

constexpr int kGroups = 128;                      // groups per block = rows per sub-tile
constexpr int kMinWidth = 2;
constexpr int kMaxWidth = 16;
constexpr int kTileRows = 64;                     // one wgmma M tile: 64 groups
constexpr int kProducerThreads = 128;
constexpr int kMaskThreads = 96;                  // producer warps 1-3
constexpr int kConsumerThreads = 256;
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kThreads = kProducerThreads + kConsumerThreads;
constexpr int kAlign = 1024;                      // swizzled TMA tiles want 512 B
constexpr int kBarrierBytes = 1024;
constexpr int kSlabK = 64;                        // K elements per stage: 128 B a row
constexpr int kRowSlabBytes = kGroups * kSlabK * 2;  // 128 rows x 128 B
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

static_assert(kProducerRegs * kProducerThreads + kConsumerRegs * kConsumerThreads
              <= 65536, "register split");
static_assert(kMaxWidth <= 16, "4-bit winner offset per cell");

template <int N>
struct Cfg {
  static constexpr int kQueryBytes = N * kSlabK * 2;
  static constexpr int kStageBytes = kRowSlabBytes + kQueryBytes;
  static constexpr int kStages =
      (232448 - kAlign - kBarrierBytes - N * kGroups * 2) / kStageBytes;
  static constexpr int kMaskBytes = N * kGroups * 2;      // uint16 [query][group]
  static constexpr int kSmemBytes =
      kAlign + kBarrierBytes + kMaskBytes + kStages * kStageBytes;
  static_assert(kStages >= 4, "ring depth");
  static_assert(kStageBytes % kAlign == 0 && kMaskBytes % kAlign == 0, "alignment");
  static_assert(kSmemBytes <= 232448, "shared memory");
};

struct Params {
  const bool* mask;            // (batch, mask_ld)
  long long mask_ld;           // a multiple of 16, >= n
  long long n;
  long long n_cand;
  int batch, dim, width;
  float* vals;
  int* idx;
};

// grid (row blocks, query tiles of N); one CTA scans one block of 128*width
// rows for N queries: warpgroup 0 produces, warpgroups 1-2 consume.
template <int N>
__global__ void __launch_bounds__(kThreads, 1) dense_scan_kernel(
    const __grid_constant__ CUtensorMap rows_map, const __grid_constant__ CUtensorMap q_map,
    const Params P) {
  using C = Cfg<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  // bars: full[kStages], empty[kStages], mask_full
  constexpr int kStages = C::kStages;
  const uint32_t full0 = smem_addr(bars);
  const uint32_t empty0 = smem_addr(bars + kStages);
  const uint32_t mask_full = smem_addr(bars + 2 * kStages);
  uint8_t* mask_s = smem + kBarrierBytes;             // uint16 [query][group]
  uint8_t* ring = mask_s + C::kMaskBytes;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);                  // the producer's expect_tx
      mbar_init(empty0 + 8 * i, kConsumerWarps);
    }
    mbar_init(mask_full, kMaskThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long blk = blockIdx.x;
  const int q0 = static_cast<int>(blockIdx.y) * N;
  const int width = P.width;
  const long long row0 = blk * kGroups * width;
  const int nk = P.dim / kSlabK;

  if (tid < kProducerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (tid == 0) {
      // the ring: sub-tile off's K slabs, one stage each
      int stage = 0;
      uint32_t phase = 0;
      for (int off = 0; off < width; ++off) {
        for (int k = 0; k < nk; ++k) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t st = smem_addr(ring + stage * C::kStageBytes);
          const uint32_t full = full0 + 8 * stage;
          mbar_expect_tx(full, C::kStageBytes);
          tma_load_3d(st, &rows_map, full, k * kSlabK, off, static_cast<int>(blk * kGroups));
          tma_load_2d(st + kRowSlabBytes, &q_map, full, k * kSlabK, q0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (tid >= 32) {
      // the block's mask once, as one bit per offset for each (query,
      // group): 16-byte loads of each query's block_n mask bytes, the bits
      // of a group OR-ed in (a group may straddle two loads); zero past n
      // and past the batch
      const int mt = tid - 32;
      uint32_t* bits32 = reinterpret_cast<uint32_t*>(mask_s);
      for (int i = mt; i < C::kMaskBytes / 4; i += kMaskThreads) bits32[i] = 0u;
      asm volatile("bar.sync 1, %0;\n" :: "n"(kMaskThreads) : "memory");
      const int chunks = kGroups * width / 16;             // per query
      for (int c = mt; c < N * chunks; c += kMaskThreads) {
        const int q = c / chunks;
        const int r0 = (c % chunks) * 16;                  // row in the block
        if (q0 + q >= P.batch || row0 + r0 >= P.mask_ld) continue;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            P.mask + static_cast<long long>(q0 + q) * P.mask_ld + row0 + r0));
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
        int g = r0 / width;
        int off = r0 % width;
        uint32_t acc = 0u;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          acc |= static_cast<uint32_t>(((words[j / 4] >> (8 * (j % 4))) & 0xffu) != 0u) << off;
          if (++off == width || j == 15) {
            if (acc != 0u) {
              const int at = q * kGroups + g;
              atomicOr(bits32 + at / 2, acc << (16 * (at % 2)));
            }
            acc = 0u;
            off = 0;
            ++g;
          }
        }
      }
      mbar_arrive(mask_full);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int wg = tid / kProducerThreads - 1;
    const int wtid = tid % kProducerThreads;
    const int lane = wtid % 32;
    const int c = lane % 4;
    // accumulator cell 4j + 2h + e: group gbase + 8h, query 8j + 2c + e
    const int gbase = wg * kTileRows + (wtid / 32) * 16 + lane / 4;
    float d[N / 2];
    float best[N / 2];
    uint32_t best_off[N / 16];            // 4 bits per cell
#pragma unroll
    for (int i = 0; i < N / 2; ++i) best[i] = neg_inf();
#pragma unroll
    for (int i = 0; i < N / 16; ++i) best_off[i] = 0u;
    int stage = 0;
    uint32_t phase = 0;
    for (int off = 0; off < width; ++off) {
      uint32_t prev_empty = 0;
      for (int k = 0; k < nk; ++k) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t st = smem_addr(ring + stage * C::kStageBytes);
        const uint32_t a = st + wg * kTileRows * kSlabK * 2;
        const uint32_t b = st + kRowSlabBytes;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kSlabK / 16; ++s) {
          wgmma_ss(d, desc_sw128(a + 32 * s), desc_sw128(b + 32 * s),
                   k == 0 && s == 0 ? 0 : 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (prev_empty != 0) warp_arrive(prev_empty);
        prev_empty = empty0 + 8 * stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < N / 2; ++i) fence_reg(d[i]);
      warp_arrive(prev_empty);

      // fold this sub-tile into the running winners (from -inf, strict
      // '>': the lowest offset wins a tie; an all-masked group keeps
      // offset 0)
      if (off == 0) mbar_wait(mask_full, 0);
      const uint16_t* ms = reinterpret_cast<const uint16_t*>(mask_s);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int q = 8 * (i / 4) + 2 * c + i % 2;
        const int g = gbase + 8 * ((i / 2) % 2);
        const float v = (ms[q * kGroups + g] >> off) & 1u ? d[i] : neg_inf();
        const bool better = v > best[i];
        best[i] = better ? v : best[i];
        const int sh = 4 * (i % 8);
        best_off[i / 8] = better ? (best_off[i / 8] & ~(15u << sh))
                                       | (static_cast<uint32_t>(off) << sh)
                                 : best_off[i / 8];
      }
    }

    // groups holding at least one row: 128 in a full block, ceil(r/width)
    // in a ragged last block of r rows
    const long long rows_here = P.n - row0;
    const long long groups_here = rows_here >= static_cast<long long>(kGroups) * width
                                      ? kGroups
                                      : (rows_here + width - 1) / width;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int q = q0 + 8 * (i / 4) + 2 * c + i % 2;
      const int g = gbase + 8 * ((i / 2) % 2);
      if (q < P.batch && g < groups_here) {
        const long long at = static_cast<long long>(q) * P.n_cand + blk * kGroups + g;
        const int off = static_cast<int>((best_off[i / 8] >> (4 * (i % 8))) & 15u);
        P.vals[at] = best[i];
        P.idx[at] = static_cast<int>(row0 + static_cast<long long>(g) * width + off);
      }
    }
  }
}

// the (n_pad, dim) bf16 rows as (dim, width, n_pad / width): element (k,
// off, G) is row G*width + off; box (64 K, 1 offset, 128 groups) = one
// sub-tile's K slab, 128-byte swizzle, groups past the end read as zeros
bool encode_rows(CUtensorMap* map, const void* rows, long long n_pad, int dim, int width) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(n_pad / width)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dim) * 2,
                                 static_cast<cuuint64_t>(width) * dim * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kSlabK), 1,
                             static_cast<cuuint32_t>(kGroups)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(rows),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (batch, dim) bf16 queries; box (64 K, n_box queries), 128-byte swizzle,
// queries past batch read as zeros
bool encode_queries_sw128(CUtensorMap* map, const void* q, int batch, int dim, int n_box) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(dim) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kSlabK), static_cast<cuuint32_t>(n_box)};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(q),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
cudaError_t launch(const void* q, const void* rows, long long n_pad, const Params& P,
                   long long n_blocks, cudaStream_t s) {
  using C = Cfg<N>;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap rows_map, q_map;
  if (!encode_rows(&rows_map, rows, n_pad, P.dim, P.width)
      || !encode_queries_sw128(&q_map, q, P.batch, P.dim, N)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      dense_scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>((P.batch + N - 1) / N));
  dense_scan_kernel<N><<<grid, kThreads, C::kSmemBytes, s>>>(rows_map, q_map, P);
  return cudaGetLastError();
}

}  // namespace

// q (batch, dim) bf16, the rounded query; rows (n_pad, dim) bf16 with n_pad
// >= n a multiple of width (rows past n are never selected); mask (batch,
// mask_ld) bool with mask_ld >= n a multiple of 16 and zeros past n.
// Outputs (batch, n_cand): values f32, rows int32. dim must be a
// multiple of 64, pointers 16-byte aligned, block_n a multiple of 128 in
// [256, 2048] (the wrapper checks). Launches on `stream`, does not
// synchronize.
extern "C" int ck_dense_scan(
    const void* q, const void* rows, long long n_pad, const void* mask,
    long long mask_ld, long long n, int batch, int dim, int block_n, void* vals,
    void* idx, long long n_cand, void* stream) {
  const int width = block_n / kGroups;
  if (n <= 0 || batch <= 0 || dim <= 0 || dim % kSlabK != 0 || block_n % kGroups != 0
      || width < kMinWidth || width > kMaxWidth || n_pad < n || n_pad % width != 0
      || mask_ld < n || mask_ld % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_blocks = (n + block_n - 1) / block_n;
  if (n_blocks > 0x7fffffffLL || (batch + 127) / 128 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P;
  P.mask = static_cast<const bool*>(mask);
  P.mask_ld = mask_ld;
  P.n = n;
  P.n_cand = n_cand;
  P.batch = batch;
  P.dim = dim;
  P.width = width;
  P.vals = static_cast<float*>(vals);
  P.idx = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = batch <= 64 ? launch<64>(q, rows, n_pad, P, n_blocks, s)
                                      : launch<128>(q, rows, n_pad, P, n_blocks, s);
  return static_cast<int>(err);
}
