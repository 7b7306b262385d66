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
// Precision: the query arrives as f32 holding bf16-rounded values (the
// wrapper rounds it, as the Pallas kernel casts it to the bf16 storage
// dtype), rows are bf16 and widened to f32 at the shared-memory store, and
// the dot product is summed in f32. bf16 x bf16 products are exact in f32,
// so only the order of the sum differs from the TPU kernel. int8 rows are
// refused by the wrapper: the TPU kernel would cast the query to int8 and
// zero it.
//
// What bounds it on an H100: at batch 128 over 1M x 1024 bf16 rows one pass
// reads 2 GB and does 2*128*1M*1024 = 275 GFLOP, ~128 FLOP per byte: above
// the ~20 FLOP/byte at which the FP32 CUDA cores (67 TFLOP/s) stop waiting on
// HBM (3.35 TB/s), below the ~295 at which bf16 tensor cores would. So as
// written (CUDA cores) it is arithmetic-bound; on tensor cores it would be
// memory-bound.
//
// What the design does about it: K1's dense half (fused_scan.cu) with a
// different row map. A CTA owns one block_n-row block for 64 queries and
// walks `width` sub-tiles of 128 rows; sub-tile `off` holds row off of every
// group (rows b*block_n + g*width + off, g = 0..127), so each thread keeps
// the same (query, group) cells from one sub-tile to the next and folds them
// with a strict '>' in offset order — the TPU kernel's tie rule. Each
// sub-tile is an SGEMM-style register tile (4 queries x 8 rows per thread),
// the next K-slab prefetched into registers during the FMAs; the mask and the
// group max are folded in registers, so the (B, N) score plane never reaches
// device memory, only N/width candidates per query. Tensor cores, TMA and
// wgmma are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;                          // groups per block
constexpr int kMinBlockN = 256;
constexpr int kMaxBlockN = 2048;
constexpr int kBM = 64;                             // queries per CTA
constexpr int kBN = kLane;                          // rows per sub-tile
constexpr int kBK = 32;                             // K-slab width
constexpr int kTM = 4;                              // queries per thread
constexpr int kTN = 8;                              // groups per thread
constexpr int kThreadsN = kBN / kTN;                // 16
constexpr int kThreads = (kBM / kTM) * kThreadsN;   // 256
constexpr int kPerVec = 8;                          // bf16 per 16-byte load
constexpr int kVecPerRow = kBK / kPerVec;           // 4
constexpr int kXLoads = kBN * kVecPerRow / kThreads;  // 2
constexpr int kQLoads = kBM * kBK / 4 / kThreads;   // float4 per thread: 2

static_assert(kThreads == 256, "tile shape");
static_assert(kBN * kVecPerRow % kThreads == 0, "slab split");
static_assert(kMaxBlockN / kLane <= 16, "4-bit winner offset per group");

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__global__ void __launch_bounds__(kThreads, 2) dense_scan_kernel(
    const float* __restrict__ q, const __nv_bfloat16* __restrict__ x,
    const bool* __restrict__ mask, long long n, int batch, int dim, int width,
    float* __restrict__ out_vals, int* __restrict__ out_idx, long long n_cand) {
  __shared__ __align__(16) float qs[kBK][kBM];
  __shared__ __align__(16) float xs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tr = tid % kThreadsN;
  const int tq = tid / kThreadsN;
  const int n_qtiles = (batch + kBM - 1) / kBM;
  const long long cta = blockIdx.x;
  const int q0 = static_cast<int>(cta % n_qtiles) * kBM;
  const long long blk = cta / n_qtiles;
  const long long block_row0 = blk * kLane * width;

  float best[kTM][kTN];
  uint32_t best_off[kTM];
  int4 xreg[kXLoads];
  float4 qreg[kQLoads];

  for (int off = 0; off < width; ++off) {
    if (block_row0 + off >= n) break;  // uniform across the CTA

    auto load_global = [&](int k0) {
#pragma unroll
      for (int l = 0; l < kXLoads; ++l) {
        const int v = tid + l * kThreads;
        const int g = v % kBN;
        const int part = v / kBN;
        const long long grow = block_row0 + static_cast<long long>(g) * width + off;
        xreg[l] = grow < n
            ? *reinterpret_cast<const int4*>(x + grow * dim + k0 + part * kPerVec)
            : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int l = 0; l < kQLoads; ++l) {
        const int v = tid + l * kThreads;
        const int qi = v / (kBK / 4);
        const int kq = (v % (kBK / 4)) * 4;
        const int gq = q0 + qi;
        qreg[l] = gq < batch
            ? *reinterpret_cast<const float4*>(
                  q + static_cast<long long>(gq) * dim + k0 + kq)
            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    auto store_shared = [&]() {
#pragma unroll
      for (int l = 0; l < kXLoads; ++l) {
        const int v = tid + l * kThreads;
        const int g = v % kBN;
        const int part = v / kBN;
        const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&xreg[l]);
#pragma unroll
        for (int i = 0; i < kPerVec; ++i) xs[part * kPerVec + i][g] = __bfloat162float(p[i]);
      }
#pragma unroll
      for (int l = 0; l < kQLoads; ++l) {
        const int v = tid + l * kThreads;
        const int qi = v / (kBK / 4);
        const int kq = (v % (kBK / 4)) * 4;
        qs[kq + 0][qi] = qreg[l].x;
        qs[kq + 1][qi] = qreg[l].y;
        qs[kq + 2][qi] = qreg[l].z;
        qs[kq + 3][qi] = qreg[l].w;
      }
    };

    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

    load_global(0);
    for (int k0 = 0; k0 < dim; k0 += kBK) {
      __syncthreads();  // every thread is done reading the previous slab
      store_shared();
      __syncthreads();
      if (k0 + kBK < dim) load_global(k0 + kBK);  // in flight during the FMAs
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[kk][tq * kTM]);
        const float4 b0 = *reinterpret_cast<const float4*>(&xs[kk][tr * kTN]);
        const float4 b1 = *reinterpret_cast<const float4*>(&xs[kk][tr * kTN + 4]);
        const float av[kTM] = {a.x, a.y, a.z, a.w};
        const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    // epilogue: mask, running per-group winner (strict '>' in offset order)
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int gq = q0 + tq * kTM + i;
      if (off == 0) best_off[i] = 0u;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const long long row =
            block_row0 + static_cast<long long>(tr * kTN + j) * width + off;
        float v = neg_inf();
        if (gq < batch && row < n && mask[static_cast<long long>(gq) * n + row]) {
          v = acc[i][j];
        }
        if (off == 0) {
          best[i][j] = v;
        } else if (v > best[i][j]) {
          best[i][j] = v;
          best_off[i] = (best_off[i] & ~(15u << (4 * j))) |
                        (static_cast<uint32_t>(off) << (4 * j));
        }
      }
    }
  }

  // groups holding at least one row: 128 in a full block, ceil(r/width) in
  // a ragged last block of r rows
  const long long rows_here = n - block_row0;
  const long long groups_here =
      rows_here >= static_cast<long long>(kLane) * width
          ? kLane
          : (rows_here + width - 1) / width;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gq = q0 + tq * kTM + i;
    if (gq >= batch) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int g = tr * kTN + j;
      if (g >= groups_here) continue;
      const long long at = static_cast<long long>(gq) * n_cand + blk * kLane + g;
      const int off = static_cast<int>((best_off[i] >> (4 * j)) & 15u);
      out_vals[at] = best[i][j];
      out_idx[at] = static_cast<int>(block_row0 + static_cast<long long>(g) * width + off);
    }
  }
}

}  // namespace

// q (batch, dim) f32 holding bf16-rounded values; rows (n, dim) bf16; mask
// (batch, n) bool. Outputs (batch, n_cand): values f32, rows int32. dim must
// be a multiple of 32, every row 16-byte aligned, block_n a multiple of 128
// in [256, 2048] (the wrapper checks). Launches on `stream`, does not
// synchronize.
extern "C" int ck_dense_scan(
    const void* q, const void* rows, const void* mask, long long n, int batch,
    int dim, int block_n, void* vals, void* idx, long long n_cand, void* stream) {
  if (n <= 0 || batch <= 0 || dim % kBK != 0 || block_n % kLane != 0 ||
      block_n < kMinBlockN || block_n > kMaxBlockN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_blocks = (n + block_n - 1) / block_n;
  const long long grid = n_blocks * ((batch + kBM - 1) / kBM);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dense_scan_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(rows),
      static_cast<const bool*>(mask), n, batch, dim, block_n / kLane,
      static_cast<float*>(vals), static_cast<int*>(idx), n_cand);
  return static_cast<int>(cudaGetLastError());
}
