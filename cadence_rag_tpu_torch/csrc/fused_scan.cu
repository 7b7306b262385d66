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
//   - the 1/127 scale for int8 embeddings (ops/topk.py:48), with the query
//     widened to bf16 rather than cast to int8 (the wrapper rounds it);
//   - the lexical query in f32 against int8 values, f32 accumulation
//     (ops/lexical.py:31), not the TPU kernel's bf16 cast;
//   - a flag that skips the dense half (exact-mode batches).
//
// What bounds it on an H100: arithmetic. At batch 128 over 1M rows one pass
// is 2*128*1M*(1024 + 4096) = 1.4 TFLOP against ~6.4 GB of corpus bytes,
// ~215 FLOP per byte — far above the ~20 FLOP/byte at which the FP32 CUDA
// cores (67 TFLOP/s) stop waiting on HBM (3.35 TB/s). The lexical half keeps
// its query in f32, so as written it cannot use the bf16 tensor cores.
//
// What the design does about it: an SGEMM-style register tile (each thread
// owns 4 queries x 8 rows: 32 FMAs per 3 shared-memory vector loads), int8
// and bf16 widened to f32 once, at the shared-memory store, the next K-slab
// prefetched into registers while the current one is multiplied, and an
// epilogue that folds the mask, has_emb, the lexical threshold and the
// per-group max into registers: the (B, N) score planes never reach device
// memory, only N/8 candidates per lane and query are written. The two query
// tiles of one row block are adjacent CTAs, so the second reads the rows from
// L2. Tensor cores (a bf16x3 split of the f32 query), TMA and wgmma are left
// for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 1024;                    // K1 candidate block
constexpr int kGroups = 128;                        // groups per block
constexpr int kSubTiles = kBlockRows / kGroups;     // rows per group: 8
constexpr int kBM = 64;                             // queries per CTA
constexpr int kBN = kGroups;                        // rows per sub-tile
constexpr int kBK = 32;                             // K-slab width
constexpr int kTM = 4;                              // queries per thread
constexpr int kTN = 8;                              // rows per thread
constexpr int kThreadsN = kBN / kTN;                // 16
constexpr int kThreads = (kBM / kTM) * kThreadsN;   // 256
constexpr float kLexThreshold = 1e-3f;              // ops/lexical.py

static_assert(kThreads == 256, "tile shape");
static_assert(kSubTiles == 8, "3-bit winner index per group");

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <typename T>
struct SlabShape {
  static constexpr int kPerVec = 16 / sizeof(T);            // 16 int8, 8 bf16
  static constexpr int kVecPerRow = kBK / kPerVec;          // 2 or 4
  static constexpr int kXLoads = kBN * kVecPerRow / kThreads;  // 1 or 2
  static_assert(kBN * kVecPerRow % kThreads == 0, "slab split");
};

constexpr int kQLoads = kBM * kBK / 4 / kThreads;           // float4 per thread: 2

__device__ __forceinline__ void widen(const int4& v, int8_t, float* out) {
  const int8_t* p = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(p[i]);
}

__device__ __forceinline__ void widen(const int4& v, __nv_bfloat16, float* out) {
  const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(p[i]);
}

// One lane over one 1024-row block for one 64-query tile: eight 128-row
// sub-tiles, each a full K loop, folded into per-group winners.
template <typename T>
__device__ void scan_lane(
    const float* __restrict__ q, const T* __restrict__ x, int k_dim,
    const bool* __restrict__ mask, const bool* __restrict__ has_emb,
    bool lexical, float scale, long long n, int batch, int q0,
    long long blk, long long n_cand,
    float* __restrict__ out_vals, int* __restrict__ out_idx,
    float (*qs)[kBM], float (*xs)[kBN]) {
  using S = SlabShape<T>;
  const int tid = threadIdx.x;
  const int tr = tid % kThreadsN;
  const int tq = tid / kThreadsN;
  const long long block_row0 = blk * kBlockRows;

  float best[kTM][kTN];
  uint32_t best_w[kTM];
  int4 xreg[S::kXLoads];
  float4 qreg[kQLoads];

  for (int w = 0; w < kSubTiles; ++w) {
    const long long row0 = block_row0 + static_cast<long long>(w) * kGroups;
    if (row0 >= n) break;  // uniform across the CTA

    auto load_global = [&](int k0) {
#pragma unroll
      for (int l = 0; l < S::kXLoads; ++l) {
        const int v = tid + l * kThreads;
        const int row = v % kBN;
        const int part = v / kBN;
        const long long grow = row0 + row;
        xreg[l] = grow < n
            ? *reinterpret_cast<const int4*>(
                  x + grow * k_dim + k0 + part * S::kPerVec)
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
                  q + static_cast<long long>(gq) * k_dim + k0 + kq)
            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    auto store_shared = [&]() {
#pragma unroll
      for (int l = 0; l < S::kXLoads; ++l) {
        const int v = tid + l * kThreads;
        const int row = v % kBN;
        const int part = v / kBN;
        float vals[S::kPerVec];
        widen(xreg[l], T(), vals);
#pragma unroll
        for (int i = 0; i < S::kPerVec; ++i) xs[part * S::kPerVec + i][row] = vals[i];
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
    for (int k0 = 0; k0 < k_dim; k0 += kBK) {
      __syncthreads();  // every thread is done reading the previous slab
      store_shared();
      __syncthreads();
      if (k0 + kBK < k_dim) load_global(k0 + kBK);  // in flight during the FMAs
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

    // epilogue: mask, threshold / has_emb, running per-group winner
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int gq = q0 + tq * kTM + i;
      if (w == 0) best_w[i] = 0u;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const long long row = row0 + tr * kTN + j;
        float v = neg_inf();
        if (gq < batch && row < n) {
          const float s = acc[i][j] * scale;
          bool ok = mask[static_cast<long long>(gq) * n + row];
          ok = ok && (lexical ? (s > kLexThreshold) : has_emb[row]);
          if (ok) v = s;
        }
        if (w == 0) {
          best[i][j] = v;
        } else if (v > best[i][j]) {
          best[i][j] = v;
          best_w[i] = (best_w[i] & ~(7u << (3 * j))) | (static_cast<uint32_t>(w) << (3 * j));
        }
      }
    }
  }

  const long long groups_here =
      (n - block_row0) < kGroups ? (n - block_row0) : kGroups;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gq = q0 + tq * kTM + i;
    if (gq >= batch) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int g = tr * kTN + j;
      if (g >= groups_here) continue;
      const long long at = static_cast<long long>(gq) * n_cand + blk * kGroups + g;
      const int w = static_cast<int>((best_w[i] >> (3 * j)) & 7u);
      out_vals[at] = best[i][j];
      out_idx[at] = static_cast<int>(block_row0 + w * kGroups + g);
    }
  }
}

template <typename EmbT>
__global__ void __launch_bounds__(kThreads, 2) fused_scan_kernel(
    const float* __restrict__ q_emb, const float* __restrict__ q_lex,
    const EmbT* __restrict__ emb, const int8_t* __restrict__ lex,
    const bool* __restrict__ mask, const bool* __restrict__ has_emb,
    long long n, int batch, int dim, int lex_dim, int do_dense, float emb_scale,
    float* __restrict__ d_vals, int* __restrict__ d_idx,
    float* __restrict__ l_vals, int* __restrict__ l_idx, long long n_cand) {
  __shared__ __align__(16) float qs[kBK][kBM];
  __shared__ __align__(16) float xs[kBK][kBN];
  const int n_qtiles = (batch + kBM - 1) / kBM;
  const long long cta = blockIdx.x;
  const int q0 = static_cast<int>(cta % n_qtiles) * kBM;
  const long long blk = cta / n_qtiles;
  if (do_dense) {
    scan_lane<EmbT>(q_emb, emb, dim, mask, has_emb, false, emb_scale, n, batch,
                    q0, blk, n_cand, d_vals, d_idx, qs, xs);
  }
  scan_lane<int8_t>(q_lex, lex, lex_dim, mask, nullptr, true, 1.0f, n, batch,
                    q0, blk, n_cand, l_vals, l_idx, qs, xs);
}

}  // namespace

// q_emb (batch, dim) f32 holding bf16-rounded values; q_lex (batch, lex_dim)
// f32; emb (n, dim) bf16 or int8; lex (n, lex_dim) int8; mask (batch, n)
// bool; has_emb (n,) bool. Outputs (batch, n_cand): values f32, rows int32.
// dim and lex_dim must be multiples of 32 and every row 16-byte aligned (the
// wrapper checks). Launches on `stream`, does not synchronize.
extern "C" int ck_fused_scan(
    const void* q_emb, const void* q_lex, const void* emb, int emb_is_int8,
    const void* lex, const void* mask, const void* has_emb,
    long long n, int batch, int dim, int lex_dim, int do_dense,
    void* d_vals, void* d_idx, void* l_vals, void* l_idx, long long n_cand,
    void* stream) {
  if (n <= 0 || batch <= 0 || dim % kBK != 0 || lex_dim % kBK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_blocks = (n + kBlockRows - 1) / kBlockRows;
  const long long grid = n_blocks * ((batch + kBM - 1) / kBM);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qe = static_cast<const float*>(q_emb);
  const auto* ql = static_cast<const float*>(q_lex);
  const auto* lx = static_cast<const int8_t*>(lex);
  const auto* mk = static_cast<const bool*>(mask);
  const auto* he = static_cast<const bool*>(has_emb);
  auto* dv = static_cast<float*>(d_vals);
  auto* di = static_cast<int*>(d_idx);
  auto* lv = static_cast<float*>(l_vals);
  auto* li = static_cast<int*>(l_idx);
  if (emb_is_int8) {
    fused_scan_kernel<int8_t><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        qe, ql, static_cast<const int8_t*>(emb), lx, mk, he, n, batch, dim,
        lex_dim, do_dense, 1.0f / 127.0f, dv, di, lv, li, n_cand);
  } else {
    fused_scan_kernel<__nv_bfloat16><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        qe, ql, static_cast<const __nv_bfloat16*>(emb), lx, mk, he, n, batch,
        dim, lex_dim, do_dense, 1.0f, dv, di, lv, li, n_cand);
  }
  return static_cast<int>(cudaGetLastError());
}
