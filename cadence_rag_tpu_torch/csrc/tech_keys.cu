// Kernel K3: the tech lane's top-k, per range of rows.
//
// Replaces: cadence_rag_tpu/ops/pallas_tech.py — _kernel, tech_keys and
// tech_topk_pallas, the TPU kernel that fuses the token-hash intersection
// with the recency keys in one VMEM pass and writes a (B, N) f32 key plane
// for approx_max_k.
//
// For query b and row r (ops/techlane.py, ops/topk.py):
//   match = OR over c, s of (q[b, c*S + s] == tech[r, s] && q[b, c*S + s] != 0)
//   value = match && mask[b, r] ? f32_bits(started[r]) : -inf
//   key   = (sortable_i32(value) << 32) | (0xFFFFFFFF - r)
// The keys are unique and order as the reference does, `call_started_at
// DESC, id ASC`. The kernel never writes the (B, N) plane: for each range of
// kRows rows and each query it writes that range's k largest keys, and the
// wrapper's torch.topk over the (B, ranges * k) candidates gives the lane.
// That is exact: the global top-k lies in the union of the ranges' top-ks.
//
// The lane is sparse: a query's tokens match a few rows in a thousand. Keys
// fall in three bands: matched rows above -inf ("special", in a per-query
// list), every other row at -inf (the "band": their keys order by row
// alone), and a matched row whose start second reads as a NaN below -inf
// (also special). A range's top-k is therefore its specials above -inf,
// best first, then its first band rows in row order, then its specials
// below -inf; only the specials need a sort, and only when there are more
// than k of them (or any below -inf).
//
// What bounds it on an H100: the compares. Every (query, row) pair takes
// S*C slot compares (2,048 per row at batch 128, S 16, C 1) on the integer
// pipes; the bytes are the slots and start seconds once (68 MB at 1M rows),
// the mask only where a row matches, and ranges * k keys out.
//
// What the design does about it:
//   - A CTA owns kRows rows; each thread keeps kRowsPerThread rows' slots
//     and start seconds in registers, read from device memory once, and
//     serves every query of the batch from them. The queries' structures
//     sit in shared memory (broadcast reads).
//   - The mask is read only for a row that matches.
//   - Queries go in groups of one per warp: every warp scores its rows for
//     the group, appending specials to the queries' lists in shared memory
//     (warp ballot, one atomic per warp) and writing one bitmap word of
//     specials per 32 rows; then each warp completes one query's top-k of
//     the range: the specials (sorted only when needed), then band rows
//     taken in row order from the bitmap, 32 rows a step across the lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kRows = kThreads * kRowsPerThread;     // rows per CTA (range)
constexpr int kWords = kRows / 32;                    // bitmap words per query
constexpr int kGroup = kWarps;                        // queries per group
constexpr int kMaxK = 64;
constexpr int kMaxWidth = 256;                        // S * C, ints per query
constexpr int32_t kNegHi = static_cast<int32_t>(0x807fffff);   // sortable(-inf)
constexpr long long kPad = -9223372036854775807LL - 1;  // INT64_MIN


struct Smem {
  long long list[kGroup][kRows];     // specials' keys, per query of the group
  uint32_t bits[kGroup][kWords];     // specials, one bit per row
  int count[kGroup];
  int32_t q[kGroup][kMaxWidth];      // the group's query structures
};

__device__ __forceinline__ long long make_key(int32_t hi, long long row) {
  return static_cast<long long>(
      (static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32)
      | (0xFFFFFFFFull - static_cast<uint64_t>(row)));
}

__device__ __forceinline__ int32_t key_hi(long long key) {
  return static_cast<int32_t>(static_cast<uint64_t>(key) >> 32);
}

// one warp: sort list[0, p) descending (p a power of two >= 32)
__device__ void warp_sort_desc(long long* list, int p, int lane) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < p / 2; i += 32) {
        const int lo = (i / stride) * 2 * stride + (i % stride);
        const int hi = lo + stride;
        const long long a = list[lo];
        const long long b = list[hi];
        // descending where (lo & size) == 0, ascending otherwise; the last
        // merge (size == p) is all descending
        const bool desc = (lo & size) == 0;
        if (desc ? a < b : a > b) {
          list[lo] = b;
          list[hi] = a;
        }
      }
      __syncwarp();
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads, 2) tech_topk_kernel(
    const int32_t* __restrict__ q, int q_width, const int32_t* __restrict__ tech,
    const int32_t* __restrict__ started, const bool* __restrict__ mask,
    long long n, int batch, int k, long long* __restrict__ out, long long n_cand) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const long long blk = blockIdx.x;
  const long long row0 = blk * kRows;
  const int capacity = q_width / S;

  // this thread's rows: row0 + i*kThreads + tid; warp w's 32 rows of step i
  // are bitmap word i*kWarps + w
  int32_t doc[kRowsPerThread][S];
  int32_t hi_of[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const long long row = row0 + i * kThreads + tid;
    const bool ok = row < n;
    const int4* src = reinterpret_cast<const int4*>(tech + (ok ? row : 0) * S);
#pragma unroll
    for (int v = 0; v < S / 4; ++v) {
      const int4 w = ok ? __ldg(src + v) : make_int4(0, 0, 0, 0);
      doc[i][4 * v] = w.x;
      doc[i][4 * v + 1] = w.y;
      doc[i][4 * v + 2] = w.z;
      doc[i][4 * v + 3] = w.w;
    }
    const int32_t bits = ok ? __ldg(started + row) : 0;
    hi_of[i] = bits ^ ((bits >> 31) & 0x7fffffff);
  }
  if (tid < kGroup) sm.count[tid] = 0;

  const long long rows_here = n - row0 < kRows ? n - row0 : kRows;
  for (int b0 = 0; b0 < batch; b0 += kGroup) {
    const int nq = batch - b0 < kGroup ? batch - b0 : kGroup;
    for (int j = tid; j < nq * q_width; j += kThreads) {
      sm.q[j / q_width][j % q_width] = q[static_cast<long long>(b0) * q_width + j];
    }
    __syncthreads();

    // -- score this thread's rows for every query of the group ------------
    for (int g = 0; g < nq; ++g) {
      const int b = b0 + g;
      // least (doc slot ^ query column) over the nonzero columns: 0 iff a
      // column equals its slot. A column is the same for the whole warp,
      // so an empty one (most are) costs one uniform test.
      uint32_t diff[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) diff[i] = 0xffffffffu;
      for (int c = 0; c < capacity; ++c) {
        const int32_t* qs = sm.q[g] + c * S;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int32_t v = qs[s];
          if (v != 0) {
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i) {
              diff[i] = min(diff[i], static_cast<uint32_t>(doc[i][s] ^ v));
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const long long row = row0 + i * kThreads + tid;
        bool special = false;
        if (diff[i] == 0u) {  // sparse: the mask is read only here
          special = mask[static_cast<long long>(b) * n + row] && hi_of[i] != kNegHi;
        }
        const uint32_t ballot = __ballot_sync(0xffffffffu, special);
        if (lane == 0) sm.bits[g][i * kWarps + warp] = ballot;
        if (ballot != 0u) {
          int base = 0;
          if (lane == 0) base = atomicAdd(&sm.count[g], __popc(ballot));
          base = __shfl_sync(0xffffffffu, base, 0);
          if (special) {
            sm.list[g][base + __popc(ballot & ((1u << lane) - 1u))] =
                make_key(hi_of[i], row);
          }
        }
      }
    }
    __syncthreads();

    // -- warp `warp` completes query b0 + warp's top-k of the range --------
    if (warp < nq) {
      const int g = warp;
      const long long b = b0 + g;
      long long* list = sm.list[g];
      long long* dst = out + b * n_cand + blk * k;
      const int m = sm.count[g];
      int above = 0;
      for (int j = lane; j < m; j += 32) above += key_hi(list[j]) > kNegHi;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) above += __shfl_xor_sync(0xffffffffu, above, off);
      if (m > k || above < m) {
        int p = 32;
        while (p < m) p <<= 1;
        for (int j = m + lane; j < p; j += 32) list[j] = kPad;
        __syncwarp();
        warp_sort_desc(list, p, lane);
      }
      // specials above -inf, best first (all of them when m <= k)
      const int na = above < k ? above : k;
      for (int j = lane; j < na; j += 32) dst[j] = list[j];
      // band rows in row order: word w of the bitmap is rows row0 + 32w..
      const long long band_rows = rows_here - m;
      const int fill = static_cast<int>(
          k - na < band_rows ? k - na : band_rows);
      // word by word from the range's start, lane l taking row 32w + l
      int taken = 0;
      for (int w = 0; taken < fill && w < kWords; ++w) {
        const long long valid = rows_here - 32 * w;
        const uint32_t in_range = valid >= 32 ? 0xffffffffu
                                  : (valid <= 0 ? 0u : (1u << valid) - 1u);
        const uint32_t free_bits = ~sm.bits[g][w] & in_range;
        const int rank = taken + __popc(free_bits & ((1u << lane) - 1u));
        if (((free_bits >> lane) & 1u) && rank < fill) {
          dst[na + rank] = make_key(kNegHi, row0 + 32 * w + lane);
        }
        taken += __popc(free_bits);
      }
      // then the specials below -inf (sorted), then padding
      const int below = m - above;
      const int rest = k - na - (fill > 0 ? fill : 0);
      const int nb = rest < below ? rest : below;
      for (int j = lane; j < nb; j += 32) dst[k - rest + j] = list[above + j];
      for (int j = nb + lane; j < rest; j += 32) dst[k - rest + j] = kPad;
      __syncwarp();
      if (lane == 0) sm.count[g] = 0;
    }
    __syncthreads();
  }
}

template <int S>
cudaError_t launch(const void* q, int q_width, const void* tech, const void* started,
                   const void* mask, long long n, int batch, int k, void* out,
                   long long n_cand, cudaStream_t stream) {
  const size_t smem = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      tech_topk_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (n + kRows - 1) / kRows;
  tech_topk_kernel<S><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const int32_t*>(q), q_width, static_cast<const int32_t*>(tech),
      static_cast<const int32_t*>(started), static_cast<const bool*>(mask), n, batch, k,
      static_cast<long long*>(out), n_cand);
  return cudaGetLastError();
}

}  // namespace

// q (batch, q_width) int32 with q_width = slots * capacity <= 256; tech
// (n, slots) int32, slots 8, 16 or 32, 16-byte aligned; started (n,) int32;
// mask (batch, n) bool; out (batch, n_cand) int64 with n_cand = ranges * k,
// ranges = ceil(n / 1024): each range's k largest keys (padded with
// INT64_MIN where a range has fewer than k rows). 1 <= k <= 64.
// Launches on `stream`, does not synchronize.
extern "C" int ck_tech_topk(
    const void* q, int q_width, const void* tech, int slots, const void* started,
    const void* mask, long long n, int batch, int k, void* out, long long n_cand,
    void* stream) {
  const long long blocks = (n + kRows - 1) / kRows;
  if (n <= 0 || batch <= 0 || k < 1 || k > kMaxK || n > 0x7fffffffLL
      || q_width <= 0 || q_width % slots != 0 || q_width > kMaxWidth
      || n_cand != blocks * k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slots) {
    case 8: return static_cast<int>(launch<8>(q, q_width, tech, started, mask, n, batch, k, out, n_cand, s));
    case 16: return static_cast<int>(launch<16>(q, q_width, tech, started, mask, n, batch, k, out, n_cand, s));
    case 32: return static_cast<int>(launch<32>(q, q_width, tech, started, mask, n, batch, k, out, n_cand, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
