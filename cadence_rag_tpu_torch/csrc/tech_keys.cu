// Kernel K3: the tech lane's order keys.
//
// Replaces: cadence_rag_tpu/ops/pallas_tech.py — _kernel, tech_keys and
// tech_topk_pallas, the TPU kernel that fuses the token-hash intersection
// with the recency keys in one VMEM pass and writes a (B, N) f32 key plane.
//
// For each query b and row r:
//   match = OR over c, s of (q[b, c*S + s] == tech[r, s] && q[b, c*S + s] != 0)
//   key   = match && mask[b, r] ? f32_bits(started[r]) : -inf
// The compare is slot-aligned (query column c*S+s against doc slot s only:
// S*C compares, as ops/techlane.tech_match does) instead of the TPU kernel's
// every-slot-against-every-column S*Q compare; docs store a token at one of
// its two choice slots and the query structure lists it under both, so the
// two agree on every structure without dropped tokens (tested).
//
// Output: one int64 per (b, r) that orders exactly as the reference does,
// `call_started_at DESC, id ASC`:
//   (sortable_i32(key) << 32) | (0xFFFFFFFF - r)
// where sortable_i32 maps f32 bits to an int32 of the same order. These are
// the keys ops/topk.order_keys builds from the f32 plane, so torch.topk over
// them is lax.top_k's lowest-row-first tie order — and ties are the common
// case here: every chunk of a call shares its start second.
//
// What bounds it on an H100: device-memory bytes. The compares are S*C
// integer ops per (b, r); the traffic is the B*N*8-byte key plane written
// (1 GB at batch 128 x 1M rows) plus the B*N-byte mask read.
//
// What the design does about it: one thread per row, 16 queries per CTA.
// The row's S slots and start second are read once into registers and
// reused for all 16 queries; the queries' slot structures sit in shared
// memory (broadcast reads); mask reads and key writes are coalesced across
// the warp. Writing only a per-block top-k instead of the whole plane is
// left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 32;
constexpr int kRowsPerCta = 256;
constexpr int kQueriesPerCta = 16;

__global__ void __launch_bounds__(kRowsPerCta) tech_keys_kernel(
    const int32_t* __restrict__ q, int q_width,
    const int32_t* __restrict__ tech, int slots,
    const int32_t* __restrict__ started, const bool* __restrict__ mask,
    long long n, int batch, long long* __restrict__ keys) {
  extern __shared__ int32_t qs[];  // kQueriesPerCta x q_width
  const int b0 = blockIdx.y * kQueriesPerCta;
  const int nb = min(kQueriesPerCta, batch - b0);
  for (int i = threadIdx.x; i < nb * q_width; i += blockDim.x) {
    qs[i] = q[static_cast<long long>(b0) * q_width + i];
  }
  __syncthreads();

  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerCta + threadIdx.x;
  if (row >= n) return;
  int32_t doc[kMaxSlots];
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) doc[s] = s < slots ? tech[row * slots + s] : 0;
  const int32_t recency_bits = started[row];
  const uint64_t low = 0xFFFFFFFFull - static_cast<uint64_t>(row);
  const int capacity = q_width / slots;

  for (int bi = 0; bi < nb; ++bi) {
    const int32_t* qb = qs + bi * q_width;
    bool match = false;
    for (int c = 0; c < capacity; ++c) {
#pragma unroll
      for (int s = 0; s < kMaxSlots; ++s) {
        if (s < slots) {
          const int32_t v = qb[c * slots + s];
          match |= (v != 0) && (v == doc[s]);
        }
      }
    }
    const long long at = static_cast<long long>(b0 + bi) * n + row;
    const bool keep = match && mask[at];
    const int32_t bits = keep ? recency_bits : static_cast<int32_t>(0xff800000u);  // -inf
    const int32_t sortable = bits ^ ((bits >> 31) & 0x7fffffff);
    keys[at] = static_cast<long long>(
        (static_cast<uint64_t>(static_cast<uint32_t>(sortable)) << 32) | low);
  }
}

}  // namespace

// q (batch, q_width) int32 with q_width = slots * capacity; tech (n, slots)
// int32; started (n,) int32; mask (batch, n) bool; keys (batch, n) int64.
// Launches on `stream`, does not synchronize.
extern "C" int ck_tech_keys(
    const void* q, int q_width, const void* tech, int slots,
    const void* started, const void* mask, long long n, int batch,
    void* keys, void* stream) {
  if (n <= 0 || batch <= 0 || slots <= 0 || slots > kMaxSlots ||
      q_width % slots != 0 || n > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kQueriesPerCta) * q_width * sizeof(int32_t);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + kRowsPerCta - 1) / kRowsPerCta),
                  static_cast<unsigned>((batch + kQueriesPerCta - 1) / kQueriesPerCta));
  tech_keys_kernel<<<grid, kRowsPerCta, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), q_width, static_cast<const int32_t*>(tech),
      slots, static_cast<const int32_t*>(started), static_cast<const bool*>(mask),
      n, batch, static_cast<long long*>(keys));
  return static_cast<int>(cudaGetLastError());
}
