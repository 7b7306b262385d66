// Native lexical featurizer: text -> quantized BM25 signature row.
//
// Hot ingest/backfill path (reference analogue: pg_search's Rust tokenizer +
// BM25 indexer run inside Postgres; SURVEY.md §2.3). Must match
// cadence_rag_tpu_torch/ops/hashing.py BIT-FOR-BIT:
//   - FNV-1a 64 over "w:"+word / "g:"+byte-trigram of the (Python-side)
//     normalized text; first-occurrence feature ordering;
//   - bucket = h % dim, sign from bit 33;
//   - per-feature weight tf*(k1+1)/(tf+k1*(1-b+b*dl/avgdl)) accumulated in
//     float32 in insertion order (float64 math, f32 store — numpy's
//     "f32 += f64" semantics);
//   - quantization rint (round-half-even) clipped to [-127, 127].
//
// Build: g++ -O3 -shared -fPIC lexhash.cpp, at first use, by native/build.py
// (into build/cadence_rag_tpu_torch/native/)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <fenv.h>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 0xcbf29ce484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001b3ULL;

inline uint64_t fnv1a(const uint8_t* data, size_t n, uint64_t h) {
  for (size_t i = 0; i < n; ++i) {
    h ^= data[i];
    h *= kFnvPrime;
  }
  return h;
}

inline bool is_word_byte(uint8_t c) {
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '_';
}

struct FeatureCounts {
  std::unordered_map<uint64_t, int32_t> slot_of;  // hash -> slot
  std::vector<uint64_t> keys;                     // insertion order
  std::vector<int64_t> tf;

  void add(uint64_t h) {
    auto it = slot_of.find(h);
    if (it == slot_of.end()) {
      slot_of.emplace(h, static_cast<int32_t>(keys.size()));
      keys.push_back(h);
      tf.push_back(1);
    } else {
      ++tf[it->second];
    }
  }
};

void extract_features(const uint8_t* text, int64_t len, FeatureCounts* out) {
  // word tokens: maximal [a-z0-9_]+ runs (ASCII; multi-byte UTF-8 chars are
  // boundaries, matching the Python regex [a-z0-9_]+ on normalized text)
  int64_t i = 0;
  while (i < len) {
    if (!is_word_byte(text[i])) {
      ++i;
      continue;
    }
    int64_t j = i;
    while (j < len && is_word_byte(text[j])) ++j;
    uint64_t h = fnv1a(reinterpret_cast<const uint8_t*>("w:"), 2, kFnvOffset);
    h = fnv1a(text + i, static_cast<size_t>(j - i), h);
    out->add(h);
    i = j;
  }
  // byte trigrams
  for (int64_t k = 0; k + 2 < len; ++k) {
    uint64_t h = fnv1a(reinterpret_cast<const uint8_t*>("g:"), 2, kFnvOffset);
    h = fnv1a(text + k, 3, h);
    out->add(h);
  }
}

}  // namespace

extern "C" {

// Returns the number of touched buckets written to out_touched, or -1 on
// error. out_w must hold `dim` int8s; out_touched `dim` int32s.
int64_t lex_doc_signature(const uint8_t* text, int64_t len, int32_t dim,
                          double avgdl, double k1, double b,
                          double quant_scale, int8_t* out_w,
                          int32_t* out_touched, int64_t* out_dl) {
  if (dim <= 0 || len < 0) return -1;
  FeatureCounts counts;
  extract_features(text, len, &counts);

  int64_t dl = 0;
  for (int64_t f : counts.tf) dl += f;
  *out_dl = dl;

  double denom_avgdl = avgdl > 1.0 ? avgdl : 1.0;
  double norm = 1.0 - b + b * (static_cast<double>(dl) / denom_avgdl);

  std::vector<float> acc(static_cast<size_t>(dim), 0.0f);
  for (size_t s = 0; s < counts.keys.size(); ++s) {
    uint64_t h = counts.keys[s];
    int32_t bucket = static_cast<int32_t>(h % static_cast<uint64_t>(dim));
    double sign = ((h >> 33) & 1ULL) ? 1.0 : -1.0;
    double tfv = static_cast<double>(counts.tf[s]);
    double w = sign * (tfv * (k1 + 1.0)) / (tfv + k1 * norm);
    // numpy 2.x weak-promotion semantics: the float64 addend is rounded to
    // float32 BEFORE a single-precision add (f32 += pyfloat keeps f32)
    acc[bucket] = acc[bucket] + static_cast<float>(w);
  }

  int old_round = fegetround();
  fesetround(FE_TONEAREST);  // rint = round-half-even
  int64_t touched = 0;
  float scale_f = static_cast<float>(quant_scale);
  for (int32_t i = 0; i < dim; ++i) {
    // numpy weak promotion again: f32 * pyfloat stays f32, rint on f32
    float scaled = acc[i] * scale_f;
    float rounded = nearbyintf(scaled);
    if (rounded > 127.0f) rounded = 127.0f;
    if (rounded < -127.0f) rounded = -127.0f;
    out_w[i] = static_cast<int8_t>(rounded);
    if (acc[i] != 0.0f) out_touched[touched++] = i;
  }
  fesetround(old_round);
  return touched;
}

// Query-side featurization: text -> (bucket, sign, tf) arrays in
// first-occurrence order, matching ops/hashing.py query_feature_arrays
// bit-for-bit (bucket = h % dim as int64, sign from hash bit 33, tf
// clipped at 3.0). The /retrieve hot path calls this per query; the pure
// -Python fnv1a loop was ~15 ms per 64-query batch (profiled).
// Returns the feature count written (<= max_out), or -1 on error.
int64_t lex_query_features(const uint8_t* text, int64_t len, int32_t dim,
                           int64_t max_out, int64_t* out_buckets,
                           float* out_signs, float* out_tfs) {
  if (dim <= 0 || len < 0 || max_out < 0) return -1;
  FeatureCounts counts;
  extract_features(text, len, &counts);
  int64_t n = static_cast<int64_t>(counts.keys.size());
  if (n > max_out) n = max_out;
  for (int64_t s = 0; s < n; ++s) {
    uint64_t h = counts.keys[s];
    out_buckets[s] = static_cast<int64_t>(h % static_cast<uint64_t>(dim));
    out_signs[s] = ((h >> 33) & 1ULL) ? 1.0f : -1.0f;
    float tf = static_cast<float>(counts.tf[s]);
    out_tfs[s] = tf < 3.0f ? tf : 3.0f;
  }
  return n;
}

// Raw feature extraction: (fnv1a64 hash, unclipped tf) pairs in
// first-occurrence order — the deterministic hash embedder (embed/stub.py)
// seeds one gaussian direction per 64-bit feature hash, so it needs the
// raw hashes, not the dim-reduced buckets. Returns count or -1.
int64_t lex_raw_features(const uint8_t* text, int64_t len, int64_t max_out,
                         uint64_t* out_hashes, float* out_tfs) {
  if (len < 0 || max_out < 0) return -1;
  FeatureCounts counts;
  extract_features(text, len, &counts);
  int64_t n = static_cast<int64_t>(counts.keys.size());
  if (n > max_out) n = max_out;
  for (int64_t s = 0; s < n; ++s) {
    out_hashes[s] = counts.keys[s];
    out_tfs[s] = static_cast<float>(counts.tf[s]);
  }
  return n;
}

// Batch variants: one ctypes crossing per request batch instead of one
// per text (the 128 per-call crossings + numpy scratch allocations cost
// ~5 ms per micro-batch on the 1-core serving host, profiled). `ends`
// holds exclusive end offsets into the concatenated utf-8 buffer;
// per-text results are written back-to-back with counts in out_counts.
// Returns the total features written, or -1 if `cap` would overflow
// (caller re-sizes and retries).

int64_t lex_query_features_batch(const uint8_t* data, const int64_t* ends,
                                 int64_t n_texts, int32_t dim, int64_t cap,
                                 int64_t* out_buckets, float* out_signs,
                                 float* out_tfs, int64_t* out_counts) {
  if (dim <= 0 || n_texts < 0 || cap < 0) return -1;
  int64_t total = 0;
  int64_t start = 0;
  for (int64_t t = 0; t < n_texts; ++t) {
    int64_t end = ends[t];
    if (end < start) return -1;
    int64_t n = lex_query_features(data + start, end - start, dim,
                                   cap - total, out_buckets + total,
                                   out_signs + total, out_tfs + total);
    if (n < 0) return -1;
    // a full output window means the text MAY have been truncated (the
    // last text included — n == remaining cap is indistinguishable from
    // an exact fit) — signal retry; the caller doubles cap and re-calls
    if (n == cap - total) return -1;
    out_counts[t] = n;
    total += n;
    start = end;
  }
  return total;
}

int64_t lex_raw_features_batch(const uint8_t* data, const int64_t* ends,
                               int64_t n_texts, int64_t cap,
                               uint64_t* out_hashes, float* out_tfs,
                               int64_t* out_counts) {
  if (n_texts < 0 || cap < 0) return -1;
  int64_t total = 0;
  int64_t start = 0;
  for (int64_t t = 0; t < n_texts; ++t) {
    int64_t end = ends[t];
    if (end < start) return -1;
    int64_t n = lex_raw_features(data + start, end - start, cap - total,
                                 out_hashes + total, out_tfs + total);
    if (n < 0) return -1;
    if (n == cap - total) return -1;
    out_counts[t] = n;
    total += n;
    start = end;
  }
  return total;
}

// Tech-lane query slot structures for a whole batch (mirror of
// ops/hashing.tech_query_structure over PRE-NORMALIZED keys: the Python
// wrapper strips/lowers/drops-empties so Unicode lowering semantics stay
// Python's). Keys arrive concatenated with cumulative end offsets;
// key_counts[q] keys belong to query q. Each query's structure starts at
// out + q*slots*max_cap (caller-zeroed), written at its own escalated
// capacity (recorded in out_caps); zero blocks never match on device.
// Dedupe is by token hash — equivalent to Python's by-key dedupe because
// an equal-hash entry re-places the identical value (v == h) and can
// never drop.
int64_t lex_tech_structures_batch(
    const uint8_t* data, const int64_t* ends, const int32_t* key_counts,
    int64_t n_queries, int32_t slots, int32_t cap0, int32_t max_cap,
    int32_t* out, int32_t* out_caps, int32_t* out_dropped) {
  if (n_queries < 0 || slots <= 0 || cap0 <= 0 || max_cap < cap0) return -1;
  const int64_t stride = static_cast<int64_t>(slots) * max_cap;
  int64_t key_idx = 0;
  int64_t start = 0;
  std::vector<uint64_t> seen;
  std::vector<int32_t> hs, s1s, s2s;
  for (int64_t q = 0; q < n_queries; ++q) {
    seen.clear(); hs.clear(); s1s.clear(); s2s.clear();
    const int32_t n_keys = key_counts[q];
    for (int32_t k = 0; k < n_keys; ++k, ++key_idx) {
      const int64_t end = ends[key_idx];
      if (end < start) return -1;
      uint64_t h64 = fnv1a(reinterpret_cast<const uint8_t*>("t:"), 2,
                           kFnvOffset);
      h64 = fnv1a(data + start, static_cast<size_t>(end - start), h64);
      start = end;
      const int32_t h = static_cast<int32_t>(h64 % 0x7FFFFFFEULL) + 1;
      bool dup = false;
      for (uint64_t s : seen) {
        if (s == static_cast<uint64_t>(h)) { dup = true; break; }
      }
      if (dup) continue;
      seen.push_back(static_cast<uint64_t>(h));
      hs.push_back(h);
      s1s.push_back(h % slots);
      s2s.push_back((h >> 8) % slots);
    }
    int32_t cap = cap0;
    int32_t* row = out + q * stride;
    for (;;) {
      std::memset(row, 0, sizeof(int32_t) * slots * cap);
      int32_t dropped = 0;
      for (size_t e = 0; e < hs.size(); ++e) {
        const int32_t h = hs[e];
        bool fully = true;
        const int32_t cols[2] = {s1s[e], s2s[e]};
        const int n_cols = (cols[0] == cols[1]) ? 1 : 2;
        for (int ci = 0; ci < n_cols; ++ci) {
          bool ok = false;
          for (int32_t c = 0; c < cap; ++c) {
            int32_t* cell = row + static_cast<int64_t>(c) * slots + cols[ci];
            if (*cell == 0 || *cell == h) { *cell = h; ok = true; break; }
          }
          fully = fully && ok;
        }
        if (!fully) ++dropped;
      }
      if (dropped == 0 || cap * 2 > max_cap) {
        out_caps[q] = cap;
        out_dropped[q] = dropped;
        break;
      }
      std::memset(row, 0, sizeof(int32_t) * slots * cap);
      cap *= 2;
    }
  }
  return key_idx;
}

// Simple self-description for version checks.
int32_t lexhash_abi_version() { return 5; }

}  // extern "C"
