// Native RRF group-merge core for the /retrieve hot path.
//
// Copy of cadence_rag_tpu/native/rrf.cpp: the two merge cores and the
// ids_only formatter. Semantics contract (must stay bit-identical to the
// numpy path in ops/fusion._merge_flat, which mirrors the reference's
// Python dict accumulation — reference: app/retrieve.py:245-260):
//   - group the concatenated (plan, doc) entries;
//   - per group: sum the f64 contribs IN INPUT ORDER (same FP addition
//     sequence as np.add.at / the reference dict loop), OR the lane
//     bitmasks, record the first input position;
//   - emit groups plan-major, then score DESC, then first occurrence
//     ASC (== np.lexsort((first, -scores, plan))).
//
// Shape: a 128-query batch contributes ~150 entries per plan. A single
// global comparison sort over all ~19k entries measured ~6 ms (gather-
// heavy comparisons, cold cache); this version counting-sorts by plan
// (stable, O(n)) and then sorts each plan's ~150 entries in L1 —
// ~0.3 ms for the same input.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Ent {
  int64_t doc;
  int64_t idx;  // original input position (ascending == input order)
};

struct Group {
  int64_t doc;
  double score;
  int64_t first;
  uint8_t mask;
};

}  // namespace

// Rectangular-input variant: consumes the device's lane blocks directly
// ({ids (B, width_l) i64, counts (B,) i32} per lane) — no host-side
// flatten, no contrib/plan/bit arrays. Entry order within a plan is
// lane-major then rank, matching the flat path's global order, so
// accumulation sequence and first-occurrence tiebreaks are identical.
extern "C" int64_t rrf_merge_rect_groups(
    int32_t n_lanes, int32_t n_plans, const int64_t** ids,
    const int32_t** counts, const int32_t* widths, int32_t rrf_k,
    int32_t* out_plan, int64_t* out_doc, double* out_score,
    uint8_t* out_mask) {
  if (n_lanes <= 0 || n_plans <= 0) return 0;
  std::vector<Ent> ents;      // Ent.idx = (lane, rank) packed, local order
  std::vector<Group> groups;
  std::vector<double> contrib;  // contrib[r] = 1/(rrf_k + r + 1)
  int32_t max_w = 0;
  for (int32_t l = 0; l < n_lanes; ++l) max_w = std::max(max_w, widths[l]);
  contrib.reserve(max_w);
  for (int32_t r = 0; r < max_w; ++r)
    contrib.push_back(1.0 / (rrf_k + r + 1));
  int64_t m = 0;
  for (int32_t p = 0; p < n_plans; ++p) {
    ents.clear();
    for (int32_t l = 0; l < n_lanes; ++l) {
      const int64_t* row = ids[l] + static_cast<int64_t>(p) * widths[l];
      const int32_t c = std::min(counts[l][p], widths[l]);
      const int64_t base = static_cast<int64_t>(l) << 32;
      for (int32_t r = 0; r < c; ++r) ents.push_back({row[r], base | r});
    }
    if (ents.empty()) continue;
    std::sort(ents.begin(), ents.end(), [](const Ent& a, const Ent& b) {
      if (a.doc != b.doc) return a.doc < b.doc;
      return a.idx < b.idx;  // (lane, rank) == input order
    });
    groups.clear();
    for (size_t a = 0; a < ents.size();) {
      Group g{ents[a].doc, 0.0, ents[a].idx, 0};
      size_t b = a;
      for (; b < ents.size() && ents[b].doc == g.doc; ++b) {
        g.score += contrib[ents[b].idx & 0xffffffff];
        g.mask |= static_cast<uint8_t>(1u << (ents[b].idx >> 32));
      }
      groups.push_back(g);
      a = b;
    }
    std::sort(groups.begin(), groups.end(),
              [](const Group& a, const Group& b) {
                if (a.score != b.score) return a.score > b.score;
                return a.first < b.first;
              });
    for (const Group& g : groups) {
      out_plan[m] = p;
      out_doc[m] = g.doc;
      out_score[m] = g.score;
      out_mask[m] = g.mask;
      ++m;
    }
  }
  return m;
}

// Batched ids_only response assembly: the reference's final ids_only
// ordering (reference: app/retrieve.py:552-573) is sort by (-score,
// kind, id) with artifacts (kind 0) before chunks (kind 1) on ties,
// rendered as "artifact_chunk:<id>" / "chunk:<id>" strings. Building
// ~200 Python f-strings per query cost ~28 ms per 128-query batch on
// the 1-core serving host (profiled); this formats every plan's ids
// into ONE '\n'-joined char buffer that Python splits in a single C
// pass. Inputs are the two corpora's fused groups, plan-major
// ascending (the merge cores above emit exactly that). Returns bytes
// written, or -1 if out_cap would overflow (caller sizes generously
// and falls back).
extern "C" int64_t rrf_ids_only_format(
    const int32_t* a_plan, const int64_t* a_doc, const double* a_score,
    int64_t a_n, const int32_t* c_plan, const int64_t* c_doc,
    const double* c_score, int64_t c_n, int32_t n_plans,
    int32_t* out_counts, char* out_buf, int64_t out_cap) {
  struct Item {
    double score;
    int64_t id;
    uint8_t kind;  // 0 = artifact_chunk, 1 = chunk
  };
  static const char* kPrefix[2] = {"artifact_chunk:", "chunk:"};
  static const int kPrefixLen[2] = {15, 6};
  std::vector<Item> items;
  int64_t ai = 0, ci = 0, written = 0;
  for (int32_t p = 0; p < n_plans; ++p) {
    items.clear();
    for (; ai < a_n && a_plan[ai] == p; ++ai)
      items.push_back({a_score[ai], a_doc[ai], 0});
    for (; ci < c_n && c_plan[ci] == p; ++ci)
      items.push_back({c_score[ci], c_doc[ci], 1});
    std::sort(items.begin(), items.end(), [](const Item& x, const Item& y) {
      if (x.score != y.score) return x.score > y.score;
      if (x.kind != y.kind) return x.kind < y.kind;
      return x.id < y.id;
    });
    out_counts[p] = static_cast<int32_t>(items.size());
    for (const Item& it : items) {
      char digits[24];
      int nd = 0;
      uint64_t v = static_cast<uint64_t>(it.id);
      do {
        digits[nd++] = static_cast<char>('0' + v % 10);
        v /= 10;
      } while (v);
      const int need = kPrefixLen[it.kind] + nd + 1;
      if (written + need > out_cap) return -1;
      std::copy(kPrefix[it.kind], kPrefix[it.kind] + kPrefixLen[it.kind],
                out_buf + written);
      written += kPrefixLen[it.kind];
      while (nd) out_buf[written++] = digits[--nd];
      out_buf[written++] = '\n';
    }
  }
  // inputs exhausted iff they were plan-major in [0, n_plans)
  if (ai != a_n || ci != c_n) return -1;
  return written;
}

extern "C" int64_t rrf_merge_groups(
    const int32_t* plan, const int64_t* doc, const double* contrib,
    const uint8_t* bits, int64_t n, int32_t n_plans,
    int32_t* out_plan, int64_t* out_doc, double* out_score,
    uint8_t* out_mask) {
  if (n <= 0 || n_plans <= 0) return 0;
  // stable counting sort by plan
  std::vector<int64_t> starts(static_cast<size_t>(n_plans) + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t p = plan[i];
    if (p < 0 || p >= n_plans) return -1;  // caller bug; fail loudly
    ++starts[p + 1];
  }
  for (int32_t p = 0; p < n_plans; ++p) starts[p + 1] += starts[p];
  std::vector<int64_t> by_plan(n);
  {
    std::vector<int64_t> cur(starts.begin(), starts.end() - 1);
    for (int64_t i = 0; i < n; ++i) by_plan[cur[plan[i]]++] = i;
  }
  std::vector<Ent> ents;
  std::vector<Group> groups;
  int64_t m = 0;
  for (int32_t p = 0; p < n_plans; ++p) {
    const int64_t s = starts[p], e = starts[p + 1];
    if (s == e) continue;
    ents.clear();
    for (int64_t j = s; j < e; ++j)
      ents.push_back({doc[by_plan[j]], by_plan[j]});
    // (doc, idx): idx ascending within a doc group == input order, so
    // the accumulation below replays the exact FP addition sequence
    std::sort(ents.begin(), ents.end(), [](const Ent& a, const Ent& b) {
      if (a.doc != b.doc) return a.doc < b.doc;
      return a.idx < b.idx;
    });
    groups.clear();
    for (size_t a = 0; a < ents.size();) {
      Group g{ents[a].doc, 0.0, ents[a].idx, 0};
      size_t b = a;
      for (; b < ents.size() && ents[b].doc == g.doc; ++b) {
        g.score += contrib[ents[b].idx];
        g.mask |= bits[ents[b].idx];
      }
      groups.push_back(g);
      a = b;
    }
    std::sort(groups.begin(), groups.end(),
              [](const Group& a, const Group& b) {
                if (a.score != b.score) return a.score > b.score;
                return a.first < b.first;
              });
    for (const Group& g : groups) {
      out_plan[m] = p;
      out_doc[m] = g.doc;
      out_score[m] = g.score;
      out_mask[m] = g.mask;
      ++m;
    }
  }
  return m;
}
