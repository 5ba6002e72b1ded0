// The host's part of the device engine's seed selection
// (ops/seed_sort.py): the finish of the prefix-pruned z-sort whose large
// partitions ran on the device, and the seed walk over the sorted prefix.
//
//  * seed_sort_finish runs what pengnative.cpp's zscore_sort_prefix runs
//    after the device left off: pruned_introsort_loop on every range the
//    device handed over, each with its own depth budget, then the final
//    insertion pass truncated at keep_end + 16.  It drives the same
//    libstdc++ internals (std::__unguarded_partition_pivot,
//    std::__partial_sort, std::__insertion_sort,
//    std::__unguarded_insertion_sort) with the same comparator on the same
//    positions, so [0, keep_end) comes out element for element as
//    zscore_sort_prefix's.  Subranges are independent once partitioned, so
//    the order the ranges are finished in changes nothing.
//  * seed_walk_prefix is pengnative.cpp's select_patterns_walk (reference:
//    src/base_pattern.cpp:443-515) on arrays aligned with the sorted
//    prefix: ids, and z and counts at those ids, in place of whole tables
//    indexed by id.  It returns the prefix positions of the seeds.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <memory>
#include <vector>

namespace {

struct ZIPair {
  float z;
  uint32_t i;
};

// std::__introsort_loop (bits/stl_algo.h) with the keep_end prune, as
// pengnative.cpp has it; _S_threshold = 16
template <typename It, typename Comp>
void pruned_introsort_loop(It first, It last, It keep_end,
                           int64_t depth_limit, Comp comp) {
  while (last - first > 16) {
    if (depth_limit == 0) {
      std::__partial_sort(first, last, last, comp);
      return;
    }
    --depth_limit;
    It cut = std::__unguarded_partition_pivot(first, last, comp);
    if (cut < keep_end)
      pruned_introsort_loop(cut, last, keep_end, depth_limit, comp);
    last = cut;
  }
}

// reverse complement of a W-digit id (digit p at bits 2p)
inline int64_t revcomp(int64_t id, int w) {
  int64_t r = 0;
  for (int p = 0; p < w; p++) {
    r = (r << 2) | (3 - (id & 3));
    id >>= 2;
  }
  return r;
}

}  // namespace

extern "C" {

// z[0, n) are the keys at positions [0, n) of the table as the device left
// it (n >= fin); ranges holds n_ranges triples (first, last, depth) that
// the device did not partition.  Writes to perm[0, fin) the positions of
// [0, n) in their sorted order over [0, fin).
void seed_sort_finish(const float* z, int64_t n, const int64_t* ranges,
                      int64_t n_ranges, int64_t keep_end, int64_t fin,
                      uint32_t* perm) {
  std::vector<ZIPair> v(n);
  for (int64_t i = 0; i < n; i++) v[i] = {z[i], (uint32_t)i};
  auto comp = [](const ZIPair& a, const ZIPair& b) { return a.z > b.z; };
  auto wcomp = __gnu_cxx::__ops::__iter_comp_iter(comp);
  ZIPair* first = v.data();
  for (int64_t r = 0; r < n_ranges; r++)
    pruned_introsort_loop(first + ranges[3 * r], first + ranges[3 * r + 1],
                          first + keep_end, ranges[3 * r + 2], wcomp);
  // truncated std::__final_insertion_sort
  if (fin > 16) {
    std::__insertion_sort(first, first + 16, wcomp);
    std::__unguarded_insertion_sort(first + 16, first + fin, wcomp);
  } else {
    std::__insertion_sort(first, first + fin, wcomp);
  }
  for (int64_t i = 0; i < fin; i++) perm[i] = v[i].i;
}

// The walk over n prefix entries of a 4^w table; out receives the prefix
// positions of the selected seeds, in walk order.  Returns their number, or
// -1 where the seen table cannot be allocated.
int64_t seed_walk_prefix(const uint32_t* ids, const float* z,
                         const int32_t* counts, int64_t n, int w,
                         float z_thr, int32_t count_thr, int single_stranded,
                         int filter_neighbors, int64_t* out) {
  // calloc: the pages of a large table are zero until touched
  std::unique_ptr<uint8_t, decltype(&std::free)> seen_buf(
      (uint8_t*)std::calloc((size_t)1 << (2 * w), 1), &std::free);
  uint8_t* seen = seen_buf.get();
  if (seen == nullptr) return -1;
  int64_t n_sel = 0;
  for (int64_t idx = 0; idx < n; idx++) {
    const int64_t pat = ids[idx];
    if (z[idx] < z_thr) break;
    if (counts[idx] < count_thr) continue;
    bool ok = !seen[pat] && (single_stranded || !seen[revcomp(pat, w)]);
    if (!ok) continue;
    out[n_sel++] = idx;
    seen[pat] = 1;
    if (filter_neighbors) {
      int64_t p4 = 1;
      for (int p = 0; p < w; p++) {
        const int64_t c = (pat >> (2 * p)) & 3;
        const int64_t masked = pat - c * p4;
        for (int64_t letter = 0; letter < 4; letter++)
          seen[masked + letter * p4] = 1;
        p4 <<= 2;
      }
    }
  }
  return n_sel;
}

}  // extern "C"
