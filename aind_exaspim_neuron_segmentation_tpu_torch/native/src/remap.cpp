// Label remapping: unique/mask_except/renumber.
//
// Native equivalent of the reference's fastremap dependency
// (reference: utils/img_util.py:536-559 uses unique(return_counts=True),
// mask_except(ids), renumber(preserve_zero=True, in_place=True)).
// Operates on uint32 label volumes in place.

#include <algorithm>
#include <cstdint>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "common.hpp"

// Counts distinct labels. Two-call protocol: first call with ids==nullptr
// returns the number of distinct labels; second call fills ids/counts
// (sorted ascending by id).
EXA_API int64_t exa_unique_counts(const uint32_t* labels, int64_t n,
                                  uint32_t* ids, int64_t* counts,
                                  int64_t cap) {
  std::unordered_map<uint32_t, int64_t> table;
  table.reserve(1024);
  for (int64_t i = 0; i < n; ++i) ++table[labels[i]];
  if (ids == nullptr) return static_cast<int64_t>(table.size());
  std::vector<uint32_t> keys;
  keys.reserve(table.size());
  for (const auto& kv : table) keys.push_back(kv.first);
  std::sort(keys.begin(), keys.end());
  int64_t m = std::min<int64_t>(cap, keys.size());
  for (int64_t i = 0; i < m; ++i) {
    ids[i] = keys[i];
    counts[i] = table[keys[i]];
  }
  return static_cast<int64_t>(keys.size());
}

// Zeroes every label not in keep[0..k).
EXA_API void exa_mask_except(uint32_t* labels, int64_t n,
                             const uint32_t* keep, int64_t k) {
  std::unordered_set<uint32_t> keep_set(keep, keep + k);
  for (int64_t i = 0; i < n; ++i) {
    if (!keep_set.count(labels[i])) labels[i] = 0;
  }
}

// Relabels to contiguous ids in order of first appearance (fastremap
// semantics); with preserve_zero, 0 stays 0 and ids start at 1.
// Returns the number of distinct nonzero output labels.
EXA_API int64_t exa_renumber(uint32_t* labels, int64_t n,
                             int32_t preserve_zero) {
  std::unordered_map<uint32_t, uint32_t> remap;
  remap.reserve(1024);
  uint32_t next = 1;
  if (preserve_zero) remap[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    auto it = remap.find(labels[i]);
    if (it == remap.end()) {
      it = remap.emplace(labels[i], next++).first;
    }
    labels[i] = it->second;
  }
  return static_cast<int64_t>(next - 1);
}
