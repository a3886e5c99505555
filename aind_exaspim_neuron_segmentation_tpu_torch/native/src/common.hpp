// Shared helpers for the native engine.
#pragma once

#include <cstdint>
#include <vector>

#if defined(EXA_EXPORT)
#define EXA_API extern "C" __attribute__((visibility("default")))
#else
#define EXA_API extern "C"
#endif

namespace exa {

// Disjoint-set forest with path halving + union by size.
struct UnionFind {
  std::vector<uint32_t> parent;
  std::vector<uint32_t> size;

  explicit UnionFind(size_t n) : parent(n), size(n, 1) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<uint32_t>(i);
  }

  uint32_t find(uint32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }

  // Returns the surviving root (union by size; ties keep the smaller id
  // for determinism).
  uint32_t unite(uint32_t a, uint32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return a;
    if (size[a] < size[b] || (size[a] == size[b] && a > b)) std::swap(a, b);
    parent[b] = a;
    size[a] += size[b];
    return a;
  }

  // Directed union: `drop` (must be a root) is absorbed into `keep`
  // (must be a root). Callers use this when an external structure (e.g.
  // an adjacency list) dictates which side must survive.
  void unite_into(uint32_t keep, uint32_t drop) {
    if (keep == drop) return;
    parent[drop] = keep;
    size[keep] += size[drop];
  }
};

}  // namespace exa
