// Region-adjacency-graph machinery shared by the dense agglomeration
// engine (agglomerate.cpp) and the slab-streaming engine
// (streamseg.cpp): the flat edge index, compact per-edge affinity
// distributions, chunked edge/adjacency storage, and the
// component-parallel merge loop.
//
// Both engines implement the waterz-equivalent contract of reference
// inference.py:224-233; the merge loop here is the single definition,
// so dense and streaming paths are bit-identical by construction.
#pragma once

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

#include "common.hpp"

namespace exa_rag {

constexpr int kBins = 256;

// Worker-pool over contiguous index ranges (the TEASAR pattern,
// teasar.cpp:443-476): results are written to disjoint per-block or
// per-voxel slots, so output is deterministic for any thread count.
// EXA_NUM_THREADS overrides (0/unset = hardware concurrency).
inline int num_threads() {
  if (const char* env = std::getenv("EXA_NUM_THREADS")) {
    const int v = std::atoi(env);
    if (v > 0) return v;
  }
  const unsigned hc = std::thread::hardware_concurrency();
  return hc > 0 ? static_cast<int>(hc) : 1;
}

template <typename Fn>
void parallel_blocks(int64_t n_blocks, Fn&& fn) {
  const int threads = std::min<int64_t>(num_threads(), n_blocks);
  if (threads <= 1) {
    for (int64_t b = 0; b < n_blocks; ++b) fn(b);
    return;
  }
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    while (true) {
      const int64_t b = next.fetch_add(1);
      if (b >= n_blocks) return;
      fn(b);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

struct EdgeKey {
  uint32_t a, b;  // a < b (fragment root ids at creation time)
  bool operator==(const EdgeKey& o) const { return a == o.a && b == o.b; }
  uint64_t packed() const {
    return (static_cast<uint64_t>(a) << 32) | b;
  }
};

// Deterministic FlatMap rebuild accounting, reported under
// EXA_DEBUG_TIMING: wall-clock A/Bs on the shared dev host are
// steal-noise-dominated, so rebuild-policy changes are validated
// against these counters (rebuild count, entries reinserted, capacity
// allocated) as well. Only touched inside grow(), never on the probe
// hot path.
inline std::atomic<uint64_t> g_flat_rebuilds{0};
inline std::atomic<uint64_t> g_flat_reinserted{0};
inline std::atomic<uint64_t> g_flat_cap_allocated{0};
// Histogram promotions (inline sample buffer -> dense 256-bin
// histogram, a 1 KiB allocation each) -- same diagnostic role.
inline std::atomic<uint64_t> g_hist_promotions{0};

// Open-addressing uint64 -> uint32 map. The RAG merge loop performs
// tens of millions of erase/find/insert operations; std::unordered_map's
// node allocations dominated the single-core profile, so edge keys live
// in one flat probe array (linear probing, tombstone deletes, grow at
// 60% load).
class FlatMap {
  // Sentinels exploit the key domain: every key is EdgeKey::packed(),
  // i.e. (min << 32) | max with 1 <= min < max, so neither 0 nor ~0
  // can ever be a real key. Empty == 0 lets fresh tables come from
  // calloc: large allocations are lazily-faulted zero pages, so
  // (re)building a table costs O(entries touched), not an O(capacity)
  // memset -- the explicit fill was 60% of the merge loop's CPU time
  // at SURVEY-scale RAGs.
  static constexpr uint64_t kEmpty = 0;
  static constexpr uint64_t kTomb = ~0ull;

  struct Entry {
    uint64_t key;
    uint32_t val;
    uint32_t pad;
  };  // 16 B: one cache line covers four slots -- a probe touches one
      // line instead of two separate key/value arrays

  Entry* slots_ = nullptr;
  size_t cap_ = 0;
  size_t mask_ = 0;
  size_t used_ = 0;   // live + tombstones
  size_t live_ = 0;

  static Entry* alloc(size_t cap) {
    return static_cast<Entry*>(std::calloc(cap, sizeof(Entry)));
  }

  static size_t mix(uint64_t k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 29;
    return static_cast<size_t>(k);
  }

  void grow() {
    // Size to LIVE entries (<=25% load after the rebuild): the merge
    // loop erases tens of millions of keys, so by the time the load
    // trigger fires most occupied slots are usually tombstones. The
    // rebuild both sweeps them (short probe chains again) and SHRINKS
    // the table as its component's edges die off, instead of scaling
    // capacity with cumulative insert traffic. Capacity decays at most
    // 2x per rebuild: shrinking straight to 4*live would leave only
    // ~live spare slots before the next trigger, making rebuilds too
    // frequent to amortize.
    size_t cap = 16;
    while (cap < (live_ + 1) * 4) cap <<= 1;
    if (cap < cap_ / 2) cap = cap_ / 2;
    g_flat_rebuilds.fetch_add(1, std::memory_order_relaxed);
    g_flat_reinserted.fetch_add(live_, std::memory_order_relaxed);
    g_flat_cap_allocated.fetch_add(cap, std::memory_order_relaxed);
    Entry* old = slots_;
    const size_t old_cap = cap_;
    slots_ = alloc(cap);
    cap_ = cap;
    mask_ = cap - 1;
    used_ = live_ = 0;
    for (size_t i = 0; i < old_cap; ++i) {
      const Entry& e = old[i];
      if (e.key != kEmpty && e.key != kTomb) insert(e.key, e.val);
    }
    std::free(old);
  }

 public:
  explicit FlatMap(size_t hint = 16) {
    size_t cap = 16;
    while (cap < hint * 2) cap <<= 1;
    slots_ = alloc(cap);
    cap_ = cap;
    mask_ = cap - 1;
  }

  FlatMap(const FlatMap&) = delete;
  FlatMap& operator=(const FlatMap&) = delete;
  FlatMap(FlatMap&& o) noexcept
      : slots_(o.slots_), cap_(o.cap_), mask_(o.mask_), used_(o.used_),
        live_(o.live_) {
    o.slots_ = nullptr;
    o.cap_ = 0;
  }
  FlatMap& operator=(FlatMap&& o) noexcept {
    if (this != &o) {
      std::free(slots_);
      slots_ = o.slots_;
      cap_ = o.cap_;
      mask_ = o.mask_;
      used_ = o.used_;
      live_ = o.live_;
      o.slots_ = nullptr;
      o.cap_ = 0;
    }
    return *this;
  }
  ~FlatMap() { std::free(slots_); }

  // Returns pointer to value or nullptr.
  uint32_t* find(uint64_t key) {
    size_t i = mix(key) & mask_;
    while (true) {
      Entry& e = slots_[i];
      if (e.key == key) return &e.val;
      if (e.key == kEmpty) return nullptr;
      i = (i + 1) & mask_;
    }
  }

  // One probe sequence: existing slot, or insert val_if_new.
  // Returns (value pointer, inserted?).
  std::pair<uint32_t*, bool> find_or_insert(uint64_t key,
                                            uint32_t val_if_new) {
    if ((used_ + 1) * 2 > cap_) grow();
    size_t i = mix(key) & mask_;
    size_t tomb = SIZE_MAX;
    while (true) {
      Entry& e = slots_[i];
      if (e.key == key) return {&e.val, false};
      if (e.key == kTomb && tomb == SIZE_MAX) tomb = i;
      if (e.key == kEmpty) {
        size_t slot = tomb != SIZE_MAX ? tomb : i;
        if (tomb == SIZE_MAX) ++used_;
        slots_[slot] = Entry{key, val_if_new, 0};
        ++live_;
        return {&slots_[slot].val, true};
      }
      i = (i + 1) & mask_;
    }
  }

  void insert(uint64_t key, uint32_t val) {
    auto [ptr, inserted] = find_or_insert(key, val);
    if (!inserted) *ptr = val;
  }

  void erase(uint64_t key) {
    size_t i = mix(key) & mask_;
    while (true) {
      Entry& e = slots_[i];
      if (e.key == key) {
        e.key = kTomb;
        --live_;
        return;
      }
      if (e.key == kEmpty) return;
      i = (i + 1) & mask_;
    }
  }

  // Clear and resize for `hint` expected entries (the component-merge
  // workers reset one scratch map per RAG component). free + calloc is
  // cheaper than clearing in place: the kernel hands back zero pages.
  void reset(size_t hint) {
    size_t cap = 16;
    while (cap < hint * 2) cap <<= 1;
    std::free(slots_);
    slots_ = alloc(cap);
    cap_ = cap;
    mask_ = cap - 1;
    used_ = live_ = 0;
  }
};

// Memory-compact affinity distribution per RAG edge. Fragment counts
// reach millions on noisy affinities (SURVEY-scale volumes), so a dense
// 256-bin uint32 histogram per edge (1 KiB) is prohibitive. Edges keep
// raw u8-quantized samples inline while small and convert to a dense
// histogram only when they grow past kInlineMax (merged supervoxel
// boundaries) -- identical quantile results either way, since both
// representations hold the same 256-level quantization.
struct Edge {
  // Inline sample buffer: most RAG edges between watershed fragments
  // carry a handful of boundary voxels, so quantized samples live
  // inside the struct (no per-edge heap allocation); edges that grow
  // past kInlineMax (merged supervoxel boundaries) switch to a dense
  // 256-bin histogram. Identical quantile results either way.
  static constexpr size_t kInlineMax = 24;

  // NOTE: liveness is NOT stored here -- the merge loop keeps it in a
  // compact side bitvector so its hot path (skipping dead lazy-deletion
  // queue entries and scanning adjacency lists) never has to pull these
  // 72-byte structs through the cache: at SURVEY-scale RAGs (22M edges
  // = 1.6 GB of Edge data) the liveness checks dominated DRAM traffic.
  uint32_t a, b;
  uint64_t count = 0;
  std::vector<uint32_t> hist;  // dense histogram once large
  uint8_t inl[kInlineMax];     // quantized affinities while small
  uint8_t n_inl = 0;
  int16_t cached_bin = -1;     // invalidated on add/absorb

  Edge(uint32_t a_, uint32_t b_) : a(a_), b(b_) {}

  static uint8_t quantize(float aff) {
    int bin = static_cast<int>(aff * kBins);
    if (bin < 0) bin = 0;
    if (bin >= kBins) bin = kBins - 1;
    return static_cast<uint8_t>(bin);
  }

  void to_hist() {
    g_hist_promotions.fetch_add(1, std::memory_order_relaxed);
    hist.assign(kBins, 0);
    for (int i = 0; i < n_inl; ++i) ++hist[inl[i]];
    n_inl = 0;
  }

  void add_bin(uint8_t q) {
    if (hist.empty()) {
      if (n_inl == kInlineMax) to_hist();
    }
    if (hist.empty()) {
      inl[n_inl++] = q;
    } else {
      ++hist[q];
    }
    ++count;
    cached_bin = -1;
  }

  void add(float aff) { add_bin(quantize(aff)); }

  void absorb(Edge& o) {
    if (hist.empty() && o.hist.empty() &&
        size_t(n_inl) + o.n_inl <= kInlineMax) {
      std::memcpy(inl + n_inl, o.inl, o.n_inl);
      n_inl = static_cast<uint8_t>(n_inl + o.n_inl);
    } else if (hist.empty() && !o.hist.empty()) {
      // Steal o's dense histogram instead of allocating a fresh 1 KiB
      // buffer and adding 256 bins: counts are commutative sums, so
      // dropping our inline samples into o's buffer yields the
      // identical distribution.
      hist = std::move(o.hist);
      for (int i = 0; i < n_inl; ++i) ++hist[inl[i]];
      n_inl = 0;
    } else {
      if (hist.empty()) to_hist();
      if (!o.hist.empty()) {
        for (int i = 0; i < kBins; ++i) hist[i] += o.hist[i];
      } else {
        for (int i = 0; i < o.n_inl; ++i) ++hist[o.inl[i]];
      }
    }
    count += o.count;
    cached_bin = -1;
    o.n_inl = 0;
    o.hist.clear();
    o.hist.shrink_to_fit();
  }

  // Quantile bin of the affinity distribution; cached until the
  // distribution changes. score = 1 - (bin + 0.5)/256.
  int score_bin(int quantile_pct) {
    if (cached_bin >= 0) return cached_bin;
    if (count == 0) return -1;  // empty: score 1.0
    const uint64_t target = (count - 1) * quantile_pct / 100;
    int bin;
    if (hist.empty()) {
      uint8_t tmp[kInlineMax];
      std::memcpy(tmp, inl, n_inl);
      std::nth_element(tmp, tmp + target, tmp + n_inl);
      bin = tmp[target];
    } else {
      uint64_t seen = 0;
      bin = kBins - 1;
      for (int i = 0; i < kBins; ++i) {
        seen += hist[i];
        if (seen > target) {
          bin = i;
          break;
        }
      }
    }
    cached_bin = static_cast<int16_t>(bin);
    return bin;
  }

  float score(int quantile_pct) {
    const int bin = score_bin(quantile_pct);
    if (bin < 0) return 1.0f;
    return 1.0f - (bin + 0.5f) / kBins;
  }
};

// Append-only chunked Edge storage. At SURVEY-scale RAGs (tens of
// millions of 72-byte entries) std::vector reallocation both moved
// every Edge O(log E) times (26% of the single-core RAG-build profile)
// and transiently held old+new buffers (2.4 GB extra peak at E=22M).
// Fixed-size blocks keep Edge addresses stable and append O(1); each
// block reservation is one large malloc, so untouched tail pages cost
// only address space.
class EdgeStore {
  static constexpr size_t kShift = 20;  // 2^20 edges (~75 MB) per block
  static constexpr size_t kMask = (size_t(1) << kShift) - 1;
  std::vector<std::vector<Edge>> blocks_;
  size_t size_ = 0;

 public:
  size_t size() const { return size_; }
  Edge& operator[](size_t i) { return blocks_[i >> kShift][i & kMask]; }
  const Edge& operator[](size_t i) const {
    return blocks_[i >> kShift][i & kMask];
  }
  void emplace_back(uint32_t a, uint32_t b) {
    if ((size_ & kMask) == 0) {
      blocks_.emplace_back();
      blocks_.back().reserve(kMask + 1);
    }
    blocks_.back().emplace_back(a, b);
    ++size_;
  }
  void release() {
    blocks_.clear();
    blocks_.shrink_to_fit();
    size_ = 0;
  }
};

// Pooled chunked incident lists. The merge loop appends ~3x E entries
// into per-root adjacency lists and discards each dropped root's list
// right after scanning it; as std::vector<std::vector<uint32_t>> that
// was millions of malloc/realloc/free calls plus O(entries) memcpy on
// every growth -- the allocator and memmove together dominated the
// digest-path profile. Lists are now chains of 64-byte chunks drawn
// from bump arenas with freelist recycling. Semantics-preserving by
// construction: append order and gross entry counts (including
// lazily-skipped dead edges, which the smaller-side heuristic
// deliberately counts, matching the vectors this replaces) are
// identical.
struct IncChunk {
  static constexpr int kCap = 13;
  IncChunk* next;
  uint8_t n;
  uint32_t v[kCap];  // member order packs the chunk into 64 bytes
};
static_assert(sizeof(IncChunk) == 64, "one cache line per chunk");

class ChunkArena {
  static constexpr size_t kBlock = size_t(1) << 16;  // 4 MiB of chunks
  std::vector<std::unique_ptr<IncChunk[]>> blocks_;
  size_t used_ = kBlock;
  IncChunk* free_ = nullptr;

 public:
  IncChunk* get() {
    IncChunk* c;
    if (free_ != nullptr) {
      c = free_;
      free_ = c->next;
    } else {
      if (used_ == kBlock) {
        blocks_.emplace_back(new IncChunk[kBlock]);
        used_ = 0;
      }
      c = &blocks_.back()[used_++];
    }
    c->n = 0;
    c->next = nullptr;
    return c;
  }
  // Recycles a whole chain. Chunks may have been allocated by ANY
  // arena, so every arena must outlive every list that could hold its
  // chunks (all arenas live at run_merge scope).
  void recycle(IncChunk* head) {
    while (head != nullptr) {
      IncChunk* nx = head->next;
      head->next = free_;
      free_ = head;
      head = nx;
    }
  }
};

struct IncList {
  IncChunk* head = nullptr;
  IncChunk* tail = nullptr;
  uint32_t gross = 0;  // total appended, dead entries included
};

inline void inc_append(IncList& l, uint32_t val, ChunkArena& arena) {
  if (l.tail == nullptr || l.tail->n == IncChunk::kCap) {
    IncChunk* c = arena.get();
    if (l.tail != nullptr) {
      l.tail->next = c;
    } else {
      l.head = c;
    }
    l.tail = c;
  }
  l.tail->v[l.tail->n++] = val;
  ++l.gross;
}

// The merge loop's output: per-RAG-component (keep, drop) union events
// in execution order, plus, per requested threshold, how many of that
// component's events had executed when the threshold was crossed.
// Snapshots replay event prefixes (see apply_threshold); labelings are
// bit-identical for any worker count.
struct MergeEvents {
  std::vector<std::vector<std::pair<uint32_t, uint32_t>>> comp_events;
  std::vector<uint32_t> cutoffs;  // n_comps * n_thresholds
  uint32_t n_comps = 0;
  int64_t n_thresholds = 0;
};

// Hierarchical agglomeration over a prebuilt RAG. `edge_index` must map
// EdgeKey::packed() of each live edge's CURRENT endpoints to its index
// in `edges` (the RAG build constructs exactly this); it is consumed.
// Fragment ids are 1..K. Components of the RAG run as independent
// serial programs on the worker pool: merges in different components
// never interact (an edge's score is a function of intra-component
// affinity distributions only, and unions touch disjoint fragment
// sets), and the set of merges executed below any threshold is
// invariant to how components are interleaved. Production volumes --
// neurites separated by background -- decompose into many components.
inline MergeEvents run_merge(FlatMap& edge_index, EdgeStore& edges,
                             int64_t K, const float* thresholds,
                             int64_t n_thresholds, int32_t quantile_pct,
                             double* dbg_secs_adjacency = nullptr,
                             double* dbg_secs_merge = nullptr) {
  auto now = []() { return std::chrono::steady_clock::now(); };
  const auto t_start = now();
  MergeEvents me;
  me.n_thresholds = n_thresholds;
  if (n_thresholds == 0) return me;
  const uint32_t E = static_cast<uint32_t>(edges.size());
  // Hot-path side arrays (see the Edge struct note): 1 byte of
  // liveness + 8 bytes of packed original endpoints per edge, so the
  // merge loop's dead-entry skips and root lookups stay in small
  // sequential arrays instead of striding the 72-byte Edge structs.
  // Built first so the adjacency/component passes below read endpoints
  // from it too.
  std::vector<uint8_t> alive(E, 1);
  std::vector<uint64_t> ends(E);
  for (uint32_t ei = 0; ei < E; ++ei) {
    ends[ei] = (static_cast<uint64_t>(edges[ei].a) << 32) | edges[ei].b;
  }
  // Adjacency: fragment root -> incident edge indices (chunk chains;
  // every arena outlives the merge phase -- see ChunkArena::recycle).
  exa::UnionFind uf(static_cast<size_t>(K) + 1);
  ChunkArena build_arena;
  std::vector<IncList> incident(K + 1);
  for (uint32_t ei = 0; ei < E; ++ei) {
    inc_append(incident[static_cast<uint32_t>(ends[ei] >> 32)], ei,
               build_arena);
    inc_append(incident[static_cast<uint32_t>(ends[ei])], ei, build_arena);
  }

  // Connected components of the RAG (see run_merge contract above).
  // Each component logs its executed (keep, drop) unions plus, per
  // threshold, how many had executed when the threshold was crossed
  // (crossing = the component's next-lowest score strictly exceeds it,
  // the exact flush rule of the fused serial loop this replaces).
  exa::UnionFind comp_uf(static_cast<size_t>(K) + 1);
  for (uint32_t ei = 0; ei < E; ++ei) {
    comp_uf.unite(static_cast<uint32_t>(ends[ei] >> 32),
                  static_cast<uint32_t>(ends[ei]));
  }
  std::vector<uint32_t> comp_of(E);
  std::vector<uint32_t> comp_sizes;  // edge count per component
  {
    std::unordered_map<uint32_t, uint32_t> root_to_comp;
    root_to_comp.reserve(1024);
    for (uint32_t ei = 0; ei < E; ++ei) {
      const uint32_t r = comp_uf.find(static_cast<uint32_t>(ends[ei] >> 32));
      auto it = root_to_comp.find(r);
      if (it == root_to_comp.end()) {
        it = root_to_comp
                 .emplace(r, static_cast<uint32_t>(comp_sizes.size()))
                 .first;
        comp_sizes.push_back(0);
      }
      comp_of[ei] = it->second;
      ++comp_sizes[it->second];
    }
  }
  const uint32_t n_comps = static_cast<uint32_t>(comp_sizes.size());
  me.n_comps = n_comps;
  // CSR edge lists per component, ascending edge index within each
  // (keeps the serial loop's FIFO ascending-edge-index tie-break:
  // buckets never mix components, so relative order is preserved).
  std::vector<uint32_t> comp_start(n_comps + 1, 0);
  for (uint32_t c = 0; c < n_comps; ++c) {
    comp_start[c + 1] = comp_start[c] + comp_sizes[c];
  }
  std::vector<uint32_t> comp_edges(E);
  {
    std::vector<uint32_t> fill(comp_start.begin(), comp_start.end() - 1);
    for (uint32_t ei = 0; ei < E; ++ei) comp_edges[fill[comp_of[ei]]++] = ei;
  }
  comp_of.clear();
  comp_of.shrink_to_fit();
  // Largest components first: workers pull from an atomic counter, so
  // the long-running components start before the tail of tiny ones.
  std::vector<uint32_t> order(n_comps);
  for (uint32_t c = 0; c < n_comps; ++c) order[c] = c;
  std::stable_sort(order.begin(), order.end(),
                   [&](uint32_t a, uint32_t b) {
                     return comp_sizes[a] > comp_sizes[b];
                   });
  if (n_comps > 1) {
    // The RAG-build map is keyed by initial fragment pairs globally;
    // workers use per-component maps instead. Free it (16 B/edge).
    edge_index = FlatMap(16);
  }

  me.comp_events.resize(n_comps);
  me.cutoffs.resize(static_cast<size_t>(n_comps) * n_thresholds);

  const auto t4 = now();
  if (dbg_secs_adjacency != nullptr) {
    *dbg_secs_adjacency = std::chrono::duration<double>(t4 - t_start).count();
  }

  auto run_component = [&](uint32_t comp, FlatMap& local,
                           std::vector<std::vector<uint32_t>>& buckets,
                           std::vector<size_t>& heads, ChunkArena& arena) {
    const uint32_t e_lo = comp_start[comp];
    const uint32_t e_hi = comp_start[comp + 1];
    // Bucket queue: scores are 256-level quantized, so a min-heap is
    // overkill -- one FIFO bucket per score bin (ascending score
    // order; bucket 256 holds empty-distribution edges at score 1.0).
    // An edge is (re-)pushed into its current bucket whenever its
    // distribution changes; pops whose bucket no longer matches the
    // edge's bin are stale duplicates and skipped.
    auto bucket_of = [&](Edge& e) {
      const int bin = e.score_bin(quantile_pct);
      return bin < 0 ? kBins : (kBins - 1 - bin);
    };
    FlatMap* index;
    if (n_comps == 1) {
      index = &edge_index;  // the RAG-build map, keyed identically
    } else {
      local.reset(e_hi - e_lo);
      for (uint32_t i = e_lo; i < e_hi; ++i) {
        const uint32_t ei = comp_edges[i];
        local.insert(ends[ei], ei);
      }
      index = &local;
    }
    for (uint32_t i = e_lo; i < e_hi; ++i) {
      const uint32_t ei = comp_edges[i];
      buckets[bucket_of(edges[ei])].push_back(ei);
    }

    auto& evs = me.comp_events[comp];
    uint32_t* cut = &me.cutoffs[static_cast<size_t>(comp) * n_thresholds];
    int64_t t_idx = 0;
    auto flush = [&](float next_score) {
      while (t_idx < n_thresholds && next_score > thresholds[t_idx]) {
        cut[t_idx] = static_cast<uint32_t>(evs.size());
        ++t_idx;
      }
    };

    int cur = 0;
    while (cur <= kBins && t_idx < n_thresholds) {
      if (heads[cur] >= buckets[cur].size()) {
        buckets[cur].clear();
        heads[cur] = 0;
        ++cur;
        continue;
      }
      const uint32_t eidx = buckets[cur][heads[cur]++];
      if (!alive[eidx]) continue;
      const uint64_t ee = ends[eidx];
      const uint32_t ra = uf.find(static_cast<uint32_t>(ee >> 32));
      const uint32_t rb = uf.find(static_cast<uint32_t>(ee));
      if (ra == rb) {
        alive[eidx] = 0;
        continue;
      }
      Edge& e = edges[eidx];
      if (bucket_of(e) != cur) continue;  // stale: fresh entry elsewhere
      flush(e.score(quantile_pct));
      if (t_idx >= n_thresholds) break;

      // Merge the side with the SMALLER adjacency list into the
      // larger: only the small side's edges are re-keyed, so each edge
      // endpoint moves O(log K) times total (near-linear
      // agglomeration; rebuilding the large list per merge was
      // quadratic in fragments).
      uint32_t keep = ra, drop = rb;
      if (incident[keep].gross < incident[drop].gross) {
        std::swap(keep, drop);
      }
      uf.unite_into(keep, drop);
      evs.emplace_back(keep, drop);
      alive[eidx] = 0;
      index->erase(EdgeKey{std::min(ra, rb), std::max(ra, rb)}.packed());

      for (IncChunk* ch = incident[drop].head; ch != nullptr;
           ch = ch->next) {
        for (uint8_t k = 0; k < ch->n; ++k) {
        const uint32_t ei = ch->v[k];
        if (!alive[ei]) continue;
        const uint64_t fe = ends[ei];
        const uint32_t fa = uf.find(static_cast<uint32_t>(fe >> 32));
        const uint32_t fb = uf.find(static_cast<uint32_t>(fe));
        if (fa == fb) {
          alive[ei] = 0;
          continue;
        }
        const uint32_t peer = (fa == keep) ? fb : fa;
        index->erase(
            EdgeKey{std::min(drop, peer), std::max(drop, peer)}.packed());
        const EdgeKey new_key{std::min(keep, peer), std::max(keep, peer)};
        uint32_t* slot = index->find(new_key.packed());
        if (slot == nullptr || !alive[*slot]) {
          index->insert(new_key.packed(), ei);
          inc_append(incident[keep], ei, arena);
        } else if (*slot != ei) {
          Edge& g = edges[*slot];
          const uint32_t gi = *slot;
          g.absorb(edges[ei]);
          alive[ei] = 0;
          const int b = bucket_of(g);
          buckets[b].push_back(gi);
          if (b < cur) cur = b;  // score dropped: revisit earlier bucket
        }
        }
      }
      arena.recycle(incident[drop].head);
      incident[drop] = IncList{};
    }
    // Thresholds never crossed (all remaining scores <= them): every
    // executed event belongs to each remaining threshold's prefix.
    while (t_idx < n_thresholds) {
      cut[t_idx++] = static_cast<uint32_t>(evs.size());
    }
    // Scrub bucket state for the next component on this worker (early
    // break can leave entries behind).
    for (int b = 0; b <= kBins; ++b) {
      if (!buckets[b].empty()) buckets[b].clear();
      heads[b] = 0;
    }
  };

  {
    const int workers =
        static_cast<int>(std::min<int64_t>(num_threads(), n_comps));
    // Per-worker arenas at this scope: workers may recycle (and then
    // re-issue) chunks originally allocated by build_arena or another
    // worker's arena, so all arenas must outlive the whole pool.
    std::vector<ChunkArena> arenas(std::max(workers, 1));
    if (workers <= 1) {
      FlatMap local(16);
      std::vector<std::vector<uint32_t>> buckets(kBins + 1);
      std::vector<size_t> heads(kBins + 1, 0);
      for (uint32_t oi = 0; oi < n_comps; ++oi) {
        run_component(order[oi], local, buckets, heads, arenas[0]);
      }
    } else {
      std::atomic<uint32_t> next_comp{0};
      std::atomic<int> next_worker{0};
      auto worker = [&]() {
        ChunkArena& arena = arenas[next_worker.fetch_add(1)];
        FlatMap local(16);
        std::vector<std::vector<uint32_t>> buckets(kBins + 1);
        std::vector<size_t> heads(kBins + 1, 0);
        while (true) {
          const uint32_t oi = next_comp.fetch_add(1);
          if (oi >= n_comps) return;
          run_component(order[oi], local, buckets, heads, arena);
        }
      };
      std::vector<std::thread> pool;
      for (int t = 0; t < workers; ++t) pool.emplace_back(worker);
      for (auto& t : pool) t.join();
    }
  }
  if (dbg_secs_merge != nullptr) {
    *dbg_secs_merge =
        std::chrono::duration<double>(now() - t4).count();
  }
  return me;
}

// Advance the replay forest from threshold `applied` state to
// threshold k: applies each component's event prefix [applied[c],
// cutoffs[c][k]). Events record (keep, drop) root pairs at execution
// time; within a component the replayed prefix is exactly the executed
// prefix, so `drop` is still its own root when its event applies and
// parent[drop] = keep reproduces unite_into.
inline void apply_threshold(const MergeEvents& me, int64_t k,
                            std::vector<uint32_t>& rparent,
                            std::vector<uint32_t>& applied) {
  for (uint32_t c = 0; c < me.n_comps; ++c) {
    const uint32_t to =
        me.cutoffs[static_cast<size_t>(c) * me.n_thresholds + k];
    const auto& evs = me.comp_events[c];
    for (uint32_t i = applied[c]; i < to; ++i) {
      rparent[evs[i].second] = evs[i].first;
    }
    applied[c] = to;
  }
}

}  // namespace exa_rag
