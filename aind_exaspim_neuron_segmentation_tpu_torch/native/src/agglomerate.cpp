// Affinity watershed + hierarchical supervoxel agglomeration.
//
// Native equivalent of the reference's waterz dependency, matching the
// call-site contract at reference inference.py:224-233:
//   agglomerate(affs float32 (3, D, H, W), thresholds,
//               aff_threshold_low=0.1, aff_threshold_high=0.9999)
// yielding one label volume per threshold (ascending), of which the
// reference keeps only the last.
//
// Affinity convention (matches core.affinities): aff[c][z][y][x] is the
// edge weight between voxel v=(z,y,x) and v + e_c, where e_0=(1,0,0),
// e_1=(0,1,0), e_2=(0,0,1); entries in the last plane along axis c are
// out-of-range and ignored.
//
// Algorithm:
//  1. Fragments: steepest-ascent affinity watershed. Every edge with
//     aff >= high is unioned outright (seeding); every voxel whose max
//     incident affinity m(v) >= low is unioned with its steepest
//     neighbor (deterministic tie-break by edge enumeration order).
//     Voxels with m(v) < low are background (0). This follows the
//     watershed construction of Zlateski & Seung (zwatershed), which
//     waterz embeds.
//  2. Region adjacency graph with a 256-bin affinity histogram per edge.
//  3. Hierarchical agglomeration: edges are merged in order of
//     increasing score = 1 - quantile(affinities, q) (q = 85th
//     percentile by default, waterz's default scoring function
//     OneMinus<QuantileAffinity<85>>), with lazy-deletion priority
//     queue and histogram merging. After exhausting scores <= t for
//     each requested threshold t (ascending), the current labeling is
//     snapshotted.
//
// The RAG containers and the component-parallel merge loop live in
// rag.hpp, shared with the slab-streaming engine (streamseg.cpp).

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <unordered_map>
#include <vector>

#include "common.hpp"
#include "rag.hpp"

namespace {

using exa_rag::Edge;
using exa_rag::EdgeKey;
using exa_rag::EdgeStore;
using exa_rag::FlatMap;
using exa_rag::num_threads;
using exa_rag::parallel_blocks;

inline int64_t vox(int64_t z, int64_t y, int64_t x, int64_t H, int64_t W) {
  return (z * H + y) * W + x;
}

// Pass 1b + renumber: replay recorded union decisions (one byte per
// voxel: bits 0-2 outgoing >= high flags, bits 3-5 steepest direction)
// and renumber foreground roots 1..K in scan order. Shared by the
// float path (exa_watershed, which builds the bytes in pass 1a) and
// the device pre-digest path (exa_watershed_plan, where the TPU built
// them).
int64_t watershed_replay(const uint8_t* plan, int64_t D, int64_t H,
                         int64_t W, uint32_t* out) {
  const int64_t N = D * H * W;
  const int64_t strides[3] = {H * W, W, 1};
  exa::UnionFind uf(static_cast<size_t>(N));
  std::vector<uint8_t> foreground(N, 0);
  // Plan bytes may arrive from spool files or digest stores, so a
  // truncated/corrupt byte must fail (-1), not unite out-of-range
  // voxels (heap corruption). Coordinates are tracked in the loop so
  // the edge-validity tests are compares, not div/mod.
  int64_t v = 0;
  for (int64_t z = 0; z < D; ++z) {
    for (int64_t y = 0; y < H; ++y) {
      for (int64_t x = 0; x < W; ++x, ++v) {
        const uint8_t pb = plan[v];
        const bool fwd_ok[3] = {z + 1 < D, y + 1 < H, x + 1 < W};
        for (int c = 0; c < 3; ++c) {
          if (pb & (1 << c)) {
            if (!fwd_ok[c]) return -1;
            uf.unite(static_cast<uint32_t>(v),
                     static_cast<uint32_t>(v + strides[c]));
          }
        }
        const int dir = pb >> 3;
        if (dir != 0) {
          if (dir > 6) return -1;
          const int c = (dir - 1) % 3;
          const bool ok = dir <= 3
              ? fwd_ok[c]
              : (c == 0 ? z > 0 : c == 1 ? y > 0 : x > 0);
          if (!ok) return -1;
          const int64_t u = dir <= 3 ? v + strides[c] : v - strides[c];
          foreground[v] = 1;
          uf.unite(static_cast<uint32_t>(v), static_cast<uint32_t>(u));
        }
      }
    }
  }

  // Renumber fragment roots (foreground only) to 1..K in scan order.
  std::unordered_map<uint32_t, uint32_t> root_to_id;
  root_to_id.reserve(1024);
  uint32_t next = 1;
  for (int64_t v = 0; v < N; ++v) {
    if (!foreground[v]) {
      out[v] = 0;
      continue;
    }
    uint32_t r = uf.find(static_cast<uint32_t>(v));
    auto it = root_to_id.find(r);
    if (it == root_to_id.end()) it = root_to_id.emplace(r, next++).first;
    out[v] = it->second;
  }
  return static_cast<int64_t>(next - 1);
}

// RAG build + hierarchical agglomeration over precomputed fragments.
// SampleFn(c, v) -> uint8 quantized affinity bin of the outgoing edge
// along axis c stored at voxel v; the merge machinery operates purely
// on 256-level bins, so float and u8-pre-digested sources share this
// path bit-for-bit.
// last_only: snapshot only the final threshold into out[0..N) (the
// reference keeps only the last labeling, inference.py:229-233); out
// then needs N entries instead of n_thresholds * N -- the beyond-RAM
// path's contract.
template <typename SampleFn>
int64_t agglomerate_over_fragments(
    const uint32_t* frag, int64_t K, int64_t D, int64_t H, int64_t W,
    const float* thresholds, int64_t n_thresholds, int32_t quantile_pct,
    uint32_t* out, SampleFn&& sample, bool last_only = false) {
  const int64_t N = D * H * W;
  const bool dbg = std::getenv("EXA_DEBUG_TIMING") != nullptr;
  auto now = []() { return std::chrono::steady_clock::now(); };
  auto secs = [](auto a, auto b) {
    return std::chrono::duration<double>(b - a).count();
  };
  const int64_t strides[3] = {H * W, W, 1};

  auto t1 = now();
  // Build the RAG over fragments: each Z-slab builds a local edge map
  // in scan order (parallel), then slabs merge in ascending-Z order.
  // A voxel owns only its OUTGOING edges, so every RAG contribution is
  // counted by exactly one slab (reads of frag[] across the slab
  // boundary are fine -- frag is read-only here), and first-appearance
  // edge numbering under block-major merge equals the global scan
  // order: edge indices, sample order, and therefore quantile
  // tie-breaks are bit-identical to the serial build for ANY thread or
  // block count.
  const int64_t zz_per_block = std::max<int64_t>(1, D / 64);
  const int64_t n_blocks = (D + zz_per_block - 1) / zz_per_block;
  FlatMap edge_index(1024);
  EdgeStore edges;
  const bool serial = std::min<int64_t>(num_threads(), n_blocks) <= 1;
  // Scans one block's voxels, accumulating its outgoing-edge samples
  // into (index, store) -- per-block locals in the threaded path, the
  // global pair directly in the serial path.
  auto scan_block = [&](int64_t blk, FlatMap& index, EdgeStore& store) {
    const int64_t z_lo = blk * zz_per_block;
    const int64_t z_hi = std::min(D, z_lo + zz_per_block);
    for (int64_t z = z_lo; z < z_hi; ++z) {
      for (int64_t y = 0; y < H; ++y) {
        for (int64_t x = 0; x < W; ++x) {
          const int64_t v = vox(z, y, x, H, W);
          const uint32_t fa = frag[v];
          if (fa == 0) continue;
          const int64_t coord[3] = {z, y, x};
          const int64_t dims[3] = {D, H, W};
          for (int c = 0; c < 3; ++c) {
            if (coord[c] + 1 >= dims[c]) continue;
            const uint32_t fb = frag[v + strides[c]];
            if (fb == 0 || fb == fa) continue;
            EdgeKey key{std::min(fa, fb), std::max(fa, fb)};
            auto [slot, fresh] = index.find_or_insert(
                key.packed(), static_cast<uint32_t>(store.size()));
            if (fresh) store.emplace_back(key.a, key.b);
            store[*slot].add_bin(sample(c, v));
          }
        }
      }
    }
  };

  if (serial) {
    // Single worker: the per-block local-map + merge structure below
    // is pure overhead (a second full insert+absorb pass over every
    // edge and a transient second copy of the RAG). Build the global
    // map directly in scan order -- identical first-appearance edge
    // numbering and sample order by construction.
    for (int64_t blk = 0; blk < n_blocks; ++blk) {
      scan_block(blk, edge_index, edges);
    }
    auto t2s = now();
    if (dbg) {
      std::fprintf(stderr, "[exa] rag-local %.2fs (serial direct) E=%zu\n",
                   secs(t1, t2s), edges.size());
    }
  } else {
    std::vector<FlatMap> loc_index;
    loc_index.reserve(n_blocks);
    for (int64_t b = 0; b < n_blocks; ++b) loc_index.emplace_back(1024);
    std::vector<EdgeStore> loc_edges(n_blocks);
    parallel_blocks(n_blocks, [&](int64_t blk) {
      scan_block(blk, loc_index[blk], loc_edges[blk]);
    });

    auto t2 = now();
    if (dbg) std::fprintf(stderr, "[exa] rag-local %.2fs\n", secs(t1, t2));
    // Merge per-block maps in ascending-Z order (preserves global
    // scan-order edge numbering). Pre-size to the upper bound (sum of
    // per-block uniques): FlatMap regrowth re-hashes every entry and
    // vector regrowth copies every Edge -- at tens of millions of
    // edges both dominated this phase.
    size_t edge_upper = 0;
    for (const auto& le : loc_edges) edge_upper += le.size();
    edge_index = FlatMap(edge_upper + 1);
    for (int64_t blk = 0; blk < n_blocks; ++blk) {
      EdgeStore& les = loc_edges[blk];
      for (size_t li = 0; li < les.size(); ++li) {
        Edge& le = les[li];
        EdgeKey key{le.a, le.b};
        auto [slot, fresh] = edge_index.find_or_insert(
            key.packed(), static_cast<uint32_t>(edges.size()));
        if (fresh) edges.emplace_back(key.a, key.b);
        edges[*slot].absorb(le);
      }
      les.release();
    }
    loc_index.clear();

    auto t3m = now();
    if (dbg) {
      std::fprintf(stderr, "[exa] rag-merge %.2fs E=%zu\n", secs(t2, t3m),
                   edges.size());
    }
  }

  if (n_thresholds == 0) return K;
  double secs_adjacency = 0, secs_merge = 0;
  exa_rag::MergeEvents me = exa_rag::run_merge(
      edge_index, edges, K, thresholds, n_thresholds, quantile_pct,
      &secs_adjacency, &secs_merge);
  if (dbg) {
    std::fprintf(stderr, "[exa] adjacency+components %.2fs C=%u\n",
                 secs_adjacency, me.n_comps);
    std::fprintf(stderr, "[exa] merge-loop %.2fs\n", secs_merge);
    std::fprintf(
        stderr,
        "[exa] flatmap rebuilds=%llu reinserted=%llu cap-allocated=%llu "
        "hist-promotions=%llu\n",
        static_cast<unsigned long long>(
            exa_rag::g_flat_rebuilds.load(std::memory_order_relaxed)),
        static_cast<unsigned long long>(
            exa_rag::g_flat_reinserted.load(std::memory_order_relaxed)),
        static_cast<unsigned long long>(
            exa_rag::g_flat_cap_allocated.load(std::memory_order_relaxed)),
        static_cast<unsigned long long>(
            exa_rag::g_hist_promotions.load(std::memory_order_relaxed)));
  }

  auto t5 = now();
  // Replay snapshots: advance one parent forest threshold by threshold
  // (exa_rag::apply_threshold).
  std::vector<uint32_t> rparent(static_cast<size_t>(K) + 1);
  for (int64_t f = 0; f <= K; ++f) rparent[f] = static_cast<uint32_t>(f);
  std::vector<uint32_t> applied(me.n_comps, 0);
  auto rfind = [&](uint32_t x) {
    while (rparent[x] != x) {
      rparent[x] = rparent[rparent[x]];
      x = rparent[x];
    }
    return x;
  };
  std::vector<uint32_t> lut(static_cast<size_t>(K) + 1);
  for (int64_t k = 0; k < n_thresholds; ++k) {
    exa_rag::apply_threshold(me, k, rparent, applied);
    if (last_only && k != n_thresholds - 1) continue;
    // Flatten roots once (K entries, path-compressing), then the O(N)
    // relabel is a pure gather -- parallel over Z-slabs.
    lut[0] = 0;
    for (int64_t f = 1; f <= K; ++f) {
      lut[f] = rfind(static_cast<uint32_t>(f));
    }
    uint32_t* dst = out + (last_only ? 0 : k * N);
    const int64_t chunk = std::max<int64_t>(1, N / 64);
    const int64_t blocks = (N + chunk - 1) / chunk;
    parallel_blocks(blocks, [&](int64_t b) {
      const int64_t lo = b * chunk;
      const int64_t hi = std::min(N, lo + chunk);
      for (int64_t v = lo; v < hi; ++v) dst[v] = lut[frag[v]];
    });
  }
  if (dbg) std::fprintf(stderr, "[exa] snapshots %.2fs\n", secs(t5, now()));
  return K;
}

}  // namespace

// Watershed fragments only (exposed for testing / reuse).
// out: uint32 (D*H*W), 0 = background, fragments renumbered 1..K.
// Returns K.
EXA_API int64_t exa_watershed(const float* affs, int64_t D, int64_t H,
                              int64_t W, float low, float high,
                              uint32_t* out) {
  const int64_t N = D * H * W;
  const int64_t strides[3] = {H * W, W, 1};
  const float* aff_c[3] = {affs, affs + N, affs + 2 * N};

  // Pass 1a (parallel over Z-slabs): the affinity scan -- ~7 float
  // reads + compares per voxel, the bandwidth-bound part -- records
  // each voxel's decisions in one byte: bits 0-2 flag outgoing
  // >= high edges along z/y/x; bits 3-5 encode the steepest >= low
  // neighbor as a direction (0 = background, 1..6 = +z,+y,+x,-z,-y,-x).
  // Per-voxel writes are disjoint, so any thread count gives identical
  // bytes. Pass 1b (serial, watershed_replay) replays the recorded
  // unions -- cheap integer work with no affinity reads. The TPU
  // pre-digest path (ops/predigest.py) computes the identical bytes on
  // device and enters at exa_watershed_plan, skipping 1a entirely.
  std::vector<uint8_t> plan_bytes(N, 0);
  parallel_blocks(D, [&](int64_t z) {
    for (int64_t y = 0; y < H; ++y) {
      for (int64_t x = 0; x < W; ++x) {
        const int64_t v = vox(z, y, x, H, W);
        float best = -1.0f;
        int dir = 0;
        const int64_t coord[3] = {z, y, x};
        const int64_t dims[3] = {D, H, W};
        uint8_t flags = 0;
        // outgoing edges (v, v+e_c) stored at v; incoming stored at v-e_c
        for (int c = 0; c < 3; ++c) {
          if (coord[c] + 1 < dims[c]) {
            float a = aff_c[c][v];
            if (a >= high) flags |= static_cast<uint8_t>(1 << c);
            if (a >= low && a > best) {
              best = a;
              dir = 1 + c;
            }
          }
          if (coord[c] - 1 >= 0) {
            float a = aff_c[c][v - strides[c]];
            if (a >= low && a > best) {
              best = a;
              dir = 4 + c;
            }
          }
        }
        plan_bytes[v] = flags | static_cast<uint8_t>(dir << 3);
      }
    }
  });

  return watershed_replay(plan_bytes.data(), D, H, W, out);
}

// Watershed from device-predigested plan bytes (ops/predigest.py):
// pure integer replay, zero float reads. Same output contract as
// exa_watershed.
EXA_API int64_t exa_watershed_plan(const uint8_t* plan, int64_t D,
                                   int64_t H, int64_t W, uint32_t* out) {
  return watershed_replay(plan, D, H, W, out);
}

// Full pipeline: watershed + agglomeration snapshots.
// out: uint32 (n_thresholds * D*H*W), one labeling per threshold
// (thresholds must be ascending). Returns the fragment count K (>=0) or
// -1 on error.
EXA_API int64_t exa_agglomerate(const float* affs, int64_t D, int64_t H,
                                int64_t W, const float* thresholds,
                                int64_t n_thresholds, float low, float high,
                                int32_t quantile_pct, uint32_t* out) {
  const int64_t N = D * H * W;
  const bool dbg = std::getenv("EXA_DEBUG_TIMING") != nullptr;
  auto now = []() { return std::chrono::steady_clock::now(); };
  auto secs = [](auto a, auto b) {
    return std::chrono::duration<double>(b - a).count();
  };
  auto t0 = now();
  std::vector<uint32_t> frag(N);
  const int64_t K = exa_watershed(affs, D, H, W, low, high, frag.data());
  if (K < 0) return -1;
  auto t1 = now();
  if (dbg) std::fprintf(stderr, "[exa] watershed %.2fs K=%lld\n", secs(t0, t1), (long long)K);

  const float* aff_c[3] = {affs, affs + N, affs + 2 * N};
  return agglomerate_over_fragments(
      frag.data(), K, D, H, W, thresholds, n_thresholds, quantile_pct,
      out, [&](int c, int64_t v) { return Edge::quantize(aff_c[c][v]); });
}

// Full pipeline from device pre-digests (ops/predigest.py): plan bytes
// drive the watershed replay (zero float reads) and u8-quantized
// affinities feed the RAG histograms directly (1 byte per sample
// instead of 4). Bit-identical to exa_agglomerate on the same float
// volume: the plan bytes replicate pass 1a's f32 compares on device
// and qaff replicates Edge::quantize.
EXA_API int64_t exa_agglomerate_pre(const uint8_t* plan,
                                    const uint8_t* qaff, int64_t D,
                                    int64_t H, int64_t W,
                                    const float* thresholds,
                                    int64_t n_thresholds,
                                    int32_t quantile_pct, uint32_t* out) {
  const int64_t N = D * H * W;
  const bool dbg = std::getenv("EXA_DEBUG_TIMING") != nullptr;
  auto now = []() { return std::chrono::steady_clock::now(); };
  auto secs = [](auto a, auto b) {
    return std::chrono::duration<double>(b - a).count();
  };
  auto t0 = now();
  std::vector<uint32_t> frag(N);
  const int64_t K = watershed_replay(plan, D, H, W, frag.data());
  if (K < 0) return -1;
  auto t1 = now();
  if (dbg) std::fprintf(stderr, "[exa] watershed-replay %.2fs K=%lld\n", secs(t0, t1), (long long)K);

  const uint8_t* q_c[3] = {qaff, qaff + N, qaff + 2 * N};
  return agglomerate_over_fragments(
      frag.data(), K, D, H, W, thresholds, n_thresholds, quantile_pct,
      out, [&](int c, int64_t v) { return q_c[c][v]; });
}

// Beyond-RAM variant: identical to exa_agglomerate_pre but only the
// FINAL threshold's labeling is materialized (out needs N entries, not
// n_thresholds * N) -- at 1024^3 with three thresholds this saves
// 8.6 GB of output buffers.
EXA_API int64_t exa_agglomerate_pre_last(const uint8_t* plan,
                                         const uint8_t* qaff, int64_t D,
                                         int64_t H, int64_t W,
                                         const float* thresholds,
                                         int64_t n_thresholds,
                                         int32_t quantile_pct,
                                         uint32_t* out) {
  const int64_t N = D * H * W;
  std::vector<uint32_t> frag(N);
  const int64_t K = watershed_replay(plan, D, H, W, frag.data());
  if (K < 0) return -1;
  const uint8_t* q_c[3] = {qaff, qaff + N, qaff + 2 * N};
  return agglomerate_over_fragments(
      frag.data(), K, D, H, W, thresholds, n_thresholds, quantile_pct,
      out, [&](int c, int64_t v) { return q_c[c][v]; },
      /*last_only=*/true);
}
