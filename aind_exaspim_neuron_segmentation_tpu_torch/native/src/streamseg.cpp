// Slab-streaming affinity watershed + agglomeration.
//
// The dense engine (agglomerate.cpp) holds the whole fragment volume,
// a voxel-granular union-find, and the output labels in RAM
// simultaneously -- ~12-16 bytes/voxel of transient state on top of
// the 4 bytes/voxel of device pre-digests. This engine implements the
// identical pipeline (reference inference.py:196-237 semantics via the
// shared merge loop in rag.hpp) as three streaming passes over Z
// slabs, so peak host RAM is O(RAG + slab), not O(volume):
//
//  pass 1 (feed):     per-slab watershed on the device-built plan
//                     bytes (ops/predigest.py) with a slab-local
//                     union-find; connected pieces are stitched across
//                     slab boundaries through a piece-granular
//                     union-find (one entry per piece, not per voxel).
//                     Emits provisional piece labels per slab; the
//                     caller parks them in a temp store.
//  pass 2 (rag_feed): re-streams provisional labels + u8 affinities,
//                     maps pieces to final watershed fragment ids, and
//                     builds the RAG in global scan order. Then the
//                     shared component-parallel merge loop runs and the
//                     requested thresholds + min-size filter compose
//                     into ONE piece->final-label lut.
//  pass 3 (map):      relabels provisional slabs through the lut.
//
// Bit parity with the dense engine (pinned by tests/test_streamseg.py):
//  * the watershed PARTITION is the connected components of the union
//    graph, independent of union order;
//  * fragment NUMBERING follows first foreground appearance in global
//    scan order: pieces record the scan index of their first
//    foreground voxel and final fragments sort by the min over their
//    pieces -- exactly the dense replay's first-appearance renumber;
//  * RAG edge numbering and per-edge sample order equal the dense scan
//    because pass 2 visits voxels in the same global scan order with
//    the same (z, y, x) edge enumeration;
//  * the merge loop is the same code (exa_rag::run_merge);
//  * the min-size filter composes the remove_small_segments rule
//    (keep strictly greater, renumber by first appearance) into the
//    final lut: iterating fragments in ascending id IS first-appearance
//    order of the merged segments.
//
// Requires aff_threshold_low <= aff_threshold_high (the pipeline
// default 0.1 <= 0.9999): then every union endpoint is a foreground
// voxel (an incident affinity >= high >= low makes both endpoints
// foreground), background components are singletons, and cross-slab
// connectivity through background is impossible. The Python driver
// validates this. On-demand piece creation below still tolerates
// targeted background voxels for robustness.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "common.hpp"
#include "rag.hpp"

namespace {

using exa_rag::Edge;
using exa_rag::EdgeKey;
using exa_rag::EdgeStore;
using exa_rag::FlatMap;

constexpr uint64_t kNoFg = ~0ull;

struct StreamSeg {
  int64_t D, H, W;

  // ---- distributed mode (multi-rank Z partition; see the
  // exa_streamseg_set_distributed block at the bottom) ----
  bool distributed = false;
  int64_t z_offset = 0;             // global Z index of local plane 0
  std::vector<uint32_t> first_ids;  // plane-0 piece ids (first feed)
  std::vector<uint8_t> first_plan;  // plane-0 plan bytes
  bool local_done_flag = false;
  bool rag_flushed = false;
  int64_t n_roots = 0;
  std::vector<uint32_t> root_of_piece;  // piece -> root enum index + 1
  std::vector<uint64_t> root_first_fg;  // per root (enum order)
  std::vector<uint64_t> root_fg;

  // ---- pass 1 state ----
  int64_t z_done = 0;
  std::vector<uint32_t> prev_ids;   // piece id per last-plane voxel (0=none)
  std::vector<uint8_t> prev_plan;   // plan bytes of the last plane
  // Piece-granular union-find (1-based; grows as slabs arrive).
  std::vector<uint32_t> piece_parent;
  std::vector<uint32_t> piece_size;
  std::vector<uint64_t> piece_first_fg;  // global scan index, kNoFg=none
  std::vector<uint64_t> piece_fg_count;

  // ---- after fragments_done ----
  bool frags_done = false;
  int64_t K = 0;
  std::vector<uint32_t> ws_of_piece;  // piece -> watershed fragment id
  std::vector<uint64_t> frag_fg;      // fragment voxel counts (1..K)

  // ---- pass 2 state ----
  int64_t z_rag = 0;
  bool have_pending = false;
  std::vector<uint32_t> pending_frag;  // previous plane, watershed ids
  std::vector<uint8_t> pending_q;      // previous plane qaff (3, H, W)
  FlatMap edge_index{1024};
  EdgeStore edges;

  // ---- after merge ----
  int64_t n_segments = -1;
  std::vector<uint32_t> final_lut;  // piece -> final segment label

  StreamSeg(int64_t d, int64_t h, int64_t w) : D(d), H(h), W(w) {
    piece_parent.push_back(0);  // index 0 unused (background)
    piece_size.push_back(0);
    piece_first_fg.push_back(kNoFg);
    piece_fg_count.push_back(0);
  }

  uint32_t piece_find(uint32_t x) {
    while (piece_parent[x] != x) {
      piece_parent[x] = piece_parent[piece_parent[x]];
      x = piece_parent[x];
    }
    return x;
  }

  void piece_unite(uint32_t a, uint32_t b) {
    a = piece_find(a);
    b = piece_find(b);
    if (a == b) return;
    if (piece_size[a] < piece_size[b] ||
        (piece_size[a] == piece_size[b] && a > b)) {
      std::swap(a, b);
    }
    piece_parent[b] = a;
    piece_size[a] += piece_size[b];
  }

  uint32_t new_piece() {
    const uint32_t p = static_cast<uint32_t>(piece_parent.size());
    piece_parent.push_back(p);
    piece_size.push_back(1);
    piece_first_fg.push_back(kNoFg);
    piece_fg_count.push_back(0);
    return p;
  }
};

// One plane of RAG contributions, in the dense engine's scan order:
// per voxel the (z, y, x) outgoing edges, z first (fnext == nullptr for
// the volume's final plane, which has no outgoing z edges). q3 is the
// plane's quantized affinities laid out (3, H, W).
void rag_plane(StreamSeg& s, const uint32_t* fp, const uint8_t* q3,
               const uint32_t* fnext) {
  const int64_t H = s.H, W = s.W, HW = s.H * s.W;
  for (int64_t y = 0; y < H; ++y) {
    for (int64_t x = 0; x < W; ++x) {
      const int64_t i = y * W + x;
      const uint32_t fa = fp[i];
      if (fa == 0) continue;
      // c = 0 (z), 1 (y), 2 (x) -- same enumeration as the dense scan.
      for (int c = 0; c < 3; ++c) {
        uint32_t fb;
        if (c == 0) {
          if (fnext == nullptr) continue;
          fb = fnext[i];
        } else if (c == 1) {
          if (y + 1 >= H) continue;
          fb = fp[i + W];
        } else {
          if (x + 1 >= W) continue;
          fb = fp[i + 1];
        }
        if (fb == 0 || fb == fa) continue;
        EdgeKey key{std::min(fa, fb), std::max(fa, fb)};
        auto [slot, fresh] = s.edge_index.find_or_insert(
            key.packed(), static_cast<uint32_t>(s.edges.size()));
        if (fresh) s.edges.emplace_back(key.a, key.b);
        s.edges[*slot].add_bin(q3[c * HW + i]);
      }
    }
  }
}

// Min-size filter + first-appearance renumber over a finished replay
// forest (`rparent`: fragment -> surviving root pointers). Shared by
// finalize_lut_ws (single-process / rank-0 merge) and the distributed
// compose entry (exa_streamseg_compose_lut) so all paths are
// bit-identical by construction.
int64_t lut_from_rparent(std::vector<uint32_t>& rparent, int64_t K,
                         const uint64_t* frag_fg, int64_t min_size,
                         std::vector<uint32_t>& lut_ws) {
  auto rfind = [&](uint32_t x) {
    while (rparent[x] != x) {
      rparent[x] = rparent[rparent[x]];
      x = rparent[x];
    }
    return x;
  };

  // Segment sizes = summed fragment foreground counts.
  std::vector<uint64_t> sizes(static_cast<size_t>(K) + 1, 0);
  for (int64_t ws = 1; ws <= K; ++ws) {
    sizes[rfind(static_cast<uint32_t>(ws))] += frag_fg[ws];
  }
  std::vector<uint32_t> seg_of_root(static_cast<size_t>(K) + 1, 0);
  lut_ws.assign(static_cast<size_t>(K) + 1, 0);
  uint32_t next = 1;
  for (int64_t ws = 1; ws <= K; ++ws) {
    const uint32_t r = rfind(static_cast<uint32_t>(ws));
    if (sizes[r] <= static_cast<uint64_t>(min_size)) continue;
    if (seg_of_root[r] == 0) seg_of_root[r] = next++;
    lut_ws[ws] = seg_of_root[r];
  }
  return static_cast<int64_t>(next - 1);
}

// Shared tail of the merge: advance the replay forest through every
// threshold (the reference keeps only the last labeling,
// inference.py:229-233), then the min-size filter + first-appearance
// renumber (lut_from_rparent). Returns the segment count and fills
// lut_ws (K + 1 entries, fragment -> final label).
int64_t finalize_lut_ws(exa_rag::MergeEvents& me, int64_t K,
                        int64_t n_thresholds, const uint64_t* frag_fg,
                        int64_t min_size, std::vector<uint32_t>& lut_ws) {
  std::vector<uint32_t> rparent(static_cast<size_t>(K) + 1);
  for (int64_t f = 0; f <= K; ++f) rparent[f] = static_cast<uint32_t>(f);
  std::vector<uint32_t> applied(me.n_comps, 0);
  for (int64_t k = 0; k < n_thresholds; ++k) {
    exa_rag::apply_threshold(me, k, rparent, applied);
  }
  me.comp_events.clear();
  return lut_from_rparent(rparent, K, frag_fg, min_size, lut_ws);
}

}  // namespace

EXA_API void* exa_streamseg_new(int64_t D, int64_t H, int64_t W) {
  if (D <= 0 || H <= 0 || W <= 0) return nullptr;
  return new StreamSeg(D, H, W);
}

EXA_API void exa_streamseg_free(void* handle) {
  delete static_cast<StreamSeg*>(handle);
}

// Pass 1: watershed one Z slab of plan bytes (uint8, nz*H*W). Writes
// provisional piece labels (0 = background) into frag_out. Slabs must
// arrive in ascending Z order and cover the volume exactly.
EXA_API int64_t exa_streamseg_feed(void* handle, const uint8_t* plan,
                                   int64_t nz, uint32_t* frag_out) {
  StreamSeg& s = *static_cast<StreamSeg*>(handle);
  if (nz <= 0 || s.z_done + nz > s.D || s.frags_done) return -1;
  const int64_t H = s.H, W = s.W, HW = s.H * s.W;
  const int64_t n = nz * HW;

  // Slab-local voxel union-find; unions replay the plan bytes exactly
  // as the dense watershed_replay does, except that unions crossing
  // the slab's Z faces go through the piece union-find: +z edges out
  // of the previous slab's last plane were deferred to now, and -z
  // edges out of this slab's first plane are collected and resolved
  // against prev_ids after local components are known.
  exa::UnionFind local(static_cast<size_t>(n));
  std::vector<int64_t> cross_prev;  // plane-0 voxels with dir == -z
  for (int64_t z = 0; z < nz; ++z) {
    for (int64_t y = 0; y < H; ++y) {
      for (int64_t x = 0; x < W; ++x) {
        const int64_t v = (z * H + y) * W + x;
        const uint8_t pb = plan[v];
        if (pb == 0) continue;
        // Plan bytes arrive from spool files / digest stores: a
        // corrupt y/x edge flag at a volume face must fail (-1), not
        // unite out-of-range indices (e.g. -W at z=0,y=0 wraps to a
        // huge uint32 -> union-find heap corruption). Valid digests
        // never set face-crossing flags (ops/predigest.py masks
        // them). Z-face flags are NOT policed here: slab-end +z is
        // legitimately deferred (prev_plan), and in distributed mode
        // the rank's last local plane carries real +z flags for the
        // cross-rank stitch.
        if ((pb & 1) && z + 1 < nz) {
          local.unite(static_cast<uint32_t>(v),
                      static_cast<uint32_t>(v + HW));
        }
        // +z flag on the slab's last plane: deferred to the next
        // feed (prev_plan replays it); on the volume's last plane the
        // digest guarantees no such flag.
        if (pb & 2) {
          if (y + 1 >= H) return -1;
          local.unite(static_cast<uint32_t>(v),
                      static_cast<uint32_t>(v + W));
        }
        if (pb & 4) {
          if (x + 1 >= W) return -1;
          local.unite(static_cast<uint32_t>(v),
                      static_cast<uint32_t>(v + 1));
        }
        const int dir = pb >> 3;
        switch (dir) {
          case 1:
            if (z + 1 < nz) {
              local.unite(static_cast<uint32_t>(v),
                          static_cast<uint32_t>(v + HW));
            }
            break;  // last plane: deferred (prev_plan)
          case 2:
            if (y + 1 >= H) return -1;
            local.unite(static_cast<uint32_t>(v),
                        static_cast<uint32_t>(v + W));
            break;
          case 3:
            if (x + 1 >= W) return -1;
            local.unite(static_cast<uint32_t>(v),
                        static_cast<uint32_t>(v + 1));
            break;
          case 4:
            if (z > 0) {
              local.unite(static_cast<uint32_t>(v),
                          static_cast<uint32_t>(v - HW));
            } else {
              cross_prev.push_back(v);  // into the previous slab
            }
            break;
          case 5:
            if (y == 0) return -1;
            local.unite(static_cast<uint32_t>(v),
                        static_cast<uint32_t>(v - W));
            break;
          case 6:
            if (x == 0) return -1;
            local.unite(static_cast<uint32_t>(v),
                        static_cast<uint32_t>(v - 1));
            break;
          default:
            if (dir > 6) return -1;
            break;
        }
      }
    }
  }

  // Assign pieces to foreground components in scan order (recording
  // each piece's first foreground scan index for the global
  // first-appearance numbering) and write provisional labels.
  std::vector<uint32_t> prov_of_root(n, 0);
  for (int64_t z = 0; z < nz; ++z) {
    for (int64_t y = 0; y < H; ++y) {
      for (int64_t x = 0; x < W; ++x) {
        const int64_t v = (z * H + y) * W + x;
        if ((plan[v] >> 3) == 0) {
          frag_out[v] = 0;
          continue;
        }
        const uint32_t r = local.find(static_cast<uint32_t>(v));
        uint32_t p = prov_of_root[r];
        if (p == 0) {
          p = s.new_piece();
          prov_of_root[r] = p;
        }
        if (s.piece_first_fg[p] == kNoFg) {
          // Global scan index: z_offset is 0 single-process; in
          // distributed mode it makes first-appearance numbering agree
          // across ranks (disjoint Z ranges => indices never collide).
          s.piece_first_fg[p] = static_cast<uint64_t>(
              (s.z_offset + s.z_done + z) * HW + y * W + x);
        }
        ++s.piece_fg_count[p];
        frag_out[v] = p;
      }
    }
  }

  // Distributed mode: park plane 0 (piece ids + plan bytes) for the
  // cross-RANK stitch on rank 0 -- the mirror image of prev_ids /
  // prev_plan below. frag_out's first plane already holds the piece
  // assignment, and under the driver-enforced low <= high precondition
  // it equals prov_of_root[local.find(v)] exactly: union flags imply a
  // >= high >= low incident edge, so every union endpoint has dir != 0
  // and background voxels are singletons with no piece (header note).
  if (s.distributed && s.z_done == 0) {
    s.first_ids.assign(frag_out, frag_out + HW);
    s.first_plan.assign(plan, plan + HW);
  }

  // Cross-slab stitching. Forward (+z) unions recorded on the previous
  // slab's last plane target this slab's plane 0; -z unions from this
  // slab's plane 0 target the previous slab's last plane. Both reduce
  // to piece-level unions. A target with no piece is a background
  // singleton (see header note) -- the union is a no-op and is skipped
  // unless the target can still matter (it is in THIS slab, where a
  // piece can be created on demand).
  if (s.z_done > 0) {
    for (int64_t i = 0; i < HW; ++i) {
      const uint8_t pb = s.prev_plan[i];
      if ((pb & 1) || (pb >> 3) == 1) {
        const uint32_t r = local.find(static_cast<uint32_t>(i));
        uint32_t p = prov_of_root[r];
        if (p == 0) {
          p = s.new_piece();
          prov_of_root[r] = p;
        }
        s.piece_unite(s.prev_ids[i], p);
      }
    }
    for (const int64_t v : cross_prev) {
      const uint32_t target = s.prev_ids[v];  // v < HW: plane-0 index
      if (target == 0) continue;              // background singleton
      s.piece_unite(prov_of_root[local.find(static_cast<uint32_t>(v))],
                    target);
    }
  }

  // Park the last plane for the next slab's stitching.
  s.prev_ids.resize(HW);
  s.prev_plan.resize(HW);
  const int64_t last = (nz - 1) * HW;
  for (int64_t i = 0; i < HW; ++i) {
    s.prev_ids[i] = prov_of_root[local.find(static_cast<uint32_t>(last + i))];
    s.prev_plan[i] = plan[last + i];
  }
  s.z_done += nz;
  return 0;
}

// Finish pass 1: stitch pieces into final watershed fragments and
// number them 1..K by first foreground appearance in global scan order
// (bit-identical to the dense replay's renumber). Returns K.
EXA_API int64_t exa_streamseg_fragments_done(void* handle) {
  StreamSeg& s = *static_cast<StreamSeg*>(handle);
  if (s.z_done != s.D || s.frags_done || s.distributed) return -1;
  s.frags_done = true;
  const uint32_t P = static_cast<uint32_t>(s.piece_parent.size() - 1);

  std::vector<uint64_t> min_fg(P + 1, kNoFg);
  std::vector<uint64_t> cnt(P + 1, 0);
  for (uint32_t p = 1; p <= P; ++p) {
    const uint32_t r = s.piece_find(p);
    min_fg[r] = std::min(min_fg[r], s.piece_first_fg[p]);
    cnt[r] += s.piece_fg_count[p];
  }
  std::vector<std::pair<uint64_t, uint32_t>> roots;
  for (uint32_t p = 1; p <= P; ++p) {
    if (s.piece_parent[p] == p && min_fg[p] != kNoFg) {
      roots.emplace_back(min_fg[p], p);
    }
  }
  std::sort(roots.begin(), roots.end());  // first-fg indices are unique
  s.K = static_cast<int64_t>(roots.size());

  std::vector<uint32_t> ws_of_root(P + 1, 0);
  s.frag_fg.assign(static_cast<size_t>(s.K) + 1, 0);
  for (size_t k = 0; k < roots.size(); ++k) {
    ws_of_root[roots[k].second] = static_cast<uint32_t>(k + 1);
    s.frag_fg[k + 1] = cnt[roots[k].second];
  }
  s.ws_of_piece.assign(P + 1, 0);
  for (uint32_t p = 1; p <= P; ++p) {
    s.ws_of_piece[p] = ws_of_root[s.piece_find(p)];
  }

  // Pass-1 state is no longer needed (map() uses ws_of_piece).
  s.piece_parent.clear();
  s.piece_parent.shrink_to_fit();
  s.piece_size.clear();
  s.piece_size.shrink_to_fit();
  s.piece_first_fg.clear();
  s.piece_first_fg.shrink_to_fit();
  s.piece_fg_count.clear();
  s.piece_fg_count.shrink_to_fit();
  s.prev_ids.clear();
  s.prev_ids.shrink_to_fit();
  s.prev_plan.clear();
  s.prev_plan.shrink_to_fit();
  return s.K;
}

// Pass 2: stream provisional labels + u8 affinities back through in
// ascending Z order. qaff layout is plane-major (nz, 3, H, W) so slab
// slices of a (D, 3, H, W) temp store are contiguous.
EXA_API int64_t exa_streamseg_rag_feed(void* handle, const uint32_t* frag,
                                       const uint8_t* qaff, int64_t nz) {
  StreamSeg& s = *static_cast<StreamSeg*>(handle);
  if (!s.frags_done || nz <= 0 || s.z_rag + nz > s.D ||
      s.n_segments >= 0) {
    return -1;
  }
  const int64_t HW = s.H * s.W;
  std::vector<uint32_t> cur(HW);
  for (int64_t j = 0; j < nz; ++j) {
    // After the swap below, `cur` holds the previous pending buffer
    // (initially empty) -- restore its extent before overwriting.
    cur.resize(HW);
    const uint32_t* fp = frag + j * HW;
    for (int64_t i = 0; i < HW; ++i) cur[i] = s.ws_of_piece[fp[i]];
    if (s.have_pending) {
      rag_plane(s, s.pending_frag.data(), s.pending_q.data(), cur.data());
    }
    s.pending_frag.swap(cur);
    s.pending_q.assign(qaff + j * 3 * HW, qaff + (j + 1) * 3 * HW);
    s.have_pending = true;
  }
  s.z_rag += nz;
  return 0;
}

// Run the shared merge loop over the streamed RAG, then compose
// thresholds + the min-size filter (keep strictly greater; renumber by
// first appearance -- remove_small_segments parity) into the final
// piece -> label lut. Returns the number of segments.
EXA_API int64_t exa_streamseg_merge(void* handle, const float* thresholds,
                                    int64_t n_thresholds,
                                    int32_t quantile_pct, int64_t min_size) {
  StreamSeg& s = *static_cast<StreamSeg*>(handle);
  if (!s.frags_done || s.z_rag != s.D || n_thresholds <= 0 ||
      s.n_segments >= 0 || s.distributed) {
    return -1;
  }
  for (int64_t i = 1; i < n_thresholds; ++i) {
    if (thresholds[i] < thresholds[i - 1]) return -1;
  }
  if (s.have_pending) {  // the volume's final plane: no outgoing z edges
    rag_plane(s, s.pending_frag.data(), s.pending_q.data(), nullptr);
    s.have_pending = false;
    s.pending_frag.clear();
    s.pending_frag.shrink_to_fit();
    s.pending_q.clear();
    s.pending_q.shrink_to_fit();
  }

  exa_rag::MergeEvents me = exa_rag::run_merge(
      s.edge_index, s.edges, s.K, thresholds, n_thresholds, quantile_pct);
  s.edge_index.reset(16);
  s.edges.release();

  std::vector<uint32_t> lut_ws;
  s.n_segments = finalize_lut_ws(me, s.K, n_thresholds, s.frag_fg.data(),
                                 min_size, lut_ws);
  s.final_lut.assign(s.ws_of_piece.size(), 0);
  for (size_t p = 0; p < s.ws_of_piece.size(); ++p) {
    s.final_lut[p] = lut_ws[s.ws_of_piece[p]];
  }
  return s.n_segments;
}

// Pass 3: relabel a chunk of provisional labels through the final lut.
EXA_API int64_t exa_streamseg_map(void* handle, const uint32_t* frag,
                                  int64_t n, uint32_t* out) {
  StreamSeg& s = *static_cast<StreamSeg*>(handle);
  if (s.n_segments < 0 || n < 0) return -1;
  for (int64_t i = 0; i < n; ++i) out[i] = s.final_lut[frag[i]];
  return 0;
}

// ---------------------------------------------------------------------
// Distributed mode: the identical pipeline partitioned over contiguous
// Z ranges of MULTIPLE PROCESSES (postprocess/distributed.py drives it
// over jax.distributed ranks). Each rank runs pass 1 on its own range
// (D = local planes, z_offset = global index of local plane 0); the
// per-cut stitching that `feed` does between slabs happens on rank 0
// instead, at PIECE granularity, from each rank's exported boundary
// planes -- the same single-plane contract. Rank 0 numbers fragments
// globally (min first-foreground scan index over all ranks' pieces --
// Z ranges are disjoint so indices never collide), each rank builds its
// local RAG in ITS scan order (cut z-edges come from the neighbor
// rank's first-plane fragment ids, exchanged through rank 0), and rank
// 0 concatenates the serialized RAGs IN RANK ORDER: every scan position
// of rank p precedes every position of rank p+1, so first-appearance
// edge indices -- and therefore the merge loop's bucket FIFO tie order
// -- reproduce the dense engine's global scan exactly. Distributions
// are commutative counts, so cross-rank accumulation is exact. The
// merge + min-size + numbering tail is the shared finalize_lut_ws.
// Bit parity with the single-process engine is pinned by
// tests/test_streamseg_distributed.py.
//
// Serialization is little-endian host layout (ranks of one job share
// an architecture; the driver asserts this).

// Enable distributed mode; must precede the first feed.
EXA_API int64_t exa_streamseg_set_distributed(void* handle,
                                              int64_t z_offset) {
  StreamSeg& s = *static_cast<StreamSeg*>(handle);
  if (s.z_done != 0 || s.frags_done || z_offset < 0) return -1;
  s.distributed = true;
  s.z_offset = z_offset;
  return 0;
}

// Finish local pass 1: reduce the piece union-find to local roots
// (enumerated in ascending root piece id -- deterministic), each with
// its min first-foreground scan index and foreground count. Returns the
// local root count R; pass-1 voxel state is freed (boundary exports and
// the piece -> root map are kept for set_ws / get_boundary).
EXA_API int64_t exa_streamseg_local_done(void* handle) {
  StreamSeg& s = *static_cast<StreamSeg*>(handle);
  if (!s.distributed || s.z_done != s.D || s.frags_done ||
      s.local_done_flag) {
    return -1;
  }
  s.local_done_flag = true;
  const uint32_t P = static_cast<uint32_t>(s.piece_parent.size() - 1);
  std::vector<uint64_t> min_fg(P + 1, kNoFg);
  std::vector<uint64_t> cnt(P + 1, 0);
  for (uint32_t p = 1; p <= P; ++p) {
    const uint32_t r = s.piece_find(p);
    min_fg[r] = std::min(min_fg[r], s.piece_first_fg[p]);
    cnt[r] += s.piece_fg_count[p];
  }
  // Every root is exported (foreground or not): a foreground-free root
  // can still carry cross-cut connectivity in pathological inputs; the
  // numbering on rank 0 drops no-foreground roots exactly as
  // fragments_done does.
  s.root_of_piece.assign(P + 1, 0);
  std::vector<uint32_t> idx_of_root(P + 1, 0);
  for (uint32_t p = 1; p <= P; ++p) {
    if (s.piece_parent[p] == p) {
      idx_of_root[p] = static_cast<uint32_t>(++s.n_roots);
      s.root_first_fg.push_back(min_fg[p]);
      s.root_fg.push_back(cnt[p]);
    }
  }
  for (uint32_t p = 1; p <= P; ++p) {
    s.root_of_piece[p] = idx_of_root[s.piece_find(p)];
  }
  s.piece_parent.clear();
  s.piece_parent.shrink_to_fit();
  s.piece_size.clear();
  s.piece_size.shrink_to_fit();
  s.piece_first_fg.clear();
  s.piece_first_fg.shrink_to_fit();
  s.piece_fg_count.clear();
  s.piece_fg_count.shrink_to_fit();
  return s.n_roots;
}

// Local root table: first_fg[i] (global scan index, ~0ull = none) and
// fg_count[i] for root enum index i in [0, R).
EXA_API int64_t exa_streamseg_get_piece_table(void* handle,
                                              uint64_t* first_fg,
                                              uint64_t* fg_count) {
  StreamSeg& s = *static_cast<StreamSeg*>(handle);
  if (!s.local_done_flag || s.frags_done) return -1;
  std::memcpy(first_fg, s.root_first_fg.data(),
              s.root_first_fg.size() * sizeof(uint64_t));
  std::memcpy(fg_count, s.root_fg.data(),
              s.root_fg.size() * sizeof(uint64_t));
  return s.n_roots;
}

// Boundary planes for the rank-0 stitch, all HW-sized: plane-0 /
// last-plane root enum indices + 1 (0 = background) and plan bytes.
EXA_API int64_t exa_streamseg_get_boundary(void* handle,
                                           uint32_t* first_root,
                                           uint8_t* first_plan,
                                           uint32_t* last_root,
                                           uint8_t* last_plan) {
  StreamSeg& s = *static_cast<StreamSeg*>(handle);
  if (!s.local_done_flag || s.frags_done) return -1;
  const int64_t HW = s.H * s.W;
  for (int64_t i = 0; i < HW; ++i) {
    first_root[i] = s.root_of_piece[s.first_ids[i]];
    last_root[i] = s.root_of_piece[s.prev_ids[i]];
  }
  std::memcpy(first_plan, s.first_plan.data(), HW);
  std::memcpy(last_plan, s.prev_plan.data(), HW);
  return 0;
}

// Install rank 0's global numbering: ws_of_root[i] is the global
// watershed fragment id (1..K, 0 = dropped no-foreground root) of local
// root enum index i. Enables rag_feed / map.
EXA_API int64_t exa_streamseg_set_ws(void* handle,
                                     const uint32_t* ws_of_root,
                                     int64_t K) {
  StreamSeg& s = *static_cast<StreamSeg*>(handle);
  if (!s.local_done_flag || s.frags_done || K < 0) return -1;
  s.frags_done = true;
  s.K = K;
  s.ws_of_piece.assign(s.root_of_piece.size(), 0);
  for (size_t p = 1; p < s.root_of_piece.size(); ++p) {
    const uint32_t r = s.root_of_piece[p];
    s.ws_of_piece[p] = r == 0 ? 0 : ws_of_root[r - 1];
  }
  s.root_of_piece.clear();
  s.root_of_piece.shrink_to_fit();
  s.root_first_fg.clear();
  s.root_first_fg.shrink_to_fit();
  s.root_fg.clear();
  s.root_fg.shrink_to_fit();
  s.first_ids.clear();
  s.first_ids.shrink_to_fit();
  s.first_plan.clear();
  s.first_plan.shrink_to_fit();
  s.prev_ids.clear();
  s.prev_ids.shrink_to_fit();
  s.prev_plan.clear();
  s.prev_plan.shrink_to_fit();
  return 0;
}

// Flush pass 2's pending last plane. next_plane (HW global fragment
// ids of the NEXT rank's first plane, from rank 0) supplies the cut's
// outgoing z-edges; null for the globally last rank (no z successors,
// the digest guarantees no +z flags there).
EXA_API int64_t exa_streamseg_rag_flush(void* handle,
                                        const uint32_t* next_plane) {
  StreamSeg& s = *static_cast<StreamSeg*>(handle);
  if (!s.distributed || !s.frags_done || s.z_rag != s.D ||
      s.rag_flushed || !s.have_pending) {
    return -1;
  }
  rag_plane(s, s.pending_frag.data(), s.pending_q.data(), next_plane);
  s.have_pending = false;
  s.pending_frag.clear();
  s.pending_frag.shrink_to_fit();
  s.pending_q.clear();
  s.pending_q.shrink_to_fit();
  s.rag_flushed = true;
  return 0;
}

namespace {

// Serialized-edge byte size (see exa_streamseg_rag_export).
size_t edge_wire_size(const Edge& e) {
  if (e.hist.empty()) return 4 + 4 + 1 + 1 + e.n_inl;
  size_t nnz = 0;
  for (int b = 0; b < exa_rag::kBins; ++b) nnz += e.hist[b] != 0;
  return 4 + 4 + 1 + 2 + nnz * 5;
}

template <typename T>
void wr(uint8_t*& p, T v) {
  std::memcpy(p, &v, sizeof(T));
  p += sizeof(T);
}

template <typename T>
T rd(const uint8_t*& p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  p += sizeof(T);
  return v;
}

}  // namespace

// Wire size of the local RAG serialization.
EXA_API int64_t exa_streamseg_rag_export_size(void* handle) {
  StreamSeg& s = *static_cast<StreamSeg*>(handle);
  if (!s.rag_flushed || s.n_segments >= 0) return -1;
  size_t total = 8;  // u64 edge count
  for (size_t i = 0; i < s.edges.size(); ++i) {
    total += edge_wire_size(s.edges[i]);
  }
  return static_cast<int64_t>(total);
}

// Serialize the local RAG in ascending edge index (= local
// first-appearance scan order). Per edge: u32 a, u32 b (a < b), u8 tag;
// tag 0: u8 n, n raw u8-quantized samples; tag 1: u16 nnz, nnz x
// (u8 bin, u32 count). Frees the local RAG. Returns bytes written.
EXA_API int64_t exa_streamseg_rag_export(void* handle, uint8_t* out,
                                         int64_t cap) {
  StreamSeg& s = *static_cast<StreamSeg*>(handle);
  if (!s.rag_flushed || s.n_segments >= 0) return -1;
  uint8_t* p = out;
  uint8_t* end = out + cap;
  if (end - p < 8) return -2;
  wr<uint64_t>(p, s.edges.size());
  for (size_t i = 0; i < s.edges.size(); ++i) {
    Edge& e = s.edges[i];
    if (static_cast<size_t>(end - p) < edge_wire_size(e)) return -2;
    wr<uint32_t>(p, e.a);
    wr<uint32_t>(p, e.b);
    if (e.hist.empty()) {
      wr<uint8_t>(p, 0);
      wr<uint8_t>(p, e.n_inl);
      std::memcpy(p, e.inl, e.n_inl);
      p += e.n_inl;
    } else {
      wr<uint8_t>(p, 1);
      uint16_t nnz = 0;
      for (int b = 0; b < exa_rag::kBins; ++b) nnz += e.hist[b] != 0;
      wr<uint16_t>(p, nnz);
      for (int b = 0; b < exa_rag::kBins; ++b) {
        if (e.hist[b] != 0) {
          wr<uint8_t>(p, static_cast<uint8_t>(b));
          wr<uint32_t>(p, e.hist[b]);
        }
      }
    }
  }
  s.edge_index.reset(16);
  s.edges.release();
  return static_cast<int64_t>(p - out);
}

// Install the final fragment -> label lut (K + 1 entries from rank 0's
// merge); enables map().
EXA_API int64_t exa_streamseg_set_lut(void* handle, const uint32_t* lut_ws,
                                      int64_t n_segments) {
  StreamSeg& s = *static_cast<StreamSeg*>(handle);
  if (!s.distributed || !s.frags_done || s.n_segments >= 0 ||
      n_segments < 0) {
    return -1;
  }
  s.final_lut.assign(s.ws_of_piece.size(), 0);
  for (size_t p = 0; p < s.ws_of_piece.size(); ++p) {
    s.final_lut[p] = lut_ws[s.ws_of_piece[p]];
  }
  s.n_segments = n_segments;
  return 0;
}

// Rank 0: rebuild the global RAG from the ranks' serialized parts
// (concatenated in rank order inside `buf`, part i spanning
// [offsets[i], offsets[i+1])), run the shared merge loop, and fill
// lut_ws_out (K + 1 fragment -> final label entries). find_or_insert
// over the rank-ordered stream assigns each edge its GLOBAL
// first-appearance index; duplicate (a, b) keys accumulate their
// distributions (commutative counts). Returns the segment count.
EXA_API int64_t exa_streamseg_merge_parts(
    const uint8_t* buf, const int64_t* offsets, int64_t n_parts,
    int64_t K, const uint64_t* frag_fg, const float* thresholds,
    int64_t n_thresholds, int32_t quantile_pct, int64_t min_size,
    uint32_t* lut_ws_out) {
  if (n_parts <= 0 || K < 0 || n_thresholds <= 0) return -1;
  for (int64_t i = 1; i < n_thresholds; ++i) {
    if (thresholds[i] < thresholds[i - 1]) return -1;
  }
  FlatMap edge_index{1024};
  EdgeStore edges;
  for (int64_t part = 0; part < n_parts; ++part) {
    const uint8_t* p = buf + offsets[part];
    const uint8_t* end = buf + offsets[part + 1];
    if (end - p < 8) return -2;
    const uint64_t n_edges = rd<uint64_t>(p);
    for (uint64_t ei = 0; ei < n_edges; ++ei) {
      if (end - p < 9) return -2;
      const uint32_t a = rd<uint32_t>(p);
      const uint32_t b = rd<uint32_t>(p);
      if (a == 0 || a >= b || static_cast<int64_t>(b) > K) return -2;
      const uint8_t tag = rd<uint8_t>(p);
      auto [slot, fresh] = edge_index.find_or_insert(
          EdgeKey{a, b}.packed(), static_cast<uint32_t>(edges.size()));
      if (fresh) edges.emplace_back(a, b);
      Edge& e = edges[*slot];
      if (tag == 0) {
        if (end - p < 1) return -2;
        const uint8_t n = rd<uint8_t>(p);
        if (end - p < n) return -2;
        for (uint8_t k = 0; k < n; ++k) e.add_bin(p[k]);
        p += n;
      } else if (tag == 1) {
        if (end - p < 2) return -2;
        const uint16_t nnz = rd<uint16_t>(p);
        if (end - p < static_cast<int64_t>(nnz) * 5) return -2;
        if (e.hist.empty()) e.to_hist();
        for (uint16_t k = 0; k < nnz; ++k) {
          const uint8_t bin = rd<uint8_t>(p);
          const uint32_t c = rd<uint32_t>(p);
          e.hist[bin] += c;
          e.count += c;
        }
        e.cached_bin = -1;
      } else {
        return -2;
      }
    }
    if (p != end) return -2;
  }

  exa_rag::MergeEvents me = exa_rag::run_merge(
      edge_index, edges, K, thresholds, n_thresholds, quantile_pct);
  edge_index.reset(16);
  edges.release();

  std::vector<uint32_t> lut_ws;
  const int64_t n_segments =
      finalize_lut_ws(me, K, n_thresholds, frag_fg, min_size, lut_ws);
  std::memcpy(lut_ws_out, lut_ws.data(), lut_ws.size() * sizeof(uint32_t));
  return n_segments;
}

// ---------------------------------------------------------------------
// Component-partitioned distributed merge. Rank-0's merge_parts above
// rebuilds the GLOBAL RAG and runs the whole merge loop alone -- the
// one stage of the distributed postprocess that more hosts could not
// speed up. RAG components are independent serial programs (the
// run_merge contract in rag.hpp), so the merge partitions by connected
// component instead:
//
//   1. rank 0 scans the gathered serialized parts ONCE for edge
//      endpoints only (no Edge structs, no distributions -- the O(RAG)
//      rebuild that was rank 0's memory peak disappears), unions them
//      into components, and greedily assigns components to ranks by
//      edge load (descending load, ties by smallest fragment id; least
//      loaded rank wins, ties by rank index -- the deterministic
//      _partition_labels rule from postprocess/distributed.py);
//   2. a second scan routes each serialized edge record, in global
//      stream order, to its component's owner buffer -- so within any
//      component the records keep their global first-appearance
//      relative order, which is the only order run_merge's FIFO
//      tie-break can observe (CSR bucket fill never mixes components);
//   3. every rank deserializes ITS buffer with fragment ids remapped to
//      a dense local range (bounding its UnionFind/adjacency memory by
//      the local subgraph, not global K), runs the SAME run_merge, and
//      returns the executed (keep, drop) unions up to the last
//      threshold in global fragment ids;
//   4. rank 0 composes the pairs into the replay forest and applies the
//      shared min-size + first-appearance tail (lut_from_rparent).
//
// Bit parity with merge_parts holds because per-component event
// prefixes are invariant to which process runs the component (same
// records, same relative order, same code), pair composition is
// order-independent (components touch disjoint fragments; each
// fragment is dropped at most once), and the final numbering depends
// only on the composed forest. Pinned by tests/test_streamseg_distributed.py.

namespace {

// Scan one serialized RAG part (the exa_streamseg_rag_export format)
// record by record, invoking fn(a, b, record_ptr, record_bytes) per
// edge record. Structural validation matches merge_parts. Returns 0 or
// -2 on malformed input.
template <typename Fn>
int64_t scan_part(const uint8_t* p, const uint8_t* end, int64_t K,
                  Fn&& fn) {
  if (end - p < 8) return -2;
  const uint64_t n_records = rd<uint64_t>(p);
  for (uint64_t ei = 0; ei < n_records; ++ei) {
    const uint8_t* rec = p;
    if (end - p < 9) return -2;
    const uint32_t a = rd<uint32_t>(p);
    const uint32_t b = rd<uint32_t>(p);
    if (a == 0 || a >= b || static_cast<int64_t>(b) > K) return -2;
    const uint8_t tag = rd<uint8_t>(p);
    if (tag == 0) {
      if (end - p < 1) return -2;
      const uint8_t n = rd<uint8_t>(p);
      if (end - p < n) return -2;
      p += n;
    } else if (tag == 1) {
      if (end - p < 2) return -2;
      const uint16_t nnz = rd<uint16_t>(p);
      if (end - p < static_cast<int64_t>(nnz) * 5) return -2;
      p += static_cast<int64_t>(nnz) * 5;
    } else {
      return -2;
    }
    fn(a, b, rec, static_cast<size_t>(p - rec));
  }
  if (p != end) return -2;
  return 0;
}

struct RagRouter {
  std::vector<const uint8_t*> begins, ends;
  int64_t K = 0;
  int64_t n_owners = 0;
  exa::UnionFind uf{0};
  std::vector<uint32_t> owner_of_root;  // K + 1; valid at component roots
  std::vector<int64_t> owner_bytes;     // per owner, incl. 8 B header
  std::vector<uint64_t> owner_records;  // edge records per owner
};

}  // namespace

// Rank 0: plan the component partition over the gathered parts.
// part_ptrs/part_sizes: n_parts serialized RAG payloads in RANK ORDER
// (the buffers must stay alive until exa_ragroute_free). Returns a
// router handle or nullptr on malformed input.
EXA_API void* exa_ragroute_new(const uint8_t* const* part_ptrs,
                               const int64_t* part_sizes, int64_t n_parts,
                               int64_t K, int64_t n_owners) {
  if (n_parts <= 0 || K < 0 || n_owners <= 0) return nullptr;
  auto r = std::make_unique<RagRouter>();
  r->K = K;
  r->n_owners = n_owners;
  r->uf = exa::UnionFind(static_cast<size_t>(K) + 1);
  for (int64_t i = 0; i < n_parts; ++i) {
    r->begins.push_back(part_ptrs[i]);
    r->ends.push_back(part_ptrs[i] + part_sizes[i]);
  }

  // Pass A: union endpoints; accumulate per-fragment load so component
  // loads aggregate in O(K) afterwards (no second byte scan here).
  std::vector<uint64_t> rec_of_frag(static_cast<size_t>(K) + 1, 0);
  std::vector<int64_t> bytes_of_frag(static_cast<size_t>(K) + 1, 0);
  for (int64_t i = 0; i < n_parts; ++i) {
    const int64_t rc = scan_part(
        r->begins[i], r->ends[i], K,
        [&](uint32_t a, uint32_t b, const uint8_t*, size_t sz) {
          r->uf.unite(a, b);
          ++rec_of_frag[a];
          bytes_of_frag[a] += static_cast<int64_t>(sz);
        });
    if (rc < 0) return nullptr;
  }

  // Aggregate loads per component root; component identity for the
  // deterministic greedy order is its smallest member fragment id.
  std::vector<uint64_t> comp_recs(static_cast<size_t>(K) + 1, 0);
  std::vector<int64_t> comp_bytes(static_cast<size_t>(K) + 1, 0);
  std::vector<uint32_t> comp_min(static_cast<size_t>(K) + 1, 0);
  for (int64_t f = 1; f <= K; ++f) {
    if (rec_of_frag[f] == 0 &&
        r->uf.find(static_cast<uint32_t>(f)) == f && r->uf.size[f] == 1) {
      continue;  // isolated fragment: no edges, no owner needed
    }
    const uint32_t root = r->uf.find(static_cast<uint32_t>(f));
    comp_recs[root] += rec_of_frag[f];
    comp_bytes[root] += bytes_of_frag[f];
    if (comp_min[root] == 0) comp_min[root] = static_cast<uint32_t>(f);
  }
  std::vector<uint32_t> roots;
  for (int64_t f = 1; f <= K; ++f) {
    if (comp_min[f] != 0 &&
        r->uf.find(static_cast<uint32_t>(f)) == f) {
      roots.push_back(static_cast<uint32_t>(f));
    }
  }
  std::sort(roots.begin(), roots.end(), [&](uint32_t x, uint32_t y) {
    if (comp_recs[x] != comp_recs[y]) return comp_recs[x] > comp_recs[y];
    return comp_min[x] < comp_min[y];
  });

  r->owner_of_root.assign(static_cast<size_t>(K) + 1, 0);
  r->owner_bytes.assign(n_owners, 8);  // u64 record-count header each
  r->owner_records.assign(n_owners, 0);
  std::vector<uint64_t> load(n_owners, 0);
  for (const uint32_t root : roots) {
    int64_t best = 0;
    for (int64_t o = 1; o < n_owners; ++o) {
      if (load[o] < load[best]) best = o;
    }
    load[best] += comp_recs[root];
    r->owner_of_root[root] = static_cast<uint32_t>(best);
    r->owner_bytes[best] += comp_bytes[root];
    r->owner_records[best] += comp_recs[root];
  }
  return r.release();
}

EXA_API void exa_ragroute_free(void* handle) {
  delete static_cast<RagRouter*>(handle);
}

// Per-owner routed-buffer byte sizes (n_owners entries, headers
// included).
EXA_API int64_t exa_ragroute_sizes(void* handle, int64_t* bytes_out) {
  RagRouter& r = *static_cast<RagRouter*>(handle);
  std::memcpy(bytes_out, r.owner_bytes.data(),
              r.owner_bytes.size() * sizeof(int64_t));
  return 0;
}

// Route every edge record to its owner's buffer in global stream
// order. `out` + owner_offsets[o] must have owner_bytes[o] capacity
// per owner (offsets are the caller's cumulative-sum layout).
EXA_API int64_t exa_ragroute_fill(void* handle, uint8_t* out,
                                  const int64_t* owner_offsets) {
  RagRouter& r = *static_cast<RagRouter*>(handle);
  std::vector<uint8_t*> cursor(r.n_owners);
  for (int64_t o = 0; o < r.n_owners; ++o) {
    uint8_t* p = out + owner_offsets[o];
    wr<uint64_t>(p, r.owner_records[o]);
    cursor[o] = p;
  }
  for (size_t i = 0; i < r.begins.size(); ++i) {
    const int64_t rc = scan_part(
        r.begins[i], r.ends[i], r.K,
        [&](uint32_t a, uint32_t, const uint8_t* rec, size_t sz) {
          const uint32_t o = r.owner_of_root[r.uf.find(a)];
          std::memcpy(cursor[o], rec, sz);
          cursor[o] += sz;
        });
    if (rc < 0) return -2;
  }
  for (int64_t o = 0; o < r.n_owners; ++o) {
    if (cursor[o] != out + owner_offsets[o] + r.owner_bytes[o]) return -2;
  }
  return 0;
}

// One rank's merge over its routed component buffer. Fragment ids are
// remapped to a dense local range on deserialization (memory bounded
// by the LOCAL subgraph, not global K), the shared run_merge executes,
// and the events up to the LAST threshold stream out as (keep, drop)
// pairs in GLOBAL fragment ids (2 * max_pairs u32 capacity; the
// routed buffer's u64 record-count header is a valid bound). Returns
// the pair count; -2 malformed, -3 capacity exceeded.
EXA_API int64_t exa_streamseg_merge_local(
    const uint8_t* buf, int64_t size, int64_t K, const float* thresholds,
    int64_t n_thresholds, int32_t quantile_pct, uint32_t* pairs_out,
    int64_t max_pairs) {
  if (K < 0 || n_thresholds <= 0 || max_pairs < 0) return -1;
  for (int64_t i = 1; i < n_thresholds; ++i) {
    if (thresholds[i] < thresholds[i - 1]) return -1;
  }
  const bool dbg = std::getenv("EXA_DEBUG_TIMING") != nullptr;
  auto now = []() { return std::chrono::steady_clock::now(); };
  auto secs = [](auto a, auto b) {
    return std::chrono::duration<double>(b - a).count();
  };
  const auto t0 = now();
  FlatMap remap{1024};
  std::vector<uint32_t> to_global(1, 0);  // local id 0 unused
  auto localize = [&](uint32_t g) {
    auto [slot, fresh] = remap.find_or_insert(
        g, static_cast<uint32_t>(to_global.size()));
    if (fresh) to_global.push_back(g);
    return *slot;
  };
  FlatMap edge_index{1024};
  EdgeStore edges;
  const uint8_t* p = buf;
  const uint8_t* end = buf + size;
  const int64_t rc = scan_part(
      p, end, K,
      [&](uint32_t a, uint32_t b, const uint8_t* rec, size_t) {
        const uint32_t la = localize(a);
        const uint32_t lb = localize(b);
        const EdgeKey key{std::min(la, lb), std::max(la, lb)};
        auto [slot, fresh] = edge_index.find_or_insert(
            key.packed(), static_cast<uint32_t>(edges.size()));
        if (fresh) edges.emplace_back(key.a, key.b);
        Edge& e = edges[*slot];
        const uint8_t* q = rec + 9;  // past a, b, tag
        if (rec[8] == 0) {
          const uint8_t n = *q++;
          for (uint8_t k = 0; k < n; ++k) e.add_bin(q[k]);
        } else {
          uint16_t nnz;
          std::memcpy(&nnz, q, 2);
          q += 2;
          if (e.hist.empty()) e.to_hist();
          for (uint16_t k = 0; k < nnz; ++k) {
            const uint8_t bin = q[0];
            uint32_t c;
            std::memcpy(&c, q + 1, 4);
            q += 5;
            e.hist[bin] += c;
            e.count += c;
          }
          e.cached_bin = -1;
        }
      });
  if (rc < 0) return -2;
  remap.reset(16);
  const auto t1 = now();

  const int64_t k_local = static_cast<int64_t>(to_global.size()) - 1;
  exa_rag::MergeEvents me = exa_rag::run_merge(
      edge_index, edges, k_local, thresholds, n_thresholds, quantile_pct);
  const auto t2 = now();
  if (dbg) {
    std::fprintf(stderr,
                 "[exa merge_local] deserialize+localize %.3fs "
                 "(k_local=%lld edges=%lld) run_merge %.3fs\n",
                 secs(t0, t1), static_cast<long long>(k_local),
                 static_cast<long long>(edges.size()), secs(t1, t2));
  }
  edge_index.reset(16);
  edges.release();

  int64_t n_pairs = 0;
  for (uint32_t c = 0; c < me.n_comps; ++c) {
    const uint32_t to =
        me.cutoffs[static_cast<size_t>(c) * n_thresholds + n_thresholds - 1];
    if (n_pairs + to > max_pairs) return -3;
    for (uint32_t i = 0; i < to; ++i) {
      pairs_out[2 * n_pairs] = to_global[me.comp_events[c][i].first];
      pairs_out[2 * n_pairs + 1] = to_global[me.comp_events[c][i].second];
      ++n_pairs;
    }
  }
  return n_pairs;
}

// Rank 0: compose the ranks' (keep, drop) pairs into the replay forest
// and apply the shared min-size + first-appearance tail. Pair order is
// irrelevant (disjoint components; each fragment dropped at most
// once -- validated). Fills lut_ws_out (K + 1); returns the segment
// count, -2 on an invalid pair stream.
EXA_API int64_t exa_streamseg_compose_lut(
    int64_t K, const uint64_t* frag_fg, const uint32_t* pairs,
    int64_t n_pairs, int64_t min_size, uint32_t* lut_ws_out) {
  if (K < 0 || n_pairs < 0) return -1;
  std::vector<uint32_t> rparent(static_cast<size_t>(K) + 1);
  for (int64_t f = 0; f <= K; ++f) rparent[f] = static_cast<uint32_t>(f);
  for (int64_t i = 0; i < n_pairs; ++i) {
    const uint32_t keep = pairs[2 * i];
    const uint32_t drop = pairs[2 * i + 1];
    if (keep == 0 || drop == 0 || keep == drop ||
        static_cast<int64_t>(keep) > K || static_cast<int64_t>(drop) > K ||
        rparent[drop] != drop) {
      return -2;
    }
    rparent[drop] = keep;
  }
  std::vector<uint32_t> lut_ws;
  const int64_t n_segments =
      lut_from_rparent(rparent, K, frag_fg, min_size, lut_ws);
  std::memcpy(lut_ws_out, lut_ws.data(), lut_ws.size() * sizeof(uint32_t));
  return n_segments;
}
