// TEASAR skeletonization of labeled volumes.
//
// Native equivalent of the reference's kimimaro dependency, honoring the
// call-site parameter set at reference inference.py:272-291:
// scale, const, pdrf_exponent, pdrf_scale, soma detection/acceptance/
// invalidation thresholds, anisotropy, fix_borders, fill_holes.
//
// Per label id, per 26-connected component:
//  1. optional binary hole filling (6-conn background flood from the
//     component bbox border);
//  2. DBF: exact anisotropic EDT to the nearest non-label voxel
//     (edt.cpp);
//  3. root: soma center (argmax DBF) when max DBF exceeds the soma
//     acceptance threshold after detection, else the geodesically
//     farthest voxel from an arbitrary extremum (two-sweep Dijkstra);
//  4. PDRF Dijkstra from the root with per-voxel cost
//     pdrf_scale * (1 - DBF/maxDBF)^pdrf_exponent + step-length
//     tie-break, plus a pure-Euclidean geodesic field for target
//     selection;
//  5. iteratively trace the farthest valid voxel back to the existing
//     skeleton, appending path vertices and invalidating all valid
//     voxels within radius scale*DBF(p) + const of each path vertex p
//     (TEASAR invalidation rule); with fix_borders, border-contact
//     voxels are exhausted as targets first so block-wise skeletons
//     meet at block faces;
//  6. vertices are emitted in physical units (index * anisotropy) with
//     DBF radii and path edges.

#include <algorithm>
#include <array>
#include <atomic>
#include <thread>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <unordered_map>
#include <vector>

#include "common.hpp"
#include "edt.hpp"

namespace {

constexpr float kInf = std::numeric_limits<float>::max() / 4;

struct Params {
  float scale, konst;
  float pdrf_exponent, pdrf_scale;
  float soma_detect, soma_accept, soma_inv_scale, soma_inv_const;
  float wz, wy, wx;
  int32_t fix_borders, fill_holes, black_border;
};

struct SkeletonData {
  uint32_t label;
  std::vector<double> verts;   // (n, 3) physical zyx
  std::vector<double> radii;   // (n,)
  std::vector<int64_t> edges;  // (e, 2)
};

struct Result {
  std::vector<SkeletonData> skeletons;
};

struct HeapItem {
  float dist;
  int64_t idx;
  bool operator>(const HeapItem& o) const {
    if (dist != o.dist) return dist > o.dist;
    return idx > o.idx;
  }
};

using MinHeap =
    std::priority_queue<HeapItem, std::vector<HeapItem>, std::greater<>>;

// Dijkstra over the 26-neighborhood restricted to mask, with edge weight
// step_cost(v) (entering v) + optional euclidean step length. Fills dist
// and pred.
void dijkstra(const std::vector<uint8_t>& mask, int64_t D, int64_t H,
              int64_t W, const Params& p, int64_t src,
              const std::vector<float>& node_cost, bool add_step_len,
              std::vector<float>& dist, std::vector<int64_t>& pred) {
  const int64_t N = D * H * W;
  dist.assign(N, kInf);
  pred.assign(N, -1);
  dist[src] = 0.0f;
  MinHeap heap;
  heap.push({0.0f, src});
  while (!heap.empty()) {
    auto [d, u] = heap.top();
    heap.pop();
    if (d > dist[u]) continue;
    const int64_t uz = u / (H * W), uy = (u / W) % H, ux = u % W;
    for (int dz = -1; dz <= 1; ++dz) {
      for (int dy = -1; dy <= 1; ++dy) {
        for (int dx = -1; dx <= 1; ++dx) {
          if (!dz && !dy && !dx) continue;
          const int64_t vz = uz + dz, vy = uy + dy, vx = ux + dx;
          if (vz < 0 || vz >= D || vy < 0 || vy >= H || vx < 0 || vx >= W)
            continue;
          const int64_t v = (vz * H + vy) * W + vx;
          if (!mask[v]) continue;
          const float sz = dz * p.wz, sy = dy * p.wy, sx = dx * p.wx;
          const float step = std::sqrt(sz * sz + sy * sy + sx * sx);
          float w = node_cost.empty() ? step : node_cost[v];
          if (add_step_len && !node_cost.empty()) w += step * 1e-3f;
          const float nd = d + w;
          if (nd < dist[v]) {
            dist[v] = nd;
            pred[v] = u;
            heap.push({nd, v});
          }
        }
      }
    }
  }
}

// Fill interior holes: 6-conn flood of non-mask voxels from the bbox
// faces; anything non-mask not reached is a hole -> set to mask.
void fill_holes(std::vector<uint8_t>& mask, int64_t D, int64_t H,
                int64_t W) {
  const int64_t N = D * H * W;
  std::vector<uint8_t> outside(N, 0);
  std::vector<int64_t> stack;
  auto push = [&](int64_t z, int64_t y, int64_t x) {
    const int64_t i = (z * H + y) * W + x;
    if (!mask[i] && !outside[i]) {
      outside[i] = 1;
      stack.push_back(i);
    }
  };
  for (int64_t z = 0; z < D; ++z)
    for (int64_t y = 0; y < H; ++y) {
      push(z, y, 0);
      push(z, y, W - 1);
    }
  for (int64_t z = 0; z < D; ++z)
    for (int64_t x = 0; x < W; ++x) {
      push(z, 0, x);
      push(z, H - 1, x);
    }
  for (int64_t y = 0; y < H; ++y)
    for (int64_t x = 0; x < W; ++x) {
      push(0, y, x);
      push(D - 1, y, x);
    }
  const int64_t off[6] = {H * W, -H * W, W, -W, 1, -1};
  while (!stack.empty()) {
    const int64_t u = stack.back();
    stack.pop_back();
    const int64_t uz = u / (H * W), uy = (u / W) % H, ux = u % W;
    const int64_t coord[3] = {uz, uy, ux};
    const int64_t dims[3] = {D, H, W};
    for (int a = 0; a < 3; ++a) {
      for (int s = 0; s < 2; ++s) {
        const int64_t c = coord[a] + (s ? 1 : -1);
        if (c < 0 || c >= dims[a]) continue;
        const int64_t v = u + off[a * 2 + (s ? 0 : 1)];
        if (!mask[v] && !outside[v]) {
          outside[v] = 1;
          stack.push_back(v);
        }
      }
    }
  }
  for (int64_t i = 0; i < N; ++i)
    if (!mask[i] && !outside[i]) mask[i] = 1;
}

// Skeletonize one connected component (mask over a bbox-local grid).
// gd/gh/gw are the GLOBAL volume dims; faces of the tight bbox interior
// to the volume always count as boundary (non-component voxels lie just
// outside), while faces on the global border follow kimimaro's
// black_border semantics (open unless black_border).
void skeletonize_component(const std::vector<uint8_t>& mask, int64_t D,
                           int64_t H, int64_t W, const Params& p,
                           int64_t z0, int64_t y0, int64_t x0,
                           int64_t gd, int64_t gh, int64_t gw,
                           uint32_t label, Result* res) {
  const int64_t N = D * H * W;

  const bool on_global[6] = {
      z0 == 0, z0 + D == gd, y0 == 0, y0 + H == gh,
      x0 == 0, x0 + W == gw,
  };
  uint8_t cap_face[6];
  for (int f = 0; f < 6; ++f)
    cap_face[f] = (!on_global[f] || p.black_border) ? 1 : 0;

  std::vector<float> dbf_sq(N);
  exa::edt_sq(mask.data(), D, H, W, p.wz, p.wy, p.wx, dbf_sq.data(),
              cap_face);
  std::vector<float> dbf(N, 0.0f);
  float max_dbf = 0.0f;
  int64_t argmax_dbf = -1;
  int64_t any_fg = -1;
  for (int64_t i = 0; i < N; ++i) {
    if (!mask[i]) continue;
    dbf[i] = std::sqrt(dbf_sq[i]);
    if (any_fg < 0) any_fg = i;
    if (dbf[i] > max_dbf) {
      max_dbf = dbf[i];
      argmax_dbf = i;
    }
  }
  if (any_fg < 0) return;

  // Root selection.
  std::vector<float> dist;
  std::vector<int64_t> pred;
  std::vector<float> empty_cost;
  bool soma = p.soma_detect > 0 && max_dbf * 2 > p.soma_detect &&
              max_dbf * 2 > p.soma_accept;
  int64_t root;
  if (soma) {
    root = argmax_dbf;
  } else {
    dijkstra(mask, D, H, W, p, any_fg, empty_cost, false, dist, pred);
    root = any_fg;
    float best = -1.0f;
    for (int64_t i = 0; i < N; ++i)
      if (mask[i] && dist[i] < kInf && dist[i] > best) {
        best = dist[i];
        root = i;
      }
  }

  // PDRF field + predecessor tree from root.
  std::vector<float> pdrf(N, 0.0f);
  for (int64_t i = 0; i < N; ++i) {
    if (!mask[i]) continue;
    const float r = 1.0f - dbf[i] / max_dbf;
    pdrf[i] = p.pdrf_scale * std::pow(r, p.pdrf_exponent) + 1e-5f;
  }
  std::vector<float> pdrf_dist;
  std::vector<int64_t> pdrf_pred;
  dijkstra(mask, D, H, W, p, root, pdrf, true, pdrf_dist, pdrf_pred);
  // Euclidean geodesic distance from root (target selection field).
  dijkstra(mask, D, H, W, p, root, empty_cost, false, dist, pred);

  std::vector<uint8_t> valid = mask;  // not-yet-invalidated voxels
  // Border-contact voxels: faces of the *global* volume only (a tight
  // bbox face interior to the volume is not a block border).
  std::vector<uint8_t> border(N, 0);
  if (p.fix_borders) {
    for (int64_t z = 0; z < D; ++z)
      for (int64_t y = 0; y < H; ++y)
        for (int64_t x = 0; x < W; ++x) {
          const int64_t i = (z * H + y) * W + x;
          if (!mask[i]) continue;
          if ((on_global[0] && z == 0) || (on_global[1] && z == D - 1) ||
              (on_global[2] && y == 0) || (on_global[3] && y == H - 1) ||
              (on_global[4] && x == 0) || (on_global[5] && x == W - 1))
            border[i] = 1;
        }
  }

  SkeletonData skel;
  skel.label = label;
  std::unordered_map<int64_t, int64_t> vert_id;  // voxel -> vertex index
  std::vector<uint8_t> on_skeleton(N, 0);

  auto add_vertex = [&](int64_t v) -> int64_t {
    auto it = vert_id.find(v);
    if (it != vert_id.end()) return it->second;
    const int64_t id = static_cast<int64_t>(skel.radii.size());
    vert_id.emplace(v, id);
    const int64_t vz = v / (H * W), vy = (v / W) % H, vx = v % W;
    skel.verts.push_back((vz + z0) * p.wz);
    skel.verts.push_back((vy + y0) * p.wy);
    skel.verts.push_back((vx + x0) * p.wx);
    skel.radii.push_back(dbf[v]);
    on_skeleton[v] = 1;
    return id;
  };

  auto invalidate_around = [&](int64_t v) {
    const float r = p.scale * dbf[v] + p.konst;
    const int64_t vz = v / (H * W), vy = (v / W) % H, vx = v % W;
    const int64_t rz = static_cast<int64_t>(r / p.wz) + 1;
    const int64_t ry = static_cast<int64_t>(r / p.wy) + 1;
    const int64_t rx = static_cast<int64_t>(r / p.wx) + 1;
    const float r2 = r * r;
    for (int64_t z = std::max<int64_t>(0, vz - rz);
         z <= std::min(D - 1, vz + rz); ++z) {
      for (int64_t y = std::max<int64_t>(0, vy - ry);
           y <= std::min(H - 1, vy + ry); ++y) {
        for (int64_t x = std::max<int64_t>(0, vx - rx);
             x <= std::min(W - 1, vx + rx); ++x) {
          const float dz = (z - vz) * p.wz, dy = (y - vy) * p.wy,
                      dx = (x - vx) * p.wx;
          if (dz * dz + dy * dy + dx * dx <= r2) {
            valid[(z * H + y) * W + x] = 0;
          }
        }
      }
    }
  };

  // Soma: root vertex + ball invalidation.
  add_vertex(root);
  if (soma) {
    const float rr = p.soma_inv_scale * dbf[root] + p.soma_inv_const;
    const int64_t vz = root / (H * W), vy = (root / W) % H, vx = root % W;
    const int64_t rz = static_cast<int64_t>(rr / p.wz) + 1;
    const int64_t ry = static_cast<int64_t>(rr / p.wy) + 1;
    const int64_t rx = static_cast<int64_t>(rr / p.wx) + 1;
    for (int64_t z = std::max<int64_t>(0, vz - rz);
         z <= std::min(D - 1, vz + rz); ++z)
      for (int64_t y = std::max<int64_t>(0, vy - ry);
           y <= std::min(H - 1, vy + ry); ++y)
        for (int64_t x = std::max<int64_t>(0, vx - rx);
             x <= std::min(W - 1, vx + rx); ++x) {
          const float dz = (z - vz) * p.wz, dy = (y - vy) * p.wy,
                      dx = (x - vx) * p.wx;
          if (dz * dz + dy * dy + dx * dx <= rr * rr)
            valid[(z * H + y) * W + x] = 0;
        }
  }
  // Non-soma roots do NOT pre-invalidate a ball: TEASAR invalidates only
  // along traced paths, so the first root->farthest path always exists.
  valid[root] = 0;

  // Main path-peeling loop.
  while (true) {
    int64_t target = -1;
    float best = -1.0f;
    if (p.fix_borders) {
      for (int64_t i = 0; i < N; ++i)
        if (valid[i] && border[i] && dist[i] < kInf && dist[i] > best) {
          best = dist[i];
          target = i;
        }
    }
    if (target < 0) {
      for (int64_t i = 0; i < N; ++i)
        if (valid[i] && dist[i] < kInf && dist[i] > best) {
          best = dist[i];
          target = i;
        }
    }
    if (target < 0) break;

    // Trace back to the existing skeleton.
    std::vector<int64_t> path;
    int64_t cur = target;
    while (cur >= 0 && !on_skeleton[cur]) {
      path.push_back(cur);
      cur = pdrf_pred[cur];
    }
    if (cur >= 0) path.push_back(cur);  // junction vertex
    // Append vertices root-ward -> target order doesn't matter for SWC.
    for (size_t i = 0; i + 1 < path.size(); ++i) {
      const int64_t a = add_vertex(path[i]);
      const int64_t b = add_vertex(path[i + 1]);
      skel.edges.push_back(a);
      skel.edges.push_back(b);
    }
    for (int64_t v : path) {
      invalidate_around(v);
      valid[v] = 0;
    }
    if (path.size() <= 1 && target >= 0) valid[target] = 0;
  }

  if (!skel.radii.empty()) res->skeletons.push_back(std::move(skel));
}

}  // namespace

// Skeletonize a CROP of a larger volume: `labels` is the (D, H, W)
// crop at global offset (z_off, y_off, x_off) inside a (GD, GH, GW)
// volume; when only_label != 0, only that label's components are
// processed. The crop must contain every voxel of each processed label
// plus a 1-voxel pad wherever the label's bbox is interior to the
// volume -- then component discovery, bboxes, EDT, fix_borders, and
// black_border semantics are identical to running the dense engine on
// the full volume (vertices come out in GLOBAL coordinates), which is
// what the streaming skeletonizer (postprocess/skeleton.py
// skeletonize_lazy) relies on. exa_skeletonize is the whole-volume
// special case.
EXA_API void* exa_skeletonize_crop(const uint32_t* labels, int64_t D,
                                   int64_t H, int64_t W, int64_t z_off,
                                   int64_t y_off, int64_t x_off,
                                   int64_t GD, int64_t GH, int64_t GW,
                                   uint32_t only_label,
                                   const double* params_arr,
                                   int32_t fix_borders,
                                   int32_t fill_holes_flag) {
  Params p;
  p.scale = static_cast<float>(params_arr[0]);
  p.konst = static_cast<float>(params_arr[1]);
  p.pdrf_exponent = static_cast<float>(params_arr[2]);
  p.pdrf_scale = static_cast<float>(params_arr[3]);
  p.soma_detect = static_cast<float>(params_arr[4]);
  p.soma_accept = static_cast<float>(params_arr[5]);
  p.soma_inv_scale = static_cast<float>(params_arr[6]);
  p.soma_inv_const = static_cast<float>(params_arr[7]);
  p.wz = static_cast<float>(params_arr[8]);
  p.wy = static_cast<float>(params_arr[9]);
  p.wx = static_cast<float>(params_arr[10]);
  p.fix_borders = fix_borders;
  p.fill_holes = fill_holes_flag;
  p.black_border = static_cast<int32_t>(params_arr[12]);

  auto* res = new Result();
  const int64_t N = D * H * W;

  // Connected components (26-conn) per label, with bboxes.
  std::vector<uint32_t> comp(N, 0);
  uint32_t n_comp = 0;
  std::vector<int64_t> stack;
  std::vector<std::array<int64_t, 6>> bbox;  // z0,z1,y0,y1,x0,x1 inclusive
  std::vector<uint32_t> comp_label;
  for (int64_t seed = 0; seed < N; ++seed) {
    if (labels[seed] == 0 || comp[seed] != 0) continue;
    if (only_label != 0 && labels[seed] != only_label) continue;
    const uint32_t lab = labels[seed];
    const uint32_t cid = ++n_comp;
    comp[seed] = cid;
    stack.push_back(seed);
    std::array<int64_t, 6> bb = {D, -1, H, -1, W, -1};
    while (!stack.empty()) {
      const int64_t u = stack.back();
      stack.pop_back();
      const int64_t uz = u / (H * W), uy = (u / W) % H, ux = u % W;
      bb[0] = std::min(bb[0], uz);
      bb[1] = std::max(bb[1], uz);
      bb[2] = std::min(bb[2], uy);
      bb[3] = std::max(bb[3], uy);
      bb[4] = std::min(bb[4], ux);
      bb[5] = std::max(bb[5], ux);
      for (int dz = -1; dz <= 1; ++dz)
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx) {
            if (!dz && !dy && !dx) continue;
            const int64_t vz = uz + dz, vy = uy + dy, vx = ux + dx;
            if (vz < 0 || vz >= D || vy < 0 || vy >= H || vx < 0 ||
                vx >= W)
              continue;
            const int64_t v = (vz * H + vy) * W + vx;
            if (labels[v] == lab && comp[v] == 0) {
              comp[v] = cid;
              stack.push_back(v);
            }
          }
    }
    bbox.push_back(bb);
    comp_label.push_back(lab);
  }

  // Components are independent: process them on a worker pool
  // (kimimaro's `parallel` knob; the reference calls with parallel=1,
  // inference.py:288). Results are collected per component and appended
  // in component order so the output is deterministic regardless of
  // thread count.
  const int32_t n_threads =
      std::max<int32_t>(1, static_cast<int32_t>(params_arr[11]));
  std::vector<Result> partial(n_comp);
  std::atomic<uint32_t> next_comp{1};

  auto worker = [&]() {
    while (true) {
      const uint32_t c = next_comp.fetch_add(1);
      if (c > n_comp) return;
      const auto& bb = bbox[c - 1];
      const int64_t cd = bb[1] - bb[0] + 1, ch = bb[3] - bb[2] + 1,
                    cw = bb[5] - bb[4] + 1;
      std::vector<uint8_t> mask(cd * ch * cw, 0);
      for (int64_t z = 0; z < cd; ++z)
        for (int64_t y = 0; y < ch; ++y)
          for (int64_t x = 0; x < cw; ++x) {
            const int64_t g =
                ((z + bb[0]) * H + (y + bb[2])) * W + (x + bb[4]);
            if (comp[g] == c) mask[(z * ch + y) * cw + x] = 1;
          }
      if (p.fill_holes) fill_holes(mask, cd, ch, cw);
      skeletonize_component(mask, cd, ch, cw, p, bb[0] + z_off,
                            bb[2] + y_off, bb[4] + x_off, GD, GH, GW,
                            comp_label[c - 1], &partial[c - 1]);
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  for (auto& part : partial) {
    for (auto& s : part.skeletons) res->skeletons.push_back(std::move(s));
  }
  return res;
}

EXA_API void* exa_skeletonize(const uint32_t* labels, int64_t D, int64_t H,
                              int64_t W, const double* params_arr,
                              int32_t fix_borders, int32_t fill_holes_flag) {
  return exa_skeletonize_crop(labels, D, H, W, 0, 0, 0, D, H, W, 0,
                              params_arr, fix_borders, fill_holes_flag);
}

// Per-label bounding boxes + voxel counts over one Z slab of labels
// (the streaming skeletonizer's discovery pass). bbox layout:
// (n_labels + 1) x 6 int64 rows [z0, z1, y0, y1, x0, x1] (inclusive),
// initialized by the CALLER to (INT64_MAX, -1, ...) and updated in
// place across slabs; counts is (n_labels + 1) int64. Labels greater
// than n_labels return -1 (caller re-scans with a bigger table).
EXA_API int64_t exa_label_bboxes(const uint32_t* labels, int64_t nz,
                                 int64_t H, int64_t W, int64_t z_off,
                                 int64_t n_labels, int64_t* bbox,
                                 int64_t* counts) {
  for (int64_t z = 0; z < nz; ++z) {
    for (int64_t y = 0; y < H; ++y) {
      for (int64_t x = 0; x < W; ++x) {
        const uint32_t lab = labels[(z * H + y) * W + x];
        if (lab == 0) continue;
        if (static_cast<int64_t>(lab) > n_labels) return -1;
        int64_t* bb = bbox + static_cast<int64_t>(lab) * 6;
        const int64_t gz = z + z_off;
        if (gz < bb[0]) bb[0] = gz;
        if (gz > bb[1]) bb[1] = gz;
        if (y < bb[2]) bb[2] = y;
        if (y > bb[3]) bb[3] = y;
        if (x < bb[4]) bb[4] = x;
        if (x > bb[5]) bb[5] = x;
        ++counts[lab];
      }
    }
  }
  return 0;
}

EXA_API int64_t exa_skel_count(void* handle) {
  return static_cast<Result*>(handle)->skeletons.size();
}

EXA_API uint32_t exa_skel_label(void* handle, int64_t i) {
  return static_cast<Result*>(handle)->skeletons[i].label;
}

EXA_API int64_t exa_skel_nverts(void* handle, int64_t i) {
  return static_cast<Result*>(handle)->skeletons[i].radii.size();
}

EXA_API int64_t exa_skel_nedges(void* handle, int64_t i) {
  return static_cast<Result*>(handle)->skeletons[i].edges.size() / 2;
}

EXA_API void exa_skel_copy(void* handle, int64_t i, double* verts,
                           double* radii, int64_t* edges) {
  const auto& s = static_cast<Result*>(handle)->skeletons[i];
  std::memcpy(verts, s.verts.data(), s.verts.size() * sizeof(double));
  std::memcpy(radii, s.radii.data(), s.radii.size() * sizeof(double));
  std::memcpy(edges, s.edges.data(), s.edges.size() * sizeof(int64_t));
}

EXA_API void exa_skel_free(void* handle) {
  delete static_cast<Result*>(handle);
}
