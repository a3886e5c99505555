// Exact anisotropic Euclidean distance transform (squared), 3D.
//
// Felzenszwalb & Huttenlocher separable lower-envelope algorithm with
// per-axis spacing weights; distance of each foreground voxel to the
// nearest background voxel.
//
// Volume faces: interior component-bbox faces always count as boundary
// (a tight bbox guarantees non-component voxels just outside), but
// faces lying on the *global* volume border only count as boundary when
// the caller requests it (kimimaro's black_border semantics: open faces
// for multi-label volumes, closed for single-label ones). Controlled by
// the per-face cap flags.

#include <algorithm>
#include <cstdint>
#include <limits>
#include <vector>

#include "common.hpp"

namespace {

constexpr float kInf = std::numeric_limits<float>::max() / 4;

// 1D squared-distance transform with spacing w: out[i] =
// min_j (f[j] + w^2 (i-j)^2). In-place over a strided row.
//
// Infinite parabolas (uninitialized foreground) can push intersections
// below the z[0] sentinel for small w, so the envelope pop guards k > 0
// and replaces the root parabola instead of decrementing past it
// (unguarded versions read v[-1] for spacings < sqrt(0.5)).
void dt1d(float* f, int64_t n, int64_t stride, float w,
          std::vector<float>& z, std::vector<int64_t>& v,
          std::vector<float>& scratch) {
  const float w2 = w * w;
  v.assign(n, 0);
  z.assign(n + 1, 0.0f);
  scratch.resize(n);
  for (int64_t i = 0; i < n; ++i) scratch[i] = f[i * stride];

  auto intersect = [&](int64_t q, int64_t p) {
    return (scratch[q] + w2 * q * q - (scratch[p] + w2 * p * p)) /
           (2 * w2 * (q - p));
  };

  int64_t k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int64_t q = 1; q < n; ++q) {
    float s = intersect(q, v[k]);
    bool replaced_root = false;
    while (s <= z[k]) {
      if (k == 0) {
        v[0] = q;  // q dominates everywhere: new root parabola
        replaced_root = true;
        break;
      }
      --k;
      s = intersect(q, v[k]);
    }
    if (replaced_root) {
      z[1] = kInf;
      continue;
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = kInf;
  }
  k = 0;
  for (int64_t q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    const int64_t p = v[k];
    f[q * stride] = w2 * (q - p) * (q - p) + scratch[p];
  }
}

}  // namespace

namespace exa {

// mask: 1 = foreground. out: squared physical distance to the nearest
// background voxel center. cap_face: 6 flags (z0, z1, y0, y1, x0, x1)
// -- when set, the corresponding volume face acts as background at one
// spacing unit beyond the edge; when clear the face is open.
void edt_sq(const uint8_t* mask, int64_t D, int64_t H, int64_t W,
            float wz, float wy, float wx, float* out,
            const uint8_t* cap_face) {
  const int64_t N = D * H * W;
  for (int64_t i = 0; i < N; ++i) out[i] = mask[i] ? kInf : 0.0f;

  std::vector<float> z;
  std::vector<int64_t> v;
  std::vector<float> scratch;

  for (int64_t zi = 0; zi < D; ++zi)
    for (int64_t yi = 0; yi < H; ++yi)
      dt1d(out + (zi * H + yi) * W, W, 1, wx, z, v, scratch);
  for (int64_t zi = 0; zi < D; ++zi)
    for (int64_t xi = 0; xi < W; ++xi)
      dt1d(out + zi * H * W + xi, H, W, wy, z, v, scratch);
  for (int64_t yi = 0; yi < H; ++yi)
    for (int64_t xi = 0; xi < W; ++xi)
      dt1d(out + yi * W + xi, D, H * W, wz, z, v, scratch);

  const uint8_t all_faces[6] = {1, 1, 1, 1, 1, 1};
  const uint8_t* cap = cap_face ? cap_face : all_faces;
  for (int64_t zi = 0; zi < D; ++zi) {
    for (int64_t yi = 0; yi < H; ++yi) {
      for (int64_t xi = 0; xi < W; ++xi) {
        const int64_t i = (zi * H + yi) * W + xi;
        if (!mask[i]) continue;
        float b = kInf;
        if (cap[0]) b = std::min(b, wz * (zi + 1));
        if (cap[1]) b = std::min(b, wz * (D - zi));
        if (cap[2]) b = std::min(b, wy * (yi + 1));
        if (cap[3]) b = std::min(b, wy * (H - yi));
        if (cap[4]) b = std::min(b, wx * (xi + 1));
        if (cap[5]) b = std::min(b, wx * (W - xi));
        if (b < kInf) out[i] = std::min(out[i], b * b);
      }
    }
  }
}

}  // namespace exa

EXA_API void exa_edt_sq(const uint8_t* mask, int64_t D, int64_t H,
                        int64_t W, float wz, float wy, float wx,
                        float* out) {
  exa::edt_sq(mask, D, H, W, wz, wy, wx, out, nullptr);
}
