#pragma once
#include <cstdint>

namespace exa {
// cap_face: 6 flags (z0, z1, y0, y1, x0, x1) selecting which volume
// faces act as background; nullptr = all faces capped.
void edt_sq(const uint8_t* mask, int64_t D, int64_t H, int64_t W,
            float wz, float wy, float wx, float* out,
            const uint8_t* cap_face = nullptr);
}  // namespace exa
