// Overlap-blend scatter-add of a batch of trimmed patches (kernel K1).
//
// Replaces the TPU kernel `pallas_scatter_batch`
// (aind_exaspim_neuron_segmentation_tpu/ops/experimental/pallas_stitch.py,
// pl.pallas_call at :95, body `_kernel` at :34-64): for i = 0 .. B-1 in
// order,
//
//     acc[:, s_i + trim : s_i + trim + c]  +=  probs[i]
//
// acc (C, D, H, W) f32 is updated in place; probs (B, C, cz, cy, cx) f32;
// starts (B, 3) i32. Patches of one batch may overlap or repeat, and the
// result must equal the sequential loop bit for bit, so no unordered float
// atomics touch a voxel.
//
// Design: walk the output. The wrapper passes the bounding box of the
// batch's cores, [lo, hi), computed on the host from its copy of the
// starts. The box is cut into (z, y) rows of VEC-wide x chunks, and one
// thread takes one chunk, for every channel; no two threads touch one acc
// element, so there is no owner test, no idle thread and no atomic. Which
// patches cover a chunk is a 64-bit mask over the batch: each block first
// builds, in shared memory, the mask of patches whose z and y ranges hold
// each of the (few) rows its chunks lie in; a thread then keeps the bits
// of its row whose x range holds its chunk. It walks the set bits in
// increasing j, loads the acc chunk and the probs chunks of kSlots
// covering patches into registers, adds them in j order -- the loop's
// left-to-right sum, bit for bit -- and stores once. A chunk that no core
// covers is neither read nor written. A launch takes at most 64 patches;
// the wrapper runs a larger batch as consecutive launches, in order.
//
// VEC = 4 when W, cx and every core x origin are multiples of 4: each
// chunk then lies wholly inside or wholly outside every core, and every
// access is one aligned 16-byte float4. VEC = 1 takes any other batch.
//
// Bound: memory bandwidth. One add per probs element; every probs byte is
// read once and every acc byte of the union of the cores read once and
// written once. The main path (B=16 patches of C=3 x 80^3 cores in one
// 4x4 Z row of a 256^3 volume, into 3 x 288^3) moves 98.3 MB of probs and
// 2 x 71.0 MB of acc, 240.35 MB: >= 71.7 us at 3.35 TB/s. To come near it
// a thread issues all its loads, 3 x (1 + up to kSlots) float4, before
// its first add, and 64 registers (vec 4) leave 32 warps per SM: far
// more than the ~18 KB per SM in flight that Little's law asks at ~0.7 us
// of latency. The masks make finding the covering patches cost a few
// instructions per covering patch instead of a scan over the batch. Index
// math is 32-bit (unsigned divisions by the box's row length and height);
// only element offsets are 64-bit.
//
// The caller guarantees 0 <= s + trim and s + trim + c <= dim on every
// axis and fewer than 2^31 chunks in the box (checked on the host), so the
// kernel does no bounds clamping.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBatch = 64;  // patches per launch: one bit each
constexpr int kChannels = 3;   // channels held in registers per pass
constexpr int kSlots = 2;      // covering patches loaded ahead of the adds

template <int VEC>
struct Chunk;

template <>
struct Chunk<1> {
  float v;
  __device__ static Chunk load(const float* p) { return {*p}; }
  __device__ static Chunk load_once(const float* p) { return {__ldg(p)}; }
  __device__ void store(float* p) const { *p = v; }
  __device__ void add(const Chunk& o) { v += o.v; }
};

template <>
struct Chunk<4> {
  float4 v;
  __device__ static Chunk load(const float* p) {
    return {*reinterpret_cast<const float4*>(p)};
  }
  __device__ static Chunk load_once(const float* p) {
    return {__ldg(reinterpret_cast<const float4*>(p))};
  }
  __device__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = v;
  }
  __device__ void add(const Chunk& o) {
    v.x += o.v.x;
    v.y += o.v.y;
    v.z += o.v.z;
    v.w += o.v.w;
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    scatter_blend_kernel(float* __restrict__ acc,
                         const float* __restrict__ probs,
                         const int* __restrict__ starts, int batch,
                         int channels, int dz, int dy, int dx, int cz, int cy,
                         int cx, int trim, int z0, int y0, int x0,
                         unsigned height, unsigned chunks, unsigned total) {
  __shared__ int box[3 * kMaxBatch];  // core origins: start + trim
  __shared__ unsigned long long row_mask[kThreads];
  for (int k = threadIdx.x; k < 3 * batch; k += blockDim.x) {
    box[k] = starts[k] + trim;
  }
  __syncthreads();

  // the rows this block's chunks lie in: at most one per thread
  const unsigned first = blockIdx.x * kThreads;
  const unsigned row0 = first / chunks;
  const unsigned last = min(first + kThreads, total) - 1;
  for (unsigned r = threadIdx.x; r <= last / chunks - row0;
       r += blockDim.x) {
    const unsigned zr = (row0 + r) / height;
    const int gz = z0 + (int)zr;
    const int gy = y0 + (int)(row0 + r - zr * height);
    unsigned long long mask = 0;
    for (int j = 0; j < batch; ++j) {
      if ((unsigned)(gz - box[3 * j]) < (unsigned)cz &&
          (unsigned)(gy - box[3 * j + 1]) < (unsigned)cy) {
        mask |= 1ull << j;
      }
    }
    row_mask[r] = mask;
  }
  __syncthreads();

  const unsigned t = first + threadIdx.x;
  if (t >= total) return;
  const unsigned row = t / chunks;
  const int gx = x0 + (int)(t - row * chunks) * VEC;
  unsigned long long covering = 0;
  for (unsigned long long m = row_mask[row - row0]; m; m &= m - 1) {
    const int j = __ffsll(m) - 1;
    if ((unsigned)(gx - box[3 * j + 2]) < (unsigned)cx) {
      covering |= 1ull << j;
    }
  }
  if (!covering) return;  // no core holds this chunk: leave it untouched

  const unsigned zr = row / height;
  const int gz = z0 + (int)zr;
  const int gy = y0 + (int)(row - zr * height);
  const int64_t plane = (int64_t)dy * dx;
  const int64_t volume = (int64_t)dz * plane;
  const int64_t core = (int64_t)cz * cy * cx;
  const int64_t g = gz * plane + (int64_t)gy * dx + gx;
  for (int c0 = 0; c0 < channels; c0 += kChannels) {
    Chunk<VEC> a[kChannels];
#pragma unroll
    for (int k = 0; k < kChannels; ++k) {
      if (c0 + k < channels) {
        a[k] = Chunk<VEC>::load(acc + (c0 + k) * volume + g);
      }
    }
    for (unsigned long long m = covering; m;) {  // kSlots patches a pass
      Chunk<VEC> p[kSlots][kChannels];
      int n = 0;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (m) {
          const int j = __ffsll(m) - 1;
          m &= m - 1;
          const int64_t local =
              ((int64_t)(gz - box[3 * j]) * cy + (gy - box[3 * j + 1])) *
                  cx +
              (gx - box[3 * j + 2]);
          const float* src =
              probs + ((int64_t)j * channels + c0) * core + local;
#pragma unroll
          for (int k = 0; k < kChannels; ++k) {
            if (c0 + k < channels) {
              p[s][k] = Chunk<VEC>::load_once(src + k * core);
            }
          }
          n = s + 1;
        }
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
#pragma unroll
        for (int k = 0; k < kChannels; ++k) {
          if (s < n && c0 + k < channels) a[k].add(p[s][k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kChannels; ++k) {
      if (c0 + k < channels) a[k].store(acc + (c0 + k) * volume + g);
    }
  }
}

template <int VEC>
int launch(float* acc, const float* probs, const int* starts, int batch,
           int channels, int dz, int dy, int dx, int cz, int cy, int cx,
           int trim, int z0, int y0, int x0, int z1, int y1, int x1,
           cudaStream_t stream) {
  const unsigned height = (unsigned)(y1 - y0);
  const unsigned chunks = (unsigned)(x1 - x0) / VEC;
  const unsigned total = (unsigned)(z1 - z0) * height * chunks;
  if (total == 0) return 0;
  scatter_blend_kernel<VEC>
      <<<(total + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          acc, probs, starts, batch, channels, dz, dy, dx, cz, cy, cx, trim,
          z0, y0, x0, height, chunks, total);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` over the core box [z0, z1) x [y0, y1) x [x0, x1)
// with `vec` x per thread (4 or 1); returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a batch over 64 or another vec.
// The wrapper checks the alignment that vec 4 needs and the box's chunk
// count.
extern "C" int exa_scatter_blend(void* acc, const void* probs,
                                 const void* starts, int batch, int channels,
                                 int dz, int dy, int dx, int cz, int cy,
                                 int cx, int trim, int z0, int y0, int x0,
                                 int z1, int y1, int x1, int vec,
                                 void* stream) {
  if (batch <= 0) return 0;
  if (batch > kMaxBatch || (vec != 4 && vec != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  return (vec == 4 ? launch<4> : launch<1>)(
      (float*)acc, (const float*)probs, (const int*)starts, batch, channels,
      dz, dy, dx, cz, cy, cx, trim, z0, y0, x0, z1, y1, x1,
      (cudaStream_t)stream);
}
