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
// Design: owner computes, one launch per batch. Thread (i, core voxel v)
// maps to global voxel g = s_i + trim + v. It acts only when i is the
// lowest-index patch of the batch that covers g; it then reads acc[:, g]
// once, adds probs[j] for every covering j >= i in increasing j -- the
// same left-to-right sum as the loop -- and writes once. Every voxel of
// the union of the batch's cores therefore has exactly one owner. The
// batch's box origins sit in shared memory, loaded by each block itself.
//
// Bound: memory bandwidth. The kernel does one add per probs element and
// moves every probs byte once plus every acc byte of the union of the
// cores twice (read, write). The main path (B=16 patches of C=3 x 80^3 in
// one 4x4 row of a 256^3 volume) moves 98.3 MB of probs and 2 x 71.0 MB
// of acc: >= ~72 us at 3.35 TB/s. Neighbouring threads take neighbouring
// x, so every load and store is coalesced; the non-owner threads of the
// overlaps exit after a few integer compares.
//
// The caller guarantees 0 <= s + trim and s + trim + c <= dim on every
// axis (checked on the host), so the kernel does no bounds clamping.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ bool covers(const int* box, int j, int gz, int gy,
                                       int gx, int cz, int cy, int cx) {
  return (unsigned)(gz - box[3 * j]) < (unsigned)cz &&
         (unsigned)(gy - box[3 * j + 1]) < (unsigned)cy &&
         (unsigned)(gx - box[3 * j + 2]) < (unsigned)cx;
}

__global__ void scatter_blend_kernel(float* __restrict__ acc,
                                     const float* __restrict__ probs,
                                     const int* __restrict__ starts,
                                     int batch, int channels, int dz, int dy,
                                     int dx, int cz, int cy, int cx,
                                     int trim) {
  extern __shared__ int box[];  // (batch, 3) core origins: start + trim
  for (int k = threadIdx.x; k < 3 * batch; k += blockDim.x) {
    box[k] = starts[k] + trim;
  }
  __syncthreads();

  const int i = blockIdx.y;
  const int64_t core = (int64_t)cz * cy * cx;
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= core) return;
  const int x = (int)(v % cx);
  const int y = (int)((v / cx) % cy);
  const int z = (int)(v / ((int64_t)cy * cx));
  const int gz = box[3 * i] + z;
  const int gy = box[3 * i + 1] + y;
  const int gx = box[3 * i + 2] + x;

  for (int j = 0; j < i; ++j) {
    if (covers(box, j, gz, gy, gx, cz, cy, cx)) return;  // not the owner
  }

  const int64_t plane = (int64_t)dy * dx;
  const int64_t volume = (int64_t)dz * plane;
  const int64_t g = gz * plane + (int64_t)gy * dx + gx;
  for (int ch = 0; ch < channels; ++ch) {
    float sum = acc[ch * volume + g];
    for (int j = i; j < batch; ++j) {
      if (!covers(box, j, gz, gy, gx, cz, cy, cx)) continue;
      const int64_t local = ((int64_t)(gz - box[3 * j]) * cy +
                             (gy - box[3 * j + 1])) * cx +
                            (gx - box[3 * j + 2]);
      sum += probs[((int64_t)j * channels + ch) * core + local];
    }
    acc[ch * volume + g] = sum;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The
// wrapper checks batch <= 4096 (48 KB of shared memory for the boxes) and
// batch <= 65535 grid rows.
extern "C" int exa_scatter_blend(void* acc, const void* probs,
                                 const void* starts, int batch, int channels,
                                 int dz, int dy, int dx, int cz, int cy,
                                 int cx, int trim, void* stream) {
  if (batch <= 0) return 0;
  const int threads = 256;
  const int64_t core = (int64_t)cz * cy * cx;
  const dim3 grid((unsigned)((core + threads - 1) / threads),
                  (unsigned)batch);
  const size_t smem = (size_t)batch * 3 * sizeof(int);
  scatter_blend_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (float*)acc, (const float*)probs, (const int*)starts, batch, channels,
      dz, dy, dx, cz, cy, cx, trim);
  return (int)cudaGetLastError();
}
