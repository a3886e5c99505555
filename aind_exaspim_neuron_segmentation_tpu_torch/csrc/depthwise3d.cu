// Depthwise k^3 convolution of an NCDHW map: MedNeXt's blocks.
//
// Replaces no TPU kernel: the JAX package has no MedNeXt. It replaces the
// library routes the port ran on the card (a banded grouped 2D conv, ATen's
// conv_depthwise3d, eight stride-1 phases of the transposed conv), which
// ran the 62 depthwise convs of a batch-9 128^3 forward some 56x over
// their least time.
//
// One design, three modes (`ops/depthwise.py` holds the plain version in
// the same index arithmetic), odd k in {3, 5, 7}, padding p = k / 2,
// channel c of the output from channel c of the input alone:
//
//   same        y[o] = sum_t w[t] x[o + t - p]                 (stride 1)
//   down        y[o] = sum_t w[t] x[2o + t - p]                (stride 2)
//   up          y[o] = sum_t w[t] x[(o + p - t) / 2],          (transposed,
//               over the taps t with o + p - t even              stride 2)
//
// on each of D, H and W (the 3D tap is the product), plus the bias;
// x outside the map reads as zero. Output sides: n, (n - 1) / 2 + 1 and
// 2n - 1.
//
// Bound: arithmetic. A batch-9 forward of MedNeXt-L at 128^3 runs 0.738e12
// multiply-adds in its depthwise convs and moves 27.7 GB: 8.3 ms of HBM
// at 3.35 TB/s against 22 ms of float32 FMA at 67 TFLOP/s. So the design
// keeps the FMA pipe busy and makes every other instruction rare:
//
// * A block owns an output tile of H x W (a 2 x 4 patch of outputs a
//   thread) of one (n, c), or of several channels when the map is small
//   (`groups`), and marches along D. Input planes arrive in a ring of
//   kStages shared-memory tiles (haloed, zero outside the map) by
//   16-byte cp.async, two steps ahead of their use.
// * Each thread keeps SLOTS rolling output planes of accumulators in
//   registers. An input plane, loaded once from shared memory (a row of
//   the thread's window a time, in bf16 pairs where the alignment allows),
//   feeds every output plane it reaches through each depth tap: k^3 FMAs
//   an input value at stride 1, all with compile-time register indices.
//   When a plane's last input has been added it gets the bias, is rounded
//   to the output type and stored (8 or 16 bytes a row), and the ring of
//   accumulators rolls on. The transposed mode emits two planes a step,
//   the strided one reads two a step.
// * The k^3 weights of the channel sit in registers for k <= 5 (in
//   shared memory for k = 7, a path only tests take), so a window row's
//   values feed their FMAs with no further load. At k = 5 and stride 1 a
//   step is 1,000 FMAs a thread against 24 shared loads, 48 bf16 unpacks
//   and the fill and store; 219 registers leave 8 warps an SM.
//
// On an H100 this runs the 62 convs of that forward in about 45 ms: the
// stride-1 convs at about half the FMA pipe's peak (the clock holds
// 1980 MHz), the stride-2 and transposed ones (4 % of the arithmetic, 12 %
// of the time) at a fifth of their bounds or less. Going further would
// take the tensor cores: a banded (Toeplitz) bf16 product along W, each A
// fragment reused by the k rolling planes, which this design does not
// attempt.
//
// Float32 accumulation throughout; bf16 or float32 in and out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 3;       // planes in flight: the ring's depth
constexpr int kRows = 2;         // output rows (H) a thread
constexpr int kCols = 4;         // output columns (W) a thread
constexpr int kMaxThreadsW = 32; // threads along W in a tile
constexpr int kMaxSmem = 200 * 1024;

enum { kSame = 0, kDown = 1, kUp = 2 };

__host__ __device__ constexpr int floor_half(int a) {
  return a >= 0 ? a / 2 : -((1 - a) / 2);
}

template <int MODE, int K>
struct Geo {
  static constexpr int P = K / 2;
  // H and W: the offset in a thread's input window that output r (of the
  // thread's run along the axis) reads through tap t, or -1 where the
  // transposed mode's parity rule skips the tap
  __host__ __device__ static constexpr int tap(int r, int t) {
    return MODE == kSame   ? r + t
           : MODE == kDown ? 2 * r + t
           : ((r + P - t) & 1) ? -1
                               : (r + P - t) / 2 + P / 2;
  }
  // input voxels a run of R outputs reads, and the input shift from one
  // run to the next
  __host__ __device__ static constexpr int window(int R) {
    return MODE == kSame   ? R + K - 1
           : MODE == kDown ? 2 * R + K - 2
                           : (R - 1 + P) / 2 + P / 2 + 1;
  }
  __host__ __device__ static constexpr int shift(int R) {
    return MODE == kSame ? R : MODE == kDown ? 2 * R : R / 2;
  }
  // first input voxel of the window of output o (o even when transposed)
  __host__ __device__ static int start(int o) {
    return MODE == kSame ? o - P : MODE == kDown ? 2 * o - P : o / 2 - P / 2;
  }
  // D: input planes read and output planes finished a step, the rolling
  // output planes, and the first output plane step 0 finishes
  static constexpr int SI = MODE == kDown ? 2 : 1;
  static constexpr int SO = MODE == kUp ? 2 : 1;
  static constexpr int SLOTS = MODE == kDown ? P + 1 : K;
  static constexpr int OFF = MODE == kDown ? floor_half(1 - P) : -P;
  // the rolling slot that input plane j of a step reaches through depth
  // tap t (slot q holds output plane SO * step + OFF + q), or -1
  __host__ __device__ static constexpr int slot(int j, int t) {
    return MODE == kSame   ? K - 1 - t
           : MODE == kDown ? (((j + P - t) & 1) ? -1 : (j + P - t) / 2 - OFF)
                           : t;
  }
  // bf16 windows start on an even element (4-byte pairs) when the tile's
  // first input column does: tiles start at W = 0 or a multiple of 128
  static constexpr bool EVEN = ((MODE == kUp ? P / 2 : P) & 1) == 0;
};

struct Args {
  const void* x;
  const void* w;
  const void* b;
  void* y;
  int nc, C, D, H, W, Do, Ho, Wo;
  int tx, ty, groups, tiles_w, rows, cols, steps, vec;
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerChunk = 4;
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static float smem(const float* p) { return *p; }
  __device__ static void store4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static void store1(float* p, float v) { *p = v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerChunk = 8;
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  __device__ static float smem(const __nv_bfloat16* p) {
    return __uint_as_float(
        static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
  }
  __device__ static void store4(__nv_bfloat16* p, const float (&v)[4]) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
  __device__ static void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// N values of a shared-memory row from p, as float
template <typename T, int N, bool PAIRS>
__device__ __forceinline__ void load_window(const T* p, float (&v)[N]) {
  if constexpr (PAIRS) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int m = 0; m < (N + 1) / 2; ++m) {
      const uint32_t u = q[m];
      v[2 * m] = __uint_as_float(u << 16);
      if (2 * m + 1 < N) v[2 * m + 1] = __uint_as_float(u & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int m = 0; m < N; ++m) v[m] = Elem<T>::smem(p + m);
  }
}

// Add input plane J of a step (the thread's window at p, row pitch cols)
// into the rolling accumulators, through every depth tap that reaches one.
template <int MODE, int K, typename T, int J>
__device__ __forceinline__ void accumulate(
    const T* p, int cols, const float* wt,
    float (&acc)[Geo<MODE, K>::SLOTS][kRows][kCols]) {
  using G = Geo<MODE, K>;
  constexpr int NH = G::window(kRows);
  constexpr int NW = G::window(kCols);
  constexpr bool PAIRS = G::EVEN && sizeof(T) == 2;
#pragma unroll
  for (int a = 0; a < NH; ++a) {
    float v[NW];
    load_window<T, NW, PAIRS>(p + a * cols, v);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
        if (G::tap(r, kh) != a) continue;
#pragma unroll
        for (int kd = 0; kd < K; ++kd) {
          const int q = G::slot(J, kd);
          if (q < 0) continue;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
#pragma unroll
            for (int kw = 0; kw < K; ++kw) {
              const int b = G::tap(c, kw);
              if (b < 0) continue;
              acc[q][r][c] =
                  fmaf(wt[(kd * K + kh) * K + kw], v[b], acc[q][r][c]);
            }
          }
        }
      }
    }
  }
}

template <int MODE, int K, typename T>
__global__ void __launch_bounds__(kThreads, 2) depthwise3d_kernel(Args a) {
  using G = Geo<MODE, K>;
  constexpr int EPC = Elem<T>::kPerChunk;
  constexpr int K3 = K * K * K;
  constexpr bool WREG = K <= 5;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w = static_cast<const T*>(a.w);
  const T* __restrict__ bias = static_cast<const T*>(a.b);
  T* __restrict__ y = static_cast<T*>(a.y);

  const int tid = threadIdx.x;
  const int per_group = a.tx * a.ty;
  int g = tid / per_group;
  const int lt = tid - g * per_group;
  const int tx = lt % a.tx, ty = lt / a.tx;
  const bool in_group = g < a.groups;
  if (!in_group) g = 0;  // idle threads read group 0's tile, store nothing
  const int nc = blockIdx.y * a.groups + g;
  const bool active = in_group && nc < a.nc;
  const int c = (nc < a.nc ? nc : 0) % a.C;

  const int tile_h = blockIdx.x / a.tiles_w;
  const int tile_w = blockIdx.x - tile_h * a.tiles_w;
  const int h0 = (tile_h * a.ty + ty) * kRows;  // the thread's outputs
  const int w0 = (tile_w * a.tx + tx) * kCols;
  const int in_h0 = G::start(tile_h * a.ty * kRows);  // the tile's input
  const int in_w0 = G::start(tile_w * a.tx * kCols);
  const int lead = in_w0 & (EPC - 1);  // smem column of input in_w0
  const int gw0 = in_w0 - lead;        // input column of smem column 0
  const int plane = a.rows * a.cols;   // a group's tile of one plane
  const int stage = G::SI * a.groups * plane;

  float wr[WREG ? K3 : 1];
  float* wsm = reinterpret_cast<float*>(
      smem_raw + static_cast<size_t>(kStages) * stage * sizeof(T));
  if constexpr (WREG) {
#pragma unroll
    for (int i = 0; i < K3; ++i) wr[i] = Elem<T>::load(w + c * K3 + i);
  } else {
    if (in_group) {
      for (int i = lt; i < K3; i += per_group) {
        wsm[g * K3 + i] = Elem<T>::load(w + c * K3 + i);
      }
    }
  }
  const float* wg = wsm + g * K3;
  const float b = bias != nullptr ? Elem<T>::load(bias + c) : 0.f;

  // The fill: chunk column fc of rows fr, fr + fstride, ... of a stage's
  // SI x groups x rows tile rows; row fr is row fy0 of plane x group fjg0.
  const int chunks = a.cols / EPC;
  const int fstride = kThreads / chunks;
  const int fc = tid % chunks;
  const int fr = tid / chunks;
  const int fy0 = fr % a.rows, fjg0 = fr / a.rows;
  const int frows = G::SI * a.groups * a.rows;
  const int fgw = gw0 + fc * EPC;
  const bool fcol_in = fgw >= 0 && fgw + EPC <= a.W;
  const bool fcol_out = fgw + EPC <= 0 || fgw >= a.W;
  auto fill = [&](int t) {
    if (t >= a.steps || fr >= fstride) return;
    T* dst = ring + (t % kStages) * stage + fr * a.cols + fc * EPC;
    int yy = fy0, jg = fjg0;  // row, plane x groups + group
    for (int r = fr; r < frows; r += fstride, dst += fstride * a.cols) {
      const int j = G::SI == 2 && jg >= a.groups ? 1 : 0;
      const int i = G::SI * t + j;
      const int n = blockIdx.y * a.groups + jg - j * a.groups;
      const int h = in_h0 + yy;
      if (i < a.D) {
        const bool row_in = n < a.nc && h >= 0 && h < a.H;
        const T* src =
            x + (static_cast<int64_t>(n * a.D + i) * a.H + h) * a.W + fgw;
        if (row_in && a.vec && fcol_in) {
          cp_async16(dst, src);
        } else if (!row_in || fcol_out) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        } else {
#pragma unroll
          for (int e = 0; e < EPC; ++e) {
            const int ww = fgw + e;
            dst[e] = (ww >= 0 && ww < a.W) ? src[e] : T(0.f);
          }
        }
      }
      yy += fstride;
      while (yy >= a.rows) {
        yy -= a.rows;
        ++jg;
      }
    }
  };

  // the thread's window in its group's tile, and its outputs
  const int own = g * plane + ty * G::shift(kRows) * a.cols + lead +
                  tx * G::shift(kCols);
  const int64_t out_plane = static_cast<int64_t>(a.Ho) * a.Wo;
  T* const yt = y + static_cast<int64_t>(nc) * a.Do * out_plane +
                static_cast<int64_t>(h0) * a.Wo + w0;
  const bool whole = w0 + kCols <= a.Wo && a.Wo % kCols == 0;

  float acc[G::SLOTS][kRows][kCols];
#pragma unroll
  for (int q = 0; q < G::SLOTS; ++q)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) acc[q][r][cc] = 0.f;

  // one step: the SI input planes of step s in, the SO finished output
  // planes out, the accumulators rolled on
  auto step = [&](int s) {
    const T* p = ring + (s % kStages) * stage + own;
    if (G::SI * s < a.D) {
      if constexpr (WREG) {
        accumulate<MODE, K, T, 0>(p, a.cols, wr, acc);
      } else {
        accumulate<MODE, K, T, 0>(p, a.cols, wg, acc);
      }
    }
    if constexpr (G::SI == 2) {
      if (G::SI * s + 1 < a.D) {
        const T* p1 = p + a.groups * plane;
        if constexpr (WREG) {
          accumulate<MODE, K, T, 1>(p1, a.cols, wr, acc);
        } else {
          accumulate<MODE, K, T, 1>(p1, a.cols, wg, acc);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < G::SO; ++e) {
      const int o = G::SO * s + G::OFF + e;
      if (!active || o < 0 || o >= a.Do) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (h0 + r >= a.Ho) continue;
        T* dst = yt + o * out_plane + r * a.Wo;
        float v[kCols];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) v[cc] = acc[e][r][cc] + b;
        if (whole) {
          Elem<T>::store4(dst, v);
        } else {
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            if (w0 + cc < a.Wo) Elem<T>::store1(dst + cc, v[cc]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < G::SLOTS; ++q)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          acc[q][r][cc] = q < G::SLOTS - G::SO
                              ? acc[q < G::SLOTS - G::SO ? q + G::SO : 0][r][cc]
                              : 0.f;
  };

  // a barrier a step; planes land kStages - 1 steps ahead of their use
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    fill(t);
    cp_async_commit();
  }
  for (int s = 0; s < a.steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    fill(s + kStages - 1);
    cp_async_commit();
    step(s);
  }
  cp_async_wait<0>();
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

template <int MODE, int K, typename T>
int launch(Args a, cudaStream_t stream) {
  using G = Geo<MODE, K>;
  constexpr int EPC = Elem<T>::kPerChunk;
  a.tx = pow2_at_least((a.Wo + kCols - 1) / kCols);
  if (a.tx > kMaxThreadsW) a.tx = kMaxThreadsW;
  a.ty = pow2_at_least((a.Ho + kRows - 1) / kRows);
  if (a.ty > kThreads / a.tx) a.ty = kThreads / a.tx;
  a.tiles_w = (a.Wo + a.tx * kCols - 1) / (a.tx * kCols);
  const int tiles_h = (a.Ho + a.ty * kRows - 1) / (a.ty * kRows);
  a.rows = (a.ty - 1) * G::shift(kRows) + G::window(kRows);
  // room for the lead (< EPC) and one element past the last window
  a.cols = ((a.tx - 1) * G::shift(kCols) + G::window(kCols) + 2 * EPC - 1) /
           EPC * EPC;
  if (a.cols / EPC > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t per_group =
      static_cast<size_t>(kStages) * G::SI * a.rows * a.cols * sizeof(T) +
      (K > 5 ? K * K * K * sizeof(float) : 0);
  a.groups = kThreads / (a.tx * a.ty);
  if (static_cast<size_t>(a.groups) * per_group > kMaxSmem) {
    a.groups = static_cast<int>(kMaxSmem / per_group);
  }
  if (a.groups < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks_y = (a.nc + a.groups - 1) / a.groups;
  if (blocks_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  a.steps = (a.Do - G::SO - G::OFF + G::SO - 1) / G::SO + 1;
  const size_t smem = a.groups * per_group;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        depthwise3d_kernel<MODE, K, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  depthwise3d_kernel<MODE, K, T>
      <<<dim3(tiles_h * a.tiles_w, blocks_y), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, typename T>
int launch_k(const Args& a, int k, cudaStream_t stream) {
  switch (k) {
    case 3:
      return launch<MODE, 3, T>(a, stream);
    case 5:
      return launch<MODE, 5, T>(a, stream);
    case 7:
      return launch<MODE, 7, T>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_mode(const Args& a, int mode, int k, cudaStream_t stream) {
  switch (mode) {
    case kSame:
      return launch_k<kSame, T>(a, k, stream);
    case kDown:
      return launch_k<kDown, T>(a, k, stream);
    case kUp:
      return launch_k<kUp, T>(a, k, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (n, c, d, h, w), weight (c, 1, k, k, k), bias (c) or null, y the
// output of the mode's sides, all contiguous and of one type (bf16 when
// `bf16`, else float32). `vec`: x's rows may be copied in aligned 16-byte
// chunks (w a multiple of 16 bytes' worth, x 16-byte aligned). Returns 0
// or the CUDA error of the launch.
extern "C" int exa_depthwise3d(const void* x, const void* weight,
                               const void* bias, void* y, int mode, int k,
                               int bf16, int n, int c, int d, int h, int w,
                               int vec, void* stream) {
  if (n <= 0 || c <= 0 || d <= 0 || h <= 0 || w <= 0) return 0;
  Args a{};
  a.x = x;
  a.w = weight;
  a.b = bias;
  a.y = y;
  a.nc = n * c;
  a.C = c;
  a.D = d;
  a.H = h;
  a.W = w;
  auto side = [mode](int s) {
    return mode == kSame ? s : mode == kDown ? (s - 1) / 2 + 1 : 2 * s - 1;
  };
  a.Do = side(d);
  a.Ho = side(h);
  a.Wo = side(w);
  a.vec = vec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_mode<__nv_bfloat16>(a, mode, k, s)
              : launch_mode<float>(a, mode, k, s);
}
