// Selective scan of SegMamba's Mamba layers: one direction of a token-major
// map, in one of three orders.
//
// Replaces no TPU kernel: the JAX package has no SegMamba, and no op of
// torch or cuDNN computes a selective scan. `ops/selective_scan.py` holds
// the plain version (the kernel's CPU path and oracle).
//
// A Mamba layer of d inner channels over L tokens (W fastest, then H, D)
// scans each channel c with N = 16 states, in a direction's order of the
// tokens (position p -> token tok(p)):
//
//   forward   tok(p) = p
//   backward  tok(p) = L - 1 - p
//   slice     tok(p) = (p % S) HW + p / S     (S depth slices of HW tokens:
//             the scan runs along depth at each (h, w), then moves on)
//
// Two kernels per direction, each indexing one token-major buffer through
// tok(p), so no reordered copy is ever made:
//
// * scan_conv: u = SiLU(b + sum_j w[j] x[tok(p - 3 + j)]), the causal
//   depthwise conv of kernel 4 in the direction's order (zero before p =
//   0), from the x half of in_proj's output xz (B, L, 2d). x_proj then
//   runs as a GEMM on u (B, L, d) outside the kernels, giving dbl
//   (B, L, R + 2N): the rank-R delta, B and C of every token.
// * the scan, float32 throughout (delta, A, the state h, the exp):
//     delta = softplus(dt_b[c] + sum_r dt_w[c, r] dbl[r])
//     h[n]  = exp(delta A[c, n]) h[n] + delta B[n] u[c]
//     y     = sum_n C[n] h[n] + D[c] u[c]
//   run as a chunked scan along the sequence: the sequence is cut into
//   chunks of `chunk` positions; (1) every chunk is scanned from a zero
//   state, keeping its end state and its summed delta (the chunk's decay
//   is exp(A sum delta)); (2) one thread a (batch, state, channel) walks the
//   chunks in order and turns the end states into the state entering each
//   chunk; (3) every chunk is scanned again from that state, now writing y.
//   y is written (mode 0), added to a float32 accumulator (mode 1), or
//   added to it and gated, (acc + y) SiLU(z), into the output in the
//   activation type (mode 2). The gate is elementwise per token, so gating
//   the three directions' sum once equals gating each direction's y in its
//   own order.
//
// Work: a thread owns one channel of one chunk and walks its positions with
// 16 states in registers; the warp's 32 channels read one token's u (one
// coalesced row), and the chunk's dbl rows are staged in shared memory as
// float32, a stage of 32 positions at a time, where every thread reads the
// same B and C (broadcast). A step is 16 exp2 on the special-function unit
// (16 results a clock an SM), about 50 float32 FMA-pipe operations and one
// softplus (two more), and the chunk scan runs twice: the special-function
// unit bounds this design, at about 2 ms a direction at stage 0's shape
// (batch 9, 96 inner channels, 262,144 tokens), where a layer's three
// directions move 0.4 ms of HBM bytes at least (xz read once, y written
// once). On an H100 such a direction takes about 4.3 ms with chunks of 256
// positions, 45 % of the design's limit; chunks of 128 to 1,024, u staged
// in shared memory, loads batched ahead of their use, two steps unrolled,
// 64-position stages and a cap of 64 registers all ran within 3 % of it or
// slower. The conv walks 16 positions a thread with the last three inputs
// in registers. bf16 or float32 in and out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;      // states a channel (d_state)
constexpr int kConv = 4;    // conv taps (d_conv)
constexpr int kStage = 32;  // positions of dbl staged at a time
constexpr int kForward = 0, kBackward = 1, kSlice = 2;
constexpr int kWrite = 0, kAdd = 1, kGate = 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float silu(float x) {
  return __fdividef(x, 1.f + __expf(-x));
}

__device__ __forceinline__ float softplus(float x) {
  return x <= 20.f ? log1pf(__expf(x)) : x;
}

// The token at position p of the order (p in [0, L)).
__device__ __forceinline__ int token_of(int order, int p, int L, int S,
                                        int HW) {
  if (order == kForward) return p;
  if (order == kBackward) return L - 1 - p;
  return (p % S) * HW + p / S;
}

// Walks the tokens of consecutive positions of the order.
struct Walk {
  int order, L, S, HW, tok, s;
  __device__ Walk(int order_, int L_, int S_, int HW_, int p)
      : order(order_), L(L_), S(S_), HW(HW_) {
    tok = token_of(order, p, L, S, HW);
    s = p % S;
  }
  __device__ __forceinline__ void next() {
    if (order == kForward) {
      ++tok;
    } else if (order == kBackward) {
      --tok;
    } else if (++s == S) {  // on to the next (h, w), slice 0
      s = 0;
      tok -= (S - 1) * HW - 1;
    } else {
      tok += HW;
    }
  }
};

// ---- the causal conv of the order, SiLU out --------------------------------

constexpr int kRun = 16;  // positions a thread of the conv

// A thread: 16 bytes of channels of kRun consecutive positions, the last
// three inputs kept in registers.
template <typename T>
__global__ void scan_conv_kernel(const T* __restrict__ xz,
                                 const float* __restrict__ w,
                                 const float* __restrict__ bias,
                                 T* __restrict__ u, int batch, int L, int d,
                                 int order, int S, int HW) {
  constexpr int V = 16 / sizeof(T);
  const int groups = d / V;
  const int runs = (L + kRun - 1) / kRun;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= static_cast<long long>(batch) * runs * groups) return;
  const int g = static_cast<int>(i % groups);
  const int run = static_cast<int>(i / groups);
  const long long row0 = static_cast<long long>(run / runs) * L;
  const int p0 = (run % runs) * kRun;
  const int c0 = g * V;
  float wt[kConv][V], b[V], win[kConv - 1][V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    b[v] = bias[c0 + v];
#pragma unroll
    for (int j = 0; j < kConv; ++j) wt[j][v] = w[(c0 + v) * kConv + j];
#pragma unroll
    for (int j = 0; j < kConv - 1; ++j) win[j][v] = 0.f;
  }
  const int first = max(p0 - (kConv - 1), 0);
  Walk walk(order, L, S, HW, first);
  const int p1 = min(p0 + kRun, L);
  for (int p = first; p < p1; ++p, walk.next()) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        xz + (row0 + walk.tok) * 2 * d + c0);
    const T* x = reinterpret_cast<const T*>(&raw);
    float now[V];
#pragma unroll
    for (int v = 0; v < V; ++v) now[v] = to_f(x[v]);
    if (p >= p0) {
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float acc = fmaf(wt[kConv - 1][v], now[v], b[v]);
#pragma unroll
        for (int j = 0; j < kConv - 1; ++j)
          acc = fmaf(wt[j][v], win[j][v], acc);
        o[v] = from_f<T>(silu(acc));
      }
      *reinterpret_cast<uint4*>(u + (row0 + walk.tok) * d + c0) = out;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int j = 0; j < kConv - 2; ++j) win[j][v] = win[j + 1][v];
      win[kConv - 2][v] = now[v];
    }
  }
}

// ---- the chunk scans -------------------------------------------------------

struct ScanArgs {
  const void* u;      // (B, L, d)
  const void* dbl;    // (B, L, E), E = R + 2N: delta_r, B, C
  const float* dtw;   // (d, R)
  const float* dtb;   // (d)
  const float* A2;    // (d, N): A log2(e), A = -exp(A_log)
  const float* Dv;    // (d)
  const void* xz;     // (B, L, 2d): z = xz + d (mode 2)
  float* acc;         // (B, L, d)
  void* out;          // (B, L, d) (mode 2)
  float* states;      // (B, nc, N, d): end states, then entering states
  float* sums;        // (B, nc, d): summed delta of each chunk
  int batch, L, d, R, order, S, HW, chunk, nc;
};

// One block: `blockDim.x` channels of one (batch, chunk). FINAL: the
// second scan (from the entering state, writing y); else the first (from
// zero, writing the end state and the summed delta).
template <typename T, bool FINAL, int MODE>
__global__ void __launch_bounds__(128) chunk_scan_kernel(ScanArgs a) {
  extern __shared__ float smem[];
  const int Rp = (a.R + 3) & ~3;
  const int Ep = Rp + 2 * kN;         // a staged row: delta_r | B | C
  float* rows = smem;                 // [kStage][Ep]
  float* wts = rows + kStage * Ep;    // [R][blockDim.x]
  int* toks = reinterpret_cast<int*>(wts + a.R * blockDim.x);  // [kStage]

  const int k = blockIdx.x % a.nc;
  const int b = blockIdx.x / a.nc;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = c < a.d;
  const int E = a.R + 2 * kN;
  const int p0 = k * a.chunk;
  const int p1 = min(p0 + a.chunk, a.L);
  const long long row0 = static_cast<long long>(b) * a.L;
  const T* u = static_cast<const T*>(a.u);
  const T* dbl = static_cast<const T*>(a.dbl);

  for (int r = 0; r < a.R; ++r)
    wts[r * blockDim.x + threadIdx.x] = live ? a.dtw[c * a.R + r] : 0.f;
  float A2[kN], h[kN];
  const float dtb = live ? a.dtb[c] : 0.f;
  const float Dc = live ? a.Dv[c] : 0.f;
  const long long sidx =
      ((static_cast<long long>(b) * a.nc + k) * kN) * a.d + c;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    A2[n] = live ? a.A2[c * kN + n] : 0.f;
    h[n] = (FINAL && live && k > 0)  // the first chunk enters from zero
               ? a.states[sidx + static_cast<long long>(n) * a.d]
               : 0.f;
  }
  float dsum = 0.f;

  for (int q0 = p0; q0 < p1; q0 += kStage) {
    const int steps = min(kStage, p1 - q0);
    __syncthreads();  // the last stage's rows and tokens are read
    for (int j = threadIdx.x; j < steps; j += blockDim.x)
      toks[j] = token_of(a.order, q0 + j, a.L, a.S, a.HW);
    __syncthreads();
    for (int i = threadIdx.x; i < steps * E; i += blockDim.x) {
      const int j = i / E, e = i - j * E;
      const float v = to_f(dbl[(row0 + toks[j]) * E + e]);
      rows[j * Ep + (e < a.R ? e : e - a.R + Rp)] = v;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < steps; ++j) {
      const float* row = rows + j * Ep;
      const long long at = (row0 + toks[j]) * a.d + c;
      float dr = dtb;
      for (int r = 0; r < a.R; ++r)
        dr = fmaf(wts[r * blockDim.x + threadIdx.x], row[r], dr);
      const float delta = softplus(dr);
      const float uv = to_f(u[at]);
      const float du = delta * uv;
      const float4* Bq = reinterpret_cast<const float4*>(row + Rp);
#pragma unroll
      for (int q = 0; q < kN / 4; ++q) {
        const float4 bb = Bq[q];
        h[4 * q + 0] = fmaf(ex2(delta * A2[4 * q + 0]), h[4 * q + 0],
                            du * bb.x);
        h[4 * q + 1] = fmaf(ex2(delta * A2[4 * q + 1]), h[4 * q + 1],
                            du * bb.y);
        h[4 * q + 2] = fmaf(ex2(delta * A2[4 * q + 2]), h[4 * q + 2],
                            du * bb.z);
        h[4 * q + 3] = fmaf(ex2(delta * A2[4 * q + 3]), h[4 * q + 3],
                            du * bb.w);
      }
      if (FINAL) {
        const float4* Cq = reinterpret_cast<const float4*>(row + Rp + kN);
        float y0 = Dc * uv, y1 = 0.f;
#pragma unroll
        for (int q = 0; q < kN / 4; ++q) {
          const float4 cc = Cq[q];
          y0 = fmaf(cc.x, h[4 * q + 0], y0);
          y1 = fmaf(cc.y, h[4 * q + 1], y1);
          y0 = fmaf(cc.z, h[4 * q + 2], y0);
          y1 = fmaf(cc.w, h[4 * q + 3], y1);
        }
        const float y = y0 + y1;
        if (MODE == kWrite) {
          a.acc[at] = y;
        } else if (MODE == kAdd) {
          a.acc[at] += y;
        } else {
          const T* xz = static_cast<const T*>(a.xz);
          const float zv = to_f(xz[(row0 + toks[j]) * 2 * a.d + a.d + c]);
          static_cast<T*>(a.out)[at] = from_f<T>((a.acc[at] + y) * silu(zv));
        }
      } else {
        dsum += delta;
      }
    }
  }
  if (!FINAL && live) {
#pragma unroll
    for (int n = 0; n < kN; ++n)
      a.states[sidx + static_cast<long long>(n) * a.d] = h[n];
    a.sums[(static_cast<long long>(b) * a.nc + k) * a.d + c] = dsum;
  }
}

// One thread a (batch, state, channel): the state entering each chunk, in
// place of the chunk's end state.
__global__ void chunk_carry_kernel(ScanArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= static_cast<long long>(a.batch) * kN * a.d) return;
  const int c = static_cast<int>(i % a.d);
  const int n = static_cast<int>((i / a.d) % kN);
  const int b = static_cast<int>(i / (static_cast<long long>(a.d) * kN));
  const float A2 = a.A2[c * kN + n];
  float carry = 0.f;
  constexpr int kAhead = 8;
  for (int k0 = 0; k0 < a.nc; k0 += kAhead) {
    float end[kAhead], sum[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int k = k0 + j;
      if (k < a.nc) {
        const long long base = static_cast<long long>(b) * a.nc + k;
        end[j] = a.states[(base * kN + n) * a.d + c];
        sum[j] = a.sums[base * a.d + c];
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int k = k0 + j;
      if (k < a.nc) {
        const long long base = static_cast<long long>(b) * a.nc + k;
        a.states[(base * kN + n) * a.d + c] = carry;
        carry = fmaf(ex2(A2 * sum[j]), carry, end[j]);
      }
    }
  }
}

template <typename T, int MODE>
int launch_scan(const ScanArgs& a, int threads, cudaStream_t s) {
  const dim3 grid(a.batch * a.nc, (a.d + threads - 1) / threads);
  const int Rp = (a.R + 3) & ~3;
  const size_t shmem = (kStage * (Rp + 2 * kN) + a.R * threads) *
                           sizeof(float) + kStage * sizeof(int);
  if (a.nc > 1) {
    chunk_scan_kernel<T, false, kWrite><<<grid, threads, shmem, s>>>(a);
    const long long n = static_cast<long long>(a.batch) * kN * a.d;
    chunk_carry_kernel<<<static_cast<unsigned>((n + 127) / 128), 128, 0,
                         s>>>(a);
  }
  chunk_scan_kernel<T, true, MODE><<<grid, threads, shmem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mode(const ScanArgs& a, int mode, int threads, cudaStream_t s) {
  if (mode == kWrite) return launch_scan<T, kWrite>(a, threads, s);
  if (mode == kAdd) return launch_scan<T, kAdd>(a, threads, s);
  return launch_scan<T, kGate>(a, threads, s);
}

int channel_threads(int d) {
  for (int g : {4, 3, 2, 1})
    if (d % (32 * g) == 0) return 32 * g;
  return 128;
}

}  // namespace

// u = SiLU(causal conv of the order) of the x half of xz (B, L, 2d); w is
// float32 (d, 4), bias float32 (d). d must be a multiple of 16 bytes'
// worth of elements and xz, u 16-byte aligned (the wrapper checks).
extern "C" int exa_scan_conv(const void* xz, const float* w,
                             const float* bias, void* u, int bf16, int batch,
                             int L, int d, int order, int S, void* stream) {
  if (batch <= 0 || L <= 0 || d <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HW = L / S;
  const long long work = static_cast<long long>(batch) *
                         ((L + kRun - 1) / kRun) * (d / (bf16 ? 8 : 4));
  const int threads = 128;
  const unsigned grid = static_cast<unsigned>((work + threads - 1) / threads);
  if (bf16)
    scan_conv_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(xz), w, bias,
        static_cast<__nv_bfloat16*>(u), batch, L, d, order, S, HW);
  else
    scan_conv_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(xz), w, bias, static_cast<float*>(u), batch,
        L, d, order, S, HW);
  return static_cast<int>(cudaGetLastError());
}

// One direction's scan (see the head of this file). states and sums are
// float32 scratch of (B, nc, 16, d) and (B, nc, d), nc = ceil(L / chunk).
extern "C" int exa_selective_scan(const void* u, const void* dbl,
                                  const float* dtw, const float* dtb,
                                  const float* A2, const float* Dv,
                                  const void* xz, float* acc, void* out,
                                  float* states, float* sums, int bf16,
                                  int batch, int L, int d, int R, int order,
                                  int S, int chunk, int mode, void* stream) {
  if (batch <= 0 || L <= 0 || d <= 0) return 0;
  ScanArgs a{};
  a.u = u;
  a.dbl = dbl;
  a.dtw = dtw;
  a.dtb = dtb;
  a.A2 = A2;
  a.Dv = Dv;
  a.xz = xz;
  a.acc = acc;
  a.out = out;
  a.states = states;
  a.sums = sums;
  a.batch = batch;
  a.L = L;
  a.d = d;
  a.R = R;
  a.order = order;
  a.S = S;
  a.HW = L / S;
  a.chunk = chunk;
  a.nc = (L + chunk - 1) / chunk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = channel_threads(d);
  return bf16 ? launch_mode<__nv_bfloat16>(a, mode, threads, s)
              : launch_mode<float>(a, mode, threads, s);
}
