// K1: EEGNet block 1 in eval mode, both BatchNorms folded, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel eegnetreplication_tpu/ops/fused_eegnet.py
// (block1_pallas, body _block1_kernel).  It computes, per trial b and output
// filter f of F2,
//
//   mixed[f, t] = sum_c S[f, c] * x[b, c, t]                 (spatial mix)
//   acc[f, t]   = sum_k W[f, k] * mixed[f, t + k - 15]        (32 taps, SAME (15, 16))
//   out[b, f, q] = mean_{j<4} ELU(A[f] * acc[f, 4q + j] + B[f])  (AvgPool 4)
//
// x (B, C, T) f32 -> out (B, F2, T/4) f32, row-major and contiguous.
//
// The stacked form (eeg_block1_stacked_launch) takes G weight sets, S
// (G, F2, C), W (G, F2, 32), A and B (G, F2), and an int32 index per trial
// naming its set: the counterpart of block1_pallas under jax.vmap over the
// weights, which the JAX protocols use to evaluate every fold of a
// within-subject run at once.  A block serves one trial, so it reads its
// trial's index once and offsets the four weight pointers; nothing else of
// the design changes.  An index outside [0, G) reads no weights and writes
// NaN rows (the wrapper checks the range before the launch).
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32 without
// tensor cores): at B=128, C=22, T=257, F2=16 the call must move ~3.4 MB (x
// in, pooled out; the weights are < 4 KB) and do ~60 MFLOP, so the bytes
// bound it at ~1.0 us and the FLOPs at ~0.9 us.  At the serving batch sizes
// (1 to 128 trials) that is below the cost of a launch, so what a call
// costs is the latency of the longest block: the chain of dependent steps
// from the first load to the last store, and how many blocks share the SMs.
//
// Design: one thread block per (trial, tile of kFTile filters, time tile of
// kPoolTile pooled outputs), so a trial of 257 samples is 8 time tiles; the
// old design had one block per (trial, 8 filters) and launched 2 blocks at
// B=1.  A block's time tile covers kTimeTile conv positions; it stages only
// the kWindow samples those positions read (kTimeTile + 31, rounded up to a
// power of two), so the halo's mix is computed twice, by the two blocks
// that share it, and shared memory (~14 KB) does not grow with T.  A block
// of 8 filters and 64 threads, which launches 16 blocks at B=1, measured
// slower at every serving bucket than this one of 16 filters and 128
// threads: at these sizes the critical path of a block, not the number of
// blocks, sets the time.
//  1. Staging: every thread issues all of its copies of a pass (one window
//     column of kRows channels, its share of the S, W, A, B tiles) as 4-byte
//     cp.async from fixed-trip unrolled loops with no per-element division,
//     and only then waits: the copies are in flight together, one memory
//     latency per pass, not one per trip, and they hold no registers (an
//     earlier version that staged through registers spilled at the 64
//     registers the occupancy target allows).  A copy outside [0, T) writes
//     a zero, which is SAME padding (the mix is linear).  kRows channels a
//     pass; C = 22 is one pass.  Bulk copies (TMA) are not used: a trial
//     row of 257 floats is 1028 bytes and trial b starts at b * 22616
//     bytes, so rows are not 16-byte aligned at the product shape.
//  2. Mix: kColThreads threads share a window column, each keeping kMixF
//     accumulators, so its 22-deep FMA chains run interleaved (8
//     independent chains); the S tile is stored transposed, so the 8
//     weights of a channel are two broadcast float4 loads.
//  3. Taps: thread (f, q) computes the 4 positions of one pool window: 36
//     mixed values as 9 float4 loads (a quarter warp reads 128 consecutive
//     bytes), 4 interleaved 32-deep chains, the affine, ELU with expm1f and
//     the pool mean in the thread, with no shuffles.
// Only the pooled output goes back to HBM.  Tensor cores are not used: a
// TF32 product would cost ~1e-3 relative error against a reference pinned
// to full f32 (utils/device.py), and at ~18 FLOP per byte the work sits
// below the card's f32 FLOP/byte line anyway.  IEEE f32 FMAs, no fast-math:
// each sum runs in the order of the earlier design (channels 0..C-1, taps
// 0..31, pool (0+1)+(2+3)); it differs from the plain PyTorch version only
// in order.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTaps = 32;
constexpr int kPadLeft = 15;
constexpr int kFTile = 16;      // output filters per block (F2 = 16: all)
constexpr int kPoolTile = 8;    // pooled outputs per block (one time tile)
constexpr int kTimeTile = 4 * kPoolTile;           // conv positions per block
constexpr int kWindow = 64;     // staged samples per channel (>= 32 + 31)
constexpr int kRows = 24;       // channels staged per pass
constexpr int kThreads = kFTile * kPoolTile;       // one per pool window
constexpr int kMixF = 8;        // filters one thread mixes
constexpr int kColThreads = kThreads / kWindow;    // threads per window column
constexpr int kSLoads = kRows * kFTile / kThreads;  // S loads per thread
constexpr int kWLoads = kFTile * kTaps / kThreads;  // W loads per thread
constexpr int kMixed = kTaps + 4;  // mixed values a pool window loads (35 read)

static_assert(kTimeTile + kTaps - 1 <= kWindow, "window misses the halo");
static_assert(kColThreads * kWindow == kThreads, "whole window columns");
static_assert(kColThreads * kMixF == kFTile, "the mix covers the tile");
static_assert(kRows % kColThreads == 0, "staging is exact");
static_assert((kWindow & (kWindow - 1)) == 0, "window index is a shift");
static_assert(kSLoads * kThreads == kRows * kFTile, "S staging is exact");
static_assert(kWLoads * kThreads == kFTile * kTaps, "W staging is exact");
static_assert(4 * (kPoolTile - 1) + kMixed <= kWindow, "taps read the window");

// One 4-byte cp.async from global to shared memory.  With `valid` false it
// reads nothing (src only has to be a mapped address) and writes a zero.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// 8 blocks an SM: 64 registers a thread.  kStacked: the weights are G sets
// and idx names each trial's set.
template <bool kStacked>
__global__ void __launch_bounds__(kThreads, 8) block1_kernel(
    const float* __restrict__ x, const float* __restrict__ S,
    const float* __restrict__ W, const float* __restrict__ A,
    const float* __restrict__ B, const int* __restrict__ idx,
    float* __restrict__ out, int C, int T, int F2, int G, int n_tq) {
  __shared__ __align__(16) float xs[kRows][kWindow];
  __shared__ __align__(16) float st[kRows][kFTile];    // S tile, transposed
  __shared__ __align__(16) float mixed[kFTile][kWindow];
  __shared__ __align__(16) float ws[kFTile][kTaps];
  __shared__ float as[kFTile];
  __shared__ float bs[kFTile];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / n_tq;            // once per block
  const int tq = blockIdx.x - b * n_tq;
  const int f0 = blockIdx.y * kFTile;
  const int t0 = tq * kTimeTile - kPadLeft;   // sample of window column 0
  const float* xb = x + static_cast<size_t>(b) * C * T;
  // The weight set's index is loaded here and first used after the x
  // copies are issued, so its latency hides behind them.
  bool set_ok = true;
  if constexpr (kStacked) {
    const int g = idx[b];
    set_ok = g >= 0 && g < G;
    const size_t set = set_ok ? static_cast<size_t>(g) : 0;
    S += set * F2 * C;
    W += set * F2 * kTaps;
    A += set * F2;
    B += set * F2;
  }

  const int col = tid % kWindow;               // the mix's window column
  const int fm = (tid / kWindow) * kMixF;      // and its first filter
  float acc[kMixF];
#pragma unroll
  for (int f = 0; f < kMixF; ++f) acc[f] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kRows) {
    if (c0 > 0) __syncthreads();   // the previous pass is done with xs, st
    // 1. Every copy of the pass is issued before any is waited for.  Row r
    // of the window is channel c0 + r; thread tid copies column col of
    // every kColThreads-th row.
    const int t = t0 + col;
    const bool t_in = t >= 0 && t < T;
#pragma unroll
    for (int rr = 0; rr < kRows / kColThreads; ++rr) {
      const int r = rr * kColThreads + fm / kMixF;
      const int c = c0 + r;
      const bool ok = t_in && c < C;
      stage(&xs[r][col], ok ? xb + static_cast<size_t>(c) * T + t : x, ok);
    }
#pragma unroll
    for (int j = 0; j < kSLoads; ++j) {
      const int i = j * kThreads + tid;
      const int c = c0 + i / kFTile;
      const int f = f0 + i % kFTile;
      const bool ok = c < C && f < F2;
      stage(&st[i / kFTile][i % kFTile],
            ok ? S + static_cast<size_t>(f) * C + c : S, ok);
    }
    if (c0 == 0) {   // the tile's W, A, B ride with the first pass
#pragma unroll
      for (int j = 0; j < kWLoads; ++j) {
        const int i = j * kThreads + tid;
        const int f = f0 + i / kTaps;
        stage(&ws[i / kTaps][i % kTaps],
              f < F2 ? W + static_cast<size_t>(f) * kTaps + i % kTaps : W,
              f < F2);
      }
      if (tid < 2 * kFTile) {
        static_assert(2 * kFTile <= kThreads, "A and B in one trip");
        const int f = f0 + tid % kFTile;
        const float* src = tid < kFTile ? A : B;
        stage(tid < kFTile ? &as[tid] : &bs[tid - kFTile],
              f < F2 ? src + f : src, f < F2);
      }
    }
    stage_wait();
    __syncthreads();

    // 2. Mix window column col for filters fm..fm+7.  Rows past C are
    // zeros in xs and st, so they add exact zeros.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float v = xs[r][col];
      const float4 lo = *reinterpret_cast<const float4*>(&st[r][fm]);
      const float4 hi = *reinterpret_cast<const float4*>(&st[r][fm + 4]);
      acc[0] = fmaf(lo.x, v, acc[0]);
      acc[1] = fmaf(lo.y, v, acc[1]);
      acc[2] = fmaf(lo.z, v, acc[2]);
      acc[3] = fmaf(lo.w, v, acc[3]);
      acc[4] = fmaf(hi.x, v, acc[4]);
      acc[5] = fmaf(hi.y, v, acc[5]);
      acc[6] = fmaf(hi.z, v, acc[6]);
      acc[7] = fmaf(hi.w, v, acc[7]);
    }
  }
  static_assert(kMixF == 8, "the mix above unrolls 8 filters");
#pragma unroll
  for (int f = 0; f < kMixF; ++f) mixed[fm + f][col] = acc[f];
  __syncthreads();

  // 3. Taps, affine, ELU and AvgPool(4) of pool window (f, q): positions
  // 4q + j read window columns 4 (q mod kPoolTile) + j + k.
  const int f = tid / kPoolTile;
  const int q = tq * kPoolTile + tid % kPoolTile;
  const float* mrow = &mixed[f][4 * (tid % kPoolTile)];
  float m[kMixed];
#pragma unroll
  for (int i = 0; i < kMixed / 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(mrow + 4 * i);
    m[4 * i] = v.x;
    m[4 * i + 1] = v.y;
    m[4 * i + 2] = v.z;
    m[4 * i + 3] = v.w;
  }
  float a4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kTaps; k += 4) {
    const float4 w = *reinterpret_cast<const float4*>(&ws[f][k]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a4[j] = fmaf(w.x, m[k + j], a4[j]);
      a4[j] = fmaf(w.y, m[k + 1 + j], a4[j]);
      a4[j] = fmaf(w.z, m[k + 2 + j], a4[j]);
      a4[j] = fmaf(w.w, m[k + 3 + j], a4[j]);
    }
  }
  float e[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float pre = fmaf(as[f], a4[j], bs[f]);
    e[j] = pre > 0.0f ? pre : expm1f(pre);
  }
  const int t_pool = T / 4;
  if (f0 + f < F2 && q < t_pool) {
    const float pooled = ((e[0] + e[1]) + (e[2] + e[3])) * 0.25f;
    out[(static_cast<size_t>(b) * F2 + f0 + f) * t_pool + q] =
        set_ok ? pooled : __int_as_float(0x7fc00000);   // NaN
  }
}

}  // namespace

extern "C" {

namespace {

int launch(const float* x, const float* S, const float* W, const float* A,
           const float* B, const int* idx, float* out, int n_b, int C, int T,
           int F2, int G, void* stream) {
  if (n_b <= 0 || C <= 0 || T < 4 || F2 <= 0 || G <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tq = (T / 4 + kPoolTile - 1) / kPoolTile;
  const int n_ft = (F2 + kFTile - 1) / kFTile;
  if (static_cast<long long>(n_b) * n_tq > 0x7fffffffLL || n_ft > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(n_b * n_tq, n_ft);
  auto s = static_cast<cudaStream_t>(stream);
  if (idx == nullptr) {
    block1_kernel<false><<<grid, kThreads, 0, s>>>(
        x, S, W, A, B, nullptr, out, C, T, F2, 1, n_tq);
  } else {
    block1_kernel<true><<<grid, kThreads, 0, s>>>(
        x, S, W, A, B, idx, out, C, T, F2, G, n_tq);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch K1 on `stream`; returns the launch's cudaError_t (0 = success).
// Pointers are device pointers to contiguous f32 arrays: x (n_b, C, T),
// S (F2, C), W (F2, 32), A and B (F2,), out (n_b, F2, T/4).
int eeg_block1_launch(const float* x, const float* S, const float* W,
                      const float* A, const float* B, float* out, int n_b,
                      int C, int T, int F2, void* stream) {
  return launch(x, S, W, A, B, nullptr, out, n_b, C, T, F2, 1, stream);
}

// The stacked form: S (G, F2, C), W (G, F2, 32), A and B (G, F2), and idx
// (n_b,) int32 naming each trial's weight set.
int eeg_block1_stacked_launch(const float* x, const float* S, const float* W,
                              const float* A, const float* B, const int* idx,
                              float* out, int n_b, int C, int T, int F2,
                              int G, void* stream) {
  if (idx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, S, W, A, B, idx, out, n_b, C, T, F2, G, stream);
}

const char* eeg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
