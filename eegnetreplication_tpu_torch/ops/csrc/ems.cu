// K2: exponential moving standardization (EMS) of a (C, T) recording, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel eegnetreplication_tpu/ops/ems_pallas.py
// (ems_pallas, body _ems_kernel, constants _block_operators).  Per channel,
// with a = factor_new, c = 1 - a and the seed statistics mean0, var0 of the
// first min(init_block_size, T) samples (biased variance, computed by the
// wrapper):
//
//   z_t   = x_t - mean0
//   m_t   = c * m_{t-1} + a * z_t                 m_{-1} = 0
//   v_t   = c * v_{t-1} + a * (z_t - m_t)^2       v_{-1} = var0
//   out_t = (z_t - m_t) / sqrt(v_t + eps)
//
// x (C, T) f32 -> out (C, T) f32, row-major and contiguous.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32 without tensor
// cores): a competition session after the 128 Hz resample is (22, 345600),
// 30.4 MB; reading it once and writing it once moves 60.8 MB, ~18 us, while
// its ~12 FLOP per sample (91 MFLOP) take ~1.4 us.  Bytes bound it.
//
// Design.  On the TPU the scan was a triangular matmul on the matrix unit
// over time blocks run in sequence with the carry in VMEM.  Here:
//  - one thread block per channel; the block walks the channel's time in
//    tiles of kThreads * kItems samples, in order, and the (m, v) carry
//    stays in registers from tile to tile.  Nothing carries between blocks.
//  - within a tile, thread i owns kItems consecutive samples.  The tile is
//    loaded with coalesced loads into shared memory (skewed by one word per
//    32 so that reading kItems consecutive words per thread is free of bank
//    conflicts), and the next tile's loads are issued before this tile is
//    computed, so their latency overlaps the scan.
//  - each recurrence is scanned the same way: every thread runs it serially
//    over its kItems samples from 0; a block-wide exclusive scan of those
//    partial sums (warp shuffles, then one warp over the warp totals through
//    shared memory) gives each thread the state entering its span; the
//    thread then reruns its samples serially from that state.  Every span is
//    a whole number of samples, so a span's coefficient is c^span, read from
//    a table of c^n (n = 0..kTile) that the host computes in float64 from
//    the f32 c and rounds to f32 once (not powf in f32).
//  - a ragged last tile is masked: loads past T read as z = 0 and stores
//    past T are skipped.  The scan is causal, so the padding cannot reach a
//    valid output.
// IEEE f32 throughout (no fast-math): sqrtf and the division round
// correctly, and within a thread the recurrences run in the same order as
// the sequential scan.
//
// One block per channel puts 22 blocks on 132 SMs at the product shape, and
// every tile waits on two block-wide scans, so this first design is expected
// to sit far from the bound.  Splitting a channel's time across blocks (a
// decoupled look-back over the affine carries) is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                     // samples per thread per tile
constexpr int kTile = kThreads * kItems;       // 4096 samples
constexpr int kWarps = kThreads / 32;
constexpr int kBuf = kTile + kTile / 32;       // skewed tile buffer
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

// Inclusive scan across the lanes of a warp of s = c^span * s_prev + b, where
// each lane covers `span` samples: at the step with offset o a lane joins
// o lanes' worth of samples, whose coefficient is powers[span * o].  Only
// the first `width` lanes are combined (width a power of two, <= 32).
__device__ __forceinline__ float warp_scan(float b, int lane, int width,
                                           int span, const float* powers) {
  for (int o = 1; o < width; o <<= 1) {
    const float other = __shfl_up_sync(kFull, b, o);
    if (lane >= o) b = fmaf(powers[span * o], other, b);
  }
  return b;
}

// Exclusive block-wide scan of the threads' partial sums b (each spanning
// kItems samples, started from 0).  Returns (x) the state entering the
// thread's span from a zero state at the tile start and (y) the state at
// the tile end.  scratch holds 2 * kWarps + 1 floats.
__device__ __forceinline__ float2 block_scan(float b, const float* powers,
                                             float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float incl = warp_scan(b, lane, 32, kItems, powers);
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float w = lane < kWarps ? scratch[lane] : 0.0f;
    const float w_incl = warp_scan(w, lane, kWarps, 32 * kItems, powers);
    float w_excl = __shfl_up_sync(kFull, w_incl, 1);
    if (lane == 0) w_excl = 0.0f;
    if (lane < kWarps) scratch[kWarps + lane] = w_excl;
    if (lane == kWarps - 1) scratch[2 * kWarps] = w_incl;
  }
  __syncthreads();
  return make_float2(fmaf(powers[kItems * lane], scratch[kWarps + warp], excl),
                     scratch[2 * kWarps]);
}

__global__ void __launch_bounds__(kThreads) ems_kernel(
    const float* __restrict__ x, const float* __restrict__ mean0,
    const float* __restrict__ var0, const float* __restrict__ powers_in,
    float* __restrict__ out, int t_total, float a, float c, float eps) {
  __shared__ float buf[kBuf];
  __shared__ float powers[kTile + 1];
  __shared__ float scratch[2 * kWarps + 1];

  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * t_total;
  const float* xr = x + row;
  float* outr = out + row;
  const float mu = mean0[blockIdx.x];

  for (int n = tid; n <= kTile; n += kThreads) powers[n] = powers_in[n];

  float next[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int g = j * kThreads + tid;
    next[j] = g < t_total ? xr[g] : 0.0f;
  }

  float carry_m = 0.0f;
  float carry_v = var0[blockIdx.x];
  for (int start = 0; start < t_total; start += kTile) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int idx = j * kThreads + tid;
      buf[skew(idx)] = start + idx < t_total ? next[j] - mu : 0.0f;
    }
    __syncthreads();
    const int next_start = start + kTile;
    if (next_start < t_total) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int g = next_start + j * kThreads + tid;
        next[j] = g < t_total ? xr[g] : 0.0f;
      }
    }

    float z[kItems];
    float part = 0.0f;
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
      z[s] = buf[skew(tid * kItems + s)];
      part = c * part + a * z[s];
    }
    const float2 ms = block_scan(part, powers, scratch);
    float m = fmaf(powers[kItems * tid], carry_m, ms.x);
    carry_m = fmaf(powers[kTile], carry_m, ms.y);

    float dev[kItems];
    part = 0.0f;
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
      m = c * m + a * z[s];
      dev[s] = z[s] - m;
      part = c * part + a * (dev[s] * dev[s]);
    }
    const float2 vs = block_scan(part, powers, scratch);
    float v = fmaf(powers[kItems * tid], carry_v, vs.x);
    carry_v = fmaf(powers[kTile], carry_v, vs.y);

    // Every thread read its z from buf before the first block_scan's
    // barrier, so buf is free to take the outputs.
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
      v = c * v + a * (dev[s] * dev[s]);
      buf[skew(tid * kItems + s)] = dev[s] / sqrtf(v + eps);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int idx = j * kThreads + tid;
      if (start + idx < t_total) outr[start + idx] = buf[skew(idx)];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Samples per tile: the host's table of c^n must hold n = 0..eeg_ems_tile().
int eeg_ems_tile() { return kTile; }

const char* eeg_ems_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches K2 on `stream` (a cudaStream_t) over x (C, T); powers holds
// c^n for n = 0..kTile as f32.  Returns the launch's cudaError_t.
int eeg_ems_launch(const void* x, const void* mean0, const void* var0,
                   const void* powers, void* out, int n_channels, int t_total,
                   float a, float c, float eps, void* stream) {
  if (n_channels <= 0 || t_total <= 0) return cudaSuccess;
  ems_kernel<<<n_channels, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(mean0),
      static_cast<const float*>(var0), static_cast<const float*>(powers),
      static_cast<float*>(out), t_total, a, c, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
