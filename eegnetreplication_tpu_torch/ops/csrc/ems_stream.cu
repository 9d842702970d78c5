// K2s: the exponential moving standardization (EMS) carry over one chunk of
// a stream, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package advances a live session's EMS
// with a jitted lax.scan (eegnetreplication_tpu/ops/ems.py, _stream_chunk),
// and the one-shot method="scan" with the same step.  Per channel, with the
// seed mean mean0 and the carry (m, v) entering the chunk:
//
//   z_t   = x_t - mean0
//   m_t   = c * m_{t-1} + a * z_t
//   v_t   = c * v_{t-1} + a * (z_t - m_t)^2
//   out_t = (z_t - m_t) / sqrt(v_t + eps)
//
// x (C, n) f32 -> out (C, n) f32, row-major and contiguous; m and v (C,) are
// read at the start and written back with the carry leaving the chunk.
//
// Rounding.  Every operation is rounded on its own, in the order above:
// __fmul_rn, __fadd_rn and __fsub_rn are never contracted into an FMA (the
// build's -O3 would fuse c * m + a * z otherwise), and __fsqrt_rn and
// __fdiv_rn round correctly.  That is exactly what the plain version's
// separate PyTorch operations compute, so the kernel equals it bit for bit.
// A chunk split (or a tile boundary) only moves where the carry is stored,
// never an operation, so any chunking of a stream gives the same bits as
// the one-shot call.
//
// What bounds it: the recurrence.  Each sample's m_t needs m_{t-1} through a
// multiply and an add, and v_t likewise needs v_{t-1}: about 8 cycles of
// dependent latency a sample, whatever the bytes (a (22, 250) chunk moves
// 44 KB, ~13 ns at 3.35 TB/s).  One thread has to walk each channel in
// order, and a lone warp issues one instruction a cycle, so what else that
// thread does a sample adds to the chain's time: the correctly rounded
// square root and division are about 30 instructions, the load's latency
// hundreds of cycles.  So the chain's thread does nothing else.
//
// Design: one block of kThreads for up to kChannels channels, and time in
// tiles of kTile samples.  For each tile:
//  - the whole block stages z = x - mean0 in shared memory, from registers
//    it loaded with coalesced loads while the previous tile ran;
//  - warp 0, one lane a channel, runs the recurrences over the tile from
//    shared memory (an odd row pitch puts the 32 lanes of a column on 32
//    banks), kUnroll samples at a time read into registers ahead of their
//    steps, and leaves z - m and v there: 8 arithmetic instructions a
//    sample;
//  - the whole block adds eps, takes the square roots and divides, and
//    stores the tile with coalesced stores.
// The block issues the next tile's loads before the chain starts, so they
// arrive while it runs.
// What still holds it back (PERF.md, utils/k2s_variants.py): the phases
// run one after another, so the output phase (the division and square
// root) and the wait for a tile's loads add to the chain's time instead of
// hiding under it; a producer/consumer split of the warps over a ring of
// tiles is the next step.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                  // 8 warps a block
constexpr int kChannels = 32;                  // warp 0's lanes
constexpr int kTile = 128;                     // samples a tile
constexpr int kPitch = kTile + 1;              // odd: no bank conflicts
constexpr int kPer = kChannels * kTile / kThreads;   // elements a thread
constexpr int kUnroll = 32;                    // steps from registers

// One step from z = x - mean0: the carry (m, v) advances and z - m is
// returned.
__device__ __forceinline__ float step(float z, float a, float c, float& m,
                                      float& v) {
  m = __fadd_rn(__fmul_rn(c, m), __fmul_rn(a, z));
  const float d = __fsub_rn(z, m);
  v = __fadd_rn(__fmul_rn(c, v), __fmul_rn(a, __fmul_rn(d, d)));
  return d;
}

__global__ void __launch_bounds__(kThreads)
ems_stream_kernel(const float* __restrict__ x,
                  const float* __restrict__ mean0,
                  float* __restrict__ m, float* __restrict__ v,
                  float* __restrict__ out, int n_channels, long long n,
                  float a, float c, float eps) {
  __shared__ float dev[kChannels][kPitch];     // z, then z - m
  __shared__ float var[kChannels][kPitch];     // v
  __shared__ float mu[kChannels];
  const int ch0 = blockIdx.x * kChannels;
  const int rows = min(kChannels, n_channels - ch0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool chain = tid < 32 && lane < rows;
  float cm = 0.0f, cv = 0.0f;
  if (tid < kChannels) mu[tid] = tid < rows ? mean0[ch0 + tid] : 0.0f;
  if (chain) {
    cm = m[ch0 + lane];
    cv = v[ch0 + lane];
  }

  // Element k of a thread is row (tid + k * kThreads) / kTile, column
  // (tid + k * kThreads) % kTile of the tile: a warp covers 32 consecutive
  // samples of one channel.
  float reg[kPer];
  auto load = [&](long long t0, long long len) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kThreads;
      const int r = e / kTile, j = e % kTile;
      reg[k] = (r < rows && j < len)
                   ? __ldg(x + static_cast<long long>(ch0 + r) * n + t0 + j)
                   : 0.0f;
    }
  };

  load(0, n);
  __syncthreads();                             // mu
  for (long long t0 = 0; t0 < n; t0 += kTile) {
    const int len = static_cast<int>(min(static_cast<long long>(kTile),
                                         n - t0));
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kThreads;
      dev[e / kTile][e % kTile] = __fsub_rn(reg[k], mu[e / kTile]);
    }
    __syncthreads();
    if (t0 + kTile < n) load(t0 + kTile, n - t0 - kTile);
    if (chain) {
      float* row_d = dev[lane];
      float* row_v = var[lane];
      int j = 0;
      for (; j + kUnroll <= len; j += kUnroll) {
        float z[kUnroll], w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) z[u] = row_d[j + u];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          z[u] = step(z[u], a, c, cm, cv);
          w[u] = cv;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          row_d[j + u] = z[u];
          row_v[j + u] = w[u];
        }
      }
      for (; j < len; ++j) {
        row_d[j] = step(row_d[j], a, c, cm, cv);
        row_v[j] = cv;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kThreads;
      const int r = e / kTile, j = e % kTile;
      if (r < rows && j < len) {
        out[static_cast<long long>(ch0 + r) * n + t0 + j] =
            __fdiv_rn(dev[r][j], __fsqrt_rn(__fadd_rn(var[r][j], eps)));
      }
    }
    __syncthreads();
  }
  if (chain) {
    m[ch0 + lane] = cm;
    v[ch0 + lane] = cv;
  }
}

}  // namespace

extern "C" {

// Channels a block: the wrapper checks it against its own constant.
int eeg_ems_stream_channels() { return kChannels; }

const char* eeg_ems_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches K2s on `stream` (a cudaStream_t) over x (C, n): ceil(C / 32)
// blocks of kThreads.  m and v (C,) hold the carry entering
// the chunk and receive the carry leaving it.  Returns the launch's
// cudaError_t.
int eeg_ems_stream_launch(const void* x, const void* mean0, void* m, void* v,
                          void* out, int n_channels, long long n, float a,
                          float c, float eps, void* stream) {
  if (n_channels <= 0 || n <= 0) return cudaSuccess;
  const int blocks = (n_channels - 1) / kChannels + 1;
  ems_stream_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(mean0),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<float*>(out), n_channels, n, a, c, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
