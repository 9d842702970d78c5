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
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32 without tensor cores):
// at B=128, C=22, T=257, F2=16 the kernel must move ~3.4 MB (x in, pooled
// out; the weights are < 4 KB) and do ~60 MFLOP, so the bytes bound it at
// ~1.0 us and the FLOPs at ~0.9 us: it is memory-bound, and at the serving
// batch sizes (1 to 128 trials) a launch (a few us) costs more than either.
// The design answers that with one pass and one launch: each trial is read
// from HBM once into shared memory, every intermediate (the padded series,
// the mixed rows, the taps, the activations) stays on chip, and only the
// pooled output is written back.  Nothing here is tuned further yet.
//
// Design: one thread block per (trial, tile of kFTile output filters).
//  1. Stage the trial's zero-padded (C, T+31) series in shared memory
//     (25.3 KB at 22 x 257) with the tile's S, W, A, B.
//  2. Mix: mixed[f][p] = sum_c S[f][c] * xs[c][p] into shared memory with
//     IEEE f32 FMAs; the zero pads mix to zero, which is SAME padding.
//  3. One conv position per thread: 32 taps from shared memory, the affine,
//     ELU with expm1f; the four lanes of one pool window sum through two warp
//     shuffles and one of them writes the mean.  (The Pallas kernel pooled
//     with a one-hot matmul and used exp-1 to get around Mosaic; neither is
//     needed here.)
// No fast-math: the sums differ from the plain PyTorch version only in order.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTaps = 32;
constexpr int kPadLeft = 15;
constexpr int kPadRight = 16;
constexpr int kFTile = 8;       // output filters per block
constexpr int kThreads = 256;   // a multiple of the warp size (shuffles)
constexpr size_t kDefaultSmemBytes = 48 * 1024;

__host__ __device__ inline int padded_len(int t) {
  return t + kPadLeft + kPadRight;
}

size_t smem_floats(int c, int t) {
  const size_t tp = static_cast<size_t>(padded_len(t));
  return static_cast<size_t>(c) * tp        // xs
         + kFTile * tp                      // mixed
         + static_cast<size_t>(kFTile) * c  // S tile
         + kFTile * kTaps                   // W tile
         + 2 * kFTile;                      // A, B tiles
}

__global__ void __launch_bounds__(kThreads) block1_kernel(
    const float* __restrict__ x, const float* __restrict__ S,
    const float* __restrict__ W, const float* __restrict__ A,
    const float* __restrict__ B, float* __restrict__ out,
    int C, int T, int F2) {
  extern __shared__ float smem[];
  const int tp = padded_len(T);
  const int t_pool = T / 4;
  const int t_used = 4 * t_pool;
  float* xs = smem;                                   // [C][tp]
  float* mixed = xs + static_cast<size_t>(C) * tp;    // [kFTile][tp]
  float* s_tile = mixed + static_cast<size_t>(kFTile) * tp;  // [kFTile][C]
  float* w_tile = s_tile + kFTile * C;                // [kFTile][kTaps]
  float* a_tile = w_tile + kFTile * kTaps;            // [kFTile]
  float* b_tile = a_tile + kFTile;                    // [kFTile]

  const int b = blockIdx.x;
  const int f0 = blockIdx.y * kFTile;
  const int nf = min(kFTile, F2 - f0);
  const int tid = threadIdx.x;

  // 1. Stage the trial with its zero pads, and the tile's weights.
  const float* xb = x + static_cast<size_t>(b) * C * T;
  for (int i = tid; i < C * tp; i += blockDim.x) {
    const int c = i / tp;
    const int t = i - c * tp - kPadLeft;
    xs[i] = (t >= 0 && t < T) ? xb[static_cast<size_t>(c) * T + t] : 0.0f;
  }
  for (int i = tid; i < kFTile * C; i += blockDim.x) {
    const int f = i / C;
    s_tile[i] = f < nf ? S[static_cast<size_t>(f0 + f) * C + (i - f * C)]
                       : 0.0f;
  }
  for (int i = tid; i < kFTile * kTaps; i += blockDim.x) {
    const int f = i / kTaps;
    w_tile[i] = f < nf ? W[(f0 + f) * kTaps + (i - f * kTaps)] : 0.0f;
  }
  if (tid < kFTile) {
    a_tile[tid] = tid < nf ? A[f0 + tid] : 0.0f;
    b_tile[tid] = tid < nf ? B[f0 + tid] : 0.0f;
  }
  __syncthreads();

  // 2. Spatial mix over the padded series.
  for (int i = tid; i < kFTile * tp; i += blockDim.x) {
    const int f = i / tp;
    const int p = i - f * tp;
    const float* srow = s_tile + f * C;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc = fmaf(srow[c], xs[c * tp + p], acc);
    mixed[i] = acc;
  }
  __syncthreads();

  // 3. Taps, affine, ELU, AvgPool(4).  base steps by blockDim.x, a multiple
  // of 32, so every lane of a warp runs the same trip count (the shuffles
  // need the whole warp) and a pool window's four lanes share f.
  const int n_pos = kFTile * t_used;
  for (int base = 0; base < n_pos; base += blockDim.x) {
    const int i = base + tid;
    const bool active = i < n_pos;
    int f = 0;
    int t = 0;
    float v = 0.0f;
    if (active) {
      f = i / t_used;
      t = i - f * t_used;
      const float* m = mixed + f * tp + t;
      const float* w = w_tile + f * kTaps;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc = fmaf(w[k], m[k], acc);
      const float pre = fmaf(a_tile[f], acc, b_tile[f]);
      v = pre > 0.0f ? pre : expm1f(pre);
    }
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (active && (t & 3) == 0 && f < nf) {
      out[(static_cast<size_t>(b) * F2 + f0 + f) * t_pool + (t >> 2)] =
          v * 0.25f;
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for a (C, T) trial, in bytes.
size_t eeg_block1_smem_bytes(int C, int T) {
  return smem_floats(C, T) * sizeof(float);
}

// Launch K1 on `stream`; returns the launch's cudaError_t (0 = success).
// Pointers are device pointers to contiguous f32 arrays: x (n_b, C, T),
// S (F2, C), W (F2, 32), A and B (F2,), out (n_b, F2, T/4).
int eeg_block1_launch(const float* x, const float* S, const float* W,
                      const float* A, const float* B, float* out, int n_b,
                      int C, int T, int F2, void* stream) {
  if (n_b <= 0 || C <= 0 || T < 4 || F2 <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = eeg_block1_smem_bytes(C, T);
  if (smem > kDefaultSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        block1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n_b, (F2 + kFTile - 1) / kFTile);
  block1_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, S, W, A, B, out, C, T, F2);
  return static_cast<int>(cudaGetLastError());
}

const char* eeg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
