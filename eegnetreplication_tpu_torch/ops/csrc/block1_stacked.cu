// K1-stacked: EEGNet block 1 in eval mode on G stacked weight sets, for
// Hopper (sm_90a), designed for the training batch.
//
// Replaces the Pallas TPU kernel eegnetreplication_tpu/ops/fused_eegnet.py
// (block1_pallas) under jax.vmap over the weights, which the JAX protocols
// use to evaluate every fold of a run at once.  Trial b runs with weight set
// g = idx[b] of S (G, F2, C), W (G, F2, 32), A and B (G, F2):
//
//   mixed[f, t] = sum_c S[g, f, c] * x[b, c, t]
//   acc[f, t]   = sum_k W[g, f, k] * mixed[f, t + k - 15]     (SAME (15, 16))
//   out[b, f, q] = mean_{j<4} ELU(A[g, f] * acc[f, 4q + j] + B[g, f])
//
// x (N, C, T) f32, idx (N,) int32 -> out (N, F2, T/4) f32.  An index
// outside [0, G) reads no weights and writes NaN rows (the wrapper checks
// the range before the launch).
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 without tensor
// cores): at a 90-fold validation batch, (5760, 22, 257) with F2 = 16, the
// call must move ~154 MB (x in, pooled out) and do ~2.6 GFLOP, so the bytes
// bound it at ~0.046 ms and the FLOPs at ~0.039 ms: both have to be spent
// well at once.  K1's design (block1.cu), one block per 32 conv positions,
// stages and mixes the 31-sample halo twice and stages the weight set in
// every block; at this size that doubles the mix and its staging.
//
// Design: persistent blocks of kThreads, a few an SM, each walking a
// contiguous range of work items; a work item is one trial and one time
// tile of kPool pooled outputs (kLongPool: a whole trial at T=257, so the
// halo costs 31 of 288 mixed columns; kShortPool for small batches, where a
// trial is spread over two blocks to fill the card; the wrapper picks it
// from the trial count).  Per item:
//  1. Staging, a ring of kStages: while earlier items compute, the item's x
//     window (its kPos + 32 samples of every channel) lands by one bulk
//     copy a row (the copy engine, cp.async.bulk, completing on the stage's
//     mbarrier), of the 16-byte chunks that hold the row's samples, from
//     the aligned address at or below the first (so the row lands shifted
//     by its misalignment, 0-3 floats, and the chunks bring a few floats of
//     the neighbouring rows).  A row whose chunks would reach outside x
//     (the first, the last) copies its edge floats one by one.  The item's
//     weight set rides in the same stage slot (4-byte cp.async) and is
//     copied only when it differs from the set the slot holds, so a
//     fold-major batch (64 consecutive trials a set) restages a set once a
//     slot, and a permuted one is still correct.
//  2. Mix: thread p mixes window column p for 16 filters; per channel it
//     reads its x value and the filters' S column as broadcast float4s (S
//     is staged transposed).  A column outside [0, T) is SAME padding:
//     its mix is +0, written without reading the stage.
//  3. Taps: thread (f, pg) computes kPer consecutive positions of filter f
//     from a sliding window of mixed values read as float4s (the mixed rows
//     are skewed by 4 floats every kPer columns, so the lanes' float4s fall
//     on distinct banks), then the affine, ELU and AvgPool(4), written
//     once.
// An item's copies are issued right after the barrier that opens the item
// before it: every thread is then done with the stage they reuse.
// Tensor cores are not used, for K1's reason (block1.cu): a TF32 product
// would cost ~1e-3 relative error against a reference pinned to full f32.
// Every sum runs in K1's order (channels 0..C-1 in one FMA chain, taps
// 0..31, fmaf(A, acc, B), expm1f, ((e0 + e1) + (e2 + e3)) * 0.25f), so an
// item equals K1 on the same trial and weight set bit for bit.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kTaps = 32;
constexpr int kPadLeft = 15;
constexpr int kThreads = 256;
constexpr int kFTile = 16;       // filters of a mix and taps pass
constexpr int kLongPool = 64;    // pooled outputs of a long work item
constexpr int kShortPool = 32;   // pooled outputs of a short work item
constexpr int kStages = 2;       // x and weight stages in the ring
constexpr int kGroups = kThreads / kFTile;   // position groups a filter
static_assert(kStages >= 2, "an item loads while the one before computes");

template <int kPool>
struct Tile {
  static constexpr int kPos = 4 * kPool;        // conv positions
  static constexpr int kWin = kPos + kTaps;     // mixed columns (kPos + 31 read)
  static constexpr int kXPitch = kWin + 4;      // a staged row and its shift
  static constexpr int kChunks = kXPitch / 4;   // 16-byte chunks of a row
  static constexpr int kPer = kPos / kGroups;   // positions a thread's taps
  static constexpr int kSkew = kPer >= 8 ? 4 : 0;
  static constexpr int kMPitch = kWin + (kWin / kPer) * kSkew;
  static_assert(kPos % kGroups == 0 && kPer % 4 == 0, "whole pool windows");
  static_assert(kWin % kPer == 0, "whole skew groups");
  static_assert(kPer * (kGroups - 1) + kPer + kTaps <= kWin,
                "the taps read the window");
  // The skewed column of window column p.
  __device__ static constexpr int col(int p) {
    return p + (p / kPer) * kSkew;
  }
};

// Floats of one stage: x rows, then the weight slot (S transposed, W, A, B).
__host__ __device__ constexpr size_t stage_floats(int x_pitch, int C,
                                                  int f2p) {
  return static_cast<size_t>(C) * x_pitch
      + static_cast<size_t>(f2p) * (C + kTaps + 2);
}

// The stages, the mixed rows, then one mbarrier a stage.
template <int kPool>
__host__ __device__ constexpr size_t smem_bytes(int C, int f2p) {
  return sizeof(float) * (kStages * stage_floats(Tile<kPool>::kXPitch, C, f2p)
                          + kFTile * Tile<kPool>::kMPitch)
      + kStages * sizeof(uint64_t);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) by the copy engine, counted on `bar`'s transaction count.
__device__ __forceinline__ void copy_bulk(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrives on `bar` and adds `bytes` to the transaction count it waits for.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// A 4-byte cp.async; with `valid` false it writes a zero.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// 2 blocks an SM: 128 registers a thread.
template <int kPool>
__global__ void __launch_bounds__(kThreads, 2)
block1_stacked_kernel(
    const float* __restrict__ x, const float* __restrict__ S,
    const float* __restrict__ W, const float* __restrict__ A,
    const float* __restrict__ B, const int* __restrict__ idx,
    float* __restrict__ out, int C, int T, int F2, int G, int n_tq,
    long long n_items, int per_block) {
  using L = Tile<kPool>;
  extern __shared__ __align__(16) float smem[];
  const int f2p = (F2 + kFTile - 1) / kFTile * kFTile;
  const size_t stage_size = stage_floats(L::kXPitch, C, f2p);
  float* mixed = smem + kStages * stage_size;
  uint64_t* landed = reinterpret_cast<uint64_t*>(mixed + kFTile * L::kMPitch);
  // Threads that copy rows: each arrives on its stage's mbarrier once an
  // item, with its rows' bytes.
  const int copiers = min(C, kThreads);
  const float* x_end = x + static_cast<size_t>(n_items / n_tq) * C * T;
  const int tid = threadIdx.x;
  const int t_pool = T / 4;
  const long long lo = static_cast<long long>(blockIdx.x) * per_block;
  const int count = static_cast<int>(
      max(0LL, min(static_cast<long long>(per_block), n_items - lo)));

  // Low bits of x's address in floats: a row's shift in its stage.
  const unsigned x_words =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(x) >> 2);
  auto set_of = [&](int i) {                    // item lo + i's weight set
    return idx[(lo + i) / n_tq];
  };
  // The shift of channel row 0 of item lo + i (row c adds c * T).
  auto shift0 = [&](int i) {
    const long long item = lo + i;
    const long long b = item / n_tq;
    const int t0 = static_cast<int>(item - b * n_tq) * L::kPos;
    return x_words + static_cast<unsigned>(b * C * T)
        + static_cast<unsigned>(t0 - kPadLeft);
  };

  int held[kStages];           // the weight set each stage's slot holds
  bool ok[kStages];            // the stage's item has a set in [0, G)
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    held[s] = -1;
    ok[s] = false;
  }

  // Item lo + i's copies into stage st (a constant once unrolled).
  auto issue = [&](int i, int st, int g) {
    float* xs = smem + st * stage_size;
    const long long item = lo + i;
    const long long b = item / n_tq;
    const int t0 = static_cast<int>(item - b * n_tq) * L::kPos;
    const float* xb = x + static_cast<size_t>(b) * C * T;
    const unsigned sh0 = shift0(i);
    // Row r's samples [lo_t, hi_t) of the window: one bulk copy of the
    // 16-byte chunks [head, tail) that hold them (window column p lands at
    // p + d, d the misalignment of sample t0 - 15).  The chunks' floats
    // outside [lo_t, hi_t) are the neighbouring rows'; the mix skips those
    // columns.  A chunk outside x's own memory (the first row's, the last
    // row's) is left to 4-byte copies of the row's own floats.
    const int lo_t = max(t0 - kPadLeft, 0);
    const int hi_t = min(t0 - kPadLeft + L::kWin, T);
    struct Span {
      const float *row, *head, *begin, *end, *tail;
    };
    auto span = [&](int r) {
      Span sp;
      sp.row = xb + static_cast<size_t>(r) * T;
      sp.head = reinterpret_cast<const float*>(
          reinterpret_cast<uintptr_t>(sp.row + lo_t) & ~uintptr_t{15});
      sp.tail = reinterpret_cast<const float*>(
          (reinterpret_cast<uintptr_t>(sp.row + hi_t) + 15) & ~uintptr_t{15});
      sp.begin = sp.head < x ? sp.head + 4 : sp.head;
      sp.end = sp.tail > x_end ? sp.tail - 4 : sp.tail;
      return sp;
    };
    if (tid < copiers) {
      unsigned bytes = 0;
      for (int r = tid; r < C; r += kThreads) {
        const Span sp = span(r);
        if (sp.end > sp.begin) {
          bytes += static_cast<unsigned>((sp.end - sp.begin) * 4);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_arrive_tx(&landed[st], bytes);
      for (int r = tid; r < C; r += kThreads) {
        const Span sp = span(r);
        const int d = static_cast<int>((sh0 + static_cast<unsigned>(r) * T)
                                       & 3u);
        float* dst = xs + r * L::kXPitch
            + (static_cast<int>(sp.head - sp.row) - (t0 - kPadLeft) + d);
        if (sp.end > sp.begin) {
          copy_bulk(dst + (sp.begin - sp.head), sp.begin,
                    static_cast<unsigned>((sp.end - sp.begin) * 4),
                    &landed[st]);
        }
        // The edge chunks left out of the bulk copy, float by float.
        auto edge = [&](const float* from, const float* to) {
          for (const float* q = from; q < to; ++q) {
            if (q >= sp.row + lo_t && q < sp.row + hi_t) {
              copy4(dst + (q - sp.head), q, true);
            }
          }
        };
        edge(sp.head, sp.begin);
        edge(sp.end > sp.begin ? sp.end : sp.begin, sp.tail);
      }
    }
    const bool valid = g >= 0 && g < G;
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      if (s != st) continue;
      ok[s] = valid;
      if (!valid || held[s] == g) continue;
      held[s] = g;
      float* st_s = xs + static_cast<size_t>(C) * L::kXPitch;   // (C, f2p)
      float* ws = st_s + static_cast<size_t>(C) * f2p;          // (f2p, 32)
      float* as = ws + f2p * kTaps;
      float* bs = as + f2p;
      const float* Sg = S + static_cast<size_t>(g) * F2 * C;
      const float* Wg = W + static_cast<size_t>(g) * F2 * kTaps;
      for (int i2 = tid; i2 < C * f2p; i2 += kThreads) {
        const int c = i2 / f2p, f = i2 - (i2 / f2p) * f2p;
        copy4(st_s + i2, f < F2 ? Sg + static_cast<size_t>(f) * C + c : S,
              f < F2);
      }
      for (int i2 = tid; i2 < f2p * kTaps; i2 += kThreads) {
        const int f = i2 / kTaps;
        copy4(ws + i2, f < F2 ? Wg + i2 : W, f < F2);
      }
      for (int i2 = tid; i2 < 2 * f2p; i2 += kThreads) {
        const int f = i2 % f2p;
        const float* src = i2 < f2p ? A : B;
        copy4(i2 < f2p ? as + f : bs + f,
              f < F2 ? src + static_cast<size_t>(g) * F2 + f : src, f < F2);
      }
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&landed[s], copiers);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Prologue: the first kStages - 1 items' copies, one group each.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < count) issue(s, s, set_of(s));
    copy_commit();
  }
  int g_next = kStages - 1 < count ? set_of(kStages - 1) : 0;

  const int f = tid / kGroups;          // the taps' filter in the pass
  const int pg = tid % kGroups;         // and its position group
  for (int i0 = 0; i0 < count; i0 += kStages) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const int i = i0 + s;
      if (i >= count) break;
      copy_wait<kStages - 2>();
      bar_wait(&landed[s], (i / kStages) & 1);
      // Item i's x and weights have landed, and every thread is done with
      // item i - 1, so item i + kStages - 1 goes into its stage.
      __syncthreads();
      const int st_ahead = (s + kStages - 1) % kStages;
      if (i + kStages - 1 < count) issue(i + kStages - 1, st_ahead, g_next);
      copy_commit();
      if (i + kStages < count) g_next = set_of(i + kStages);

      const float* xs = smem + s * stage_size;
      const float* st_s = xs + static_cast<size_t>(C) * L::kXPitch;
      const float* ws = st_s + static_cast<size_t>(C) * f2p;
      const float* as = ws + f2p * kTaps;
      const float* bs = as + f2p;
      const long long item = lo + i;
      const long long b = item / n_tq;
      const int tq = static_cast<int>(item - b * n_tq);
      const int t0 = tq * L::kPos;
      const unsigned sh0 = shift0(i);

      for (int f0 = 0; f0 < F2; f0 += kFTile) {
        if (f0 > 0) __syncthreads();    // the last pass's taps read mixed
        // 2. Mix: thread p mixes window column p for the pass's filters.
        static_assert(kFTile == 16, "the mix unrolls 4 float4s of S");
        for (int p = tid; p < L::kWin; p += kThreads) {
          float acc[kFTile];
#pragma unroll
          for (int k = 0; k < kFTile; ++k) acc[k] = 0.0f;
          // A column outside [0, T) mixes SAME padding to +0: skip it (its
          // staged floats are other rows').
          const int t_col = t0 - kPadLeft + p;
          if (t_col >= 0 && t_col < T) {
            for (int c = 0; c < C; ++c) {
              const float v = xs[c * L::kXPitch
                                 + ((sh0 + static_cast<unsigned>(c) * T) & 3u)
                                 + p];
              const float* scol = st_s + static_cast<size_t>(c) * f2p + f0;
#pragma unroll
              for (int q = 0; q < kFTile / 4; ++q) {
                const float4 s4 = *reinterpret_cast<const float4*>(scol
                                                                   + 4 * q);
                acc[4 * q] = fmaf(s4.x, v, acc[4 * q]);
                acc[4 * q + 1] = fmaf(s4.y, v, acc[4 * q + 1]);
                acc[4 * q + 2] = fmaf(s4.z, v, acc[4 * q + 2]);
                acc[4 * q + 3] = fmaf(s4.w, v, acc[4 * q + 3]);
              }
            }
          }
#pragma unroll
          for (int k = 0; k < kFTile; ++k) {
            mixed[k * L::kMPitch + L::col(p)] = acc[k];
          }
        }
        const float a_f = as[f0 + f];
        const float b_f = bs[f0 + f];
        __syncthreads();                // mixed is complete

        // 3. Taps of positions pg * kPer .. + kPer - 1 of filter f0 + f.
        constexpr int kRead = L::kPer + kTaps;
        float mv[kRead];
        const float* mrow = mixed + f * L::kMPitch
            + (L::kPer + L::kSkew) * pg;
#pragma unroll
        for (int r4 = 0; r4 < kRead / 4; ++r4) {
          const float4 m4 = *reinterpret_cast<const float4*>(
              mrow + 4 * r4 + (4 * r4 / L::kPer) * L::kSkew);
          mv[4 * r4] = m4.x;
          mv[4 * r4 + 1] = m4.y;
          mv[4 * r4 + 2] = m4.z;
          mv[4 * r4 + 3] = m4.w;
        }
        // Tap k of every position in turn: each sum runs over k in order.
        // The taps are read as broadcast float4s (a long item's thread
        // reuses each over its 16 positions).
        float acc[L::kPer];
#pragma unroll
        for (int j = 0; j < L::kPer; ++j) acc[j] = 0.0f;
#pragma unroll
        for (int k = 0; k < kTaps; k += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(
              ws + (f0 + f) * kTaps + k);
          const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int j = 0; j < L::kPer; ++j) {
              acc[j] = fmaf(w[kk], mv[k + kk + j], acc[j]);
            }
          }
        }
        const bool set_ok = ok[s];
        float* orow = out + (static_cast<size_t>(b) * F2 + f0 + f) * t_pool;
        // The affine and every expm1f first, then ELU's choice: the kPer
        // expm1f run side by side (taking each only where pre <= 0, behind
        // its branch, runs them one after another).
        float em[L::kPer];
#pragma unroll
        for (int j = 0; j < L::kPer; ++j) {
          acc[j] = fmaf(a_f, acc[j], b_f);
          em[j] = expm1f(acc[j]);
        }
#pragma unroll
        for (int pw = 0; pw < L::kPer / 4; ++pw) {
          float e[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float pre = acc[4 * pw + j];
            e[j] = pre > 0.0f ? pre : em[4 * pw + j];
          }
          const int q = tq * kPool + pg * (L::kPer / 4) + pw;
          if (f0 + f < F2 && q < t_pool) {
            const float pooled = ((e[0] + e[1]) + (e[2] + e[3])) * 0.25f;
            orow[q] = set_ok ? pooled : __int_as_float(0x7fc00000);   // NaN
          }
        }
      }
    }
  }
}

// Opts the `kPool` kernel in to `bytes` of dynamic shared memory, once
// per size that grows.
template <int kPool>
cudaError_t ensure_smem(size_t bytes) {
  static std::mutex lock;
  static size_t opted = 48 * 1024;
  std::lock_guard<std::mutex> guard(lock);
  if (bytes <= opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      block1_stacked_kernel<kPool>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) opted = bytes;
  return err;
}

template <int kPool>
int blocks_per_sm(int C, int F2) {
  const int f2p = (F2 + kFTile - 1) / kFTile * kFTile;
  const size_t bytes = smem_bytes<kPool>(C, f2p);
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&limit,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev) != cudaSuccess
      || bytes > static_cast<size_t>(limit)
      || ensure_smem<kPool>(bytes) != cudaSuccess) {
    cudaGetLastError();   // clear a failed query's error
    return 0;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, block1_stacked_kernel<kPool>, kThreads, bytes) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

template <int kPool>
int launch(const float* x, const float* S, const float* W, const float* A,
           const float* B, const int* idx, float* out, int n_b, int C, int T,
           int F2, int G, int per_block, cudaStream_t stream) {
  const int t_pool = T / 4;
  const int n_tq = (t_pool + kPool - 1) / kPool;
  const long long n_items = static_cast<long long>(n_b) * n_tq;
  const long long grid = (n_items + per_block - 1) / per_block;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int f2p = (F2 + kFTile - 1) / kFTile * kFTile;
  const size_t bytes = smem_bytes<kPool>(C, f2p);
  const cudaError_t err = ensure_smem<kPool>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  block1_stacked_kernel<kPool>
      <<<static_cast<unsigned>(grid), kThreads, bytes, stream>>>(x, S, W, A, B, idx, out, C, T, F2, G, n_tq, n_items,
                   per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The two work-item lengths, in pooled outputs; the wrapper checks them
// against its own constants.
int eeg_block1_stacked_long_pool() { return kLongPool; }
int eeg_block1_stacked_short_pool() { return kShortPool; }

// Blocks of the `pool` kernel one SM holds at (C, F2); 0 when a block's
// shared memory does not fit (or `pool` is neither length).
int eeg_block1_stacked_blocks_per_sm(int pool, int C, int F2) {
  if (C <= 0 || F2 <= 0) return 0;
  if (pool == kLongPool) return blocks_per_sm<kLongPool>(C, F2);
  if (pool == kShortPool) return blocks_per_sm<kShortPool>(C, F2);
  return 0;
}

// Launches K1-stacked on `stream`: work items of `pool` pooled outputs
// (kLongPool or kShortPool), `per_block` consecutive items a block.
// Pointers are device pointers to contiguous arrays: x (n_b, C, T) f32,
// S (G, F2, C), W (G, F2, 32), A and B (G, F2) f32, idx (n_b,) int32,
// out (n_b, F2, T/4) f32.  Returns the launch's cudaError_t.
int eeg_block1_stacked_launch(const float* x, const float* S, const float* W,
                              const float* A, const float* B, const int* idx,
                              float* out, int n_b, int C, int T, int F2,
                              int G, int pool, int per_block, void* stream) {
  if (idx == nullptr || n_b <= 0 || C <= 0 || T < 4 || F2 <= 0 || G <= 0
      || per_block <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (pool == kLongPool) {
    return launch<kLongPool>(x, S, W, A, B, idx, out, n_b, C, T, F2, G,
                             per_block, s);
  }
  if (pool == kShortPool) {
    return launch<kShortPool>(x, S, W, A, B, idx, out, n_b, C, T, F2, G,
                              per_block, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* eeg_block1_stacked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
