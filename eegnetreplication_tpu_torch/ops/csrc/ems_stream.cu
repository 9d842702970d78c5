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
// order, and a lone warp issues about one f32 instruction every other
// cycle, so the step's 9 operations cost ~18 cycles a sample in one thread
// however they are scheduled (utils/k2s_variants.py measures both; the
// numbers are in PERF.md).  So only the two chains run in order, each on a warp
// of its own and each two operations a sample, c * m + a * z and
// c * v + a * d * d; a * z, d = z - m and a * d * d, which neither chain
// waits on, are formed by whole warps, 32 samples at a time.
//
// Design: one block of kThreads for kChannels channels (one by default), so
// a session's channels run on as many SMs, and inside a block one warp a
// role over a ring of kRing tiles of kTile samples, handed on by mbarriers
// (no block-wide barrier after the start):
//  - the producer warp (kWarpProducer) keeps kAhead - 1 tiles of x in
//    flight with cp.async into a staging ring: 16-byte copies from the
//    aligned address at or below each 16-byte chunk (the tile lands shifted
//    by the row's misalignment, 0-3 floats), 4-byte copies at a row's
//    ragged ends.  When a tile has landed and its ring slot is free
//    ("empty"), it writes z = x - mean0 and a * z into the slot and signals
//    "full";
//  - the m warp (kWarpM), one lane a channel, steps m over a full slot's
//    a * z, kGroup samples at a time read as float4s one group ahead of
//    their steps, leaves m in the slot, and signals "stepped";
//  - the square warp (kWarpSquare) writes d = z - m over m and a * d * d
//    over a * z and signals "squared";
//  - the v warp (kWarpV) steps v over it the same way as the m warp, leaves
//    v beside it, and signals "ready";
//  - the output warp (kWarpOut) takes the square roots and divisions of a
//    ready slot, signals "empty", and stores the tile with coalesced
//    stores.
// The ring holds kRing tiles, so the producer runs up to kRing tiles ahead
// of the chains and they never wait for memory after the first tile.
// A chunk of at most kPush samples (a live push of 25, a second's 250)
// skips the ring: the m warp stages it, steps it on its lanes with the
// whole step and writes it out, with no hand-off (for one tile the ring's
// stages run in turn; measured slower, utils/k2s_variants.py push_off).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kChannels = 1;       // channels a block: a chain warp's lanes
constexpr int kTile = 512;         // samples a ring slot holds per channel
constexpr int kRing = 4;           // ring slots
constexpr int kAhead = 2;          // x tiles the producer keeps in flight
constexpr int kGroup = 32;         // samples a chain warp reads ahead
constexpr int kPush = 256;         // chunks this short run on one warp
// Warp w runs on the SM's scheduler w % 4 (utils/k2s_variants.py
// v_on_m_scheduler moves the v warp onto the m warp's): the two chains each
// get one of their own.
constexpr int kThreads = 256;      // 8 warps, one a role or idle:
constexpr int kWarpM = 0;          //   steps m
constexpr int kWarpV = 1;          //   steps v
constexpr int kWarpProducer = 2;   //   copies x, writes z and a * z
constexpr int kWarpOut = 3;        //   divides, roots and stores
constexpr int kWarpSquare = 6;     //   writes z - m and a * d * d
constexpr int kPitch = kTile + 4;  // a row in a slot: 16-byte rows, shift room
constexpr int kChunks = kPitch / 4;  // 16-byte chunks of a staged row

static_assert(kChannels >= 1 && kChannels <= 32, "one lane a channel");
static_assert(kAhead >= 2 && kAhead <= kRing - 2,
              "the producer converts a tile while later ones load, and the "
              "ring leaves the chain slack");
static_assert(kTile % kGroup == 0 && kGroup % 4 == 0, "whole float4 groups");
static_assert(kChannels * kTile % 32 == 0, "the producer's lanes share rows");
static_assert(kPush <= kTile, "a push fits one slot");

constexpr size_t kSmemBytes =
    5 * kRing * sizeof(uint64_t)
    + sizeof(float) * kChannels * (kPitch * (kAhead + 4 * kRing) + 4);

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed, polling (each
// role's warp is alone on its scheduler, so the spin costs the chain
// nothing, and a polling warp resumes as soon as the phase completes).
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// One step from z = x - mean0: the carry (m, v) advances and z - m is
// returned.
__device__ __forceinline__ float step(float z, float a, float c, float& m,
                                      float& v) {
  m = __fadd_rn(__fmul_rn(c, m), __fmul_rn(a, z));
  const float d = __fsub_rn(z, m);
  v = __fadd_rn(__fmul_rn(c, v), __fmul_rn(a, __fmul_rn(d, d)));
  return d;
}

// The chain of each carry in step: s advances from s * c + u (u = a * z for
// m, a * d * d for v, each rounded on its own as step rounds it) and is
// returned.
__device__ __forceinline__ float step_carry(float u, float c, float& s) {
  s = __fadd_rn(__fmul_rn(c, s), u);
  return s;
}

// One chain warp's lane over `len` samples of a slot row: out[j] = the
// carry after step_carry(in[j]), in order, kGroup samples at a time read as
// float4s one group ahead of their steps, into two buffers in turn (no
// register copies between groups).  The loop over pairs of groups is not
// unrolled, so the chains' code stays in the SM's instruction cache
// (unrolled over a whole tile, they slowed down as more SMs ran them:
// utils/k2s_variants.py, PERF.md).
__device__ __forceinline__ void chain_row(const float* in, float* out,
                                          int len, float c, float& carry) {
  constexpr int kVec = kGroup / 4;
  const int whole = len / kGroup;
  float4 buf[2][kVec];
  auto load = [&](float4 (&dst)[kVec], int g) {
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      dst[u] = reinterpret_cast<const float4*>(in + g * kGroup)[u];
    }
  };
  auto run = [&](const float4 (&src)[kVec], int g) {
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      float4 r;
      r.x = step_carry(src[u].x, c, carry);
      r.y = step_carry(src[u].y, c, carry);
      r.z = step_carry(src[u].z, c, carry);
      r.w = step_carry(src[u].w, c, carry);
      reinterpret_cast<float4*>(out + g * kGroup)[u] = r;
    }
  };
  if (whole > 0) load(buf[0], 0);
#pragma unroll 1
  for (int g = 0; g < whole; g += 2) {
    if (g + 1 < whole) load(buf[1], g + 1);
    run(buf[0], g);
    if (g + 1 == whole) break;
    if (g + 2 < whole) load(buf[0], g + 2);
    run(buf[1], g + 1);
  }
  for (int j = whole * kGroup; j < len; ++j) {
    out[j] = step_carry(in[j], c, carry);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ems_stream_kernel(const float* __restrict__ x,
                  const float* __restrict__ mean0,
                  float* __restrict__ m, float* __restrict__ v,
                  float* __restrict__ out, int n_channels, long long n,
                  float a, float c, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* stepped = full + kRing;
  uint64_t* squared = stepped + kRing;
  uint64_t* ready = squared + kRing;
  uint64_t* empty = ready + kRing;
  float* staged = reinterpret_cast<float*>(empty + kRing);    // kAhead slots
  float* zs = staged + kAhead * kChannels * kPitch;          // z
  float* ps = zs + kRing * kChannels * kPitch;               // a z, then a d d
  float* ms = ps + kRing * kChannels * kPitch;               // m, then d
  float* vs = ms + kRing * kChannels * kPitch;               // v
  float* mu = vs + kRing * kChannels * kPitch;               // mean0

  const int ch0 = blockIdx.x * kChannels;
  const int rows = min(kChannels, n_channels - ch0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  auto row_of = [&](int r, int tile) {         // x at (ch0 + r, tile start)
    return x + static_cast<long long>(ch0 + r) * n
        + static_cast<long long>(tile) * kTile;
  };
  auto tile_len = [&](int tile) {
    return static_cast<int>(min(static_cast<long long>(kTile),
                                n - static_cast<long long>(tile) * kTile));
  };
  // The misalignment of a row's tile start in floats: sample j of the tile
  // lands at staged column shift + j.
  auto shift_of = [&](const float* p) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
  };
  // The producer's copies of tile i into staging slot i % kAhead.
  auto issue = [&](int i) {
    float* slot = staged + (i % kAhead) * kChannels * kPitch;
    const int len = tile_len(i);
    for (int task = lane; task < rows * kChunks; task += 32) {
      const int r = task / kChunks;
      const int k = task % kChunks;
      const float* src = row_of(r, i);
      const int j0 = 4 * k - shift_of(src);    // the chunk's first sample
      float* dst = slot + r * kPitch + 4 * k;
      if (j0 >= 0 && j0 + 4 <= len) {
        copy16(dst, src + j0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j0 + e >= 0 && j0 + e < len) copy4(dst + e, src + j0 + e);
        }
      }
    }
  };

  float cm = 0.0f, cv = 0.0f;
  const bool chain = lane < rows;
  if (n <= kPush) {
    // A push: the m warp alone stages z, runs the whole step on its lanes
    // and writes out; no hand-off, no barrier.
    if (warp != kWarpM) return;
    for (int r = 0; r < rows; ++r) {
      const float mu_r = mean0[ch0 + r];
      for (int j = lane; j < n; j += 32) {
        zs[r * kPitch + j] = __fsub_rn(row_of(r, 0)[j], mu_r);
      }
    }
    __syncwarp();
    if (chain) {
      float* zr = zs + lane * kPitch;
      float* vr = vs + lane * kPitch;
      cm = m[ch0 + lane];
      cv = v[ch0 + lane];
      for (int j = 0; j < n; ++j) {
        zr[j] = step(zr[j], a, c, cm, cv);
        vr[j] = cv;
      }
      m[ch0 + lane] = cm;
      v[ch0 + lane] = cv;
    }
    __syncwarp();
    for (int r = 0; r < rows; ++r) {
      for (int j = lane; j < n; j += 32) {
        out[static_cast<long long>(ch0 + r) * n + j] = __fdiv_rn(
            zs[r * kPitch + j], __fsqrt_rn(__fadd_rn(vs[r * kPitch + j],
                                                      eps)));
      }
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      bar_init(&full[s], 32);
      bar_init(&stepped[s], 32);
      bar_init(&squared[s], 32);
      bar_init(&ready[s], 32);
      bar_init(&empty[s], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (warp == kWarpM && chain) cm = m[ch0 + lane];
  if (warp == kWarpV && chain) cv = v[ch0 + lane];
  if (warp == kWarpProducer) {
    // The first tiles' copies leave before the block's one barrier.
#pragma unroll
    for (int i = 0; i < kAhead - 1; ++i) {
      if (i < n_tiles) issue(i);
      copy_commit();
    }
    if (lane < rows) mu[lane] = mean0[ch0 + lane];
  }
  __syncthreads();   // the mbarriers and mu

  if (warp == kWarpProducer) {
    // Producer: tile j, landed, becomes z in ring slot j % kRing once the
    // output warp has emptied it; then tile j + kAhead - 1's copies go out
    // into the staging slot tile j - 1 left.
    constexpr int kPer = kChannels * kTile / 32;   // elements a lane
    for (int j = 0; j < n_tiles; ++j) {
      copy_wait<kAhead - 2>();
      __syncwarp();
      if (j >= kRing) bar_wait(&empty[j % kRing], ((j / kRing) - 1) & 1);
      const float* slot = staged + (j % kAhead) * kChannels * kPitch;
      float (*dev)[kPitch] =
          reinterpret_cast<float (*)[kPitch]>(zs + (j % kRing) * kChannels
                                              * kPitch);
      float (*prod)[kPitch] =
          reinterpret_cast<float (*)[kPitch]>(ps + (j % kRing) * kChannels
                                              * kPitch);
      const int len = tile_len(j);
      float reg[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = lane + k * 32;
        const int r = e / kTile, col = e % kTile;
        reg[k] = (r < rows && col < len)
                     ? slot[r * kPitch + shift_of(row_of(r, j)) + col]
                     : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = lane + k * 32;
        const float z = __fsub_rn(reg[k], mu[e / kTile]);
        dev[e / kTile][e % kTile] = z;
        prod[e / kTile][e % kTile] = __fmul_rn(a, z);
      }
      bar_arrive(&full[j % kRing]);
      __syncwarp();   // every lane has read staging slot j % kAhead
      if (j + kAhead - 1 < n_tiles) issue(j + kAhead - 1);
      copy_commit();
    }
  } else if (warp == kWarpM) {
    // The m warp: one lane a channel, tile after tile; d replaces z.
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kRing;
      bar_wait(&full[s], (i / kRing) & 1);
      if (chain) {
        chain_row(ps + (s * kChannels + lane) * kPitch,
                  ms + (s * kChannels + lane) * kPitch, tile_len(i), c, cm);
      }
      bar_arrive(&stepped[s]);
    }
    if (chain) m[ch0 + lane] = cm;
  } else if (warp == kWarpSquare) {
    // d = z - m and a * d * d of every sample of a stepped slot, over its
    // lanes, in place of m and a * z.
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kRing;
      bar_wait(&stepped[s], (i / kRing) & 1);
      const int len = tile_len(i);
      for (int r = 0; r < rows; ++r) {
        const float* zr = zs + (s * kChannels + r) * kPitch;
        float* qr = ps + (s * kChannels + r) * kPitch;
        float* dr = ms + (s * kChannels + r) * kPitch;
        for (int j = lane; j < len; j += 32) {
          const float d = __fsub_rn(zr[j], dr[j]);
          dr[j] = d;
          qr[j] = __fmul_rn(a, __fmul_rn(d, d));
        }
      }
      bar_arrive(&squared[s]);
    }
  } else if (warp == kWarpV) {
    // The v warp: v from a * d * d, tile after tile.
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kRing;
      bar_wait(&squared[s], (i / kRing) & 1);
      if (chain) {
        chain_row(ps + (s * kChannels + lane) * kPitch,
                  vs + (s * kChannels + lane) * kPitch, tile_len(i), c, cv);
      }
      bar_arrive(&ready[s]);
    }
    if (chain) v[ch0 + lane] = cv;
  } else if (warp == kWarpOut) {
    // Output: out = (z - m) / sqrt(v + eps), coalesced along each row.  The
    // slot is emptied before the stores.
    constexpr int kOut = kChannels * kTile / 32;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kRing;
      bar_wait(&ready[s], (i / kRing) & 1);
      const float (*dev)[kPitch] = reinterpret_cast<const float (*)[kPitch]>(
          ms + s * kChannels * kPitch);
      const float (*var)[kPitch] = reinterpret_cast<const float (*)[kPitch]>(
          vs + s * kChannels * kPitch);
      const int len = tile_len(i);
      const long long t0 = static_cast<long long>(i) * kTile;
      float res[kOut];
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const int e = lane + k * 32;
        const int r = e / kTile, j = e % kTile;
        res[k] = (r < rows && j < len)
            ? __fdiv_rn(dev[r][j], __fsqrt_rn(__fadd_rn(var[r][j], eps)))
            : 0.0f;
      }
      bar_arrive(&empty[s]);
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const int e = lane + k * 32;
        const int r = e / kTile, j = e % kTile;
        if (r < rows && j < len) {
          out[static_cast<long long>(ch0 + r) * n + t0 + j] = res[k];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Channels a block: the wrapper checks it against its own constant.
int eeg_ems_stream_channels() { return kChannels; }

const char* eeg_ems_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches K2s on `stream` (a cudaStream_t) over x (C, n): ceil(C /
// kChannels) blocks of kThreads with kSmemBytes of dynamic shared memory.
// m and v (C,) hold the carry entering the chunk and receive the carry
// leaving it.  Returns the launch's cudaError_t.
int eeg_ems_stream_launch(const void* x, const void* mean0, void* m, void* v,
                          void* out, int n_channels, long long n, float a,
                          float c, float eps, void* stream) {
  if (n_channels <= 0 || n <= 0) return cudaSuccess;
  if (n > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kSmemBytes > 48 * 1024) {
    static std::once_flag once;
    static cudaError_t set = cudaSuccess;
    std::call_once(once, [] {
      set = cudaFuncSetAttribute(ems_stream_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmemBytes));
    });
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const int blocks = (n_channels - 1) / kChannels + 1;
  ems_stream_kernel<<<blocks, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(mean0),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<float*>(out), n_channels, n, a, c, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
