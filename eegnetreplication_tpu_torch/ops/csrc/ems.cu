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
// What bounds it on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32 without
// tensor cores): a competition session after the 128 Hz resample is
// (22, 345600), 30.4 MB; reading it once and writing it once moves 60.8 MB,
// ~18 us, while its ~12 FLOP per sample (91 MFLOP) take ~1.4 us.  Bytes
// bound it, so every SM has to stream, and no sample may be read twice.
//
// Design: one block per tile of kTile samples of one channel, so the
// session is 22 x 85 = 1870 blocks over the 132 SMs (eight resident on each,
// at 32 registers a thread).  The earlier design gave each channel one block
// that walked its 85 tiles in order: 22 of 132 SMs, two block scans in
// sequence per tile.
//  - Order.  A block takes its tile from an atomicAdd ticket in the order
//    blocks start, not from blockIdx, tile-major over the channels: every
//    tile it waits on belongs to a block that started earlier and waits only
//    on earlier ones, so waiting cannot deadlock.
//  - The tile stays on chip.  It comes in once with coalesced loads into a
//    shared-memory buffer (skewed by one word per 32, so the kItems
//    consecutive words of a thread read without bank conflicts), stays
//    there across both waits (z, then the deviations, overwrite it in
//    place), and goes out once with coalesced stores.
//  - Inside a tile (as before): thread i owns kItems consecutive samples;
//    each recurrence is run serially over them from 0, a block-wide
//    exclusive scan of those partial sums (warp shuffles, then one warp over
//    the warp totals) gives each thread the state entering its span from a
//    zero state at the tile start, and the thread reruns its samples from
//    there.
//  - Across tiles, two waits.  The mean's zero-start aggregate b_m of a
//    tile (the state at its end from m = 0 at its start, coefficient c^L
//    for L = kTile samples) needs only the tile, so the block publishes it
//    at once.  The state entering tile k is m_in = sum_{j<k} c^(L(k-1-j))
//    b_m[j]: the block waits for its predecessors' b_m and folds them.  Only
//    then can it form the deviations and its variance aggregate b_v, which
//    it publishes before it waits for its predecessors' b_v and folds them
//    into v_in = c^(Lk) var0 + sum_{j<k} c^(L(k-1-j)) b_v[j].  No block
//    waits on a chain: every aggregate is published as soon as its own
//    tile (and, for b_v, the b_m before it) allows.
//  - Publishing.  An aggregate and its flag share one 64-bit word (flag in
//    the high half, the float's bits in the low), stored with one
//    st.release.gpu.  Since nothing else of the publishing block is read,
//    the waiting warp polls with ld.relaxed.gpu: a single-copy-atomic load
//    of the word sees zero or the whole aggregate.  Each lane keeps kPoll
//    such loads in flight.  The wrapper zeroes the status words (and the
//    ticket counter) for every launch.
//  - Determinism.  A block folds aggregates, each computed from one tile
//    alone, never an inclusive prefix whose availability depends on timing
//    (the classic decoupled look-back does that): warp 0's lane l sums the
//    terms j = l, l + 32, ... in that order, and a fixed butterfly of
//    shuffles adds the 32 lanes.  Every launch on the same input gives the
//    same bits.
//  - Coefficients.  Every span is a whole number of samples, so every
//    coefficient is c^n, read from a table the host computes in float64 from
//    the f32 c and rounds to f32 once (not powf in f32): c^(kItems i) for the
//    spans inside a tile, c^(kTile j) for whole tiles.
//  - A ragged last tile is masked: loads past T read as z = 0 and stores
//    past T are skipped.  The scan is causal, so the padding cannot reach a
//    valid output, and the last tile's aggregates are not published.
// What still holds it back (PERF.md): the 1870 blocks run as about two
// waves of 1056, each loading together, computing together and storing
// together, so the in-tile arithmetic (the correctly rounded square root
// and division above all) does not overlap the memory stream.
// A persistent variant that prefetched its next tile measured slower: a
// prefetched tile publishes its aggregates late, and the next tile of its
// channel waits for it.
// IEEE f32 throughout (no fast-math): sqrtf and the division round
// correctly, and within a thread the recurrences run in the same order as
// the sequential scan.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                     // samples per thread
constexpr int kTile = kThreads * kItems;       // 4096 samples per block
constexpr int kWarps = kThreads / 32;
constexpr int kBuf = kTile + kTile / 32;       // skewed tile buffer
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPoll = 4;                       // polls in flight a lane

__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

__device__ __forceinline__ void publish(unsigned long long* word, float v) {
  const unsigned long long w =
      (1ull << 32) | static_cast<unsigned long long>(__float_as_uint(v));
  asm volatile("st.release.gpu.global.b64 [%0], %1;"
               :: "l"(word), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* word) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(w) : "l"(word) : "memory");
  return w;
}

// init * c^(Lk) + sum_{j<k} c^(L(k-1-j)) agg[j], by the 32 lanes of one
// warp in a fixed order, after each agg[j]'s flag is seen.  tile_pow[n] is
// c^(kTile n).  Every lane returns the same value.
__device__ float fold(const unsigned long long* agg, int k,
                      const float* __restrict__ tile_pow, float init) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int j0 = 0; j0 < k; j0 += 32 * kPoll) {
    unsigned long long w[kPoll];
#pragma unroll
    for (int u = 0; u < kPoll; ++u) {
      const int j = j0 + 32 * u + lane;
      w[u] = j < k ? peek(agg + j) : (1ull << 32);
    }
#pragma unroll
    for (int u = 0; u < kPoll; ++u) {
      const int j = j0 + 32 * u + lane;
      while ((w[u] >> 32) == 0) {
        __nanosleep(64);
        w[u] = peek(agg + j);
      }
      if (j < k) {
        s = fmaf(tile_pow[k - 1 - j],
                 __uint_as_float(static_cast<unsigned>(w[u])), s);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return fmaf(tile_pow[k], init, s);
}

// Inclusive scan across the first `width` lanes of a warp (width a power of
// two, <= 32) of s = c^span * s_prev + b, where each lane covers `unit`
// spans of kItems samples: at the step with offset o a lane joins o lanes'
// worth, whose coefficient is spans[unit * o] = c^(kItems unit o).
__device__ __forceinline__ float warp_scan(float b, int lane, int width,
                                           int unit, const float* spans) {
  for (int o = 1; o < width; o <<= 1) {
    const float other = __shfl_up_sync(kFull, b, o);
    if (lane >= o) b = fmaf(spans[unit * o], other, b);
  }
  return b;
}

// Exclusive block-wide scan of the threads' partial sums b (each spanning
// kItems samples, started from 0).  Returns (x) the state entering the
// thread's span from a zero state at the tile start and (y) the state at
// the tile end.  scratch holds 2 * kWarps + 1 floats.
__device__ __forceinline__ float2 block_scan(float b, const float* spans,
                                             float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float incl = warp_scan(b, lane, 32, 1, spans);
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float w = lane < kWarps ? scratch[lane] : 0.0f;
    const float w_incl = warp_scan(w, lane, kWarps, 32, spans);
    float w_excl = __shfl_up_sync(kFull, w_incl, 1);
    if (lane == 0) w_excl = 0.0f;
    if (lane < kWarps) scratch[kWarps + lane] = w_excl;
    if (lane == kWarps - 1) scratch[2 * kWarps] = w_incl;
  }
  __syncthreads();
  return make_float2(fmaf(spans[lane], scratch[kWarps + warp], excl),
                     scratch[2 * kWarps]);
}

// status: [0] the ticket counter, then the mean aggregates (n_ch, n_tiles),
// then the variance aggregates (n_ch, n_tiles); zero at launch.
// powers: c^(kItems i) for i = 0..kThreads, then c^(kTile j) for
// j = 0..n_tiles-1.
__global__ void __launch_bounds__(kThreads, 8) ems_kernel(
    const float* __restrict__ x, const float* __restrict__ mean0,
    const float* __restrict__ var0, const float* __restrict__ powers,
    unsigned long long* status, float* __restrict__ out, int n_ch,
    int t_total, int n_tiles, float a, float c, float eps) {
  __shared__ float buf[kBuf];
  __shared__ float spans[kThreads + 1];
  __shared__ float scratch[2 * kWarps + 1];
  __shared__ int ticket;
  __shared__ float m_in;
  __shared__ float v_in;

  const int tid = threadIdx.x;
  if (tid == 0) {
    ticket = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned int*>(status), 1u));
  }
  for (int i = tid; i <= kThreads; i += kThreads) spans[i] = powers[i];
  __syncthreads();
  const int tile = ticket / n_ch;
  const int ch = ticket - tile * n_ch;
  const int start = tile * kTile;
  const int len = min(kTile, t_total - start);
  const size_t row = static_cast<size_t>(ch) * t_total + start;
  const float* tile_pow = powers + kThreads + 1;
  unsigned long long* agg_m = status + 1 + static_cast<size_t>(ch) * n_tiles;
  unsigned long long* agg_v = agg_m + static_cast<size_t>(n_ch) * n_tiles;
  const bool has_successor = tile + 1 < n_tiles;
  const float mu = mean0[ch];

  float v[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int idx = j * kThreads + tid;
    v[j] = idx < len ? x[row + idx] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int idx = j * kThreads + tid;
    buf[skew(idx)] = idx < len ? v[j] - mu : 0.0f;
  }
  __syncthreads();

  // The mean: zero-start partial sums, the tile's aggregate, then m_in.
  float* mine = buf + skew(tid * kItems);   // kItems words, no skew inside
  float part = 0.0f;
#pragma unroll
  for (int s = 0; s < kItems; ++s) part = c * part + a * mine[s];
  const float2 ms = block_scan(part, spans, scratch);
  if (tid < 32) {
    if (tid == 0 && has_successor) publish(agg_m + tile, ms.y);
    const float folded = fold(agg_m, tile, tile_pow, 0.0f);
    if (tid == 0) m_in = folded;
  }
  __syncthreads();
  const float m_enter = fmaf(spans[tid], m_in, ms.x);

  // The variance: deviations from the finished mean (kept in place of z),
  // the aggregate, v_in.
  float m = m_enter;
  part = 0.0f;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const float z = mine[s];
    m = c * m + a * z;
    const float dev = z - m;
    mine[s] = dev;
    part = c * part + a * (dev * dev);
  }
  const float2 vs = block_scan(part, spans, scratch);
  if (tid < 32) {
    if (tid == 0 && has_successor) publish(agg_v + tile, vs.y);
    const float folded = fold(agg_v, tile, tile_pow, var0[ch]);
    if (tid == 0) v_in = folded;
  }
  __syncthreads();

  // The output, over the thread's own words in place.
  float var = fmaf(spans[tid], v_in, vs.x);
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const float dev = mine[s];
    var = c * var + a * (dev * dev);
    mine[s] = dev / sqrtf(var + eps);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int idx = j * kThreads + tid;
    if (idx < len) out[row + idx] = buf[skew(idx)];
  }
}

}  // namespace

extern "C" {

// Samples per tile and per thread: the host's tables of c^n are built for
// them (ops/ems_kernel.py::_powers).
int eeg_ems_tile() { return kTile; }
int eeg_ems_items() { return kItems; }

const char* eeg_ems_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches K2 on `stream` (a cudaStream_t) over x (C, T): one block per
// tile, n_tiles = ceil(T / kTile) per channel.  powers holds c^(kItems i)
// for i = 0..kThreads, then c^(kTile j) for j = 0..n_tiles-1, as f32;
// status holds 1 + 2 * C * n_tiles zeroed 64-bit words.  Returns the
// launch's cudaError_t.
int eeg_ems_launch(const void* x, const void* mean0, const void* var0,
                   const void* powers, void* status, void* out,
                   int n_channels, int t_total, float a, float c, float eps,
                   void* stream) {
  if (n_channels <= 0 || t_total <= 0) return cudaSuccess;
  const int n_tiles = (t_total - 1) / kTile + 1;
  const long long n_blocks = static_cast<long long>(n_channels) * n_tiles;
  if (n_blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  ems_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(mean0),
      static_cast<const float*>(var0), static_cast<const float*>(powers),
      static_cast<unsigned long long*>(status), static_cast<float*>(out),
      n_channels, t_total, n_tiles, a, c, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
