// bn_spatial: EEGNet's first training BatchNorm (temporal.1, flax mode) and
// the depthwise spatial convolution after it, forward and backward, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package leaves this chain of its
// banded training forward (models/eegnet.py, the BatchNorm then the
// "gbctf,gfdc->gbtfd" contraction of ops/banded.py) to XLA's fusion.  The
// port ran it as PyTorch ops on permuted views: some thirty strided passes
// over the temporal convolution's output h a train step, forward and
// backward, the largest block of a 90-fold step's time.  Per fold g and
// feature f1 of F1, with N = B * C * T:
//
//   m = sum(h) / N,  v = max(sum(h^2) / N - m^2, 0),  inv = scale / sqrt(v + eps)
//   y[g,b,c,t,f1] = (h - m) * inv + bias
//   out[g,b,t,f1*D+d] = sum_c s[g,f1,d,c] * y[g,b,c,t,f1]
//   running mean and var <- keep * running + take * (m, v)
//
// and the gradients of out with respect to h, scale, bias and s, as
// autograd differentiates that composition (through m and through
// v = m2 - m^2, the clamp's gradient zero where m2 - m^2 < 0).
//
// h is (G, B, C, T, F1) f32 with F1 innermost; a (g, b, c) row holds
// L = T * F1 contiguous floats and rows lie `pitch` floats apart (pitch = L
// when h is contiguous, more when the banded convolution's tiled path left
// T a slice of a longer axis).  s is (G, F1, D, C), out and dout
// (G, B, T, F1 * D) contiguous, dh (G, B, C, T, F1) contiguous.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32 without
// tensor cores): ~3 FLOP a byte of h, so the bytes.  At the 90-fold train
// step, (90, 64, 22, 257, 8) with D = 2, h is 1.04 GB and out 95 MB.  The
// four passes move 2.18 GB forward and 3.31 GB backward, ~1.64 ms at the
// card's bandwidth; reading each input and writing each output once would
// take 0.34 + 0.65 ms, but the statistics must be complete before anything
// is normalised, and the BatchNorm's input gradient needs the sums of
// pass C over the whole fold first.
//
// Design, four passes over h and two small combines:
//  A. Statistics: blocks of kThreads each walk rows of one fold, a warp a
//     row at a time, a lane reading V consecutive floats (16-byte loads when
//     the layout allows, V = 4; else V = 1), four loads in flight.  Since
//     F1 divides 32 * V, a lane always reads the same features: it sums them
//     in registers (f32 within a row, f64 across rows), and the block
//     reduces by warp shuffles and shared memory into per-feature partials.
//  A'. One thread a (g, f1) adds the fold's partials in block order (f64),
//     writes mean, inv, 1/sqrt(v + eps) and whether the clamp passed, and
//     the running statistics.
//  B. Forward: a thread owns V consecutive elements of one (g, b) row
//     position and walks the C rows, normalising on the fly and summing
//     over c in registers (the fold's taps staged in shared memory), so the
//     normalised 1 GB tensor is never written; it writes V * D contiguous
//     outputs.
//  C. Backward sums: a block per (g, b, tile of a row) stages its dout tile
//     in shared memory; each warp walks whole rows c, recomputing
//     dy = sum_d s * dout and y, and sums sum(dy) and sum(dy * (h - m)) per
//     feature and, per row, y * dout per (f1, d): a warp shuffle reduces that
//     row's sums, written as one partial per (g, b, tile, c).
//  C'. One thread per (g, f1, d, c) adds the s-gradient partials over
//     (b, tile) in order (f64); one per (g, f1) adds the BatchNorm sums and
//     writes the scale and bias gradients and the two coefficients of
//     dh = dy * inv + c0 + c1 * (h - m).
//  D. Input gradient: pass B's mapping; a thread keeps its V * D dout values
//     in registers and writes dh for every row c.
// No float atomics anywhere: every sum runs in a fixed order, so two runs
// are bitwise equal.  IEEE f32 arithmetic (no fast-math), f64 for the sums
// across rows and blocks.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // every main pass
constexpr int kWarps = kThreads / 32;
constexpr int kMaxF1 = 32;                    // F1 must divide 32
constexpr int kTileFloats = 8192;             // pass C's dout tile, 32 KB
constexpr unsigned kFull = 0xffffffffu;

struct Geo {
  int G, B, C, T, F1;
  int L;              // T * F1, the floats of one (g, b, c) row
  long long pitch;    // floats between consecutive rows of h
};

template <int V>
__device__ __forceinline__ void load_row(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = *p;
  }
}

// Fold a lane's W values a element onto its distinct features: with V = 4
// and F1 < 4 (1 or 2, as F1 divides 32) element k holds feature k % F1.
// Indices stay compile-time constants, so the arrays stay in registers.
template <int V, int W, typename T>
__device__ __forceinline__ void fold_features(T (&v)[V * W], int F1) {
  if constexpr (V == 4) {
    if (F1 == 2) {
#pragma unroll
      for (int i = 0; i < 2 * W; ++i) v[i] += v[2 * W + i];
    } else if (F1 == 1) {
#pragma unroll
      for (int k = 1; k < 4; ++k) {
#pragma unroll
        for (int i = 0; i < W; ++i) v[i] += v[k * W + i];
      }
    }
  }
}

// Add a lane's values over the lanes that hold the same features: lanes
// congruent modulo span = max(F1 / V, 1).  Afterwards lane l < span holds
// the warp's totals of features V * l + k, k < min(V, F1).
template <int N, typename T>
__device__ __forceinline__ void warp_feature_sums(T (&v)[N], int span) {
  for (int off = 16; off >= span; off >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(kFull, v[i], off);
  }
}

// Pass A.  Grid (per_fold, G); part is (G, per_fold, F1, 2) f64.
template <int V>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const float* __restrict__ h, Geo geo, int per_fold,
             double* __restrict__ part) {
  __shared__ double red[2][kWarps][kMaxF1];
  const int g = blockIdx.y, j = blockIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rows = geo.B * geo.C;
  const int step = 32 * V;
  double s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.0;
  for (int r = j * kWarps + w; r < rows; r += per_fold * kWarps) {
    const float* row = h + (static_cast<long long>(g) * rows + r) * geo.pitch;
    float a1[V], a2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) a1[k] = a2[k] = 0.0f;
    int e = V * lane;
    for (; e + 3 * step < geo.L; e += 4 * step) {
      float x[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) load_row<V>(row + e + u * step, x[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          a1[k] += x[u][k];
          a2[k] = fmaf(x[u][k], x[u][k], a2[k]);
        }
      }
    }
    for (; e < geo.L; e += step) {
      float x[V];
      load_row<V>(row + e, x);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a1[k] += x[k];
        a2[k] = fmaf(x[k], x[k], a2[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s1[k] += a1[k];
      s2[k] += a2[k];
    }
  }
  const int span = geo.F1 > V ? geo.F1 / V : 1;
  const int nf = geo.F1 < V ? geo.F1 : V;
  fold_features<V, 1>(s1, geo.F1);
  fold_features<V, 1>(s2, geo.F1);
  warp_feature_sums(s1, span);
  warp_feature_sums(s2, span);
  if (lane < span) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (k < nf) {
        red[0][w][V * lane + k] = s1[k];
        red[1][w][V * lane + k] = s2[k];
      }
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < geo.F1) {
    const int f = threadIdx.x;
    double t1 = 0.0, t2 = 0.0;
    for (int i = 0; i < kWarps; ++i) {
      t1 += red[0][i][f];
      t2 += red[1][i][f];
    }
    double* p = part + ((static_cast<long long>(g) * per_fold + j) * geo.F1
                        + f) * 2;
    p[0] = t1;
    p[1] = t2;
  }
}

// Pass A'.  One thread a (g, f1).  stat is (G, F1, 4) f32: mean, inv
// (scale / sqrt(v + eps)), 1 / sqrt(v + eps), 1 where m2 - m^2 >= 0.
__global__ void stats_combine_kernel(const double* __restrict__ part,
                                     int per_fold, Geo geo, float eps,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ run_mean,
                                     const float* __restrict__ run_var,
                                     float keep, float take,
                                     float* __restrict__ stat,
                                     float* __restrict__ new_mean,
                                     float* __restrict__ new_var) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= geo.G * geo.F1) return;
  const int g = i / geo.F1, f = i % geo.F1;
  double t1 = 0.0, t2 = 0.0;
  for (int j = 0; j < per_fold; ++j) {
    const double* p = part + ((static_cast<long long>(g) * per_fold + j)
                              * geo.F1 + f) * 2;
    t1 += p[0];
    t2 += p[1];
  }
  const double n = static_cast<double>(geo.B) * geo.C * geo.T;
  const double m = t1 / n;
  const double raw = t2 / n - m * m;
  const double v = raw > 0.0 ? raw : 0.0;
  const double r = 1.0 / sqrt(v + static_cast<double>(eps));
  stat[4 * i] = static_cast<float>(m);
  stat[4 * i + 1] = static_cast<float>(r * static_cast<double>(scale[i]));
  stat[4 * i + 2] = static_cast<float>(r);
  stat[4 * i + 3] = raw >= 0.0 ? 1.0f : 0.0f;
  // as the composition rounds it: keep * running + take * batch, in f32
  new_mean[i] = __fadd_rn(__fmul_rn(keep, run_mean[i]),
                          __fmul_rn(take, static_cast<float>(m)));
  new_var[i] = __fadd_rn(__fmul_rn(keep, run_var[i]),
                         __fmul_rn(take, static_cast<float>(v)));
}

// The fold's taps into shared memory as [c][f1 * D + d].
__device__ __forceinline__ void stage_taps(const float* __restrict__ s, int g,
                                           int C, int F2, float* taps) {
  for (int i = threadIdx.x; i < C * F2; i += blockDim.x) {
    const int c = i / F2, fd = i % F2;
    taps[i] = s[(static_cast<long long>(g) * F2 + fd) * C + c];
  }
}

// Pass B.  Grid (ceil(B * L / V / kThreads), G); thread q owns elements
// [V * (q % (L / V)), +V) of the rows of trial b = q / (L / V).
template <int V, int D>
__global__ void __launch_bounds__(kThreads)
forward_kernel(const float* __restrict__ h, const float* __restrict__ s,
               const float* __restrict__ stat, const float* __restrict__ bias,
               float* __restrict__ out, Geo geo) {
  extern __shared__ float taps[];
  const int g = blockIdx.y;
  const int F2 = geo.F1 * D;
  stage_taps(s, g, geo.C, F2, taps);
  __syncthreads();
  const int n_items = geo.L / V;
  const long long q = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (q >= static_cast<long long>(geo.B) * n_items) return;
  const int b = static_cast<int>(q / n_items);
  const int e0 = V * static_cast<int>(q % n_items);
  int fk[V];
  float mk[V], ik[V], bk[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    fk[k] = (e0 + k) % geo.F1;
    const int at = g * geo.F1 + fk[k];
    mk[k] = stat[4 * at];
    ik[k] = stat[4 * at + 1];
    bk[k] = bias[at];
  }
  float acc[V][D];
#pragma unroll
  for (int k = 0; k < V; ++k) {
#pragma unroll
    for (int d = 0; d < D; ++d) acc[k][d] = 0.0f;
  }
  const float* base = h + (static_cast<long long>(g) * geo.B + b) * geo.C
                          * geo.pitch + e0;
  int c = 0;
  for (; c + 3 < geo.C; c += 4) {
    float x[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) load_row<V>(base + (c + u) * geo.pitch, x[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* tc = taps + (c + u) * F2;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float y = fmaf(x[u][k] - mk[k], ik[k], bk[k]);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          acc[k][d] = fmaf(tc[fk[k] * D + d], y, acc[k][d]);
        }
      }
    }
  }
  for (; c < geo.C; ++c) {
    float x[V];
    load_row<V>(base + c * geo.pitch, x);
    const float* tc = taps + c * F2;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float y = fmaf(x[k] - mk[k], ik[k], bk[k]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        acc[k][d] = fmaf(tc[fk[k] * D + d], y, acc[k][d]);
      }
    }
  }
  float* o = out + ((static_cast<long long>(g) * geo.B + b) * geo.L + e0) * D;
  if constexpr (V == 4) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int a = 4 * i;
      reinterpret_cast<float4*>(o)[i] = make_float4(
          acc[a / D][a % D], acc[(a + 1) / D][(a + 1) % D],
          acc[(a + 2) / D][(a + 2) % D], acc[(a + 3) / D][(a + 3) % D]);
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = acc[0][d];
  }
}

// Pass C.  Grid (n_tiles, B, G).  ds_part is (G, B, n_tiles, C, F1 * D)
// f32; bn_part (G, B, n_tiles, F1, 2) f64: sum(dy), sum(dy * (h - m)).
template <int V, int D>
__global__ void __launch_bounds__(kThreads)
backward_sums_kernel(const float* __restrict__ h,
                     const float* __restrict__ dout,
                     const float* __restrict__ s,
                     const float* __restrict__ stat,
                     const float* __restrict__ bias, Geo geo, int tile,
                     float* __restrict__ ds_part,
                     double* __restrict__ bn_part) {
  extern __shared__ float4 smem4[];         // 16-byte aligned
  __shared__ double red[2][kWarps][kMaxF1];
  const int F2 = geo.F1 * D;
  const int j = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int n_tiles = gridDim.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e_lo = j * tile;
  const int e_hi = min(e_lo + tile, geo.L);
  float* dot = reinterpret_cast<float*>(smem4);   // min(tile, L) * D
  float* taps = dot + min(tile, geo.L) * D;        // C * F2
  stage_taps(s, g, geo.C, F2, taps);
  const long long trial = static_cast<long long>(g) * geo.B + b;
  const float* dsrc = dout + (trial * geo.L + e_lo) * D;
  const int n_do = (e_hi - e_lo) * D;
  if constexpr (V == 4) {
    for (int i = threadIdx.x; i < n_do / 4; i += kThreads) {
      reinterpret_cast<float4*>(dot)[i] =
          reinterpret_cast<const float4*>(dsrc)[i];
    }
  } else {
    for (int i = threadIdx.x; i < n_do; i += kThreads) dot[i] = dsrc[i];
  }
  __syncthreads();
  // e_lo is a multiple of 32 * V, so of F1: a lane's features are fixed
  int fk[V];
  float mk[V], ik[V], bk[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    fk[k] = (V * lane + k) % geo.F1;
    const int at = g * geo.F1 + fk[k];
    mk[k] = stat[4 * at];
    ik[k] = stat[4 * at + 1];
    bk[k] = bias[at];
  }
  const int step = 32 * V;
  const int span = geo.F1 > V ? geo.F1 / V : 1;
  const int nf = geo.F1 < V ? geo.F1 : V;
  double t1[V], t2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) t1[k] = t2[k] = 0.0;
  for (int c = w; c < geo.C; c += kWarps) {
    const float* row = h + (trial * geo.C + c) * geo.pitch;
    float sc[V][D], a1[V], a2[V], dsk[V * D];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      a1[k] = a2[k] = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        sc[k][d] = taps[c * F2 + fk[k] * D + d];
        dsk[k * D + d] = 0.0f;
      }
    }
#pragma unroll 4
    for (int e = e_lo + V * lane; e < e_hi; e += step) {
      float x[V], dv[V * D];
      load_row<V>(row + e, x);
      const float* dp = dot + (e - e_lo) * D;
      if constexpr (V == 4) {
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const float4 q = reinterpret_cast<const float4*>(dp)[i];
          dv[4 * i] = q.x;
          dv[4 * i + 1] = q.y;
          dv[4 * i + 2] = q.z;
          dv[4 * i + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) dv[d] = dp[d];
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xm = x[k] - mk[k];
        const float y = fmaf(xm, ik[k], bk[k]);
        float dy = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dy = fmaf(sc[k][d], dv[k * D + d], dy);
          dsk[k * D + d] = fmaf(y, dv[k * D + d], dsk[k * D + d]);
        }
        a1[k] += dy;
        a2[k] = fmaf(dy, xm, a2[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      t1[k] += a1[k];
      t2[k] += a2[k];
    }
    // this row's s-gradient: lanes of the same features together
    fold_features<V, D>(dsk, geo.F1);
    warp_feature_sums(dsk, span);
    if (lane < span) {
      float* p = ds_part + ((trial * n_tiles + j) * geo.C + c) * F2;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (k < nf) {
#pragma unroll
          for (int d = 0; d < D; ++d) {
            p[(V * lane + k) * D + d] = dsk[k * D + d];
          }
        }
      }
    }
  }
  fold_features<V, 1>(t1, geo.F1);
  fold_features<V, 1>(t2, geo.F1);
  warp_feature_sums(t1, span);
  warp_feature_sums(t2, span);
  if (lane < span) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (k < nf) {
        red[0][w][V * lane + k] = t1[k];
        red[1][w][V * lane + k] = t2[k];
      }
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < geo.F1) {
    const int f = threadIdx.x;
    double u1 = 0.0, u2 = 0.0;
    for (int i = 0; i < kWarps; ++i) {
      u1 += red[0][i][f];
      u2 += red[1][i][f];
    }
    double* p = bn_part + ((trial * n_tiles + j) * geo.F1 + f) * 2;
    p[0] = u1;
    p[1] = u2;
  }
}

// Pass C'.  Threads [0, G * F2 * C) add the s-gradient partials over
// (b, tile); threads [G * F2 * C, + G * F1) the BatchNorm sums.  coef is
// (G, F1, 2): c0, c1.
__global__ void backward_combine_kernel(const float* __restrict__ ds_part,
                                        const double* __restrict__ bn_part,
                                        int n_parts, Geo geo, int D,
                                        const float* __restrict__ stat,
                                        const float* __restrict__ scale,
                                        float* __restrict__ ds,
                                        float* __restrict__ dscale,
                                        float* __restrict__ dbias,
                                        float* __restrict__ coef) {
  const int F2 = geo.F1 * D;
  const long long n_ds = static_cast<long long>(geo.G) * F2 * geo.C;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i < n_ds) {
    const int g = static_cast<int>(i / (F2 * geo.C));
    const int rem = static_cast<int>(i % (F2 * geo.C));
    const int fd = rem / geo.C, c = rem % geo.C;
    double t = 0.0;
    for (int p = 0; p < n_parts; ++p) {
      t += ds_part[((static_cast<long long>(g) * n_parts + p) * geo.C + c)
                   * F2 + fd];
    }
    ds[i] = static_cast<float>(t);   // (G, F1, D, C): i = (g * F2 + fd) * C + c
    return;
  }
  const long long at = i - n_ds;
  if (at >= static_cast<long long>(geo.G) * geo.F1) return;
  const int g = static_cast<int>(at / geo.F1), f = static_cast<int>(at % geo.F1);
  double a1 = 0.0, a2 = 0.0;
  for (int p = 0; p < n_parts; ++p) {
    const double* q = bn_part + ((static_cast<long long>(g) * n_parts + p)
                                 * geo.F1 + f) * 2;
    a1 += q[0];
    a2 += q[1];
  }
  const double inv = stat[4 * at + 1], r = stat[4 * at + 2];
  const double n = static_cast<double>(geo.B) * geo.C * geo.T;
  const double dv = stat[4 * at + 3] != 0.0f
      ? -0.5 * a2 * static_cast<double>(scale[at]) * r * r * r : 0.0;
  dbias[at] = static_cast<float>(a1);
  dscale[at] = static_cast<float>(a2 * r);
  coef[2 * at] = static_cast<float>(-inv * a1 / n);
  coef[2 * at + 1] = static_cast<float>(2.0 * dv / n);
}

// Pass D.  Pass B's grid and mapping; dh is (G, B, C, T, F1) contiguous.
template <int V, int D>
__global__ void __launch_bounds__(kThreads)
input_grad_kernel(const float* __restrict__ h, const float* __restrict__ dout,
                  const float* __restrict__ s, const float* __restrict__ stat,
                  const float* __restrict__ coef, float* __restrict__ dh,
                  Geo geo) {
  extern __shared__ float taps[];
  const int g = blockIdx.y;
  const int F2 = geo.F1 * D;
  stage_taps(s, g, geo.C, F2, taps);
  __syncthreads();
  const int n_items = geo.L / V;
  const long long q = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (q >= static_cast<long long>(geo.B) * n_items) return;
  const int b = static_cast<int>(q / n_items);
  const int e0 = V * static_cast<int>(q % n_items);
  const long long trial = static_cast<long long>(g) * geo.B + b;
  float dv[V * D];
  const float* dp = dout + (trial * geo.L + e0) * D;
  if constexpr (V == 4) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float4 v = reinterpret_cast<const float4*>(dp)[i];
      dv[4 * i] = v.x;
      dv[4 * i + 1] = v.y;
      dv[4 * i + 2] = v.z;
      dv[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) dv[d] = dp[d];
  }
  int fk[V];
  float mk[V], ik[V], c0[V], c1[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    fk[k] = (e0 + k) % geo.F1;
    const int at = g * geo.F1 + fk[k];
    mk[k] = stat[4 * at];
    ik[k] = stat[4 * at + 1];
    c0[k] = coef[2 * at];
    c1[k] = coef[2 * at + 1];
  }
  const float* src = h + trial * geo.C * geo.pitch + e0;
  float* dst = dh + trial * geo.C * geo.L + e0;
#pragma unroll 4
  for (int c = 0; c < geo.C; ++c) {
    float x[V], r[V];
    load_row<V>(src + c * geo.pitch, x);
    const float* tc = taps + c * F2;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float dy = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) dy = fmaf(tc[fk[k] * D + d], dv[k * D + d], dy);
      r[k] = fmaf(dy, ik[k], fmaf(c1[k], x[k] - mk[k], c0[k]));
    }
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(dst + static_cast<long long>(c) * geo.L) =
          make_float4(r[0], r[1], r[2], r[3]);
    } else {
      dst[static_cast<long long>(c) * geo.L] = r[0];
    }
  }
}

template <int V_, int D_>
struct Shape {
  static constexpr int V = V_;
  static constexpr int D = D_;
};

// Calls f(Shape<V, D>{}) for the instantiated (vec, D); anything else is
// refused.
template <typename F>
cudaError_t with_shape(int vec, int D, F&& f) {
  if (vec == 4) {
    if (D == 1) return f(Shape<4, 1>{});
    if (D == 2) return f(Shape<4, 2>{});
    if (D == 4) return f(Shape<4, 4>{});
  } else if (vec == 1) {
    if (D == 1) return f(Shape<1, 1>{});
    if (D == 2) return f(Shape<1, 2>{});
    if (D == 4) return f(Shape<1, 4>{});
  }
  return cudaErrorInvalidValue;
}

bool geometry_ok(int G, int B, int C, int T, int F1, int D, long long pitch,
                 int vec) {
  if (G <= 0 || B <= 0 || C <= 0 || T <= 0 || F1 <= 0 || D <= 0) return false;
  if (F1 > kMaxF1 || kMaxF1 % F1 != 0) return false;
  if (G > 65535 || B > 65535) return false;
  const long long L = static_cast<long long>(T) * F1;
  if (L * D > 0x7fffffffLL || pitch < L) return false;
  if (static_cast<long long>(G) * B * C * pitch > (1LL << 40)) return false;
  if (vec == 4) return L % 4 == 0 && pitch % 4 == 0;
  return vec == 1;
}

Geo make_geo(int G, int B, int C, int T, int F1, long long pitch) {
  return Geo{G, B, C, T, F1, T * F1, pitch};
}

}  // namespace

extern "C" {

// The dout tile of pass C in floats; the wrapper plans with the same.
int eeg_bn_spatial_tile_floats() { return kTileFloats; }

// Passes A, A' and B on `stream`.  h is a device pointer to (G, B, C, T,
// F1) f32 rows `pitch` floats apart (16-byte aligned when vec = 4); s
// (G, F1, D, C), scale, bias, run_mean, run_var (G, F1); out (G, B, T,
// F1 * D); stat (G, F1, 4); new_mean, new_var (G, F1); part (G, per_fold,
// F1, 2) f64 scratch.  Returns the first launch's cudaError_t that is not
// success (0 = all three launched).
int eeg_bn_spatial_forward(const float* h, const float* s, const float* scale,
                           const float* bias, const float* run_mean,
                           const float* run_var, float* out, float* stat,
                           float* new_mean, float* new_var, double* part,
                           int G, int B, int C, int T, int F1, int D,
                           long long pitch, int vec, int per_fold, float eps,
                           float keep, float take, void* stream) {
  if (!geometry_ok(G, B, C, T, F1, D, pitch, vec) || per_fold <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const Geo geo = make_geo(G, B, C, T, F1, pitch);
  if (vec == 4) {
    stats_kernel<4><<<dim3(per_fold, G), kThreads, 0, st>>>(h, geo, per_fold,
                                                            part);
  } else {
    stats_kernel<1><<<dim3(per_fold, G), kThreads, 0, st>>>(h, geo, per_fold,
                                                            part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_stat = G * F1;
  stats_combine_kernel<<<(n_stat + 127) / 128, 128, 0, st>>>(
      part, per_fold, geo, eps, scale, run_mean, run_var, keep, take, stat,
      new_mean, new_var);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(with_shape(vec, D, [&](auto shape) {
    constexpr int V = decltype(shape)::V;
    const long long items = static_cast<long long>(B) * (geo.L / V);
    const long long blocks = (items + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const size_t smem = sizeof(float) * C * F1 * decltype(shape)::D;
    forward_kernel<V, decltype(shape)::D>
        <<<dim3(static_cast<unsigned>(blocks), G), kThreads, smem, st>>>(
            h, s, stat, bias, out, geo);
    return cudaGetLastError();
  }));
}

// Passes C, C' and D on `stream`.  dout (G, B, T, F1 * D) contiguous and
// 16-byte aligned; stat the forward's; dh (G, B, C, T, F1) contiguous; ds
// (G, F1, D, C); dscale, dbias (G, F1); ds_part (G, B, n_tiles, C, F1 * D)
// f32, bn_part (G, B, n_tiles, F1, 2) f64 and coef (G, F1, 2) scratch.
// `tile` is pass C's row tile in floats of h, a multiple of 32 * vec;
// n_tiles = ceil(T * F1 / tile).  Returns the first launch's cudaError_t
// that is not success.
int eeg_bn_spatial_backward(const float* h, const float* dout, const float* s,
                            const float* scale, const float* bias,
                            const float* stat, float* dh, float* ds,
                            float* dscale, float* dbias, float* ds_part,
                            double* bn_part, float* coef, int G, int B, int C,
                            int T, int F1, int D, long long pitch, int vec,
                            int tile, void* stream) {
  if (!geometry_ok(G, B, C, T, F1, D, pitch, vec) || tile <= 0
      || tile % (32 * vec) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const Geo geo = make_geo(G, B, C, T, F1, pitch);
  const int n_tiles = (geo.L + tile - 1) / tile;
  const int F2 = F1 * D;
  cudaError_t err = with_shape(vec, D, [&](auto shape) {
    constexpr int V = decltype(shape)::V;
    const int rows = tile < geo.L ? tile : geo.L;
    const size_t smem = sizeof(float) * (static_cast<size_t>(C) * F2
                                         + static_cast<size_t>(rows) * D);
    backward_sums_kernel<V, decltype(shape)::D>
        <<<dim3(n_tiles, B, G), kThreads, smem, st>>>(
            h, dout, s, stat, bias, geo, tile, ds_part, bn_part);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_combine = static_cast<long long>(G) * F2 * C
                              + static_cast<long long>(G) * F1;
  backward_combine_kernel<<<static_cast<unsigned>((n_combine + 127) / 128),
                            128, 0, st>>>(
      ds_part, bn_part, B * n_tiles, geo, D, stat, scale, ds, dscale, dbias,
      coef);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(with_shape(vec, D, [&](auto shape) {
    constexpr int V = decltype(shape)::V;
    const long long items = static_cast<long long>(B) * (geo.L / V);
    const long long blocks = (items + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const size_t smem = sizeof(float) * C * F2;
    input_grad_kernel<V, decltype(shape)::D>
        <<<dim3(static_cast<unsigned>(blocks), G), kThreads, smem, st>>>(
            h, dout, s, stat, coef, dh, geo);
    return cudaGetLastError();
  }));
}

const char* eeg_bn_spatial_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
