// Masked batch-statistic BatchNorm for training, as streaming passes
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses its elementwise work into few passes. On the card the eager
// torch form of model/layers.py _BatchStatsNorm runs ~30 separate fp32
// passes over each activation (casts, where, squares, broadcasts, sums).
// These kernels serve MaskedBatchNorm's batch-statistic branch on a CUDA
// tensor with no data group (ops/batchnorm_kernels.py, which documents the
// algorithm and holds its plain PyTorch transcription).
//
// What it computes, on the channels-last (rows, C) view of x (bf16 or
// fp32) with one validity byte a row:
//   ptw_bn_reduce, mode 0:  per block, Σ x over its valid rows, and the
//                           number of valid rows (column C);
//                  mode 1:  per block, Σ (x - mean)² over its valid rows;
//                  mode 2:  per block, with d = x - mean, over every row
//                           Σ gy, Σ gy (d r), Σ (gy w) d, Σ (gy w) r,
//                           and over the valid rows Σ d (5 C columns);
//   ptw_bn_finalize:        the blocks' partials summed a column at a time
//                           in a fixed order (float64, rounded once);
//   ptw_bn_elementwise, mode 0 (apply): y = ((x - mean) r) w + b, every
//                           row, written once in x's dtype;
//                  mode 1 (grad input): g_x = ((gy w) r + [valid]
//                           (2 d) g_s2) + [valid] g_mean / n, likewise.
// Each elementwise step is rounded as the plain torch code rounds it (the
// *_rn intrinsics: no FMA contraction), so with the same statistics y and
// g_x equal the plain version bit for bit; only the large sums run in
// another order. No atomics: a block's partials go to its own row of a
// (blocks, width) fp32 scratch, so a step repeats bit for bit.
//
// What bounds it on the H100: bytes. A few flops an element against 2-8
// bytes read or written, far below the ridge. The passes stream the
// activation with 16-byte loads (8 channels a thread where C % 8 == 0 and
// the pointers are 16-byte aligned; one channel a thread otherwise), keep
// the per-channel vectors in registers, skip the reads a masked row does
// not need (x in the statistics and in g_x), and keep 2-4 rows of loads
// in flight a thread.
//
// Layout of a block: tc = min(C / V, 256) threads across a row's channel
// groups, rpb = 256 / tc rows at once (a row group); block (bx, by) takes
// the row groups bx, bx + G, bx + 2G, ... of channel tile by. A thread
// accumulates its rows in increasing order, then the block sums its row
// lanes in a fixed order through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStat1 = 0, kStat2 = 1, kGrad = 2;  // ptw_bn_reduce modes
constexpr int kApply = 0, kGradInput = 1;         // ptw_bn_elementwise
// Rows of loads in flight a thread, and blocks resident a multiprocessor
// (the wave of ops/batchnorm_kernels.py reduce_blocks): the gradient
// passes hold two tensors' rows and more per-channel vectors, so fewer
// of each keeps them in registers.
template <bool GRAD>
constexpr int kUnrollOf = GRAD ? 2 : 4;
template <bool GRAD>
constexpr int kResidentOf = GRAD ? 2 : 3;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float v, float* p) { *p = v; }
__device__ __forceinline__ void put(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// V consecutive elements to and from float registers.
template <typename T, int V>
struct Io {
  static __device__ __forceinline__ void load(const T* p, float (&v)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_float(p[i]);
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i) put(v[i], p + i);
  }
};

template <>
struct Io<float, 8> {
  static __device__ __forceinline__ void load(const float* p,
                                              float (&v)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct Io<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// This thread's place in its block (see the file's note).
struct Layout {
  int tc, rpb, lane, roff, ch;
  bool active;
  long long groups;
};

template <int V>
__device__ __forceinline__ Layout layout(long long rows, int c) {
  Layout l;
  const int cv = c / V;
  l.tc = cv < kThreads ? cv : kThreads;
  l.rpb = kThreads / l.tc;
  l.lane = threadIdx.x % l.tc;
  l.roff = threadIdx.x / l.tc;
  const int group = blockIdx.y * l.tc + l.lane;
  l.ch = group * V;
  l.active = l.roff < l.rpb && group < cv;
  l.groups = (rows + l.rpb - 1) / l.rpb;
  return l;
}

template <int V>
__device__ __forceinline__ void channels(const float* src, int ch,
                                         float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = src[ch + i];
}

template <typename T, int V, int MODE>
__global__ void __launch_bounds__(kThreads, kResidentOf<MODE == kGrad>)
    bn_reduce_kernel(const T* __restrict__ x, const bool* __restrict__ mask,
                     const T* __restrict__ gy,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ weight,
                     float* __restrict__ part, long long rows, int c,
                     int width) {
  constexpr int K = MODE == kGrad ? 5 : 1;
  constexpr int kUnroll = kUnrollOf<MODE == kGrad>;
  constexpr int KG = MODE == kGrad ? kUnroll : 1;
  __shared__ float red[kThreads * V];
  __shared__ int cnt[kThreads];
  const Layout l = layout<V>(rows, c);
  float mu[V], rs[V], w[V];
  if (l.active) {
    if (MODE != kStat1) channels<V>(mean, l.ch, mu);
    if (MODE == kGrad) {
      channels<V>(rstd, l.ch, rs);
      channels<V>(weight, l.ch, w);
    }
  }
  float acc[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[k][i] = 0.0f;
  int count = 0;
  const long long stride = gridDim.x;
  for (long long q0 = blockIdx.x; q0 < l.groups; q0 += stride * kUnroll) {
    float xv[kUnroll][V];
    float gv[KG][V];
    bool live[kUnroll], valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = (q0 + u * stride) * l.rpb + l.roff;
      live[u] = l.active && q0 + u * stride < l.groups && row < rows;
      valid[u] = live[u] && mask[row];
      const size_t off = (size_t)row * c + l.ch;
      if constexpr (MODE == kGrad) {
        if (live[u]) {
          Io<T, V>::load(x + off, xv[u]);
          Io<T, V>::load(gy + off, gv[u]);
        }
      } else if (valid[u]) {
        Io<T, V>::load(x + off, xv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if constexpr (MODE == kStat1) {
        if (valid[u]) {
          ++count;
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[0][i] = __fadd_rn(acc[0][i], xv[u][i]);
        }
      } else if constexpr (MODE == kStat2) {
        if (valid[u]) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float d = __fsub_rn(xv[u][i], mu[i]);
            acc[0][i] = __fadd_rn(acc[0][i], __fmul_rn(d, d));
          }
        }
      } else if (live[u]) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float g = gv[u][i];
          const float d = __fsub_rn(xv[u][i], mu[i]);
          const float gw = __fmul_rn(g, w[i]);
          acc[0][i] = __fadd_rn(acc[0][i], g);
          acc[1][i] = __fadd_rn(acc[1][i], __fmul_rn(g, __fmul_rn(d, rs[i])));
          acc[2][i] = __fadd_rn(acc[2][i], __fmul_rn(gw, d));
          acc[3][i] = __fadd_rn(acc[3][i], __fmul_rn(gw, rs[i]));
          if (valid[u]) acc[4][i] = __fadd_rn(acc[4][i], d);
        }
      }
    }
  }
  // the block's row lanes, summed in order, one sum at a time
  const int cols = l.tc * V;
  const int base = blockIdx.y * cols;
  float* out = part + (size_t)blockIdx.x * width;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (l.active) {
#pragma unroll
      for (int i = 0; i < V; ++i)
        red[l.roff * cols + l.lane * V + i] = acc[k][i];
    }
    __syncthreads();
    for (int col = threadIdx.x; col < cols; col += kThreads) {
      if (base + col < c) {
        float s = red[col];
        for (int j = 1; j < l.rpb; ++j) s = __fadd_rn(s, red[j * cols + col]);
        out[k * c + base + col] = s;
      }
    }
    __syncthreads();
  }
  if constexpr (MODE == kStat1) {
    cnt[threadIdx.x] = l.active && l.lane == 0 ? count : 0;
    __syncthreads();
    if (threadIdx.x == 0 && blockIdx.y == 0) {
      long long n = 0;
      for (int j = 0; j < l.rpb; ++j) n += cnt[j * l.tc];
      out[c] = (float)n;
    }
  }
}

// out[col] = Σ_b part[b, col], b in a fixed order: 8 strands of every 8th
// block in float64, then the strands in order, rounded once to float.
__global__ void __launch_bounds__(256)
    bn_finalize_kernel(const float* __restrict__ part,
                       float* __restrict__ out, int blocks, int width) {
  __shared__ double strand[8][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  double s = 0.0;
  if (col < width)
    for (int b = threadIdx.y; b < blocks; b += 8)
      s = __dadd_rn(s, (double)part[(size_t)b * width + col]);
  strand[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    double t = strand[0][threadIdx.x];
    for (int j = 1; j < 8; ++j) t = __dadd_rn(t, strand[j][threadIdx.x]);
    out[col] = __double2float_rn(t);
  }
}

// kApply: v1 = bias. kGradInput: v1 = g_s2, v2 = g_mean / n.
template <typename T, int V, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    bn_elementwise_kernel(const T* __restrict__ x,
                          const bool* __restrict__ mask,
                          const T* __restrict__ gy,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          const float* __restrict__ weight,
                          const float* __restrict__ v1,
                          const float* __restrict__ v2, T* __restrict__ out,
                          long long rows, int c) {
  constexpr int kUnroll = kUnrollOf<MODE == kGradInput>;
  constexpr int KG = MODE == kGradInput ? kUnroll : 1;
  constexpr int VB = MODE == kGradInput ? V : 1;
  const Layout l = layout<V>(rows, c);
  if (!l.active) return;  // no barrier below
  float mu[V], rs[V], w[V], a[V], b[VB];
  channels<V>(mean, l.ch, mu);
  channels<V>(rstd, l.ch, rs);
  channels<V>(weight, l.ch, w);
  channels<V>(v1, l.ch, a);
  if constexpr (MODE == kGradInput) channels<V>(v2, l.ch, b);
  const long long stride = gridDim.x;
  for (long long q0 = blockIdx.x; q0 < l.groups; q0 += stride * kUnroll) {
    float xv[kUnroll][V];
    float gv[KG][V];
    bool live[kUnroll], valid[kUnroll];
    size_t off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = (q0 + u * stride) * l.rpb + l.roff;
      live[u] = q0 + u * stride < l.groups && row < rows;
      off[u] = (size_t)row * c + l.ch;
      if constexpr (MODE == kApply) {
        valid[u] = live[u];
        if (live[u]) Io<T, V>::load(x + off[u], xv[u]);
      } else {
        valid[u] = live[u] && mask[row];
        if (valid[u]) Io<T, V>::load(x + off[u], xv[u]);
        if (live[u]) Io<T, V>::load(gy + off[u], gv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!live[u]) continue;
      float y[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if constexpr (MODE == kApply) {
          const float d = __fsub_rn(xv[u][i], mu[i]);
          y[i] = __fadd_rn(__fmul_rn(__fmul_rn(d, rs[i]), w[i]), a[i]);
        } else {
          const float t = __fmul_rn(__fmul_rn(gv[u][i], w[i]), rs[i]);
          if (valid[u]) {
            const float d = __fsub_rn(xv[u][i], mu[i]);
            const float gd = __fadd_rn(t, __fmul_rn(__fmul_rn(2.0f, d), a[i]));
            y[i] = __fadd_rn(gd, b[i]);
          } else {
            y[i] = __fadd_rn(__fadd_rn(t, 0.0f), 0.0f);
          }
        }
      }
      Io<T, V>::store(out + off[u], y);
    }
  }
}

template <typename T, int V>
cudaError_t reduce(int mode, const void* x, const void* mask, const void* gy,
                   const float* mean, const float* rstd, const float* weight,
                   float* part, long long rows, int c, int width, int blocks,
                   cudaStream_t s) {
  const int cv = c / V;
  const int tc = cv < kThreads ? cv : kThreads;
  const dim3 grid(blocks, (cv + tc - 1) / tc);
  const T* xt = (const T*)x;
  const T* gt = (const T*)gy;
  const bool* m = (const bool*)mask;
  if (mode == kStat1)
    bn_reduce_kernel<T, V, kStat1><<<grid, kThreads, 0, s>>>(
        xt, m, gt, mean, rstd, weight, part, rows, c, width);
  else if (mode == kStat2)
    bn_reduce_kernel<T, V, kStat2><<<grid, kThreads, 0, s>>>(
        xt, m, gt, mean, rstd, weight, part, rows, c, width);
  else
    bn_reduce_kernel<T, V, kGrad><<<grid, kThreads, 0, s>>>(
        xt, m, gt, mean, rstd, weight, part, rows, c, width);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t elementwise(int mode, const void* x, const void* mask,
                        const void* gy, const float* mean, const float* rstd,
                        const float* weight, const float* v1, const float* v2,
                        void* out, long long rows, int c, int blocks,
                        cudaStream_t s) {
  const int cv = c / V;
  const int tc = cv < kThreads ? cv : kThreads;
  const dim3 grid(blocks, (cv + tc - 1) / tc);
  const T* xt = (const T*)x;
  const T* gt = (const T*)gy;
  const bool* m = (const bool*)mask;
  if (mode == kApply)
    bn_elementwise_kernel<T, V, kApply><<<grid, kThreads, 0, s>>>(
        xt, m, gt, mean, rstd, weight, v1, v2, (T*)out, rows, c);
  else
    bn_elementwise_kernel<T, V, kGradInput><<<grid, kThreads, 0, s>>>(
        xt, m, gt, mean, rstd, weight, v1, v2, (T*)out, rows, c);
  return cudaGetLastError();
}

bool bad_shape(long long rows, int c, int vec, int blocks) {
  const int v = vec ? 8 : 1;
  return rows < 1 || c < 1 || c % v != 0 || blocks < 1 ||
         (c / v + kThreads - 1) / kThreads > 65535;
}

}  // namespace

extern "C" {

// x, gy (rows, c) bf16 (bf16 != 0) or fp32, mask (rows,) bool, mean,
// rstd, weight (c,) fp32, part (blocks, width) fp32; all contiguous; vec:
// 8 channels a thread (c % 8 == 0, x and gy 16-byte aligned). width: c + 1
// (mode 0), c (mode 1), 5 c (mode 2). Returns the launch's cudaError_t.
int ptw_bn_reduce(int mode, const void* x, const void* mask, const void* gy,
                  const void* mean, const void* rstd, const void* weight,
                  void* part, long long rows, int c, int width, int vec,
                  int bf16, int blocks, void* stream) {
  if (bad_shape(rows, c, vec, blocks) || mode < kStat1 || mode > kGrad ||
      width < (mode == kGrad ? 5 * c : (mode == kStat1 ? c + 1 : c)))
    return (int)cudaErrorInvalidValue;
  const float* mu = (const float*)mean;
  const float* rs = (const float*)rstd;
  const float* w = (const float*)weight;
  float* p = (float*)part;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)(vec ? reduce<__nv_bfloat16, 8>(mode, x, mask, gy, mu, rs, w,
                                                p, rows, c, width, blocks, s)
                     : reduce<__nv_bfloat16, 1>(mode, x, mask, gy, mu, rs, w,
                                                p, rows, c, width, blocks, s));
  return (int)(vec ? reduce<float, 8>(mode, x, mask, gy, mu, rs, w, p, rows,
                                      c, width, blocks, s)
                   : reduce<float, 1>(mode, x, mask, gy, mu, rs, w, p, rows,
                                      c, width, blocks, s));
}

// part (blocks, width) fp32 -> out (width,) fp32, both contiguous.
int ptw_bn_finalize(const void* part, void* out, int blocks, int width,
                    void* stream) {
  if (blocks < 1 || width < 1) return (int)cudaErrorInvalidValue;
  bn_finalize_kernel<<<(width + 31) / 32, dim3(32, 8), 0,
                       (cudaStream_t)stream>>>((const float*)part,
                                               (float*)out, blocks, width);
  return (int)cudaGetLastError();
}

// As ptw_bn_reduce; mode 0: v1 = bias (mask, gy, v2 unread); mode 1: v1 =
// g_s2, v2 = g_mean / n. out (rows, c) in x's dtype.
int ptw_bn_elementwise(int mode, const void* x, const void* mask,
                       const void* gy, const void* mean, const void* rstd,
                       const void* weight, const void* v1, const void* v2,
                       void* out, long long rows, int c, int vec, int bf16,
                       int blocks, void* stream) {
  if (bad_shape(rows, c, vec, blocks) || mode < kApply || mode > kGradInput)
    return (int)cudaErrorInvalidValue;
  const float* mu = (const float*)mean;
  const float* rs = (const float*)rstd;
  const float* w = (const float*)weight;
  const float* a = (const float*)v1;
  const float* b = (const float*)v2;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)(vec ? elementwise<__nv_bfloat16, 8>(mode, x, mask, gy, mu,
                                                     rs, w, a, b, out, rows,
                                                     c, blocks, s)
                     : elementwise<__nv_bfloat16, 1>(mode, x, mask, gy, mu,
                                                     rs, w, a, b, out, rows,
                                                     c, blocks, s));
  return (int)(vec ? elementwise<float, 8>(mode, x, mask, gy, mu, rs, w, a,
                                           b, out, rows, c, blocks, s)
                   : elementwise<float, 1>(mode, x, mask, gy, mu, rs, w, a,
                                           b, out, rows, c, blocks, s));
}

}  // extern "C"
