// Farthest-point sampling over padded rows (sm_90a).
//
// Replaces no TPU kernel: the JAX package samples by voxel representatives
// or at random. It serves Point Transformer's TransitionDown
// (model/point_transformer.py), whose published code samples each stage's
// centres with pointops.furthestsampling
// (POSTECH-CVLab/point-transformer lib/pointops).
//
// What it computes, for each row b of a (B, N, 3) batch with validity
// mask (B, N): counts[b] picks (clamped to m), each the valid point
// farthest from the picks before it. Every point's distance starts at +inf
// (valid) or -1 (invalid, never picked); a pick is the arg-max of the
// distances, the lowest index on ties (so the first pick is the row's
// first valid point), and after it every distance becomes
// (d < dist) ? d : dist with d the float32 squared distance to the pick,
// ((dx*dx + dy*dy) + dz*dz) with each operation rounded (the *_rn
// intrinsics: no FMA contraction). Output out (B, m) int64: the picks,
// then 0 in the slots past counts[b]. The plain PyTorch version
// (ops/fps_kernels.py fps_plain) does the same arithmetic; the two are
// equal bit for bit.
//
// What bounds it on the H100: latency. Each pick depends on the one
// before, so a row is a chain of counts[b] block-wide arg-max reductions
// (4096 at 16384 points); the work of one pick (10 operations a point) is
// a few hundred cycles, and the reduction and its barrier as many again.
// Device memory plays no part: a row's points are read once.
//
// Design: one block a row. The row's points sit in shared memory as three
// float arrays (12 bytes a point, up to 16384 points, 196 KB); past
// 16384 they are read from device memory (L2) instead. Each thread keeps
// the distances of its PER points in registers (points tid, tid + T,
// tid + 2T, ...: ascending in a thread, so a strict '>' keeps the lowest
// index), updates them and takes its own arg-max in the same pass, then
// the block reduces (value, index) pairs by warp shuffles and one shared
// array of a value per warp. Every warp reduces that array itself, so a
// pick costs one __syncthreads; the array is double-buffered by the
// pick's parity, so a warp that runs ahead never overwrites values
// another warp still reads. 128 threads a block up to 1024 points, 1024
// above.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSmemPoints = 16384;

__device__ __forceinline__ void take(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    take(v, i, ov, oi);
  }
}

template <int T, int PER, bool SMEM>
__global__ void __launch_bounds__(T)
    fps_kernel(const float* __restrict__ pos, const bool* __restrict__ mask,
               const long long* __restrict__ counts,
               long long* __restrict__ out, int n, int m) {
  constexpr int kWarps = T / 32;
  extern __shared__ float xyz[];  // SMEM: x[n], y[n], z[n]
  __shared__ float red_v[2][kWarps];
  __shared__ int red_i[2][kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p = pos + (size_t)b * n * 3;
  const bool* mk = mask + (size_t)b * n;
  long long* o = out + (size_t)b * m;
  const long long want = counts[b];
  const int count = want < 0 ? 0 : (want > m ? m : (int)want);
  for (int t = count + tid; t < m; t += T) o[t] = 0;
  if (count == 0) return;  // the whole block leaves
  float* xs = xyz;
  float* ys = xyz + n;
  float* zs = xyz + 2 * n;
  if (SMEM) {
    for (int k = tid; k < n; k += T) {
      xs[k] = p[3 * k];
      ys[k] = p[3 * k + 1];
      zs[k] = p[3 * k + 2];
    }
  }
  float dist[PER];
  float best = -INFINITY;
  int besti = INT_MAX;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int k = r * T + tid;
    dist[r] = k < n ? (mk[k] ? INFINITY : -1.0f) : -INFINITY;
    if (k < n && dist[r] > best) {
      best = dist[r];
      besti = k;
    }
  }
  // the barrier of pick 0 also orders the shared points' stores before
  // any read of them
  for (int t = 0;; ++t) {
    warp_argmax(best, besti);
    if (lane == 0) {
      red_v[t & 1][warp] = best;
      red_i[t & 1][warp] = besti;
    }
    __syncthreads();
    float v = lane < kWarps ? red_v[t & 1][lane] : -INFINITY;
    int i = lane < kWarps ? red_i[t & 1][lane] : INT_MAX;
    warp_argmax(v, i);
    if (tid == 0) o[t] = i;
    if (t + 1 >= count) break;
    const float cx = SMEM ? xs[i] : p[3 * i];
    const float cy = SMEM ? ys[i] : p[3 * i + 1];
    const float cz = SMEM ? zs[i] : p[3 * i + 2];
    best = -INFINITY;
    besti = INT_MAX;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int k = r * T + tid;
      if (k < n) {
        const float dx = __fsub_rn(SMEM ? xs[k] : p[3 * k], cx);
        const float dy = __fsub_rn(SMEM ? ys[k] : p[3 * k + 1], cy);
        const float dz = __fsub_rn(SMEM ? zs[k] : p[3 * k + 2], cz);
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        if (d < dist[r]) dist[r] = d;
        if (dist[r] > best) {
          best = dist[r];
          besti = k;
        }
      }
    }
  }
}

template <int T, int PER, bool SMEM>
cudaError_t launch(const float* pos, const bool* mask,
                   const long long* counts, long long* out, int b, int n,
                   int m, cudaStream_t stream) {
  const int smem = SMEM ? 3 * n * (int)sizeof(float) : 0;
  static bool sized = false;  // the instance's largest row, once
  if (SMEM && !sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<T, PER, SMEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        3 * T * PER * (int)sizeof(float));
    if (e != cudaSuccess) return e;
    sized = true;
  }
  fps_kernel<T, PER, SMEM><<<b, T, smem, stream>>>(pos, mask, counts, out,
                                                    n, m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pos (B, N, 3) f32, mask (B, N) bool, counts (B,) int64, out (B, m)
// int64; all contiguous; 1 <= N <= 32768, m >= 1. Returns the
// cudaError_t of the launch.
int ptw_fps(const void* pos, const void* mask, const void* counts, void* out,
            int b, int n, int m, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || n > 2 * kSmemPoints || m < 1)
    return (int)cudaErrorInvalidValue;
  const float* p = (const float*)pos;
  const bool* mk = (const bool*)mask;
  const long long* c = (const long long*)counts;
  long long* o = (long long*)out;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (n <= 128) e = launch<128, 1, true>(p, mk, c, o, b, n, m, s);
  else if (n <= 256) e = launch<128, 2, true>(p, mk, c, o, b, n, m, s);
  else if (n <= 512) e = launch<128, 4, true>(p, mk, c, o, b, n, m, s);
  else if (n <= 1024) e = launch<128, 8, true>(p, mk, c, o, b, n, m, s);
  else if (n <= 2048) e = launch<1024, 2, true>(p, mk, c, o, b, n, m, s);
  else if (n <= 4096) e = launch<1024, 4, true>(p, mk, c, o, b, n, m, s);
  else if (n <= 8192) e = launch<1024, 8, true>(p, mk, c, o, b, n, m, s);
  else if (n <= kSmemPoints)
    e = launch<1024, 16, true>(p, mk, c, o, b, n, m, s);
  else e = launch<1024, 32, false>(p, mk, c, o, b, n, m, s);
  return (int)e;
}

}  // extern "C"
