// Inverse-distance blend of k selected source rows, and its backward
// (sm_90a).
//
// Replaces the Pallas kernel fp_interpolate_fast
// (pointstowood_tpu/ops/pallas_interp.py): its forward (_fwd_kernel,
// _weight_rows) with ptw_interp_blend, its backward (_bwd_kernel,
// _interp_bwd_1) with ptw_interp_blend_bwd.
//
// What the forward computes: for every target t of batch b, given its k
// selected sources (idx, d2) from the top-2 kernel,
//     y[t] = sum_i w_i * x[idx_i] / max(sum_i w_i, 1e-16),
//     w_i  = 1 / max(d2_i, 1e-16)   (0 where d2_i = +inf, an empty slot),
// accumulated in fp32 and written in x's type; masked targets get 0.
// The TPU kernel computes the same function as a dense thresholded
// W @ feats on the MXU (W has <= 2 non-zeros per row). On Hopper a gather
// of the k rows is the right shape for that, and no matrix product is
// involved. Known deviation: the TPU threshold also admits exact distance
// ties and, for ~1/256 of rows, the 3rd-nearest source
// (pallas_interp.py:28-35); this kernel blends exactly the k given slots.
//
// What the backward computes: the gradient with respect to x only
// (positions are network inputs),
//     d_x[b, idx_ti] += (w_ti / den_t) * d_y[b, t]
// over live targets t and slots with w_ti > 0, accumulated in an fp32
// (B, S, C) buffer and cast to x's type at the end. The TPU kernel forms
// the same sum as a dense W^T @ (d_y / den) over query blocks, with W and
// d_y / den rounded to bf16; this kernel stays in fp32 throughout.
//
// What bounds both on the H100: HBM bytes. Each target row reads (or, in
// the backward, adds into) k source rows of C values and reads or writes
// its own row once; the arithmetic is ~2 * k * C flops per row.
//
// Design: one warp per target row; each lane moves 16 bytes at a time
// (8 bf16 or 4 fp32 channels), neighbouring lanes on neighbouring
// addresses. A slot with zero weight is never read (its features may hold
// garbage, and 0 * inf would be NaN). The forward uses the *_rn
// intrinsics in the same order as the plain PyTorch version
// (interp_kernels.py), so the two agree bit for bit. The backward scatters
// with 16-byte float4 atomicAdd (sm_90) into the fp32 buffer: each
// contribution equals the plain version's bit for bit, but the order of
// the additions into one source row changes from run to run, so the sum
// agrees with the plain version's to fp32 rounding, not bit for bit. A
// deterministic variant (targets sorted by source, one warp per source
// row) is left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxK = 8;

struct Bf16x8 {
  using Elem = __nv_bfloat16;
  static constexpr int kVec = 8;
  __device__ static void load(const Elem* p, float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) f[j] = __bfloat162float(h[j]);
  }
  __device__ static void store(Elem* p, const float* f) {
    uint4 raw;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) h[j] = __float2bfloat16_rn(f[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

struct F32x4 {
  using Elem = float;
  static constexpr int kVec = 4;
  __device__ static void load(const Elem* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static void store(Elem* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <typename V>
__global__ void __launch_bounds__(kWarps * 32)
interp_blend_kernel(const typename V::Elem* __restrict__ x,
                    const int* __restrict__ idx,
                    const float* __restrict__ d2,
                    const unsigned char* __restrict__ tmask,
                    typename V::Elem* __restrict__ y, int n_src, int n_tgt,
                    int c, int k, long long n_rows) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const long long b = row / n_tgt;
  typename V::Elem* yr = y + row * c;
  const int n_vec = c / V::kVec;

  float w[kMaxK];
  int src[kMaxK];
  float den = 0.f;
  for (int i = 0; i < k; ++i) {
    const float d = d2[row * k + i];
    w[i] = __frcp_rn(fmaxf(d, 1e-16f));
    src[i] = idx[row * k + i];
    den = __fadd_rn(den, w[i]);
  }
  den = fmaxf(den, 1e-16f);
  const bool live = tmask[row] != 0;

  for (int v = lane; v < n_vec; v += 32) {
    float acc[V::kVec];
#pragma unroll
    for (int j = 0; j < V::kVec; ++j) acc[j] = 0.f;
    if (live) {
      for (int i = 0; i < k; ++i) {
        if (!(w[i] > 0.f)) continue;
        float f[V::kVec];
        V::load(x + (b * n_src + src[i]) * (long long)c + v * V::kVec, f);
#pragma unroll
        for (int j = 0; j < V::kVec; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(w[i], f[j]));
      }
#pragma unroll
      for (int j = 0; j < V::kVec; ++j) acc[j] = __fdiv_rn(acc[j], den);
    }
    V::store(yr + v * V::kVec, acc);
  }
}

template <typename V>
int launch(const void* x, const void* idx, const void* d2, const void* tmask,
           void* y, int b, int n_src, int n_tgt, int c, int k,
           cudaStream_t stream) {
  const long long n_rows = (long long)b * n_tgt;
  const unsigned grid = (unsigned)((n_rows + kWarps - 1) / kWarps);
  interp_blend_kernel<V><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const typename V::Elem*>(x), static_cast<const int*>(idx),
      static_cast<const float*>(d2),
      static_cast<const unsigned char*>(tmask),
      static_cast<typename V::Elem*>(y), n_src, n_tgt, c, k, n_rows);
  return (int)cudaGetLastError();
}

// fp32 add of 4 consecutive values into device memory: one 16-byte vector
// atomic on sm_90 with a toolkit that has it, else four scalar atomics.
__device__ __forceinline__ void atomic_add4(float* p, float a, float b,
                                            float c, float d) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && \
    (__CUDACC_VER_MAJOR__ > 12 ||                      \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 4))
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
#else
  atomicAdd(p, a);
  atomicAdd(p + 1, b);
  atomicAdd(p + 2, c);
  atomicAdd(p + 3, d);
#endif
}

template <typename V>
__global__ void __launch_bounds__(kWarps * 32)
interp_blend_bwd_kernel(const typename V::Elem* __restrict__ dy,
                        const int* __restrict__ idx,
                        const float* __restrict__ d2,
                        const unsigned char* __restrict__ tmask,
                        float* __restrict__ acc, int n_src, int n_tgt, int c,
                        int k, long long n_rows) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // a masked target's output is a constant 0: no gradient flows back
  if (row >= n_rows || tmask[row] == 0) return;
  const long long b = row / n_tgt;
  const int n_vec = c / V::kVec;

  float w[kMaxK];
  int src[kMaxK];
  float den = 0.f;
  for (int i = 0; i < k; ++i) {
    const float d = d2[row * k + i];
    w[i] = __frcp_rn(fmaxf(d, 1e-16f));
    src[i] = idx[row * k + i];
    den = __fadd_rn(den, w[i]);
  }
  den = fmaxf(den, 1e-16f);

  for (int v = lane; v < n_vec; v += 32) {
    float g[V::kVec];
    V::load(dy + row * c + v * V::kVec, g);
#pragma unroll
    for (int j = 0; j < V::kVec; ++j) g[j] = __fdiv_rn(g[j], den);
    for (int i = 0; i < k; ++i) {
      if (!(w[i] > 0.f)) continue;
      float* dst = acc + (b * n_src + src[i]) * (long long)c + v * V::kVec;
#pragma unroll
      for (int j = 0; j < V::kVec; j += 4)
        atomic_add4(dst + j, __fmul_rn(w[i], g[j]), __fmul_rn(w[i], g[j + 1]),
                    __fmul_rn(w[i], g[j + 2]), __fmul_rn(w[i], g[j + 3]));
    }
  }
}

// fp32 -> bf16, 8 values a thread (n a multiple of 8).
__global__ void cast_bf16_kernel(const float* __restrict__ in,
                                 __nv_bfloat16* __restrict__ out,
                                 long long n_vec) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_vec) return;
  const float4 lo = reinterpret_cast<const float4*>(in)[2 * v];
  const float4 hi = reinterpret_cast<const float4*>(in)[2 * v + 1];
  const float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  Bf16x8::store(out + v * 8, f);
}

template <typename V>
int launch_bwd(const void* dy, const void* idx, const void* d2,
               const void* tmask, float* acc, int b, int n_src, int n_tgt,
               int c, int k, cudaStream_t stream) {
  const long long n_rows = (long long)b * n_tgt;
  const unsigned grid = (unsigned)((n_rows + kWarps - 1) / kWarps);
  interp_blend_bwd_kernel<V><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const typename V::Elem*>(dy), static_cast<const int*>(idx),
      static_cast<const float*>(d2),
      static_cast<const unsigned char*>(tmask), acc, n_src, n_tgt, c, k,
      n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, S, C) bf16 (is_bf16 = 1) or f32 (0); idx (B, T, k) i32;
// d2 (B, T, k) f32; tmask (B, T) bool; y (B, T, C) in x's type. All
// contiguous; C a multiple of 8 (bf16) or 4 (f32); 1 <= k <= 8.
// Returns the cudaError_t of the launch.
int ptw_interp_blend(const void* x, const void* idx, const void* d2,
                     const void* tmask, void* y, int b, int n_src, int n_tgt,
                     int c, int k, int is_bf16, void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<Bf16x8>(x, idx, d2, tmask, y, b, n_src, n_tgt, c, k, s);
  return launch<F32x4>(x, idx, d2, tmask, y, b, n_src, n_tgt, c, k, s);
}

// d_y (B, T, C) bf16 (is_bf16 = 1) or f32 (0); idx, d2, tmask as in
// ptw_interp_blend; acc (B, S, C) f32 scratch; d_x (B, S, C) in d_y's type
// (for f32, d_x may be acc itself). All contiguous; C a multiple of 8
// (bf16) or 4 (f32); 1 <= k <= 8. Zeroes acc, scatters, then casts into
// d_x. Returns the first cudaError_t met.
int ptw_interp_blend_bwd(const void* dy, const void* idx, const void* d2,
                         const void* tmask, void* acc, void* dx, int b,
                         int n_src, int n_tgt, int c, int k, int is_bf16,
                         void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const long long n_out = (long long)b * n_src * c;
  int err = (int)cudaMemsetAsync(acc, 0, n_out * sizeof(float), s);
  if (err) return err;
  float* a = static_cast<float*>(acc);
  err = is_bf16 ? launch_bwd<Bf16x8>(dy, idx, d2, tmask, a, b, n_src, n_tgt,
                                     c, k, s)
                : launch_bwd<F32x4>(dy, idx, d2, tmask, a, b, n_src, n_tgt,
                                    c, k, s);
  if (err) return err;
  if (is_bf16) {
    const long long n_vec = n_out / 8;
    const unsigned grid = (unsigned)((n_vec + 255) / 256);
    if (n_vec)
      cast_bf16_kernel<<<grid, 256, 0, s>>>(
          a, static_cast<__nv_bfloat16*>(dx), n_vec);
    return (int)cudaGetLastError();
  }
  if (dx != acc)
    return (int)cudaMemcpyAsync(dx, acc, n_out * sizeof(float),
                                cudaMemcpyDeviceToDevice, s);
  return 0;
}

}  // extern "C"
