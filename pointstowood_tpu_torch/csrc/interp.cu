// Inverse-distance blend of k selected source rows (sm_90a).
//
// Replaces the forward of the Pallas kernel fp_interpolate_fast
// (pointstowood_tpu/ops/pallas_interp.py: _fwd_kernel, _weight_rows).
//
// What it computes: for every target t of batch b, given its k selected
// sources (idx, d2) from the top-2 kernel,
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
// What bounds it on the H100: HBM bytes. Each output row reads k source
// rows (C * 2 bytes each in bf16) and writes one; the arithmetic is
// 2 * k * C flops per row.
//
// Design: one warp per target row; each lane moves 16 bytes at a time
// (8 bf16 or 4 fp32 channels), neighbouring lanes on neighbouring
// addresses. A slot with zero weight is never read (its features may hold
// garbage, and 0 * inf would be NaN). The arithmetic uses the *_rn
// intrinsics in the same order as the plain PyTorch version
// (interp_kernels.py), so the two agree bit for bit.

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

}  // extern "C"
