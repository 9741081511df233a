// Exact fp32 k-nearest selection over static-shape point sets (sm_90a).
//
// Replaces two Pallas kernels of pointstowood_tpu/ops/pallas_knn.py:
//   * group_min_topk   (_make_topk_kernel)   -> ptw_knn_topk, K = 8/16/32
//   * group_min_topk_t (_make_topk_t_kernel) -> ptw_knn_topk for its
//     forward half, ptw_knn_top2 for its per-source transpose top-2
//   * top2             (_make_top2_kernel)   -> ptw_knn_top2
//
// What it computes: for every row point r of batch b, the K nearest valid
// column points c (squared distance, ascending; ties go to the lower
// column index), as (d2, idx). Masked columns and unfilled slots come back
// as d2 = +inf, idx = 0. The transpose top-2 of the SA stages is the same
// function with the roles swapped (rows = the stage's sources, columns =
// its centres, the centre mask as the column mask).
//
// What bounds it on the H100: the distance evaluations, B*R*C pairs of
// 8 fp32 operations each (3 sub, 3 mul, 2 add) on the CUDA cores, against
// 67 TFLOP/s. Bytes are negligible (each point is 12 bytes; the (R, K)
// outputs are the largest array). The contraction depth is 3, so the
// tensor cores have nothing to do.
//
// Design: one thread per row point keeps its sorted top-K list in
// registers (fully unrolled, so the arrays never spill to local memory)
// and rejects a candidate with one compare against its current K-th
// distance. Column tiles are staged in shared memory as float4
// (x, y, z, 0 or +inf for a masked column) and read as warp-wide
// broadcasts. The block loops over every column tile itself: on the TPU
// the transpose top-2 was carried in accumulators across sequential grid
// steps (pallas_knn.py:470-510), which Hopper's unordered blocks cannot
// do. The TPU kernels' mantissa bit-packing of slot/slice/query ids and
// their bf16x3 split products work around Mosaic and the MXU and are not
// needed here: the selection is exact.
//
// The distance is the difference form sum((r - c)^2) with the *_rn
// intrinsics, so nvcc cannot contract it into FMAs: the kernel's d2 is
// bit-identical to the plain PyTorch version (knn_kernels.py), and the
// two select the same columns.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 1024;

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_select_kernel(const float* __restrict__ rows,
                  const float* __restrict__ cols,
                  const unsigned char* __restrict__ col_mask,
                  float* __restrict__ out_d, int* __restrict__ out_i,
                  int n_rows, int n_cols) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool active = r < n_rows;

  float rx = 0.f, ry = 0.f, rz = 0.f;
  if (active) {
    const float* p = rows + ((size_t)b * n_rows + r) * 3;
    rx = p[0];
    ry = p[1];
    rz = p[2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = INFINITY;
    bi[j] = 0;
  }

  const float* cb = cols + (size_t)b * n_cols * 3;
  const unsigned char* mb = col_mask + (size_t)b * n_cols;
  for (int base = 0; base < n_cols; base += kTile) {
    const int cnt = min(kTile, n_cols - base);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += kThreads) {
      const float* p = cb + (size_t)(base + t) * 3;
      tile[t] = make_float4(p[0], p[1], p[2], mb[base + t] ? 0.f : INFINITY);
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < cnt; ++t) {
      const float4 c = tile[t];
      const float dx = __fsub_rn(rx, c.x);
      const float dy = __fsub_rn(ry, c.y);
      const float dz = __fsub_rn(rz, c.z);
      float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                          __fmul_rn(dz, dz));
      d = __fadd_rn(d, c.w);
      if (d < bd[K - 1]) {
        // Insert keeping (d, index) order: entries strictly greater than
        // d move down one slot; equal ones stay ahead (lower index, since
        // columns arrive in ascending index order).
        const int id = base + t;
#pragma unroll
        for (int j = K - 1; j > 0; --j) {
          if (d < bd[j - 1]) {
            bd[j] = bd[j - 1];
            bi[j] = bi[j - 1];
          } else if (d < bd[j]) {
            bd[j] = d;
            bi[j] = id;
          }
        }
        if (d < bd[0]) {
          bd[0] = d;
          bi[0] = id;
        }
      }
    }
  }
  if (!active) return;
  float* od = out_d + ((size_t)b * n_rows + r) * K;
  int* oi = out_i + ((size_t)b * n_rows + r) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    od[j] = bd[j];
    oi[j] = bi[j];
  }
}

template <int K>
int launch(const float* rows, const float* cols, const unsigned char* mask,
           float* out_d, int* out_i, int b, int n_rows, int n_cols,
           cudaStream_t stream) {
  dim3 grid((n_rows + kThreads - 1) / kThreads, b);
  knn_select_kernel<K><<<grid, kThreads, 0, stream>>>(
      rows, cols, mask, out_d, out_i, n_rows, n_cols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows (B, R, 3) f32, cols (B, C, 3) f32, col_mask (B, C) bool,
// out_d (B, R, k) f32, out_i (B, R, k) i32; all contiguous.
// k must be 8, 16 or 32. Returns the cudaError_t of the launch.
int ptw_knn_topk(const void* rows, const void* cols, const void* col_mask,
                 void* out_d, void* out_i, int b, int n_rows, int n_cols,
                 int k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const float*>(rows);
  auto c = static_cast<const float*>(cols);
  auto m = static_cast<const unsigned char*>(col_mask);
  auto d = static_cast<float*>(out_d);
  auto i = static_cast<int*>(out_i);
  switch (k) {
    case 8: return launch<8>(r, c, m, d, i, b, n_rows, n_cols, s);
    case 16: return launch<16>(r, c, m, d, i, b, n_rows, n_cols, s);
    case 32: return launch<32>(r, c, m, d, i, b, n_rows, n_cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The k = 2 selection: out_d (B, R, 2), out_i (B, R, 2).
int ptw_knn_top2(const void* rows, const void* cols, const void* col_mask,
                 void* out_d, void* out_i, int b, int n_rows, int n_cols,
                 void* stream) {
  return launch<2>(static_cast<const float*>(rows),
                   static_cast<const float*>(cols),
                   static_cast<const unsigned char*>(col_mask),
                   static_cast<float*>(out_d), static_cast<int*>(out_i), b,
                   n_rows, n_cols, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
