// Exact fp32 k-nearest selection over static-shape point sets (sm_90a).
//
// Replaces three Pallas kernels of pointstowood_tpu/ops/pallas_knn.py:
//   * group_min_topk   (_make_topk_kernel)   -> ptw_knn_topk, K = 8/16/32
//   * group_min_topk_t (_make_topk_t_kernel) -> ptw_knn_topk for its
//     forward half, ptw_knn_top2 for its per-source transpose top-2
//   * top2             (_make_top2_kernel)   -> ptw_knn_top2
//
// What it computes: for every row point r of batch b, the K nearest valid
// column points c (squared distance, ascending; ties go to the lower
// column index), as (d2, idx). Masked columns and unfilled slots come back
// as d2 = +inf, idx = 0; so does every slot of a row whose distances are
// all NaN. The transpose top-2 of the SA stages is the same function with
// the roles swapped (rows = the stage's sources, columns = its centres,
// the centre mask as the column mask).
//
// ptw_knn_topk: the warp selection of select.cuh (select_block), with a
// masked column fetched as NaN coordinates, whose distance no key beats.
// Each warp serves kRows rows, its lanes take interleaved columns. What
// bounds it: instruction issue (select.cuh): the distance evaluations,
// B*R*C pairs of 8 fp32 operations, and the keys that pass the filter.
// One warp per 2 rows puts 8192 warps on the card at SA3 (8 x 2048 rows),
// where the thread-per-row kernel had 512. Bytes are negligible (12 bytes
// a point; the (R, K) outputs are the largest array), and the contraction
// depth is 3, so the tensor cores have nothing to do.
//
// ptw_knn_top2: one thread per row keeps its two nearest in registers and
// rejects a candidate with one compare; at K = 2 the insertion is two
// compares, so the serial design is cheap there. ptw_knn_topk's K = 2
// instance (the warp selection) computes the same; chip_smoke.py times
// the two at the top-2 shapes. Columns arrive in ascending index order,
// so "equal d stays ahead" gives ties to the lower index.
//
// Both blocks loop over every column tile themselves: on the TPU the
// transpose top-2 was carried in accumulators across sequential grid
// steps (pallas_knn.py:470-510), which Hopper's unordered blocks cannot
// do. The TPU kernels' mantissa bit-packing of slot/slice/query ids and
// their bf16x3 split products work around Mosaic and the MXU and are not
// needed here: the selection is exact, and its d2 (select.cuh pair_d2) is
// bit-identical to the plain PyTorch version's (knn_kernels.py).

#include <cuda_runtime.h>
#include <math.h>

#include "select.cuh"

namespace {

using ptw_select::key_d2;
using ptw_select::key_index;
using ptw_select::kRows;
using ptw_select::kWarps;
using ptw_select::Select;
using ptw_select::select_block;

// ---- ptw_knn_topk: the warp selection

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
knn_topk_kernel(const float* __restrict__ rows,
                const float* __restrict__ cols,
                const unsigned char* __restrict__ col_mask,
                float* __restrict__ out_d, int* __restrict__ out_i,
                int n_rows, int n_cols) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  const float* cb = cols + (size_t)b * n_cols * 3;
  const unsigned char* mb = col_mask + (size_t)b * n_cols;
  Select<K> sel[kRows];
  select_block(rows + (size_t)b * n_rows * 3, r0, n_rows, n_cols,
               [=](int c) {
                 const float* p = cb + (size_t)c * 3;
                 return mb[c] ? make_float3(p[0], p[1], p[2])
                              : make_float3(NAN, NAN, NAN);
               },
               sel);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r >= n_rows) break;
    float* od = out_d + ((size_t)b * n_rows + r0 + r) * K;
    int* oi = out_i + ((size_t)b * n_rows + r0 + r) * K;
#pragma unroll
    for (int s = 0; s < Select<K>::kL; ++s) {
      const int e = s * 32 + lane;
      if (e < K) {
        od[e] = key_d2(sel[r].lk[s]);
        oi[e] = key_index(sel[r].lk[s]);
      }
    }
  }
}

template <int K>
int launch_topk(const float* rows, const float* cols,
                const unsigned char* mask, float* out_d, int* out_i, int b,
                int n_rows, int n_cols, cudaStream_t stream) {
  constexpr int per_block = kWarps * kRows;
  dim3 grid((n_rows + per_block - 1) / per_block, b);
  knn_topk_kernel<K><<<grid, kWarps * 32, 0, stream>>>(
      rows, cols, mask, out_d, out_i, n_rows, n_cols);
  return (int)cudaGetLastError();
}

// ---- ptw_knn_top2: one thread per row (the thread-per-row kernel, K = 2)

constexpr int kTop2Threads = 64;
constexpr int kTop2Tile = 1024;

template <int K>
__global__ void __launch_bounds__(kTop2Threads)
knn_top2_kernel(const float* __restrict__ rows,
                  const float* __restrict__ cols,
                  const unsigned char* __restrict__ col_mask,
                  float* __restrict__ out_d, int* __restrict__ out_i,
                  int n_rows, int n_cols) {
  __shared__ float4 tile[kTop2Tile];
  const int b = blockIdx.y;
  const int r = blockIdx.x * kTop2Threads + threadIdx.x;
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
  for (int base = 0; base < n_cols; base += kTop2Tile) {
    const int cnt = min(kTop2Tile, n_cols - base);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += kTop2Threads) {
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
int launch_top2(const float* rows, const float* cols,
                const unsigned char* mask, float* out_d, int* out_i, int b,
                int n_rows, int n_cols, cudaStream_t stream) {
  dim3 grid((n_rows + kTop2Threads - 1) / kTop2Threads, b);
  knn_top2_kernel<K><<<grid, kTop2Threads, 0, stream>>>(
      rows, cols, mask, out_d, out_i, n_rows, n_cols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows (B, R, 3) f32, cols (B, C, 3) f32, col_mask (B, C) bool,
// out_d (B, R, k) f32, out_i (B, R, k) i32; all contiguous.
// k must be 2, 8, 16 or 32. Returns the cudaError_t of the launch.
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
    case 2: return launch_topk<2>(r, c, m, d, i, b, n_rows, n_cols, s);
    case 8: return launch_topk<8>(r, c, m, d, i, b, n_rows, n_cols, s);
    case 16: return launch_topk<16>(r, c, m, d, i, b, n_rows, n_cols, s);
    case 32: return launch_topk<32>(r, c, m, d, i, b, n_rows, n_cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The k = 2 selection: out_d (B, R, 2), out_i (B, R, 2).
int ptw_knn_top2(const void* rows, const void* cols, const void* col_mask,
                 void* out_d, void* out_i, int b, int n_rows, int n_cols,
                 void* stream) {
  return launch_top2<2>(static_cast<const float*>(rows),
                        static_cast<const float*>(cols),
                        static_cast<const unsigned char*>(col_mask),
                        static_cast<float*>(out_d), static_cast<int*>(out_i),
                        b, n_rows, n_cols,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
