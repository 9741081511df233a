// Exact fp32 k-nearest selection over D-dimensional points (sm_90a).
//
// Replaces, where the JAX fast kNN searches more than three dimensions
// (ATSearchKNN's learned embedding, pointstowood_tpu/model/attention.py),
// two Pallas kernels of pointstowood_tpu/ops/pallas_knn.py:
//   * group_min_topk (_make_topk_kernel, pallas_call at :399)
//   * group_min      (_make_kernel,      pallas_call at :181), with the
//     approx_min_k that follows it
// -> ptw_knn_topk_dim, K = 2/8/16/32/64, and past k = 64 passes of
// K = 64 above the last key of the pass before (knn_kernels.topk_plan).
//
// What it computes: for every row point r of batch b, the K nearest valid
// column points c by the D-dimensional squared distance, as (d2, idx),
// ascending, ties to the lower column index; masked columns, NaN
// distances and unfilled slots as (+inf, 0). The distance is a
// left-to-right sum over d of (r_d - c_d)^2 with __fsub_rn, __fmul_rn and
// __fadd_rn (no FMA), so it equals the plain PyTorch version's
// `pair_d2_dim` (ops/knn_kernels.py) bit for bit; at D = 3 it is the 3-dim
// kernels' float. The Pallas kernels read blocks of 4 columns of their
// (Q, D + 1) and (D + 1, N) operands, so for D > 3 they rank by
// ||s||^2 over all D minus 2 q.s over the first 4 coordinates only; this
// kernel ranks by the true distance (ROADMAP.md section 3).
//
// Design: a block of kWarps warps serves kWarps * kRowsPerWarp rows; the
// columns stream through in tiles of kColTile = 32 * kCols, and each tile
// through D in chunks of kChunk dimensions staged in shared memory (rows
// and columns zero-padded past D: a zero dimension adds +0, which leaves
// every sum as it is). Each thread keeps a register block of kRowsPerWarp
// x kCols partial sums (its warp's rows against its own kCols columns,
// lane + 32 u); per 4 dimensions it reads kRowsPerWarp + kCols float4 from
// shared memory (rows broadcast, columns one 80-byte stride apart, so
// free of bank conflicts) for 48 fp32 operations a float4 pair. A
// finished tile's distances go to the warp selection of select.cuh
// (WarpSelect::add, one vote per kCols rounds), one selection per row.
//
// What bounds it: operations, 3 per pair and dimension (no FMA, for bit
// equality) at the SMs' fp32 issue rate; the selection adds a few
// instructions per pair, the shared-memory reads one float4 per 8
// pair-dimensions of a thread, the staging of a chunk about a fifth of
// its arithmetic. Bytes are small: every block reads all columns once per
// row block, from L2. A tensor-core filter (approximate distances by mma
// with a certified bound, then an exact rescore) is left for later.

#include <cuda_runtime.h>
#include <math.h>

#include "select.cuh"

namespace {

using ptw_select::Key;
using ptw_select::kEmpty;
using ptw_select::key_d2;
using ptw_select::key_index;
using ptw_select::make_key;
using ptw_select::WarpSelect;

constexpr int kWarps = 4;         // warps a block
constexpr int kRowsPerWarp = 4;   // rows a warp (and a thread) scores
constexpr int kCols = 4;          // columns a lane scores per tile
constexpr int kColTile = 32 * kCols;
constexpr int kBlockRows = kWarps * kRowsPerWarp;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;        // dimensions a shared-memory chunk
constexpr int kStride = kChunk + 4;  // floats a staged point (float4 rows)
constexpr int kQueue = 8;         // queued keys a lane, per row

template <int K, bool Above>
using Select = WarpSelect<K, kQueue, Above>;

// acc + (a - b)^2 over the 4 dimensions of a float4, in ascending order.
__device__ __forceinline__ float add_sq4(float acc, const float4& a,
                                         const float4& b) {
  float t = __fsub_rn(a.x, b.x);
  acc = __fadd_rn(acc, __fmul_rn(t, t));
  t = __fsub_rn(a.y, b.y);
  acc = __fadd_rn(acc, __fmul_rn(t, t));
  t = __fsub_rn(a.z, b.z);
  acc = __fadd_rn(acc, __fmul_rn(t, t));
  t = __fsub_rn(a.w, b.w);
  return __fadd_rn(acc, __fmul_rn(t, t));
}

// rows (B, R, D), cols (B, C, D) f32, col_mask (B, C) bool; with Above,
// prev_d / prev_i (B, R, K) the pass before, whose slot K - 1 is each
// row's floor key. out_d / out_i (B, R, K).
template <int K, bool Above>
__global__ void __launch_bounds__(kThreads)
knn_dim_kernel(const float* __restrict__ rows,
               const float* __restrict__ cols,
               const unsigned char* __restrict__ col_mask,
               const float* __restrict__ prev_d,
               const int* __restrict__ prev_i, float* __restrict__ out_d,
               int* __restrict__ out_i, int n_rows, int n_cols, int dim) {
  __shared__ __align__(16) float rtile[kBlockRows * kStride];
  __shared__ __align__(16) float ctile[kColTile * kStride];
  __shared__ unsigned char cvalid[kColTile];
  __shared__ Key queues[kWarps][kRowsPerWarp][Select<K, Above>::kQueueKeys];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kBlockRows;
  const int q0 = row0 + warp * kRowsPerWarp;  // this warp's first row
  const bool live = q0 < n_rows;              // uniform over the warp
  const float* rb = rows + (size_t)b * n_rows * dim;
  const float* cb = cols + (size_t)b * n_cols * dim;
  const unsigned char* mb = col_mask + (size_t)b * n_cols;

  Select<K, Above> sel[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    Key floor_key = kEmpty;
    if constexpr (Above) {
      if (q0 + r < n_rows) {
        const size_t f = ((size_t)b * n_rows + q0 + r) * K + K - 1;
        floor_key = make_key(prev_d[f], prev_i[f]);
      }
    }
    sel[r].init(queues[warp][r], floor_key);
  }

  for (int base = 0; base < n_cols; base += kColTile) {
    float acc[kRowsPerWarp][kCols];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int u = 0; u < kCols; ++u) acc[r][u] = 0.f;
    }
    for (int d0 = 0; d0 < dim; d0 += kChunk) {
      __syncthreads();  // the chunk before has been read
      // thread t stages dimension t % kChunk of every point it visits
      const int sd = threadIdx.x % kChunk, d = d0 + sd;
#pragma unroll
      for (int j = 0; j < kBlockRows * kChunk / kThreads; ++j) {
        const int rr = (threadIdx.x + j * kThreads) / kChunk;
        const int q = row0 + rr;
        rtile[rr * kStride + sd] =
            q < n_rows && d < dim ? rb[(size_t)q * dim + d] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kColTile * kChunk / kThreads; ++j) {
        const int cc = (threadIdx.x + j * kThreads) / kChunk;
        const int c = base + cc;
        ctile[cc * kStride + sd] =
            c < n_cols && d < dim ? cb[(size_t)c * dim + d] : 0.f;
      }
      if (d0 == 0 && threadIdx.x < kColTile) {
        const int c = base + threadIdx.x;
        cvalid[threadIdx.x] = c < n_cols && mb[c];
      }
      __syncthreads();
      // a warp without live rows scores the zero rows too (its sums are
      // never offered): the loop stays free of branches
#pragma unroll
      for (int dd = 0; dd < kChunk; dd += 4) {
        float4 q[kRowsPerWarp], c[kCols];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          q[r] = *reinterpret_cast<const float4*>(
              &rtile[(warp * kRowsPerWarp + r) * kStride + dd]);
        }
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          c[u] = *reinterpret_cast<const float4*>(
              &ctile[(32 * u + lane) * kStride + dd]);
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
          for (int u = 0; u < kCols; ++u) {
            acc[r][u] = add_sq4(acc[r][u], q[r], c[u]);
          }
        }
      }
    }
    if (live) {
      // a masked column, one past n_cols, or a row past n_rows offers a
      // NaN distance, which no key admits
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        float d2[kCols];
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          d2[u] = q0 + r < n_rows && cvalid[32 * u + lane] ? acc[r][u] : NAN;
        }
        sel[r].add(d2, base + lane);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    sel[r].finish();
    if (q0 + r >= n_rows) continue;
    float* od = out_d + ((size_t)b * n_rows + q0 + r) * K;
    int* oi = out_i + ((size_t)b * n_rows + q0 + r) * K;
#pragma unroll
    for (int s = 0; s < Select<K, Above>::kL; ++s) {
      const int e = s * 32 + lane;
      if (e < K) {
        od[e] = key_d2(sel[r].lk[s]);
        oi[e] = key_index(sel[r].lk[s]);
      }
    }
  }
}

template <int K, bool Above>
int launch(const float* rows, const float* cols, const unsigned char* mask,
           const float* prev_d, const int* prev_i, float* out_d, int* out_i,
           int b, int n_rows, int n_cols, int dim, cudaStream_t stream) {
  dim3 grid((n_rows + kBlockRows - 1) / kBlockRows, b);
  knn_dim_kernel<K, Above><<<grid, kThreads, 0, stream>>>(
      rows, cols, mask, prev_d, prev_i, out_d, out_i, n_rows, n_cols, dim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows (B, R, D) f32, cols (B, C, D) f32, col_mask (B, C) bool, out_d
// (B, R, k) f32, out_i (B, R, k) i32, all contiguous. k must be 2, 8, 16,
// 32 or 64. With prev_d / prev_i (B, R, 64) non-null (a pass past the
// first, k = 64): the 64 nearest keys above each row's key in slot 63 of
// prev. Returns the cudaError_t of the launch.
int ptw_knn_topk_dim(const void* rows, const void* cols,
                     const void* col_mask, const void* prev_d,
                     const void* prev_i, void* out_d, void* out_i, int b,
                     int n_rows, int n_cols, int dim, int k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const float*>(rows);
  auto c = static_cast<const float*>(cols);
  auto m = static_cast<const unsigned char*>(col_mask);
  auto pd = static_cast<const float*>(prev_d);
  auto pi = static_cast<const int*>(prev_i);
  auto d = static_cast<float*>(out_d);
  auto i = static_cast<int*>(out_i);
  if (b > 65535 || dim < 1) return (int)cudaErrorInvalidValue;
  if (prev_d != nullptr) {
    if (k != 64 || prev_i == nullptr) return (int)cudaErrorInvalidValue;
    return launch<64, true>(r, c, m, pd, pi, d, i, b, n_rows, n_cols, dim,
                            s);
  }
  switch (k) {
    case 2:
      return launch<2, false>(r, c, m, pd, pi, d, i, b, n_rows, n_cols, dim,
                              s);
    case 8:
      return launch<8, false>(r, c, m, pd, pi, d, i, b, n_rows, n_cols, dim,
                              s);
    case 16:
      return launch<16, false>(r, c, m, pd, pi, d, i, b, n_rows, n_cols,
                               dim, s);
    case 32:
      return launch<32, false>(r, c, m, pd, pi, d, i, b, n_rows, n_cols,
                               dim, s);
    case 64:
      return launch<64, false>(r, c, m, pd, pi, d, i, b, n_rows, n_cols,
                               dim, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
