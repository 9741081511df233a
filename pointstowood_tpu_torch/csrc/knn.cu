// Exact fp32 k-nearest selection over static-shape point sets (sm_90a).
//
// Replaces three Pallas kernels of pointstowood_tpu/ops/pallas_knn.py:
//   * group_min_topk   (_make_topk_kernel)   -> ptw_knn_topk, K = 8/16/32/64,
//     and ptw_knn_topk_above, passes of K = 64 for a k past 64
//   * group_min_topk_t (_make_topk_t_kernel) -> ptw_knn_topk for its
//     forward half, ptw_knn_top2_split for its per-source transpose top-2
//   * top2             (_make_top2_kernel)   -> ptw_knn_top2_split
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
// depth is 3, so the tensor cores have nothing to do. K = 64 keeps two
// list entries a lane; a k of 33-64 runs it and keeps the first k slots.
//
// ptw_knn_topk_above: a k past 64 runs in passes of the K = 64 selection
// (knn_kernels.topk_plan): pass r selects the 64 smallest keys strictly
// above the floor key (d2, idx) of slot 64 r - 1, the last slot of the
// pass before (select.cuh, `Above`); each pass writes its own (B, R, 64)
// slice of the wrapper's (passes, B, R, 64) output.
// Keys are unique, so the passes joined are the exact top-k, ties to the
// lower index included; a pass whose floor is the empty slot (+inf, 0)
// stays empty. Each pass scans every column again: the work grows with
// the passes, but no list past 64 entries (two a lane) is ever held, so k
// has no upper limit (the floor key's registers make ptxas spill a few
// bytes in this kernel; the build phase of chip_smoke.py lists them).
//
// ptw_knn_top2_split: split columns. L lanes of a warp share a group of
// R = 2 rows; lane l of the group scans the columns c = l (mod L) in
// ascending order and keeps, for each of its rows, its own two nearest
// in registers, so "equal d stays ahead" gives ties to the lower index
// within the lane. After every tile the L lanes merge their pairs over
// __shfl_xor_sync by the 64-bit (d2 bits, index) key of select.cuh (ties
// across lanes go to the lower index too) and take the group's second
// distance as their threshold; after the last tile the merge is the
// result. There is no vote: a lane rejects U = 4 columns x R rows with one
// compare of each row's minimum against its threshold. One shared-memory
// column read feeds R rows, and a masked column is stored as NaN
// coordinates, whose distance fails every compare, so a pair pays no
// mask. What bounds it: instruction issue, 10.5 thread instructions a
// (row, column) pair on the loop's path without insertions (8 fp32
// operations without FMA, a share of the minimum, the compare, the column
// read and the loop; chip_smoke.py counts them in the SASS), plus the
// insertions, most of them in a lane's first tile, and the merges. L comes
// from the host (knn_kernels.top2_lanes): more lanes give a small row
// count (FP3: 8 x 4096 rows) more warps, but make every block read all
// columns for fewer rows.
//
// Both kernels loop over every column tile themselves, double-buffered:
// each thread loads its share of the next tile into registers before the
// block scores the current one, and stores it after. On the TPU the
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

using ptw_select::Key;
using ptw_select::key_d2;
using ptw_select::key_index;
using ptw_select::kFull;
using ptw_select::kRows;
using ptw_select::kWarps;
using ptw_select::make_key;
using ptw_select::pair_d2;
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

// One pass of a k > 64 selection: the K smallest keys of each row above
// its floor, the key in the last slot of the row in the pass before
// (prev_d, prev_i, (B, R, K)); written to out_d, out_i (B, R, K).
template <int K>
__global__ void __launch_bounds__(kWarps * 32)
knn_topk_above_kernel(const float* __restrict__ rows,
                      const float* __restrict__ cols,
                      const unsigned char* __restrict__ col_mask,
                      const float* __restrict__ prev_d,
                      const int* __restrict__ prev_i,
                      float* __restrict__ out_d, int* __restrict__ out_i,
                      int n_rows, int n_cols) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  const float* cb = cols + (size_t)b * n_cols * 3;
  const unsigned char* mb = col_mask + (size_t)b * n_cols;
  Select<K, true> sel[kRows];
  select_block(rows + (size_t)b * n_rows * 3, r0, n_rows, n_cols,
               [=](int c) {
                 const float* p = cb + (size_t)c * 3;
                 return mb[c] ? make_float3(p[0], p[1], p[2])
                              : make_float3(NAN, NAN, NAN);
               },
               sel, [=](int q) {
                 const size_t f = ((size_t)b * n_rows + q) * K + K - 1;
                 return make_key(prev_d[f], prev_i[f]);
               });
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r >= n_rows) break;
    float* od = out_d + ((size_t)b * n_rows + r0 + r) * K;
    int* oi = out_i + ((size_t)b * n_rows + r0 + r) * K;
#pragma unroll
    for (int s = 0; s < Select<K, true>::kL; ++s) {
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

// ---- ptw_knn_top2_split: split columns, two rows a thread

constexpr int kTop2Threads = 256;  // 8 warps a block
constexpr int kTop2Rows = 2;       // rows a thread (R)
constexpr int kTop2Tile = 512;     // columns a shared-memory tile
constexpr int kTop2Staged = kTop2Tile / kTop2Threads;  // columns a thread
constexpr int kTop2Unroll = 4;     // columns a lane scores per compare

// Insert (d, c) into a row's ascending pair; equal distances stay ahead
// (columns reach a lane in ascending index order).
__device__ __forceinline__ void insert2(float d, int c, float& d0, int& i0,
                                        float& d1, int& i1) {
  if (d < d1) {
    if (d < d0) {
      d1 = d0;
      i1 = i0;
      d0 = d;
      i0 = c;
    } else {
      d1 = d;
      i1 = c;
    }
  }
}

// The two smallest keys of a row group's L lane pairs, in every lane of
// the group (a butterfly over __shfl_xor_sync; the whole warp calls it):
// of two ascending pairs (a0, a1), (b0, b1) they are min(a0, b0) and
// min(max(a0, b0), min(a1, b1)). An empty slot is (+inf, 0).
template <int L>
__device__ __forceinline__ void group_top2(float d0, int i0, float d1,
                                           int i1, Key& k0, Key& k1) {
  k0 = make_key(d0, i0);
  k1 = make_key(d1, i1);
#pragma unroll
  for (int s = L / 2; s > 0; s >>= 1) {
    const Key o0 = __shfl_xor_sync(kFull, k0, s);
    const Key o1 = __shfl_xor_sync(kFull, k1, s);
    const Key hi = k0 < o0 ? o0 : k0;
    const Key t = k1 < o1 ? k1 : o1;
    k0 = k0 < o0 ? k0 : o0;
    k1 = hi < t ? hi : t;
  }
}

template <int L>
__global__ void __launch_bounds__(kTop2Threads)
knn_top2_kernel(const float* __restrict__ rows,
                const float* __restrict__ cols,
                const unsigned char* __restrict__ col_mask,
                float* __restrict__ out_d, int* __restrict__ out_i,
                int n_rows, int n_cols) {
  static_assert(32 % L == 0 && kTop2Tile % (L * kTop2Unroll) == 0,
                "L must divide the warp and the tile");
  constexpr int R = kTop2Rows;
  __shared__ float4 tiles[2][kTop2Tile];
  const int b = blockIdx.y;
  const int sub = threadIdx.x % L;  // lane within the row group
  // group g of the launch serves rows g * R .. g * R + R - 1
  const int r0 = (blockIdx.x * (kTop2Threads / L) + threadIdx.x / L) * R;

  float qx[R], qy[R], qz[R], d0[R], d1[R];
  int i0[R], i1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    qx[r] = qy[r] = qz[r] = NAN;  // a row past n_rows admits nothing
    if (r0 + r < n_rows) {
      const float* p = rows + ((size_t)b * n_rows + r0 + r) * 3;
      qx[r] = p[0];
      qy[r] = p[1];
      qz[r] = p[2];
    }
    d0[r] = d1[r] = INFINITY;
    i0[r] = i1[r] = 0;
  }

  // a column past n_cols, or masked, is staged as NaN coordinates
  const float* cb = cols + (size_t)b * n_cols * 3;
  const unsigned char* mb = col_mask + (size_t)b * n_cols;
  float sx[kTop2Staged], sy[kTop2Staged], sz[kTop2Staged];
  auto fetch = [&](int base) {
#pragma unroll
    for (int i = 0; i < kTop2Staged; ++i) {
      const int c = base + threadIdx.x + i * kTop2Threads;
      const bool on = c < n_cols && mb[c];
      sx[i] = on ? cb[(size_t)c * 3] : NAN;
      sy[i] = on ? cb[(size_t)c * 3 + 1] : NAN;
      sz[i] = on ? cb[(size_t)c * 3 + 2] : NAN;
    }
  };
  auto store = [&](float4* tile) {
#pragma unroll
    for (int i = 0; i < kTop2Staged; ++i) {
      tile[threadIdx.x + i * kTop2Threads] = make_float4(sx[i], sy[i], sz[i],
                                                         0.f);
    }
  };

  // share the group's pair: lane 0 keeps it, the others keep only its
  // second distance as their threshold, under the index 0xffffffff, whose
  // key is above every real key of that distance (and above the empty
  // slot). Later columns have higher indices, so one that ties the
  // threshold is not needed.
  auto share = [&]() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Key k0, k1;
      group_top2<L>(d0[r], i0[r], d1[r], i1[r], k0, k1);
      d1[r] = key_d2(k1);
      i1[r] = sub == 0 ? key_index(k1) : -1;
      d0[r] = sub == 0 ? key_d2(k0) : d1[r];
      i0[r] = sub == 0 ? key_index(k0) : -1;
    }
  };
  // score columns [base + lo, base + hi) of the tile: lane sub takes
  // columns j + u * L + sub (NaN past n_cols)
  auto scan = [&](const float4* tile, int base, int lo, int hi) {
    for (int j = lo; j < hi; j += L * kTop2Unroll) {
      float4 c[kTop2Unroll];
#pragma unroll
      for (int u = 0; u < kTop2Unroll; ++u) c[u] = tile[j + u * L + sub];
      float d[R][kTop2Unroll];
      bool near = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int u = 0; u < kTop2Unroll; ++u) {
          d[r][u] = pair_d2(qx[r], qy[r], qz[r], c[u]);
        }
        // fminf drops a NaN operand; a NaN distance fails the insert's
        // own compare
        float m = d[r][0];
#pragma unroll
        for (int u = 1; u < kTop2Unroll; ++u) m = fminf(m, d[r][u]);
        near |= m < d1[r];
      }
      if (near) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int u = 0; u < kTop2Unroll; ++u) {
            insert2(d[r][u], base + j + u * L + sub, d0[r], i0[r], d1[r],
                    i1[r]);
          }
        }
      }
    }
  };

  fetch(0);
  store(tiles[0]);
  __syncthreads();
  for (int base = 0, buf = 0; base < n_cols; base += kTop2Tile, buf ^= 1) {
    const bool more = base + kTop2Tile < n_cols;  // uniform over the block
    if (more) fetch(base + kTop2Tile);
    const int padded = min(kTop2Tile, n_cols - base + L * kTop2Unroll - 1) &
                       -(L * kTop2Unroll);
    scan(tiles[buf], base, 0, padded);
    if (more) {
      store(tiles[buf ^ 1]);
      share();
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    Key k0, k1;
    group_top2<L>(d0[r], i0[r], d1[r], i1[r], k0, k1);
    if (sub == 0 && r0 + r < n_rows) {
      const size_t o = ((size_t)b * n_rows + r0 + r) * 2;
      *reinterpret_cast<float2*>(out_d + o) =
          make_float2(key_d2(k0), key_d2(k1));
      *reinterpret_cast<int2*>(out_i + o) =
          make_int2(key_index(k0), key_index(k1));
    }
  }
}

template <int L>
int launch_top2(const float* rows, const float* cols,
                const unsigned char* mask, float* out_d, int* out_i, int b,
                int n_rows, int n_cols, cudaStream_t stream) {
  constexpr int per_block = kTop2Threads / L * kTop2Rows;
  dim3 grid((n_rows + per_block - 1) / per_block, b);
  knn_top2_kernel<L><<<grid, kTop2Threads, 0, stream>>>(
      rows, cols, mask, out_d, out_i, n_rows, n_cols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows (B, R, 3) f32, cols (B, C, 3) f32, col_mask (B, C) bool,
// out_d (B, R, k) f32, out_i (B, R, k) i32; all contiguous.
// k must be 2, 8, 16, 32 or 64. Returns the cudaError_t of the launch.
int ptw_knn_topk(const void* rows, const void* cols, const void* col_mask,
                 void* out_d, void* out_i, int b, int n_rows, int n_cols,
                 int k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const float*>(rows);
  auto c = static_cast<const float*>(cols);
  auto m = static_cast<const unsigned char*>(col_mask);
  auto d = static_cast<float*>(out_d);
  auto i = static_cast<int*>(out_i);
  if (b > 65535) return (int)cudaErrorInvalidValue;
  switch (k) {
    case 2: return launch_topk<2>(r, c, m, d, i, b, n_rows, n_cols, s);
    case 8: return launch_topk<8>(r, c, m, d, i, b, n_rows, n_cols, s);
    case 16: return launch_topk<16>(r, c, m, d, i, b, n_rows, n_cols, s);
    case 32: return launch_topk<32>(r, c, m, d, i, b, n_rows, n_cols, s);
    case 64: return launch_topk<64>(r, c, m, d, i, b, n_rows, n_cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One pass of a k > 64 selection (K = 64): prev_d / prev_i (B, R, 64) the
// pass before (or ptw_knn_topk's K = 64 output), out_d / out_i (B, R, 64)
// f32 / i32, the 64 nearest keys above each row's key in slot 63 of prev.
// Returns the cudaError_t of the launch.
int ptw_knn_topk_above(const void* rows, const void* cols,
                       const void* col_mask, const void* prev_d,
                       const void* prev_i, void* out_d, void* out_i, int b,
                       int n_rows, int n_cols, void* stream) {
  if (b > 65535) return (int)cudaErrorInvalidValue;
  constexpr int per_block = kWarps * kRows;
  dim3 grid((n_rows + per_block - 1) / per_block, b);
  knn_topk_above_kernel<64><<<grid, kWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(cols),
      static_cast<const unsigned char*>(col_mask),
      static_cast<const float*>(prev_d), static_cast<const int*>(prev_i),
      static_cast<float*>(out_d), static_cast<int*>(out_i), n_rows, n_cols);
  return (int)cudaGetLastError();
}

// The k = 2 selection: out_d (B, R, 2), out_i (B, R, 2), with `lanes`
// lanes a row group (the host's choice, knn_kernels.top2_lanes): 2, 4,
// 8, 16 or 32.
int ptw_knn_top2_split(const void* rows, const void* cols,
                       const void* col_mask, void* out_d, void* out_i, int b,
                       int n_rows, int n_cols, int lanes, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const float*>(rows);
  auto c = static_cast<const float*>(cols);
  auto m = static_cast<const unsigned char*>(col_mask);
  auto d = static_cast<float*>(out_d);
  auto i = static_cast<int*>(out_i);
  if (b > 65535) return (int)cudaErrorInvalidValue;
  switch (lanes) {
    case 2: return launch_top2<2>(r, c, m, d, i, b, n_rows, n_cols, s);
    case 4: return launch_top2<4>(r, c, m, d, i, b, n_rows, n_cols, s);
    case 8: return launch_top2<8>(r, c, m, d, i, b, n_rows, n_cols, s);
    case 16: return launch_top2<16>(r, c, m, d, i, b, n_rows, n_cols, s);
    case 32: return launch_top2<32>(r, c, m, d, i, b, n_rows, n_cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
