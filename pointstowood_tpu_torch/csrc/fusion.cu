// Exact pair selection for device fusion (sm_90a).
//
// Replaces the Pallas kernel group_min_payload (_make_payload_kernel,
// pointstowood_tpu/ops/pallas_knn.py) together with the approx_min_k and
// unpack_payload that follow it in _pair_group
// (pointstowood_tpu/predict/tpu_fusion.py): ptw_pair_select, K = 32/64.
//
// What it computes: fusion works on "entries". Entry e holds up to Q query
// points (the first q_len[e] rows of queries[e] are live) and a union of
// two regions of the flat classified-point arrays: its fine tile's rows
// [off_f, off_f + len_f) followed by its coarse tile's rows
// [off_c, off_c + len_c). For every live query it returns the K nearest
// union rows by squared distance, ascending, ties to the lower union index
// (fine before coarse), as (d2, payload): the payload is the source's
// 10-bit quantized wood probability round(clip(p, 0, 1) * 1023), so the
// probability rides with the distance and no (Q, K) index gather follows.
// Slots with no source, every slot of a dead query, and every slot of a
// query whose distances are all NaN, are (+inf, 0). The TPU kernel folded
// the union into group minima and left the final selection to
// approx_min_k at recall 0.8; this kernel selects exactly, and the
// distance it returns is the true d2, not a payload-packed one.
//
// Design: the warp selection of select.cuh (select_block). One block per
// (entry, kWarps * kRows queries); the union's rows are the columns, each
// fetched through its region, and the key keeps the union index. The
// payload is looked up from pay[row(u)] when the output is written, not
// carried through the sort. Region lengths are read at run time: one
// launch covers entries of any size.
//
// What bounds it on the H100: instruction issue (select.cuh): the
// distance evaluations, sum over entries of q_len * (len_f + len_c) pairs
// of 8 fp32 operations, and the keys that pass the filter (K = 64 admits
// more and keeps two list entries a lane). Bytes are small: 12 B per
// union row per entry, 12 B per query, K * 8 B of output per query. The
// thread-per-query kernel this replaces kept K = 64 lists in 64 KB of
// shared memory per 128 threads (3 blocks an SM) and shifted them
// serially; the lists now live in registers, spread over a warp.

#include <cuda_runtime.h>
#include <math.h>

#include "select.cuh"

namespace {

using ptw_select::Key;
using ptw_select::key_d2;
using ptw_select::key_index;
using ptw_select::kRows;
using ptw_select::kWarps;
using ptw_select::Select;
using ptw_select::select_block;

__device__ __forceinline__ int union_row(int u, int off_f, int len_f,
                                         int off_c) {
  return u < len_f ? off_f + u : off_c + (u - len_f);
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
pair_select_kernel(const float* __restrict__ queries,
                   const int* __restrict__ q_len,
                   const float* __restrict__ src,
                   const int* __restrict__ pay,
                   const int* __restrict__ regions,
                   float* __restrict__ out_d, int* __restrict__ out_p,
                   int n_q) {
  static_assert(Select<K>::kL * 32 == K, "K must be 32 or 64");
  const int e = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  const int len = min(q_len[e], n_q);
  const int off_f = regions[4 * e];
  const int len_f = regions[4 * e + 1];
  const int off_c = regions[4 * e + 2];
  // uniform over the block: a block without live queries scans nothing
  const int first = blockIdx.x * kWarps * kRows;
  const int n_union = first < len ? len_f + regions[4 * e + 3] : 0;
  Select<K> sel[kRows];
  select_block(queries + (size_t)e * n_q * 3, q0, len, n_union,
               [=](int u) {
                 const float* p =
                     src + (size_t)union_row(u, off_f, len_f, off_c) * 3;
                 return make_float3(p[0], p[1], p[2]);
               },
               sel);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (q0 + r >= n_q) break;
    float* od = out_d + ((size_t)e * n_q + q0 + r) * K;
    int* op = out_p + ((size_t)e * n_q + q0 + r) * K;
#pragma unroll
    for (int s = 0; s < Select<K>::kL; ++s) {
      const Key k = sel[r].lk[s];
      const float d = key_d2(k);
      int p = 0;
      if (d < INFINITY) p = pay[union_row(key_index(k), off_f, len_f, off_c)];
      od[s * 32 + lane] = d;
      op[s * 32 + lane] = p;
    }
  }
}

template <int K>
int launch(const float* queries, const int* q_len, const float* src,
           const int* pay, const int* regions, float* out_d, int* out_p,
           int n_entries, int n_q, cudaStream_t stream) {
  constexpr int per_block = kWarps * kRows;
  dim3 grid((n_q + per_block - 1) / per_block, n_entries);
  pair_select_kernel<K><<<grid, kWarps * 32, 0, stream>>>(
      queries, q_len, src, pay, regions, out_d, out_p, n_q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// queries (E, Q, 3) f32, q_len (E,) i32, src (N, 3) f32, pay (N,) i32,
// regions (E, 4) i32 = [off_f, len_f, off_c, len_c] (rows of src),
// out_d (E, Q, k) f32, out_p (E, Q, k) i32; all contiguous. k must be 32
// or 64, E at most 65535. Returns the cudaError_t of the launch.
int ptw_pair_select(const void* queries, const void* q_len, const void* src,
                    const void* pay, const void* regions, void* out_d,
                    void* out_p, int n_entries, int n_q, int k,
                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float*>(queries);
  auto ql = static_cast<const int*>(q_len);
  auto sp = static_cast<const float*>(src);
  auto pp = static_cast<const int*>(pay);
  auto rg = static_cast<const int*>(regions);
  auto d = static_cast<float*>(out_d);
  auto p = static_cast<int*>(out_p);
  switch (k) {
    case 32:
      return launch<32>(qp, ql, sp, pp, rg, d, p, n_entries, n_q, s);
    case 64:
      return launch<64>(qp, ql, sp, pp, rg, d, p, n_entries, n_q, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
