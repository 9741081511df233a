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
// Slots with no source, and every slot of a dead query, are (+inf, 0).
// The TPU kernel folded the union into group minima and left the final
// selection to approx_min_k at recall 0.8; this kernel selects exactly,
// and the distance it returns is the true d2, not a payload-packed one.
//
// What bounds it on the H100: the distance evaluations, sum over entries
// of q_len * (len_f + len_c) pairs of 8 fp32 operations on the CUDA cores
// (67 TFLOP/s). Bytes are small: 16 B per union row per entry, 12 B per
// query, K * 8 B of output per query.
//
// Design: one block per (entry, 128-query tile); one thread per query.
// The union streams through shared memory in tiles of float4
// (x, y, z, payload bits) read as warp-wide broadcasts. Each thread keeps
// its current K-th distance in a register and rejects a candidate with
// one compare; its sorted (d2, payload) list lives in shared memory,
// column-major (slot j of thread t at j * 128 + t), so lanes never share
// a bank whatever slot each touches. K = 64 lists do not fit in
// registers (K1 in knn.cu already uses 54 for K = 32). Over a union of
// n rows a query inserts about K * (1 + ln(n / K)) times, so the
// threshold test rejects almost every candidate. Region lengths are read
// at run time: one launch covers entries of any size.
//
// The distance is the difference form with the *_rn intrinsics, so nvcc
// cannot contract it into FMAs: d2 equals the plain PyTorch version's
// (fusion_kernels.py) bit for bit, and both select the same rows.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 512;

template <int K>
constexpr size_t smem_bytes() {
  return kTile * sizeof(float4) + (size_t)K * kThreads * (sizeof(float) +
                                                           sizeof(int));
}

template <int K>
__global__ void __launch_bounds__(kThreads)
pair_select_kernel(const float* __restrict__ queries,
                   const int* __restrict__ q_len,
                   const float* __restrict__ src,
                   const int* __restrict__ pay,
                   const int* __restrict__ regions,
                   float* __restrict__ out_d, int* __restrict__ out_p,
                   int n_q) {
  extern __shared__ float4 smem[];
  float4* tile = smem;
  float* list_d = reinterpret_cast<float*>(smem + kTile);
  int* list_p = reinterpret_cast<int*>(list_d + K * kThreads);

  const int e = blockIdx.y;
  const int tid = threadIdx.x;
  const int q = blockIdx.x * kThreads + tid;
  const int len = min(q_len[e], n_q);
  const bool active = q < len;

#pragma unroll 8
  for (int j = 0; j < K; ++j) {
    list_d[j * kThreads + tid] = INFINITY;
    list_p[j * kThreads + tid] = 0;
  }

  // Uniform over the block: a tile without live queries skips the scan.
  if (blockIdx.x * kThreads < len) {
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (active) {
      const float* p = queries + ((size_t)e * n_q + q) * 3;
      qx = p[0];
      qy = p[1];
      qz = p[2];
    }
    const int off_f = regions[4 * e];
    const int len_f = regions[4 * e + 1];
    const int off_c = regions[4 * e + 2];
    const int len_c = regions[4 * e + 3];
    const int n_union = len_f + len_c;
    float thr = INFINITY;  // the K-th distance of this query's list
    for (int base = 0; base < n_union; base += kTile) {
      const int cnt = min(kTile, n_union - base);
      __syncthreads();
      for (int t = tid; t < cnt; t += kThreads) {
        const int u = base + t;
        const int row = u < len_f ? off_f + u : off_c + (u - len_f);
        const float* p = src + (size_t)row * 3;
        tile[t] = make_float4(p[0], p[1], p[2], __int_as_float(pay[row]));
      }
      __syncthreads();
      if (!active) continue;
      for (int t = 0; t < cnt; ++t) {
        const float4 c = tile[t];
        const float dx = __fsub_rn(qx, c.x);
        const float dy = __fsub_rn(qy, c.y);
        const float dz = __fsub_rn(qz, c.z);
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        if (d < thr) {
          // Entries strictly greater than d move down one slot; equal ones
          // stay ahead (lower union index: rows arrive in index order).
          int j = K - 1;
          while (j > 0) {
            const float prev = list_d[(j - 1) * kThreads + tid];
            if (!(d < prev)) break;
            list_d[j * kThreads + tid] = prev;
            list_p[j * kThreads + tid] = list_p[(j - 1) * kThreads + tid];
            --j;
          }
          list_d[j * kThreads + tid] = d;
          list_p[j * kThreads + tid] = __float_as_int(c.w);
          thr = list_d[(K - 1) * kThreads + tid];
        }
      }
    }
  }
  if (q >= n_q) return;
  float* od = out_d + ((size_t)e * n_q + q) * K;
  int* op = out_p + ((size_t)e * n_q + q) * K;
#pragma unroll 8
  for (int j = 0; j < K; ++j) {
    od[j] = list_d[j * kThreads + tid];
    op[j] = list_p[j * kThreads + tid];
  }
}

template <int K>
int launch(const float* queries, const int* q_len, const float* src,
           const int* pay, const int* regions, float* out_d, int* out_p,
           int n_entries, int n_q, cudaStream_t stream) {
  const size_t smem = smem_bytes<K>();
  cudaError_t err = cudaFuncSetAttribute(
      pair_select_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_q + kThreads - 1) / kThreads, n_entries);
  pair_select_kernel<K><<<grid, kThreads, smem, stream>>>(
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
