// Grouped minima of squared distances: the first stage of the two-stage
// fast kNN (sm_90a).
//
// Replaces the Pallas kernel group_min of pointstowood_tpu/ops/pallas_knn.py
// (pallas_call at :181, kernel _make_kernel :78-138).
//
// What it computes: for every row point r of batch b and every group j of
// the column axis, the smallest squared distance from r to the group's g
// member columns (+inf at masked columns) and the member slot that holds
// it; a strict '<' scan over the slots gives ties, and groups whose members
// are all masked, to the lower slot. The grouping is the JAX package's
// block-local one: the columns are cut into blocks of n_block, and group j
// of block bk = j / npg (npg = n_block / g) holds the columns
// bk * n_block + a * npg + j % npg for slots a < g. Outputs: out_min
// (B, R, C/g) f32 and out_slot (B, R, C/g) u8.
//
// What bounds it on the H100: instruction issue. At SA1 of a 32768-point
// batch (B = 8, R = 16384, C = 32768, g = 8) it evaluates 4.3e9 pairs of
// 8 fp32 operations, which must not contract into FMAs (bit equality with
// the plain version), plus the slot scan's compare and two selects: about
// 11 thread instructions a pair, 1.4 ms at one instruction a lane cycle
// (132 SMs x 128 lanes x 1.98 GHz). The 5.4e8 minima and slots it writes
// (2.7 GB, 0.8 ms at 3.35 TB/s) come second; the inputs are tiny (12
// bytes a point).
//
// Design: one thread per group column, two rows at a time. A block takes
// kCols consecutive groups of one column block and kRows rows; each
// thread loads its group's g members into registers once, and the rows
// are staged in shared memory as float4 and read as broadcasts.
//  * The mask leaves the pair loop: a masked member is loaded as +inf
//    coordinates, and for a finite row (r - inf)^2 = +inf, which is the
//    plain version's where(mask, d, inf) bit for bit. A row with a
//    non-finite coordinate (NaN, or inf, whose difference with an inf
//    member is NaN) would differ, so a block whose rows are not all
//    finite takes a second loop that also applies the mask per member:
//    the choice is made once per block, uniformly.
//  * Two rows a thread: two independent slot scans, one pass over the
//    loop's bookkeeping for both.
//  * The outputs are staged in shared memory, kChunk rows at a time
//    (double-buffered), and written out with 16-byte vector stores: a warp
//    issues one store per 4 minima and per 16 slots, where one thread per
//    output needed a 4-byte and a 1-byte store, each with its own 64-bit
//    address. Rows of a chunk are contiguous runs of kCols outputs (npg
//    and the output row length are multiples of kCols), so every store is
//    aligned and a warp's stores are coalesced.
// The TPU kernel packs the slot into the low mantissa bits of a bf16x3
// selection value ||s||^2 - 2 q.s, which works around Mosaic; here the
// slot is its own array and the value is the true squared distance in
// the difference form with the *_rn intrinsics (no FMA contraction), so
// the kernel equals the plain PyTorch version (knn_kernels.py
// group_min_plain) bit for bit. Output offsets are 64-bit (B * R * C/g
// passes 2^31 at these shapes).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCols = 128;  // group columns (threads) a block
constexpr int kRows = 128;  // rows a block
constexpr int kChunk = 16;  // rows staged before a store-out
static_assert(kChunk * kCols / 16 == kCols, "one slot vector a thread");

// min and slot over the G members for one row: a strict '<' scan, so ties
// keep the lower slot. Masked: also apply the member mask (`live`), for
// rows that are not all finite.
template <int G, bool Masked>
__device__ __forceinline__ void scan(const float4 q, const float (&mx)[G],
                                     const float (&my)[G],
                                     const float (&mz)[G], unsigned live,
                                     float& m, int& slot) {
#pragma unroll
  for (int a = 0; a < G; ++a) {
    const float dx = __fsub_rn(q.x, mx[a]);
    const float dy = __fsub_rn(q.y, my[a]);
    const float dz = __fsub_rn(q.z, mz[a]);
    float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                        __fmul_rn(dz, dz));
    if (Masked) d = ((live >> a) & 1u) ? d : INFINITY;
    if (a == 0) {
      m = d;
      slot = 0;
    } else if (d < m) {
      m = d;
      slot = a;
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kCols)
group_min_kernel(const float* __restrict__ rows,
                 const float* __restrict__ cols,
                 const unsigned char* __restrict__ col_mask,
                 float* __restrict__ out_min,
                 unsigned char* __restrict__ out_slot, int n_rows,
                 int n_cols, int n_block) {
  __shared__ float4 rs[kRows];  // w = 1 where the row is finite
  __shared__ __align__(16) float smin[2][kChunk][kCols];
  __shared__ __align__(16) unsigned char sslot[2][kChunk][kCols];
  const int npg = n_block / G;
  const int tiles = npg / kCols;
  const int bk = blockIdx.x / tiles;
  const int j0 = (blockIdx.x % tiles) * kCols;  // first group of the block
  const int jj = j0 + threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kRows;
  const int cnt = min(kRows, n_rows - r0);

  float mx[G], my[G], mz[G];
  unsigned live = 0;
  const float* cb = cols + (size_t)b * n_cols * 3;
  const unsigned char* mb = col_mask + (size_t)b * n_cols;
#pragma unroll
  for (int a = 0; a < G; ++a) {
    const int c = bk * n_block + a * npg + jj;
    const bool on = mb[c] != 0;
    const float* p = cb + (size_t)c * 3;
    mx[a] = on ? p[0] : INFINITY;
    my[a] = on ? p[1] : INFINITY;
    mz[a] = on ? p[2] : INFINITY;
    live |= (on ? 1u : 0u) << a;
  }
  bool finite = true;
  if (threadIdx.x < kRows) {
    float4 q = make_float4(0.f, 0.f, 0.f, 1.f);  // rows past cnt: unused
    if (threadIdx.x < cnt) {
      const float* p = rows + ((size_t)b * n_rows + r0 + threadIdx.x) * 3;
      q = make_float4(p[0], p[1], p[2], 0.f);
      finite = isfinite(q.x) && isfinite(q.y) && isfinite(q.z);
      q.w = finite ? 1.f : 0.f;
    }
    rs[threadIdx.x] = q;
  }
  // uniform over the block: every row finite
  const bool fast = __syncthreads_and(finite);

  const size_t n_groups = (size_t)(n_cols / G);
  const size_t o0 = (size_t)bk * npg + j0;  // the block's first group
  for (int c0 = 0, buf = 0; c0 < cnt; c0 += kChunk, buf ^= 1) {
#pragma unroll 2
    for (int t = 0; t < kChunk; t += 2) {
      const float4 q0 = rs[c0 + t], q1 = rs[c0 + t + 1];
      float m0, m1;
      int s0, s1;
      if (fast) {
        scan<G, false>(q0, mx, my, mz, live, m0, s0);
        scan<G, false>(q1, mx, my, mz, live, m1, s1);
      } else {
        scan<G, true>(q0, mx, my, mz, live, m0, s0);
        scan<G, true>(q1, mx, my, mz, live, m1, s1);
      }
      smin[buf][t][threadIdx.x] = m0;
      smin[buf][t + 1][threadIdx.x] = m1;
      sslot[buf][t][threadIdx.x] = (unsigned char)s0;
      sslot[buf][t + 1][threadIdx.x] = (unsigned char)s1;
    }
    __syncthreads();
    // store-out: row t of the chunk is kCols contiguous outputs at
    // ((b * n_rows + r0 + c0 + t) * n_groups + o0)
    const int live_rows = min(kChunk, cnt - c0);
    const size_t row0 = (size_t)b * n_rows + r0 + c0;
#pragma unroll
    for (int s = 0; s < kChunk / 4; ++s) {
      const int i = threadIdx.x + s * kCols;  // float4 i of the chunk
      const int t = i / (kCols / 4), v = i % (kCols / 4);
      if (t < live_rows) {
        reinterpret_cast<float4*>(out_min + (row0 + t) * n_groups + o0)[v] =
            reinterpret_cast<const float4*>(smin[buf][t])[v];
      }
    }
    {  // kChunk * kCols / 16 = kCols vectors of 16 slots: one a thread
      const int t = threadIdx.x / (kCols / 16), v = threadIdx.x % (kCols / 16);
      if (t < live_rows) {
        reinterpret_cast<uint4*>(out_slot + (row0 + t) * n_groups + o0)[v] =
            reinterpret_cast<const uint4*>(sslot[buf][t])[v];
      }
    }
  }
}

template <int G>
int launch(const float* rows, const float* cols, const unsigned char* mask,
           float* out_min, unsigned char* out_slot, int b, int n_rows,
           int n_cols, int n_block, cudaStream_t stream) {
  const int npg = n_block / G;
  dim3 grid((n_cols / n_block) * (npg / kCols), (n_rows + kRows - 1) / kRows,
            b);
  group_min_kernel<G><<<grid, kCols, 0, stream>>>(
      rows, cols, mask, out_min, out_slot, n_rows, n_cols, n_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows (B, R, 3) f32, cols (B, C, 3) f32, col_mask (B, C) bool, out_min
// (B, R, C/g) f32, out_slot (B, R, C/g) u8; all contiguous. g is 2, 4 or
// 8; n_block divides C and g * 128 divides n_block. Returns the
// cudaError_t of the launch.
int ptw_group_min(const void* rows, const void* cols, const void* col_mask,
                  void* out_min, void* out_slot, int b, int n_rows,
                  int n_cols, int g, int n_block, void* stream) {
  if ((g != 2 && g != 4 && g != 8) || n_block <= 0 || n_cols % n_block ||
      n_block % (g * kCols) ||
      (n_rows + kRows - 1) / kRows > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const float*>(rows);
  auto c = static_cast<const float*>(cols);
  auto m = static_cast<const unsigned char*>(col_mask);
  auto om = static_cast<float*>(out_min);
  auto os = static_cast<unsigned char*>(out_slot);
  switch (g) {
    case 2: return launch<2>(r, c, m, om, os, b, n_rows, n_cols, n_block, s);
    case 4: return launch<4>(r, c, m, om, os, b, n_rows, n_cols, n_block, s);
    case 8: return launch<8>(r, c, m, om, os, b, n_rows, n_cols, n_block, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
