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
// What bounds it on the H100: the output. At SA1 of a 32768-point batch
// (B = 8, R = 16384, C = 32768, g = 8) it writes 5.4e8 minima and slots, 2.7
// GB: 0.8 ms at 3.35 TB/s, against 0.51 ms for the 34 GFLOP of distances
// (8 operations per pair) at 67 TFLOP/s. The inputs are tiny (12 bytes a
// point).
//
// Design: one thread per group column. A block takes kCols consecutive
// groups of one column block and kRows rows; each thread loads its group's
// g members into registers once, the rows are staged in shared memory and
// read as broadcasts, and for each row a warp stores 32 neighbouring minima
// (128 bytes) and slots (32 bytes), so the stores are coalesced. Output
// offsets are 64-bit (B * R * C/g passes 2^31 at these shapes). The TPU
// kernel packs the slot into the low mantissa bits of a bf16x3 selection
// value ||s||^2 - 2 q.s, which works around Mosaic; here the slot is its
// own array and the value is the true squared distance in the difference
// form with the *_rn intrinsics (no FMA contraction), so the kernel equals
// the plain PyTorch version (knn_kernels.py group_min_plain) bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCols = 128;  // group columns (threads) per block
constexpr int kRows = 64;   // rows per block

template <int G>
__global__ void __launch_bounds__(kCols)
group_min_kernel(const float* __restrict__ rows,
                 const float* __restrict__ cols,
                 const unsigned char* __restrict__ col_mask,
                 float* __restrict__ out_min,
                 unsigned char* __restrict__ out_slot, int n_rows,
                 int n_cols, int n_block) {
  __shared__ float rs[kRows * 3];
  const int npg = n_block / G;
  const int tiles = (npg + kCols - 1) / kCols;
  const int bk = blockIdx.x / tiles;
  const int jj = (blockIdx.x % tiles) * kCols + threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kRows;
  const int cnt = min(kRows, n_rows - r0);
  const bool active = jj < npg;

  float mx[G], my[G], mz[G];
  unsigned live = 0;
  const float* cb = cols + (size_t)b * n_cols * 3;
  const unsigned char* mb = col_mask + (size_t)b * n_cols;
#pragma unroll
  for (int a = 0; a < G; ++a) {
    mx[a] = my[a] = mz[a] = 0.f;
    if (active) {
      const int c = bk * n_block + a * npg + jj;
      const float* p = cb + (size_t)c * 3;
      mx[a] = p[0];
      my[a] = p[1];
      mz[a] = p[2];
      live |= (mb[c] ? 1u : 0u) << a;
    }
  }
  const float* rb = rows + ((size_t)b * n_rows + r0) * 3;
  for (int t = threadIdx.x; t < cnt * 3; t += kCols) rs[t] = rb[t];
  __syncthreads();
  if (!active) return;

  const size_t n_groups = (size_t)(n_cols / G);
  size_t o = ((size_t)b * n_rows + r0) * n_groups + (size_t)bk * npg + jj;
  for (int t = 0; t < cnt; ++t, o += n_groups) {
    const float rx = rs[3 * t], ry = rs[3 * t + 1], rz = rs[3 * t + 2];
    float m = 0.f;
    int slot = 0;
#pragma unroll
    for (int a = 0; a < G; ++a) {
      const float dx = __fsub_rn(rx, mx[a]);
      const float dy = __fsub_rn(ry, my[a]);
      const float dz = __fsub_rn(rz, mz[a]);
      float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                          __fmul_rn(dz, dz));
      d = ((live >> a) & 1u) ? d : INFINITY;
      if (a == 0) {
        m = d;
      } else if (d < m) {
        m = d;
        slot = a;
      }
    }
    out_min[o] = m;
    out_slot[o] = (unsigned char)slot;
  }
}

template <int G>
int launch(const float* rows, const float* cols, const unsigned char* mask,
           float* out_min, unsigned char* out_slot, int b, int n_rows,
           int n_cols, int n_block, cudaStream_t stream) {
  const int npg = n_block / G;
  dim3 grid((n_cols / n_block) * ((npg + kCols - 1) / kCols),
            (n_rows + kRows - 1) / kRows, b);
  group_min_kernel<G><<<grid, kCols, 0, stream>>>(
      rows, cols, mask, out_min, out_slot, n_rows, n_cols, n_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows (B, R, 3) f32, cols (B, C, 3) f32, col_mask (B, C) bool, out_min
// (B, R, C/g) f32, out_slot (B, R, C/g) u8; all contiguous. g is 2, 4 or
// 8; n_block divides C and g divides n_block. Returns the cudaError_t of
// the launch.
int ptw_group_min(const void* rows, const void* cols, const void* col_mask,
                  void* out_min, void* out_slot, int b, int n_rows,
                  int n_cols, int g, int n_block, void* stream) {
  if (n_block <= 0 || n_cols % n_block || n_block % g ||
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
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
