// Inverse-distance blend of k selected source rows, and its backward
// (sm_90a).
//
// Replaces the Pallas kernel fp_interpolate_fast
// (pointstowood_tpu/ops/pallas_interp.py): its forward (_fwd_kernel,
// _weight_rows) with ptw_interp_blend, its backward (_bwd_kernel,
// _interp_bwd_1) with ptw_blend_bwd_lists + ptw_blend_bwd_gather.
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
// (positions are network inputs): for each source row (b, s),
//     d_x[b, s] = sum of (w_ti * (d_y[b, t] / den_t))
// over the entries e = t * k + i of live targets with idx[b, t, i] = s
// and w_ti > 0, in ascending e, in fp32 from +0, written once in d_y's
// type. The TPU kernel forms the same sum as a dense W^T @ (d_y / den)
// over query blocks, with W and d_y / den rounded to bf16; this kernel
// stays in fp32 throughout.
//
// What bounds both on the H100: HBM bytes. Each target row reads k source
// rows of C values (the backward: each source row reads the d_y rows of
// its entries) and each output row is written once; the arithmetic is
// ~2 * k * C flops per target.
//
// Forward design: one warp per target row; each lane moves 16 bytes at a
// time (8 bf16 or 4 fp32 channels), neighbouring lanes on neighbouring
// addresses. A slot with zero weight is never read (its features may hold
// garbage, and 0 * inf would be NaN). For k <= 8 the weights and indices
// sit in registers; a larger k reads each slot's (d2, idx) again for each
// channel chunk. Both use the *_rn intrinsics in the order of the plain
// PyTorch version (interp_kernels.blend_plain), so they equal it bit for
// bit.
//
// Backward design: a deterministic source-major gather, no atomics on
// features. The sum above is a gather once every source knows its
// entries, so the backward first builds the inverse lists (CSR by source)
// and then sums each list in one warp:
//  * ptw_blend_bwd_lists (a memset of the counts and three kernels):
//    bwd_count_kernel, one thread a target, takes each live entry's rank
//    in its source's list from an atomic on an int32 count per (b, s);
//    bwd_scan_kernel scans the counts in tiles of 4096, the block that
//    finishes last scanning the tiles' sums; bwd_fill_kernel writes the
//    offsets and puts each entry's id e, weight w and den_t, one 16-byte
//    word, at its list's offset + rank. Ranks follow the atomics, so a
//    list comes out in no fixed order.
//  * ptw_blend_bwd_gather: one warp per (b, s) and 32 16-byte vectors of
//    channels (two warps a row at C = 512 bf16) sorts its list's entry
//    ids (a bitonic sort over __shfl_xor_sync for up to 32 entries, a
//    rank sort through a scratch copy for a longer list, such as a source
//    that every target names), then walks them in ascending e: lane m
//    holds entry m's target, weight, den_t and 1 / den_t, the warp reads
//    that target's d_y row 16 bytes a lane, sums in registers, and writes
//    the d_x row once (zeros for an empty list). The sum's order is
//    fixed, so the result is the same on every run and equals the plain
//    version's (interp_kernels.blend_bwd_plain) bit for bit. No (B, S, C)
//    fp32 buffer, no memset of it, no cast pass: the earlier design's
//    atomicAdd scatter moved about 4.4x the bound's bytes at FP1.
//    d_y / den_t, rounded as __fdiv_rn rounds it, is taken from den_t's
//    reciprocal (div_by), and a chunk that meets a value div_by cannot
//    vouch for is summed again with __fdiv_rn by bwd_redo_kernel:
//    __fdiv_rn a value, with the call to its slow path in the loop, was
//    what bounded the gather.
// An entry whose idx lies outside [0, S) is dropped (the plain version
// raises on it).

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

// The forward for k > kMaxK: the same sums in the same order, each slot's
// (d2, idx) read again for every channel chunk instead of held.
template <typename V>
__global__ void __launch_bounds__(kWarps * 32)
interp_blend_any_k_kernel(const typename V::Elem* __restrict__ x,
                          const int* __restrict__ idx,
                          const float* __restrict__ d2,
                          const unsigned char* __restrict__ tmask,
                          typename V::Elem* __restrict__ y, int n_src,
                          int n_tgt, int c, int k, long long n_rows) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const long long b = row / n_tgt;
  typename V::Elem* yr = y + row * c;
  const int n_vec = c / V::kVec;
  const float* dr = d2 + row * k;
  const int* ir = idx + row * k;

  float den = 0.f;
  for (int i = 0; i < k; ++i)
    den = __fadd_rn(den, __frcp_rn(fmaxf(dr[i], 1e-16f)));
  den = fmaxf(den, 1e-16f);
  const bool live = tmask[row] != 0;

  for (int v = lane; v < n_vec; v += 32) {
    float acc[V::kVec];
#pragma unroll
    for (int j = 0; j < V::kVec; ++j) acc[j] = 0.f;
    if (live) {
      for (int i = 0; i < k; ++i) {
        const float w = __frcp_rn(fmaxf(dr[i], 1e-16f));
        if (!(w > 0.f)) continue;
        float f[V::kVec];
        V::load(x + (b * n_src + ir[i]) * (long long)c + v * V::kVec, f);
#pragma unroll
        for (int j = 0; j < V::kVec; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(w, f[j]));
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
  auto xs = static_cast<const typename V::Elem*>(x);
  auto is = static_cast<const int*>(idx);
  auto ds = static_cast<const float*>(d2);
  auto ms = static_cast<const unsigned char*>(tmask);
  auto ys = static_cast<typename V::Elem*>(y);
  if (k <= kMaxK)
    interp_blend_kernel<V><<<grid, kWarps * 32, 0, stream>>>(
        xs, is, ds, ms, ys, n_src, n_tgt, c, k, n_rows);
  else
    interp_blend_any_k_kernel<V><<<grid, kWarps * 32, 0, stream>>>(
        xs, is, ds, ms, ys, n_src, n_tgt, c, k, n_rows);
  return (int)cudaGetLastError();
}

// ---- Backward: inverse lists (CSR by source)

constexpr int kBuildThreads = 512;
constexpr int kScanPerThread = 8;  // counts a thread of the tile scan owns
constexpr int kScanTile = kBuildThreads * kScanPerThread;

// Exclusive sum over the block of one int a thread (blockDim.x ==
// kBuildThreads); *total gets the block's sum.
__device__ int block_exclusive_sum(int x, int* total) {
  __shared__ int warp_sums[kBuildThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  __syncthreads();  // warp_sums may still be read by a previous call
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int ws = lane < kBuildThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, ws, d);
      if (lane >= d) ws += o;
    }
    if (lane < kBuildThreads / 32) warp_sums[lane] = ws;  // inclusive
  }
  __syncthreads();
  *total = warp_sums[kBuildThreads / 32 - 1];
  return incl - x + (warp ? warp_sums[warp - 1] : 0);
}

// One thread a target row: a rank for each of its live entries in its
// source's list, from an atomic on the source's count (-1 for the other
// entries).
__global__ void __launch_bounds__(kBuildThreads)
bwd_count_kernel(const int* __restrict__ idx, const float* __restrict__ d2,
                 const unsigned char* __restrict__ tmask, int* counts,
                 int* __restrict__ ranks, int n_src, int n_tgt, int k,
                 long long n_rows) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const long long cell0 = row / n_tgt * n_src;
  const bool live = tmask[row] != 0;
  for (int i = 0; i < k; ++i) {
    const float w = __frcp_rn(fmaxf(d2[row * k + i], 1e-16f));
    const int s = idx[row * k + i];
    int r = -1;
    if (live && w > 0.f && s >= 0 && s < n_src)
      r = atomicAdd(counts + cell0 + s, 1);
    ranks[row * k + i] = r;
  }
}

// One block a tile of kScanTile counts: each thread's kScanPerThread
// counts become their exclusive prefix within the tile, in place, and
// tile_base[tile] their sum; the block that finishes last turns tile_base
// into the tiles' exclusive prefix, with the total at tile_base[n_tiles].
__global__ void __launch_bounds__(kBuildThreads)
bwd_scan_kernel(int* counts, int* tile_base, unsigned* done,
                long long n) {
  const long long j0 = (long long)blockIdx.x * kScanTile +
                       (long long)threadIdx.x * kScanPerThread;
  int v[kScanPerThread];
  int sum = 0;
#pragma unroll
  for (int q = 0; q < kScanPerThread; ++q) {
    v[q] = j0 + q < n ? counts[j0 + q] : 0;
    sum += v[q];
  }
  int total;
  int run = block_exclusive_sum(sum, &total);
#pragma unroll
  for (int q = 0; q < kScanPerThread; ++q) {
    if (j0 + q < n) counts[j0 + q] = run;
    run += v[q];
  }
  __shared__ bool last;
  if (threadIdx.x == 0) tile_base[blockIdx.x] = total;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int carry = 0;
  for (int t0 = 0; t0 < (int)gridDim.x; t0 += kBuildThreads) {
    const int t = t0 + threadIdx.x;
    const int x = t < (int)gridDim.x ? __ldcg(tile_base + t) : 0;
    int chunk;
    const int ex = block_exclusive_sum(x, &chunk);
    if (t < (int)gridDim.x) tile_base[t] = carry + ex;
    carry += chunk;
  }
  if (threadIdx.x == 0) tile_base[gridDim.x] = carry;
}

// One thread a target row: den_t = max(sum_i w_i, 1e-16) in slot order,
// and each live entry at its list's offset + rank as one 16-byte word
// (id t * k + i, the bits of w_i, the bits of den_t, 0). Threads
// 0 .. B * S also write the offsets, tile base plus prefix within the
// tile.
__global__ void __launch_bounds__(kBuildThreads)
bwd_fill_kernel(const int* __restrict__ idx, const float* __restrict__ d2,
                const int* __restrict__ ranks, const int* __restrict__ local,
                const int* __restrict__ tile_base, int* __restrict__ offsets,
                int4* __restrict__ entries, int n_src, int n_tgt, int k,
                long long n_rows, long long n_cells) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n_cells)
    offsets[row] = tile_base[row / kScanTile] + local[row];
  else if (row == n_cells)
    offsets[row] = tile_base[(n_cells + kScanTile - 1) / kScanTile];
  if (row >= n_rows) return;
  const long long b = row / n_tgt;
  const int t = (int)(row - b * n_tgt);
  const float* dr = d2 + row * k;
  float den = 0.f;
  for (int i = 0; i < k; ++i)
    den = __fadd_rn(den, __frcp_rn(fmaxf(dr[i], 1e-16f)));
  den = fmaxf(den, 1e-16f);
  for (int i = 0; i < k; ++i) {
    const int r = ranks[row * k + i];
    if (r >= 0) {
      const long long cell = b * n_src + idx[row * k + i];
      const int pos = tile_base[cell / kScanTile] + local[cell] + r;
      entries[pos] = make_int4(t * k + i,
                               __float_as_int(__frcp_rn(fmaxf(dr[i], 1e-16f))),
                               __float_as_int(den), 0);
    }
  }
}

// ---- Backward: the gather

// Compare-exchange with lane ^ stride: the lower lane of the pair keeps
// the smaller key when `up`, the larger otherwise.
__device__ __forceinline__ void exchange(unsigned long long& v, int stride,
                                         bool up) {
  const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, stride);
  const bool lower = (threadIdx.x & stride) == 0;
  if ((lower == up) == (o < v)) v = o;
}

// Ascending bitonic sort of one key a lane (32 keys).
__device__ __forceinline__ void sort32(unsigned long long& v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(v, stride, (lane & size) == 0);
  }
}

// a / b rounded to nearest, as __fdiv_rn(a, b) rounds it, for y =
// __frcp_rn(b) (within half an ulp of 1 / b), while 2^-60 <= |a|, b <=
// 2^60 (or a = 0): q = RN(a y) is within two ulps of a / b; one step
// q1 = RN(q + RN(a - b q) y) brings it within one ulp, and a second step
// from q1, whose remainder a - b q1 the FMA then forms exactly, gives the
// correctly rounded quotient (Markstein's theorem); in that range no
// value leaves the normal range. A zero a gives +0 where a / b may be -0,
// which changes no sum that starts from +0 (the sum of +0 and -0 is +0).
// The caller vouches for the range (per entry for b, by the chunk's least
// nonzero and largest |a|) and has any other chunk summed again with
// __fdiv_rn (bwd_redo_kernel). The divisor is an entry's den_t, the same
// for every channel, so its reciprocal is taken once an entry instead of
// once a value, and the gather's loop holds no call to __fdiv_rn's slow
// path.
__device__ __forceinline__ float div_by(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  const float q1 = __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
  return __fmaf_rn(__fmaf_rn(-b, q1, a), y, q1);
}

constexpr float kDivLo = 0x1p-60f, kDivHi = 0x1p60f;  // div_by's range

// The work of one warp: source row `row` of the lists (offsets,
// entries), channels v0 .. v0 + 32 * kVecs vectors (16 bytes each)
// of d_x. It orders the row's list by entry id, sums its entries' d_y
// rows over the chunk in that order, and writes the chunk once. With
// kExact every d_y / den_t is __fdiv_rn's; without, div_by's, and the
// result says whether every value and den_t of the chunk (on every lane)
// lay in div_by's range.
template <typename V, int kVecs, bool kExact>
__device__ __forceinline__ bool gather_chunk(
    const typename V::Elem* __restrict__ dy, const int* __restrict__ offsets,
    const int4* __restrict__ entries, int* order,
    typename V::Elem* __restrict__ dx, long long row, int v0, int n_src,
    int n_tgt, int c, int k) {
  const int lane = threadIdx.x % 32;
  const long long tbase = row / n_src * n_tgt;
  const int lo = offsets[row];
  const int n = offsets[row + 1] - lo;
  const int n_vec = c / V::kVec;

  // Lane m's entry: for n <= 32 lane m holds list position j in a key
  // (id << 5 | j) that a bitonic sort orders; for a longer list,
  // order[lo + m] holds the position of the m-th id (a rank sort that
  // every warp of the row writes alike).
  unsigned long long key = ~0ULL;
  if (n <= 32) {
    if (lane < n)
      key = (unsigned long long)entries[lo + lane].x << 5 | (unsigned)lane;
    sort32(key);
  } else {
    const int4* list = entries + lo;
    for (int j = lane; j < n; j += 32) {
      const int id = list[j].x;
      int r = 0;
      for (int q = 0; q < n; ++q) r += list[q].x < id;
      order[lo + r] = j;
    }
    __syncwarp();
  }

  // the least nonzero |d_y| value (as its bits times 2 less 2: a zero
  // wraps to the top), the largest, and whether every den_t lies in
  // div_by's range
  unsigned lo_a = ~0u;
  float hi_a = 0.f;
  bool ok = true;
  float acc[kVecs][V::kVec];
#pragma unroll
  for (int u = 0; u < kVecs; ++u)
#pragma unroll
    for (int j = 0; j < V::kVec; ++j) acc[u][j] = 0.f;
  for (int base = 0; base < n; base += 32) {
    // lane m: entry base + m's target row, weight, den_t and 1 / den_t
    long long trow = 0;
    float w = 0.f, dn = 1.f, yn = 1.f;
    if (base + lane < n) {
      const int j = n <= 32 ? (int)(key & 31) : order[lo + base + lane];
      const int4 e = entries[lo + j];
      trow = tbase + e.x / k;
      w = __int_as_float(e.y);
      dn = __int_as_float(e.z);
      yn = __frcp_rn(dn);
      ok &= dn >= kDivLo && dn <= kDivHi;
    }
    const int cnt = min(32, n - base);
    for (int m = 0; m < cnt; ++m) {
      const long long tr = __shfl_sync(0xffffffffu, trow, m);
      const float wm = __shfl_sync(0xffffffffu, w, m);
      const float dm = __shfl_sync(0xffffffffu, dn, m);
      const float ym = __shfl_sync(0xffffffffu, yn, m);
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int v = v0 + u * 32 + lane;
        if (v < n_vec) {
          float f[V::kVec];
          V::load(dy + tr * c + v * V::kVec, f);
#pragma unroll
          for (int j = 0; j < V::kVec; ++j) {
            float g;
            if constexpr (kExact) {
              g = __fdiv_rn(f[j], dm);
            } else {
              g = div_by(f[j], dm, ym);
              lo_a = min(lo_a, __float_as_uint(f[j]) * 2u - 2u);
              hi_a = fmaxf(hi_a, fabsf(f[j]));
            }
            acc[u][j] = __fadd_rn(acc[u][j], __fmul_rn(wm, g));
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int v = v0 + u * 32 + lane;
    if (v < n_vec) V::store(dx + row * c + v * V::kVec, acc[u]);
  }
  // a NaN value escapes both bounds, and gives NaN either way
  const unsigned lo_bound = __float_as_uint(kDivLo) * 2u - 2u;
  return __all_sync(0xffffffffu, ok && lo_a >= lo_bound && hi_a <= kDivHi);
}

// One warp per (source row, channel chunk); a chunk with a value that
// div_by could not vouch for goes to the redo list (redo[0] counts it).
template <typename V, int kVecs>
__global__ void __launch_bounds__(kWarps * 32)
bwd_gather_kernel(const typename V::Elem* __restrict__ dy,
                  const int* __restrict__ offsets,
                  const int4* __restrict__ entries, int* order,
                  typename V::Elem* __restrict__ dx, int* redo, int n_src,
                  int n_tgt, int c, int k, int n_chunks, long long n_warps) {
  const long long warp = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (warp >= n_warps) return;  // uniform over the warp
  const long long row = warp / n_chunks;
  const int v0 = (int)(warp - row * n_chunks) * 32 * kVecs;
  if (!gather_chunk<V, kVecs, false>(dy, offsets, entries, order, dx, row,
                                     v0, n_src, n_tgt, c, k) &&
      threadIdx.x % 32 == 0)
    redo[1 + atomicAdd(redo, 1)] = (int)warp;
}

// The chunks of the redo list again, with __fdiv_rn (a grid of a few
// warps an SM; with an empty list each warp only reads the count).
template <typename V, int kVecs>
__global__ void __launch_bounds__(kWarps * 32)
bwd_redo_kernel(const typename V::Elem* __restrict__ dy,
                const int* __restrict__ offsets,
                const int4* __restrict__ entries, int* order,
                typename V::Elem* __restrict__ dx, const int* redo,
                int n_src, int n_tgt, int c, int k, int n_chunks) {
  const int n_redo = redo[0];
  for (int i = blockIdx.x * kWarps + threadIdx.x / 32; i < n_redo;
       i += gridDim.x * kWarps) {
    const long long warp = redo[1 + i];
    const long long row = warp / n_chunks;
    gather_chunk<V, kVecs, true>(dy, offsets, entries, order, dx, row,
                                 (int)(warp - row * n_chunks) * 32 * kVecs,
                                 n_src, n_tgt, c, k);
  }
}

constexpr int kGatherVecs = 1;   // 16-byte vectors a lane per chunk
constexpr int kRedoBlocks = 132;

template <typename V>
int launch_gather(const void* dy, const int* offsets, const int4* entries,
                  int* order, void* dx, int* redo, int b, int n_src,
                  int n_tgt, int c, int k, cudaStream_t stream) {
  const int n_vec = c / V::kVec;
  const int n_chunks =
      max(1, (n_vec + 32 * kGatherVecs - 1) / (32 * kGatherVecs));
  const long long n_warps = (long long)b * n_src * n_chunks;
  int err = (int)cudaMemsetAsync(redo, 0, sizeof(int), stream);
  if (err) return err;
  const unsigned grid = (unsigned)((n_warps + kWarps - 1) / kWarps);
  auto y = static_cast<const typename V::Elem*>(dy);
  auto x = static_cast<typename V::Elem*>(dx);
  bwd_gather_kernel<V, kGatherVecs><<<grid, kWarps * 32, 0, stream>>>(
      y, offsets, entries, order, x, redo, n_src, n_tgt, c, k,
      n_chunks, n_warps);
  err = (int)cudaGetLastError();
  if (err) return err;
  bwd_redo_kernel<V, kGatherVecs><<<kRedoBlocks, kWarps * 32, 0, stream>>>(
      y, offsets, entries, order, x, redo, n_src, n_tgt, c, k,
      n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, S, C) bf16 (is_bf16 = 1) or f32 (0); idx (B, T, k) i32;
// d2 (B, T, k) f32; tmask (B, T) bool; y (B, T, C) in x's type. All
// contiguous; C a multiple of 8 (bf16) or 4 (f32); k >= 1 (k <= 8 holds
// the slots in registers). Returns the cudaError_t of the launch.
int ptw_interp_blend(const void* x, const void* idx, const void* d2,
                     const void* tmask, void* y, int b, int n_src, int n_tgt,
                     int c, int k, int is_bf16, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<Bf16x8>(x, idx, d2, tmask, y, b, n_src, n_tgt, c, k, s);
  return launch<F32x4>(x, idx, d2, tmask, y, b, n_src, n_tgt, c, k, s);
}

// The inverse lists of the backward. idx (B, T, k) i32, d2 (B, T, k) f32,
// tmask (B, T) bool; counts i32 scratch of B * S + ceil(B * S / 4096) + 2
// words (zeroed here: the counts, the tiles' bases, a done counter);
// offsets (B * S + 1) i32; ranks (B, T, k) i32
// scratch; entries (B * T * k, 4) i32, of which offsets[B * S] rows are
// written: list (b, s) is rows offsets[b * S + s] .. offsets[b * S + s +
// 1], each (entry id t * k + i, bits of w_ti, bits of den_t, 0), in no
// fixed order. All contiguous, B, T, S >= 1,
// B * T * k < 2^31. Returns the first cudaError_t met.
int ptw_blend_bwd_lists(const void* idx, const void* d2, const void* tmask,
                        void* counts, void* offsets, void* ranks,
                        void* entries, int b,
                        int n_src, int n_tgt, int k, void* stream) {
  if (b < 1 || n_src < 1 || n_tgt < 1 || k < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const long long n_cells = (long long)b * n_src;
  const long long n_rows = (long long)b * n_tgt;
  const long long n_tiles = (n_cells + kScanTile - 1) / kScanTile;
  int* cnt = static_cast<int*>(counts);
  int* tile_base = cnt + n_cells;  // n_tiles + 1 words, then the counter
  unsigned* done = reinterpret_cast<unsigned*>(tile_base + n_tiles + 1);
  int err = (int)cudaMemsetAsync(cnt, 0,
                                 (n_cells + n_tiles + 2) * sizeof(int), s);
  if (err) return err;
  const unsigned grid = (unsigned)((n_rows + kBuildThreads - 1) /
                                   kBuildThreads);
  bwd_count_kernel<<<grid, kBuildThreads, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const float*>(d2),
      static_cast<const unsigned char*>(tmask), cnt,
      static_cast<int*>(ranks), n_src, n_tgt, k, n_rows);
  err = (int)cudaGetLastError();
  if (err) return err;
  bwd_scan_kernel<<<(unsigned)n_tiles, kBuildThreads, 0, s>>>(
      cnt, tile_base, done, n_cells);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long n_fill = n_rows > n_cells + 1 ? n_rows : n_cells + 1;
  bwd_fill_kernel<<<(unsigned)((n_fill + kBuildThreads - 1) / kBuildThreads),
                    kBuildThreads, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const float*>(d2),
      static_cast<const int*>(ranks), cnt, tile_base,
      static_cast<int*>(offsets), static_cast<int4*>(entries), n_src, n_tgt,
      k, n_rows, n_cells);
  return (int)cudaGetLastError();
}

// The gather of the backward: d_y (B, T, C) bf16 (is_bf16 = 1) or f32
// (0); offsets, entries from ptw_blend_bwd_lists; order
// (B * T * k) i32 scratch; redo i32 scratch of 1 + B * S * ceil(C / 256)
// (bf16) or 1 + B * S * ceil(C / 128) (f32) words; d_x (B, S, C) in
// d_y's type, every row written. All contiguous; C a multiple of 8
// (bf16) or 4 (f32). Returns the first cudaError_t met.
int ptw_blend_bwd_gather(const void* dy, const void* offsets,
                         const void* entries, void* order, void* redo,
                         void* dx,
                         int b, int n_src, int n_tgt, int c, int k,
                         int is_bf16, void* stream) {
  if (b < 1 || n_src < 1 || k < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto os = static_cast<const int*>(offsets);
  auto es = static_cast<const int4*>(entries);
  auto od = static_cast<int*>(order);
  auto rd = static_cast<int*>(redo);
  if (is_bf16)
    return launch_gather<Bf16x8>(dy, os, es, od, dx, rd, b, n_src, n_tgt,
                                 c, k, s);
  return launch_gather<F32x4>(dy, os, es, od, dx, rd, b, n_src, n_tgt, c, k,
                              s);
}

}  // extern "C"
