// Exact fp32 k-nearest selection over D-dimensional points (sm_90a).
//
// Replaces, where the JAX fast kNN searches more than three dimensions
// (ATSearchKNN's learned embedding, pointstowood_tpu/model/attention.py),
// two Pallas kernels of pointstowood_tpu/ops/pallas_knn.py:
//   * group_min_topk (_make_topk_kernel, pallas_call at :399)
//   * group_min      (_make_kernel,      pallas_call at :181), with the
//     approx_min_k that follows it
// -> the launches of knn_kernels.knn_topk_dim: ptw_knn_dim_filter,
// ptw_knn_dim_rescore and ptw_knn_dim_exhaustive for K = 2/8/16/32/64,
// and past k = 64 passes of K = 64 above the last key of the pass before
// (ptw_knn_topk_dim with a floor; knn_kernels.topk_plan).
//
// What it computes: for every row point r of batch b, the K nearest valid
// column points c by the D-dimensional squared distance, as (d2, idx),
// ascending, ties to the lower column index; masked columns, NaN
// distances and unfilled slots as (+inf, 0). The distance p is a
// left-to-right sum over d of (r_d - c_d)^2 with __fsub_rn, __fmul_rn and
// __fadd_rn (no FMA), so it equals the plain PyTorch version's
// `pair_d2_dim` (ops/knn_kernels.py) bit for bit; at D = 3 it is the 3-dim
// kernels' float. The Pallas kernels rank D > 3 by a truncated distance
// (ROADMAP.md section 3); this kernel ranks by p.
//
// Design: a certified filter on the tensor cores, then an exact rescore.
//  1. Prep (knn_dim_prep_kernel, one warp a point): an exact copy of rows
//     and columns zero-padded to Dp = D rounded up to 8 (16-byte rows),
//     a TF32 copy (cvt.rna) padded to Dt = D rounded up to 32, and per
//     point the float4 (Nhi, Nlo, Q, valid) of the certificate below. A
//     zero dimension adds +0 to a sum and 0 to a product.
//  2. Filter (knn_dim_filter_kernel): a block of 8 warps serves 128 rows
//     and streams the columns in 128-column tiles; each tile's products
//     s^ = r~ . c~ by mma.sync.m16n8k8 TF32 (fp32 accumulators, a 32 x 64
//     warp tile) from 32-dimension chunks that cp.async stages in shared
//     memory four deep (rows 144 bytes apart: ldmatrix is free of bank
//     conflicts), with each tile's column terms. A row's columns fall on
//     8 lanes (the 4 of a quad of the mma fragment times the 2 warps
//     along the columns); each lane keeps, per row, its KL = min(8,
//     max(1, K / 4)) smallest U in shared memory. One sweep, in visits:
//     tiles 0 .. T - 1 fill the lists; from tile W = 8 on, and for tiles
//     0 .. W - 1 visited again at the end, a column is a candidate unless
//     L > tau_run, in exactly that form, so that a NaN bound stays:
//     tau_run, the largest of the row's 8 lanes' (max(1, K / 8))-th kept
//     U after the visits before, has 8 max(1, K / 8) >= K distinct
//     columns at or below it. A row's count and its first M = 512
//     candidates (index and L) go to device memory; at the end, tau, the
//     K-th smallest of the row's 8 KL kept values (+inf unless K are
//     finite), <= every tau_run. A tile's bounds are taken in one pass
//     without branches, which stages each lane's events (an insertion, a
//     candidate), up to 16; a second pass serves them, one event of every
//     lane at a time (a warp with a lane past 16 serves its pairs one by
//     one). A U at or above tau_run is not inserted: it could move
//     neither tau_run nor tau.
//  3. Rescore (knn_dim_rescore_kernel, one warp a row of count <= M): the
//     survivors, the candidates with !(L > tau), compacted in shared
//     memory, 64 a round: their next 32 dimensions staged from the exact
//     copy (each load four survivors' 128 contiguous bytes), each lane
//     summing its two survivors' p in ascending d (add_sq4), the keys
//     (p, index) offered to select.cuh's WarpSelect<K>: the index breaks
//     ties, so the candidates' order (atomics) does not matter.
//  4. Rows the filter cannot narrow (count > M) run the exhaustive
//     knn_dim_kernel, launched over every row block: a block whose rows
//     all fit in M exits at once, so the host never reads a count.
// Why it is exact: every column of the plain top-K has p <= the K-th
// smallest plain p <= (1 + g) tau, and (1 - g) L <= p, so it survives;
// the survivors are valid columns, so the selection over them is the
// plain one.
//
// The certificate (u = 2^-24, u_t = 2^-11 for cvt.rna; g_n = n 2^-23,
// which is >= n u / (1 - n u)). Every bound below is computed with
// directed rounding (__f*_ru up, __f*_rd down), so each computed value
// is on the safe side of the real expression it stands for.
//  * Norms: n_x = sum_d x_d^2 in fp32 (FMAs along a lane, a shuffle
//    tree): |n_x - ||x||^2| <= g_{D+6} ||x||^2 + (D + 32) 2^-149 (the
//    second term: roundings in the subnormal range). A_x =
//    sqrt_ru((n_x + t)(1 + 2 g)) >= ||x||, e_x = g A_x^2 + t >= that
//    error.
//  * Products: cvt.rna moves each coordinate by <= u_t |x|, or, for an
//    input that the tensor cores flush to zero, by < 2^-126; a product by
//    (2 u_t + u_t^2) |r_d c_d| + 2^-126 (1 + u_t)(|r_d| + |c_d|). The
//    fp32 accumulation, in the tensor cores' unspecified order and
//    rounding, adds <= a_acc sum |r~_d c~_d| with a_acc = 2 (D + 8) 2^-23
//    (about 16 units in the last place for each step of 8 products), and
//    a flushed subnormal product <= 2^-126 each. With sum |r_d c_d| <=
//    ||r|| ||c|| and sum |x_d| <= sqrt(D) ||x||:
//    2 |s^ - s| <= Q_r Q_c + f_r + f_c + D 2^-125, Q_x = sqrt_ru(2 c_s)
//    A_x, c_s = 2 u_t + u_t^2 + (1 + u_t)^2 a_acc, f_x = sqrt(D) 2^-124
//    A_x.
//  * Assembly: with d~ = n_r + n_c - 2 s^ (real arithmetic on those fp32
//    values), |d~ - d2| <= E = P_r + P_c + Q_r Q_c, P_x = e_x + f_x, plus
//    K0 = (D + 8) 2^-124 in the rows' P (the flushed products, and twice
//    the plain sum's subnormal term). Nhi = n + P up, Nlo = n - P down.
//  * The plain sum's own error: |p - d2| <= g d2 + 2 D 2^-150, g =
//    g_{D+2} (D - 1 additions, a difference and a square a term, all
//    rounded to nearest; the absolute term is the squares' underflow).
//  * So with U = (Nhi_r + Nhi_c - 2 s^) + Q_r Q_c and L = (Nlo_r + Nlo_c -
//    2 s^) - Q_r Q_c (an FMA takes the product Q_r Q_c exactly): p <=
//    (1 + g) U and p >= (1 - g) L (a negative L is below every p). The
//    lists and tau keep U; a candidate's test holds L against tau times
//    (1 + g) / (1 - g) rounded up, one product a row.
//  * Non-finite: a point whose norm is not finite (a NaN or infinite
//    coordinate, or coordinates near 1e19 whose squares sum past fp32)
//    has NaN terms, and a masked column a NaN Nhi: their U never enters a
//    list (U >= 0 and below the list's last entry), and an unmasked such
//    column is always a candidate. If s^ overflows, so does Nhi_r + Nhi_c
//    (||r||^2 + ||c||^2 >= 2 |s|), and U is NaN.
// In the standardised embedding (||x||^2 about D) the window U - L is
// about 2^-9 D: 0.5 at SA2 (D = 263), 1.0 at SA3 (D = 519).
//
// What bounds it (PERF.md, PR 10): at SA2 the mainloop's products run at
// about 190 TFLOP/s with their operands in shared memory (mma.sync, not
// wgmma: 6 ldmatrix for 16 mma at this 32 x 64 warp tile) and the tile
// loads from L2 add about 60% (a 128 x 128 block tile reads 32 KB a
// 32-dimension chunk); the bounds, their staging and the served events
// add as much again, not overlapped with the products (one block an
// SM). The rescore is bound by the survivors' columns read from L2.
//
// knn_dim_kernel, the exhaustive scan (the rows with count > M, and every
// pass past k = 64): a block of kWarps warps serves kWarps * kRowsPerWarp
// rows; the columns stream through in tiles of kColTile = 32 * kCols, and
// each tile through D in chunks of kChunk dimensions staged in shared
// memory (zero-padded past D). Each thread keeps a register block of
// kRowsPerWarp x kCols partial sums; per 4 dimensions it reads
// kRowsPerWarp + kCols float4 from shared memory for 48 fp32 operations a
// float4 pair. A finished tile's distances go to WarpSelect::add, one
// selection per row. Bound: operations, 3 per pair and dimension at the
// SMs' fp32 issue rate.

#include <cuda_runtime.h>
#include <math.h>

#include "select.cuh"

namespace {

using ptw_select::kEmpty;
using ptw_select::kFull;
using ptw_select::Key;
using ptw_select::key_d2;
using ptw_select::key_index;
using ptw_select::make_key;
using ptw_select::WarpSelect;

constexpr int kQueue = 8;  // queued keys a lane, per row

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

// ---- the exhaustive scan

constexpr int kWarps = 4;         // warps a block
constexpr int kRowsPerWarp = 4;   // rows a warp (and a thread) scores
constexpr int kCols = 4;          // columns a lane scores per tile
constexpr int kColTile = 32 * kCols;
constexpr int kBlockRows = kWarps * kRowsPerWarp;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;        // dimensions a shared-memory chunk
constexpr int kStride = kChunk + 4;  // floats a staged point (float4 rows)

// rows (B, R, D), cols (B, C, D) f32, col_mask (B, C) bool; with Above,
// prev_d / prev_i (B, R, K) the pass before, whose slot K - 1 is each
// row's floor key. With counts (B, R) non-null, only the rows whose count
// exceeds m: a block without one exits at once. out_d / out_i (B, R, K).
template <int K, bool Above>
__global__ void __launch_bounds__(kThreads)
knn_dim_kernel(const float* __restrict__ rows,
               const float* __restrict__ cols,
               const unsigned char* __restrict__ col_mask,
               const float* __restrict__ prev_d,
               const int* __restrict__ prev_i,
               const int* __restrict__ counts, int m,
               float* __restrict__ out_d, int* __restrict__ out_i,
               int n_rows, int n_cols, int dim) {
  __shared__ __align__(16) float rtile[kBlockRows * kStride];
  __shared__ __align__(16) float ctile[kColTile * kStride];
  __shared__ unsigned char cvalid[kColTile];
  __shared__ Key queues[kWarps][kRowsPerWarp][Select<K, Above>::kQueueKeys];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kBlockRows;
  const int q0 = row0 + warp * kRowsPerWarp;  // this warp's first row
  const int* cnt = counts != nullptr ? counts + (size_t)b * n_rows : nullptr;
  if (counts != nullptr) {
    bool any = false;  // the same in every thread: the block exits whole
    for (int r = 0; r < kBlockRows && row0 + r < n_rows; ++r) {
      any |= cnt[row0 + r] > m;
    }
    if (!any) return;
  }
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
    if (cnt != nullptr && cnt[q0 + r] <= m) continue;  // rescored
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

// ---- prep: padded copies and the certificate's per-point terms

constexpr int kPrepWarps = 8;

__device__ __forceinline__ float to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// (Nhi, Nlo, Q, valid) of a point of fp32 squared norm n (the source
// note's certificate; k0 is the rows' absolute term, 0 for columns).
__device__ __forceinline__ float4 point_terms(float n, int dim, float k0,
                                              float valid) {
  if (!isfinite(n)) return make_float4(NAN, NAN, NAN, valid);
  const float g = (float)(dim + 6) * 0x1p-23f;
  const float tiny = (float)(dim + 32) * 0x1p-149f;
  const float a =
      __fsqrt_ru(__fmul_ru(__fadd_ru(n, tiny), __fadd_ru(1.f, 2.f * g)));
  const float e = __fadd_ru(__fmul_ru(g, __fmul_ru(a, a)), tiny);
  const float f = __fmul_ru(__fmul_ru(__fsqrt_ru((float)dim), 0x1p-124f), a);
  const float p = __fadd_ru(__fadd_ru(e, f), k0);
  const float a_acc = (float)(2 * (dim + 8)) * 0x1p-23f;
  const float c_s = __fadd_ru(0x1p-10f + 0x1p-22f,
                              __fmul_ru(1.f + 0x1p-10f + 0x1p-22f, a_acc));
  const float q = __fmul_ru(__fsqrt_ru(2.f * c_s), a);
  return make_float4(__fadd_ru(n, p), __fsub_rd(n, p), q, valid);
}

// pts (n_pts, dim) -> exact copy (n_pts, dp), TF32 copy (n_pts, dt) and
// terms (n_pts) float4; mask (n_pts) bool or null (every point valid). A
// masked point's Nhi is NaN, so its U never enters a list.
__global__ void __launch_bounds__(kPrepWarps * 32)
knn_dim_prep_kernel(const float* __restrict__ pts,
                    const unsigned char* __restrict__ mask,
                    float* __restrict__ exact, float* __restrict__ tf32,
                    float4* __restrict__ terms, int n_pts, int dim, int dp,
                    int dt, int is_rows) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kPrepWarps + (threadIdx.x >> 5);
  if (p >= n_pts) return;
  const float* x = pts + (size_t)p * dim;
  float* ex = exact + (size_t)p * dp;
  float* tf = tf32 + (size_t)p * dt;
  float n = 0.f;
  for (int d = lane; d < dt; d += 32) {
    const float v = d < dim ? x[d] : 0.f;
    if (d < dp) ex[d] = v;
    tf[d] = to_tf32(v);
    n = __fmaf_rn(v, v, n);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    n = __fadd_rn(n, __shfl_xor_sync(kFull, n, o));
  }
  if (lane == 0) {
    const float k0 = is_rows ? (float)(dim + 8) * 0x1p-124f : 0.f;
    const bool valid = mask == nullptr || mask[p];
    float4 t = point_terms(n, dim, k0, valid ? 1.f : 0.f);
    if (!valid) t.x = NAN;
    terms[p] = t;
  }
}

// ---- the filter

constexpr int kFRows = 128;   // rows a block
constexpr int kFCols = 128;   // columns a tile
constexpr int kFDepth = 32;   // dimensions a stage (the TF32 copy's unit)
constexpr int kFStages = 4;   // cp.async stages
constexpr int kFStride = kFDepth + 4;  // floats a staged point (144 bytes)
constexpr int kFThreads = 256;  // 8 warps: 4 along rows x 2 along columns
constexpr int kFGroups = 8;     // lanes a row's columns fall on
constexpr int kFPrime = 8;      // tiles that fill the lists before listing
constexpr int kFEvents = 16;    // events a lane stages a tile

// KL, the U kept a lane and row: the 8 lists of a row hold 8 KL >= K
// values, at most 64
template <int K>
__host__ __device__ constexpr int kept() {
  return K / 4 > 8 ? 8 : (K / 4 < 1 ? 1 : K / 4);
}

// The lists: group g's list of local row r at g * list_stride + r (KL + 1),
// so that the 32 lanes of a warp (8 rows x 4 groups) reach 32 banks
template <int K>
__host__ __device__ constexpr int list_stride() {
  return kFRows * (kept<K>() + 1) + 8;
}

template <int K>
constexpr int filter_smem_bytes() {
  return (kFStages * (kFRows + kFCols) * kFStride + kFStages * kFCols * 4 +
          kFGroups * list_stride<K>() + 2 * kFRows +
          2 * kFEvents * kFThreads) * 4 +
         kFRows * 4;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const float* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows_t (B, R, dt), cols_t (B, C, dt) TF32 copies (dt a multiple of 32),
// rows_p (B, R) and cols_p (B, C) float4 terms -> counts (B, R)
// candidates a row, cand / cand_l (B, R, m) the first m candidates'
// column indices and lower bounds L, in no order, and tau (B, R) times
// (1 + g) / (1 - g), against which the rescore holds L.
template <int K>
__global__ void __launch_bounds__(kFThreads, 1)
knn_dim_filter_kernel(const float* __restrict__ rows_t,
                      const float* __restrict__ cols_t,
                      const float4* __restrict__ rows_p,
                      const float4* __restrict__ cols_p,
                      int* __restrict__ cand, float* __restrict__ cand_l,
                      int* __restrict__ counts, float* __restrict__ tau_out,
                      int n_rows, int n_cols, int dim, int dt, int m) {
  constexpr int KL = kept<K>();
  constexpr int kRun = (K / 8 > 1 ? K / 8 : 1) - 1;  // list entry of tau_run
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                                  // [stage][row][dim]
  float* sb = sa + kFStages * kFRows * kFStride;     // [stage][col][dim]
  float4* sterm = reinterpret_cast<float4*>(sb + kFStages * kFCols * kFStride);
  float* lists = reinterpret_cast<float*>(sterm + kFStages * kFCols);
  float* tau_s = lists + kFGroups * list_stride<K>();  // [2][row]
  float* ev_v = tau_s + 2 * kFRows + threadIdx.x;  // event e at e kFThreads
  int* ev_c = reinterpret_cast<int*>(ev_v + kFEvents * kFThreads);
  int* count = reinterpret_cast<int*>(tau_s + 2 * kFRows +
                                      2 * kFEvents * kFThreads);

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kFRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int grp = wn * 4 + t;  // this lane's list of each of its rows
  if (threadIdx.x < kFRows) {
    count[threadIdx.x] = 0;
    tau_s[threadIdx.x] = tau_s[kFRows + threadIdx.x] = INFINITY;
  }
  for (int i = threadIdx.x; i < kFGroups * list_stride<K>(); i += kFThreads) {
    lists[i] = INFINITY;
  }
  // this lane's list of row r: mine + r (KL + 1)
  float* mine = lists + grp * list_stride<K>();

  const float* ra = rows_t + (size_t)b * n_rows * dt;
  const float* ca = cols_t + (size_t)b * n_cols * dt;
  const float4* cp = cols_p + (size_t)b * n_cols;
  int* cand_b = cand + (size_t)b * n_rows * m;
  float* cand_lb = cand_l + (size_t)b * n_rows * m;

  // visits: tiles 0 .. T - 1, then tiles 0 .. W - 1 again; visits below
  // T fill the lists, visits from W on list candidates
  const int n_tiles = (n_cols + kFCols - 1) / kFCols;
  const int n_prime = min(kFPrime, n_tiles);
  const int n_chunks = dt / kFDepth;
  const int total = (n_tiles + n_prime) * n_chunks;
  // U and L are kept without their factors 1 + g and 1 - g (a pair's
  // p <= (1 + g) U and p >= (1 - g) L): L is held against tau
  // (1 + g) / (1 - g) rounded up, one product a row
  const float g_p = (float)(dim + 2) * 0x1p-23f;
  const float ratio = __fdiv_ru(__fadd_ru(1.f, g_p), __fsub_rd(1.f, g_p));

  // the lane's 4 rows: ri = 2 mt + h is local row wm 32 + mt 16 + h 8 + g,
  // fragment entries acc[mt][nt][2 h + j] (column wn 64 + nt 8 + 2 t + j)
  int lrow[4];
  float nhi[4], nlo[4], qr[4], thr[4];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    lrow[ri] = wm * 32 + (ri >> 1) * 16 + (ri & 1) * 8 + g;
    const int q = row0 + lrow[ri];
    const float4 p = q < n_rows ? rows_p[(size_t)b * n_rows + q]
                                : make_float4(NAN, NAN, NAN, 0.f);
    nhi[ri] = p.x;
    nlo[ri] = p.y;
    qr[ri] = p.z;
    thr[ri] = INFINITY;  // the last entry of the lane's list of the row
  }
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }

  // chunk `it` of the visits into stage `stage`: 128 rows and 128
  // columns x 32 dimensions, 16 bytes a copy, zeros past R and C; with a
  // tile's last chunk, its columns' terms
  auto load = [&](int it, int stage) {
    const int v = it / n_chunks, kc = it - v * n_chunks;
    const int tile = v < n_tiles ? v : v - n_tiles;
    const int d0 = kc * kFDepth;
    float* as = sa + stage * kFRows * kFStride;
    float* bs = sb + stage * kFCols * kFStride;
#pragma unroll
    for (int i = 0; i < kFRows * (kFDepth / 4) / kFThreads; ++i) {
      const int e = threadIdx.x + i * kFThreads;
      const int r = e >> 3, s = e & 7;
      const int q = row0 + r;
      const bool in = q < n_rows;
      cp_async16(as + r * kFStride + 4 * s,
                 in ? ra + (size_t)q * dt + d0 + 4 * s : ra, in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < kFCols * (kFDepth / 4) / kFThreads; ++i) {
      const int e = threadIdx.x + i * kFThreads;
      const int r = e >> 3, s = e & 7;
      const int c = tile * kFCols + r;
      const bool in = c < n_cols;
      cp_async16(bs + r * kFStride + 4 * s,
                 in ? ca + (size_t)c * dt + d0 + 4 * s : ca, in ? 16 : 0);
    }
    if (kc == n_chunks - 1 && threadIdx.x < kFCols) {
      const int c = tile * kFCols + threadIdx.x;
      const bool in = c < n_cols;
      cp_async16(sterm + stage * kFCols + threadIdx.x, in ? cp + c : cp,
                 in ? 16 : 0);
    }
  };

  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < total) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();  // chunk `it` landed; stage (it - 1) % S is free
    if (it + kFStages - 1 < total) {
      load(it + kFStages - 1, (it + kFStages - 1) % kFStages);
    }
    cp_async_commit();
    const int stage = it % kFStages;
    const float* as = sa + stage * kFRows * kFStride;
    const float* bs = sb + stage * kFCols * kFStride;
#pragma unroll
    for (int ks = 0; ks < kFDepth / 8; ++ks) {
      unsigned af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldsm_x4(af[mt], as + (wm * 32 + mt * 16 + (lane & 7) +
                              ((lane >> 3) & 1) * 8) * kFStride +
                            ks * 8 + (lane >> 4) * 4);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bf[4];
        ldsm_x4(bf, bs + (wn * 64 + np * 16 + (lane & 7) +
                          (lane >> 4) * 8) * kFStride +
                        ks * 8 + ((lane >> 3) & 1) * 4);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_tf32(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    const int v = it / n_chunks;
    if (it - v * n_chunks != n_chunks - 1) continue;
    // ---- a finished tile: bound every pair of the lane's fragments. One
    // pass without branches finds the pairs to insert (U below the lane's
    // list and below tau_run: a U at or above tau_run changes neither
    // tau_run nor tau) and to list, and stages them, up to kFEvents a
    // lane, as (value, code 4 (2 nt + j) + ri, + 64 to list); a second
    // pass serves them, one event of every lane at a time. A warp in
    // which a lane found more serves its marks (bit 8 (nt % 4) + 4 j + ri
    // of word nt / 4) pair by pair instead.
    const bool fill = v < n_tiles, list = v >= n_prime;
    const int tile = fill ? v : v - n_tiles;
    const float4* term = sterm + stage * kFCols + wn * 64 + 2 * t;
    const int col0 = tile * kFCols + wn * 64 + 2 * t;
    float gate[4], tau[4];
    bool live[4];
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const float run = fmaxf(tau_s[lrow[ri]], tau_s[kFRows + lrow[ri]]);
      gate[ri] = fminf(thr[ri], run);
      tau[ri] = __fmul_ru(run, ratio);  // L's units
      live[ri] = list && row0 + lrow[ri] < n_rows;
    }
    unsigned ins[2] = {0u, 0u}, lst[2] = {0u, 0u};  // by nt / 4
    int n_ev = 0;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 pc = term[nt * 8 + j];
        const bool valid = pc.w != 0.f && col0 + nt * 8 + j < n_cols;
#pragma unroll
        for (int ri = 0; ri < 4; ++ri) {
          const float s = acc[ri >> 1][nt][2 * (ri & 1) + j];
          const float u = __fmaf_ru(
              qr[ri], pc.z, __fmaf_ru(-2.f, s, __fadd_ru(nhi[ri], pc.x)));
          const float lo = __fmaf_rd(
              -qr[ri], pc.z, __fmaf_rd(-2.f, s, __fadd_rd(nlo[ri], pc.y)));
          const unsigned bit = 1u << (8 * (nt & 3) + 4 * j + ri);
          const bool ie = fill && valid && u >= 0.f && u < gate[ri];
          const bool le = live[ri] && valid && !(lo > tau[ri]);
          ins[nt >> 2] |= ie ? bit : 0u;
          lst[nt >> 2] |= le ? bit : 0u;
          const int code = 4 * (2 * nt + j) + ri;
          if (ie && n_ev < kFEvents) {
            ev_v[n_ev * kFThreads] = u;
            ev_c[n_ev * kFThreads] = code;
          }
          n_ev += ie;
          if (le && n_ev < kFEvents) {
            ev_v[n_ev * kFThreads] = lo;
            ev_c[n_ev * kFThreads] = code + 64;
          }
          n_ev += le;
        }
      }
    }
    // the two events: x into the lane's sorted list of local row lr (if
    // below its last entry), and column c with its L into lr's candidates
    auto insert = [&](int lr, float x) {
      float* l = mine + lr * (KL + 1);
      if (!(x < l[KL - 1])) return;
      float a[KL];
#pragma unroll
      for (int i = 0; i < KL; ++i) a[i] = l[i];
#pragma unroll
      for (int i = 0; i < KL; ++i) {
        const float y = fmaxf(a[i], x);
        a[i] = fminf(a[i], x);
        x = y;
      }
#pragma unroll
      for (int i = 0; i < KL; ++i) l[i] = a[i];
    };
    auto list_one = [&](int lr, int c, float x) {
      const int at = atomicAdd(&count[lr], 1);
      if (at < m) {
        const size_t o = (size_t)(row0 + lr) * m + at;
        cand_b[o] = c;
        cand_lb[o] = x;
      }
    };
    const int most = __reduce_max_sync(kFull, n_ev);
    if (most <= kFEvents) {
      for (int e = 0; e < most; ++e) {
        if (e < n_ev) {
          const int code = ev_c[e * kFThreads];
          const float x = ev_v[e * kFThreads];
          const int ri = code & 3, pos = (code >> 2) & 15;
          const int lr = wm * 32 + (ri >> 1) * 16 + (ri & 1) * 8 + g;
          if (code & 64) {
            list_one(lr, col0 + (pos >> 1) * 8 + (pos & 1), x);
          } else {
            insert(lr, x);
          }
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int ri = 0; ri < 4; ++ri) {
            const unsigned bit = 1u << (8 * (nt & 3) + 4 * j + ri);
            const float s = acc[ri >> 1][nt][2 * (ri & 1) + j];
            const float4 pc = term[nt * 8 + j];
            if (ins[nt >> 2] & bit) {
              insert(lrow[ri], __fmaf_ru(qr[ri], pc.z,
                                         __fmaf_ru(-2.f, s, __fadd_ru(
                                             nhi[ri], pc.x))));
            }
            if (lst[nt >> 2] & bit) {
              list_one(lrow[ri], col0 + nt * 8 + j,
                       __fmaf_rd(-qr[ri], pc.z,
                                 __fmaf_rd(-2.f, s,
                                           __fadd_rd(nlo[ri], pc.y))));
            }
          }
        }
      }
    }
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      thr[ri] = mine[lrow[ri] * (KL + 1) + KL - 1];
    }
    if (fill) {
      // tau_run for the next visits: a lane's kRun + 1 smallest over its 8
      // lanes are 8 (kRun + 1) >= K distinct columns
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        float run = mine[lrow[ri] * (KL + 1) + kRun];
        run = fmaxf(run, __shfl_xor_sync(kFull, run, 1));
        run = fmaxf(run, __shfl_xor_sync(kFull, run, 2));
        if (t == 0) tau_s[wn * kFRows + lrow[ri]] = run;
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // tau of a row: the K-th smallest of its 8 lists' 8 KL entries (+inf
  // unless K of them are finite), >= its K-th smallest U
  if (threadIdx.x < kFRows && row0 + threadIdx.x < n_rows) {
    const float* l = lists + threadIdx.x * (KL + 1);
    auto entry = [&](int i) {
      return l[(i / KL) * list_stride<K>() + i % KL];
    };
    float tau = INFINITY;
    for (int i = 0; i < kFGroups * KL; ++i) {
      const float x = entry(i);
      int at_most = 0;
      for (int j2 = 0; j2 < kFGroups * KL; ++j2) at_most += entry(j2) <= x;
      if (at_most >= K && x < tau) tau = x;
    }
    const size_t at = (size_t)b * n_rows + row0 + threadIdx.x;
    tau_out[at] = __fmul_ru(tau, ratio);  // in L's units
    counts[at] = count[threadIdx.x];
  }
}

// ---- the rescore

constexpr int kRWarps = 4;     // rows a block, one a warp
constexpr int kRChunk = 32;    // dimensions of a round staged at once
constexpr int kRRound = 64;    // survivors a round, two a lane
constexpr int kRStride = kRChunk + 4;
constexpr int kMaxList = 512;  // the largest candidate list (m) it takes
constexpr int kRSmemBytes =
    kRWarps * (256 * 8 + (kRRound * kRStride + kRChunk + kMaxList) * 4);

// rows_x (B, R, dp), cols_x (B, C, dp) exact copies; cand / cand_l /
// counts / tau from the filter. Rows with count <= m: the exact top-K of
// their survivors, the candidates with !(L > tau). A warp compacts them
// into shared memory, then takes 64 a round, two a lane: it stages their
// next 32 dimensions, each load four survivors' 128 contiguous bytes, and
// each lane sums its two survivors' dimensions in order.
template <int K>
__global__ void __launch_bounds__(kRWarps * 32)
knn_dim_rescore_kernel(const float* __restrict__ rows_x,
                       const float* __restrict__ cols_x,
                       const int* __restrict__ cand,
                       const float* __restrict__ cand_l,
                       const int* __restrict__ counts,
                       const float* __restrict__ tau_in,
                       float* __restrict__ out_d, int* __restrict__ out_i,
                       int n_rows, int n_cols, int dp, int m, int n_all) {
  static_assert(Select<K, false>::kQueueKeys == 256, "queue size");
  extern __shared__ __align__(16) float rsmem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Key* queue = reinterpret_cast<Key*>(rsmem) + warp * 256;
  float* tcol = rsmem + kRWarps * 512 + warp * kRRound * kRStride;
  float4* srow = reinterpret_cast<float4*>(
      rsmem + kRWarps * (512 + kRRound * kRStride) + warp * kRChunk);
  int* kept = reinterpret_cast<int*>(
      rsmem + kRWarps * (512 + kRRound * kRStride + kRChunk)) +
      warp * kMaxList;
  const int row = blockIdx.x * kRWarps + warp;  // of B * R
  if (row >= n_all) return;                     // uniform over the warp
  const int cnt = counts[row];
  if (cnt > m) return;  // an exhaustive row
  const int b = row / n_rows;
  const int nq = dp >> 2;
  const float4* r4 = reinterpret_cast<const float4*>(rows_x) + (size_t)row * nq;
  const float4* cb =
      reinterpret_cast<const float4*>(cols_x) + (size_t)b * n_cols * nq;
  const int* cl = cand + (size_t)row * m;
  const float* ll = cand_l + (size_t)row * m;
  const float tau = tau_in[row];
  int n = 0;
  for (int base = 0; base < cnt; base += 32) {
    const int j = base + lane;
    const bool keep = j < cnt && !(ll[j] > tau);
    const unsigned vote = __ballot_sync(kFull, keep);
    if (keep) kept[n + __popc(vote & ((1u << lane) - 1u))] = cl[j];
    n += __popc(vote);
  }
  __syncwarp();
  const int sub = lane >> 3, q = lane & 7;
  Select<K, false> sel;
  sel.init(queue);
  for (int base = 0; base < n; base += kRRound) {
    const int c0 = base + lane < n ? kept[base + lane] : -1;
    const int c1 = base + 32 + lane < n ? kept[base + 32 + lane] : -1;
    float a0 = 0.f, a1 = 0.f;
    for (int q0 = 0; q0 < nq; q0 += kRChunk / 4) {
      const int n4 = min(kRChunk / 4, nq - q0);  // float4s this chunk
      __syncwarp();  // the chunk before has been read
      if (lane < n4) srow[lane] = r4[q0 + lane];
#pragma unroll 4
      for (int i = 0; i < kRRound / 4; ++i) {
        const int slot = 4 * i + sub;  // i < 8: the c0s, else the c1s
        const int c = __shfl_sync(kFull, i < kRRound / 8 ? c0 : c1, slot & 31);
        if (c >= 0 && q < n4) {
          reinterpret_cast<float4*>(tcol + slot * kRStride)[q] =
              cb[(size_t)c * nq + q0 + q];
        }
      }
      __syncwarp();
      const float4* m0 =
          reinterpret_cast<const float4*>(tcol + lane * kRStride);
      const float4* m1 =
          reinterpret_cast<const float4*>(tcol + (32 + lane) * kRStride);
      for (int j = 0; j < n4; ++j) {
        a0 = add_sq4(a0, srow[j], m0[j]);
        a1 = add_sq4(a1, srow[j], m1[j]);
      }
    }
    float d2[2] = {c0 >= 0 ? a0 : NAN, c1 >= 0 ? a1 : NAN};
    int idx[2] = {max(c0, 0), max(c1, 0)};
    sel.add_indexed(d2, idx);
  }
  sel.finish();
  float* od = out_d + (size_t)row * K;
  int* oi = out_i + (size_t)row * K;
#pragma unroll
  for (int s = 0; s < Select<K, false>::kL; ++s) {
    const int e = s * 32 + lane;
    if (e < K) {
      od[e] = key_d2(sel.lk[s]);
      oi[e] = key_index(sel.lk[s]);
    }
  }
}

// ---- launches

template <int K, bool Above>
int launch_exhaustive(const float* rows, const float* cols,
                      const unsigned char* mask, const float* prev_d,
                      const int* prev_i, const int* counts, int m,
                      float* out_d, int* out_i, int b, int n_rows,
                      int n_cols, int dim, cudaStream_t stream) {
  dim3 grid((n_rows + kBlockRows - 1) / kBlockRows, b);
  knn_dim_kernel<K, Above><<<grid, kThreads, 0, stream>>>(
      rows, cols, mask, prev_d, prev_i, counts, m, out_d, out_i, n_rows,
      n_cols, dim);
  return (int)cudaGetLastError();
}

template <int K>
int exhaustive_k(const float* rows, const float* cols,
                 const unsigned char* mask, const int* counts, int m,
                 float* out_d, int* out_i, int b, int n_rows, int n_cols,
                 int dim, cudaStream_t stream) {
  return launch_exhaustive<K, false>(rows, cols, mask, nullptr, nullptr,
                                     counts, m, out_d, out_i, b, n_rows,
                                     n_cols, dim, stream);
}

int exhaustive(int k, const float* rows, const float* cols,
               const unsigned char* mask, const int* counts, int m,
               float* out_d, int* out_i, int b, int n_rows, int n_cols,
               int dim, cudaStream_t s) {
  switch (k) {
    case 2:
      return exhaustive_k<2>(rows, cols, mask, counts, m, out_d, out_i, b,
                             n_rows, n_cols, dim, s);
    case 8:
      return exhaustive_k<8>(rows, cols, mask, counts, m, out_d, out_i, b,
                             n_rows, n_cols, dim, s);
    case 16:
      return exhaustive_k<16>(rows, cols, mask, counts, m, out_d, out_i,
                              b, n_rows, n_cols, dim, s);
    case 32:
      return exhaustive_k<32>(rows, cols, mask, counts, m, out_d, out_i,
                              b, n_rows, n_cols, dim, s);
    case 64:
      return exhaustive_k<64>(rows, cols, mask, counts, m, out_d, out_i,
                              b, n_rows, n_cols, dim, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int K>
int launch_filter(const float* rows_t, const float* cols_t,
                  const float4* rows_p, const float4* cols_p, int* cand,
                  float* cand_l, int* counts, float* tau, int b, int n_rows,
                  int n_cols, int dim, int dt, int m, cudaStream_t stream) {
  constexpr int bytes = filter_smem_bytes<K>();
  static bool sized = false;  // the > 48 KB shared memory, once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_dim_filter_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  dim3 grid((n_rows + kFRows - 1) / kFRows, b);
  knn_dim_filter_kernel<K><<<grid, kFThreads, bytes, stream>>>(
      rows_t, cols_t, rows_p, cols_p, cand, cand_l, counts, tau, n_rows,
      n_cols, dim, dt, m);
  return (int)cudaGetLastError();
}

template <int K>
int launch_rescore(const float* rows_x, const float* cols_x, const int* cand,
                   const float* cand_l, const int* counts, const float* tau,
                   float* out_d, int* out_i, int b, int n_rows, int n_cols,
                   int dp, int m, cudaStream_t stream) {
  static bool sized = false;  // the > 48 KB shared memory, once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_dim_rescore_kernel<K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kRSmemBytes);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int n_all = b * n_rows;
  knn_dim_rescore_kernel<K>
      <<<(n_all + kRWarps - 1) / kRWarps, kRWarps * 32, kRSmemBytes,
         stream>>>(
          rows_x, cols_x, cand, cand_l, counts, tau, out_d, out_i, n_rows,
          n_cols, dp, m, n_all);
  return (int)cudaGetLastError();
}

int prep(const float* pts, const unsigned char* mask, float* exact,
         float* tf32, float4* terms, int n_pts, int dim, int dp, int dt,
         int is_rows, cudaStream_t stream) {
  if (n_pts == 0) return 0;
  knn_dim_prep_kernel<<<(n_pts + kPrepWarps - 1) / kPrepWarps,
                        kPrepWarps * 32, 0, stream>>>(
      pts, mask, exact, tf32, terms, n_pts, dim, dp, dt, is_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The exhaustive scan over every row. rows (B, R, D) f32, cols (B, C, D)
// f32, col_mask (B, C) bool, out_d (B, R, k) f32, out_i (B, R, k) i32,
// all contiguous. k must be 2, 8, 16, 32 or 64. With prev_d / prev_i
// (B, R, 64) non-null (a pass past the first, k = 64): the 64 nearest
// keys above each row's key in slot 63 of prev. Returns the cudaError_t
// of the launch.
int ptw_knn_topk_dim(const void* rows, const void* cols,
                     const void* col_mask, const void* prev_d,
                     const void* prev_i, void* out_d, void* out_i, int b,
                     int n_rows, int n_cols, int dim, int k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const float*>(rows);
  auto c = static_cast<const float*>(cols);
  auto msk = static_cast<const unsigned char*>(col_mask);
  auto d = static_cast<float*>(out_d);
  auto i = static_cast<int*>(out_i);
  if (b > 65535 || dim < 1) return (int)cudaErrorInvalidValue;
  if (prev_d != nullptr) {
    if (k != 64 || prev_i == nullptr) return (int)cudaErrorInvalidValue;
    return launch_exhaustive<64, true>(
        r, c, msk, static_cast<const float*>(prev_d),
        static_cast<const int*>(prev_i), nullptr, 0, d, i, b, n_rows, n_cols,
        dim, s);
  }
  return exhaustive(k, r, c, msk, nullptr, 0, d, i, b, n_rows, n_cols, dim,
                    s);
}

// Prep and filter: rows (B, R, D), cols (B, C, D) f32 and col_mask (B, C)
// bool in; scratch out: rows_x (B, R, dp) and cols_x (B, C, dp) exact
// copies, rows_t (B, R, dt) and cols_t (B, C, dt) TF32 copies (zero past
// D), rows_p (B, R, 4) and cols_p (B, C, 4) f32 terms, cand (B, R, m) i32
// and cand_l (B, R, m) f32 (candidates and their L), counts (B, R) i32
// and tau (B, R) f32. dp is D rounded up to a multiple of 8, dt to a
// multiple of 32; k (2, 8, 16, 32 or 64) is the threshold's K.
int ptw_knn_dim_filter(const void* rows, const void* cols,
                       const void* col_mask, void* rows_x, void* rows_t,
                       void* rows_p, void* cols_x, void* cols_t, void* cols_p,
                       void* cand, void* cand_l, void* counts, void* tau,
                       int b, int n_rows, int n_cols, int dim, int dp, int dt,
                       int k, int m, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (b > 65535 || dim < 1 || dp < dim || dp % 8 || dt < dp ||
      dt % kFDepth || m < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int e = prep(static_cast<const float*>(rows), nullptr,
               static_cast<float*>(rows_x), static_cast<float*>(rows_t),
               static_cast<float4*>(rows_p), b * n_rows, dim, dp, dt, 1, s);
  if (e) return e;
  e = prep(static_cast<const float*>(cols),
           static_cast<const unsigned char*>(col_mask),
           static_cast<float*>(cols_x), static_cast<float*>(cols_t),
           static_cast<float4*>(cols_p), b * n_cols, dim, dp, dt, 0, s);
  if (e) return e;
  auto rt = static_cast<const float*>(rows_t);
  auto ct = static_cast<const float*>(cols_t);
  auto rp = static_cast<const float4*>(rows_p);
  auto cpp = static_cast<const float4*>(cols_p);
  auto cd = static_cast<int*>(cand);
  auto cl = static_cast<float*>(cand_l);
  auto cn = static_cast<int*>(counts);
  auto ta = static_cast<float*>(tau);
  switch (k) {
    case 2:
      return launch_filter<2>(rt, ct, rp, cpp, cd, cl, cn, ta, b, n_rows,
                              n_cols, dim, dt, m, s);
    case 8:
      return launch_filter<8>(rt, ct, rp, cpp, cd, cl, cn, ta, b, n_rows,
                              n_cols, dim, dt, m, s);
    case 16:
      return launch_filter<16>(rt, ct, rp, cpp, cd, cl, cn, ta, b, n_rows,
                               n_cols, dim, dt, m, s);
    case 32:
      return launch_filter<32>(rt, ct, rp, cpp, cd, cl, cn, ta, b, n_rows,
                               n_cols, dim, dt, m, s);
    case 64:
      return launch_filter<64>(rt, ct, rp, cpp, cd, cl, cn, ta, b, n_rows,
                               n_cols, dim, dt, m, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Rescore: the exact top-k (2, 8, 16, 32 or 64) of each row's survivors
// (rows with count <= m, at most 512; the others are left to
// ptw_knn_dim_exhaustive) into out_d / out_i (B, R, k), from the
// filter's scratch.
int ptw_knn_dim_rescore(const void* rows_x, const void* cols_x,
                        const void* cand, const void* cand_l,
                        const void* counts, const void* tau, void* out_d,
                        void* out_i, int b, int n_rows, int n_cols, int dp,
                        int k, int m, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto rx = static_cast<const float*>(rows_x);
  auto cx = static_cast<const float*>(cols_x);
  auto cd = static_cast<const int*>(cand);
  auto cl = static_cast<const float*>(cand_l);
  auto cn = static_cast<const int*>(counts);
  auto ta = static_cast<const float*>(tau);
  auto d = static_cast<float*>(out_d);
  auto i = static_cast<int*>(out_i);
  if (dp % 8 || m < 1 || m > kMaxList) return (int)cudaErrorInvalidValue;
  if (b * n_rows == 0) return 0;
  switch (k) {
    case 2:
      return launch_rescore<2>(rx, cx, cd, cl, cn, ta, d, i, b, n_rows,
                               n_cols, dp, m, s);
    case 8:
      return launch_rescore<8>(rx, cx, cd, cl, cn, ta, d, i, b, n_rows,
                               n_cols, dp, m, s);
    case 16:
      return launch_rescore<16>(rx, cx, cd, cl, cn, ta, d, i, b, n_rows,
                                n_cols, dp, m, s);
    case 32:
      return launch_rescore<32>(rx, cx, cd, cl, cn, ta, d, i, b, n_rows,
                                n_cols, dp, m, s);
    case 64:
      return launch_rescore<64>(rx, cx, cd, cl, cn, ta, d, i, b, n_rows,
                                n_cols, dp, m, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The exhaustive scan of the rows whose count exceeds m (the inputs of
// ptw_knn_topk_dim, counts (B, R) i32 from the filter): launched over
// every row block, a block without such a row exits at once.
int ptw_knn_dim_exhaustive(const void* rows, const void* cols,
                           const void* col_mask, const void* counts,
                           void* out_d, void* out_i, int b, int n_rows,
                           int n_cols, int dim, int k, int m, void* stream) {
  if (b > 65535 || dim < 1 || counts == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return exhaustive(k, static_cast<const float*>(rows),
                    static_cast<const float*>(cols),
                    static_cast<const unsigned char*>(col_mask),
                    static_cast<const int*>(counts), m,
                    static_cast<float*>(out_d), static_cast<int*>(out_i), b,
                    n_rows, n_cols, dim, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
