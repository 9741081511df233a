// Exact warp-cooperative k-selection, shared by knn.cu (ptw_knn_topk) and
// fusion.cu (ptw_pair_select). sm_90a.
//
// What it selects: the K smallest keys (d2, index) offered to it,
// compared lexicographically, so equal distances go to the lower index.
// A key is one 64-bit word, the bits of d2 over the index: d2 >= +0, so
// its bits order as its values do, and one unsigned compare orders the
// pair. A key enters only if it is below the K-th key: a NaN d2 (bits
// above +inf's) never enters, and neither does +inf (the empty slot is
// (+inf, 0), which no +inf key is below). Slots left empty come out as
// (+inf, 0).
//
// The distance is the difference form ((dx*dx + dy*dy) + dz*dz) with the
// *_rn intrinsics, so nvcc cannot contract it into FMAs: it equals the
// plain PyTorch version's `pair_d2` (ops/knn_kernels.py) bit for bit, and
// with the same tie rule the kernels select what a stable sort selects.
//
// Design (after the WarpSelect of Johnson, Douze and Jegou, "Billion-scale
// similarity search with GPUs", 2017; no code of theirs):
//  * `select_block`, the scan both kernels run: a block of kWarps warps
//    streams the columns through shared memory in double-buffered tiles
//    of float4 (the next tile's loads are in flight while the warps score
//    the current one); each warp serves kRows queries, its 32 lanes take
//    interleaved columns, and each lane scores its column (held in
//    registers) against all of the warp's queries before the next
//    shared-memory read. A kernel supplies only how a column is fetched
//    and what it writes.
//  * Filter (`WarpSelect::add`): per group of kUnroll rounds (32 columns
//    each), one vote on d2 <= the K-th d2, a warp-uniform register. Past
//    it, each round's keys are tested exactly against the K-th key and
//    pushed, one store each, into the lane's own queue of kQueue slots in
//    shared memory. The serial insertion of the thread-per-query design,
//    which made the whole warp shift a sorted list whenever any of its 32
//    queries admitted a column, is gone.
//  * Merge: once kFlushAt keys are queued across the warp (or some lane's
//    queue could not take another group), and once at the end, the queued
//    keys are compacted to the front of the queue area (one ballot and
//    prefix popcount per slot) and taken back 32 at a time: each chunk is
//    sorted by a bitonic sort over __shfl_xor_sync and merged into the
//    warp's sorted list (K <= 32: one entry a lane; K = 64: two a lane,
//    entry s * 32 + lane) by the min(A[e], B[n-1-e]) step and a bitonic
//    merge. The K-th key is then one shuffle away. Merges are
//    warp-uniform, and flushing on the warp's total (not on its fullest
//    lane) makes nearly every merge one full chunk.
//
// What bounds it: instruction issue. The scan costs ~11 warp
// instructions per (query, 32 columns): 8 fp32 operations of the
// distance (no FMA, for bit equality), one compare, a share of the
// group's vote and of the shared-memory read. Each admitted key costs ~30
// more in the push path and its share of a merge (a chunk of 32 is ~45
// shuffles, 64-bit keys, issued at a quarter of the ALU rate). About
// K (1 + ln(C / K)) keys pass an up-to-date K-th key over C columns in
// random order; the K-th key here is as old as the last merge, so more
// pass, and the per-key work is of the order of the scan.
//
// A floor (the template flag `Above`; ptw_knn_topk_above): with a floor
// key per query, a key enters only if it is also strictly above the
// floor, so the selection is the K smallest keys above it. Keys are
// unique (the index is in the low word), so passes whose floor is the
// previous pass's K-th key join into the exact top-(passes * K). A floor
// of (+inf, 0), the empty slot, admits nothing. Without the flag the
// floor is compiled out: the instances without it keep their hot path.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ptw_select {

constexpr unsigned kFull = 0xffffffffu;

using Key = unsigned long long;
constexpr Key kEmpty = (Key)0x7f800000u << 32;  // (+inf, 0)

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ Key make_key(float d2, int index) {
  return ((Key)__float_as_uint(d2) << 32) | (unsigned)index;
}
__device__ __forceinline__ float key_d2(Key k) {
  return __uint_as_float((unsigned)(k >> 32));
}
__device__ __forceinline__ int key_index(Key k) { return (int)(unsigned)k; }

// The kernels' squared distance, bit-identical to the plain version.
__device__ __forceinline__ float pair_d2(float qx, float qy, float qz,
                                         const float4& c) {
  const float dx = __fsub_rn(qx, c.x);
  const float dy = __fsub_rn(qy, c.y);
  const float dz = __fsub_rn(qz, c.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Compare-exchange with lane ^ stride: the lower lane of the pair keeps
// the smaller key when `up`, the larger otherwise.
__device__ __forceinline__ void exchange(Key& k, int stride, bool up) {
  const Key o = __shfl_xor_sync(kFull, k, stride);
  const bool lower = (lane_id() & stride) == 0;
  if ((lower == up) == (o < k)) k = o;
}

// Ascending bitonic sort of one key a lane (32 keys).
__device__ __forceinline__ void sort32(Key& k) {
  const int lane = lane_id();
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      exchange(k, stride, (lane & size) == 0);
    }
  }
}

// Queued keys, summed over the warp, that trigger a merge: one chunk of
// 32 less the few a late round adds.
constexpr int kFlushAt = 28;

template <int K, int Q, bool Above = false>
struct WarpSelect {
  static_assert(K == 2 || K == 8 || K == 16 || K == 32 || K == 64,
                "K must be 2, 8, 16, 32 or 64");
  static constexpr int kL = K > 32 ? K / 32 : 1;  // list entries a lane
  static constexpr int kQueueKeys = 32 * Q;  // shared keys of the queues

  Key lk[kL];  // the sorted list: entry s * 32 + lane
  Key kth;     // the K-th key, the same in every lane
  float kd;    // its d2
  int cnt;     // this lane's queued keys
  int total;   // queued keys over the warp
  Key* queue;  // the lanes' queues: slot s of lane l at queue[s * 32 + l]
  Key floor;   // with Above: only keys above it enter (its high word is
               // its d2, which the vote reads)

  __device__ __forceinline__ void init(Key* queue_keys,
                                       Key floor_key = kEmpty) {
#pragma unroll
    for (int s = 0; s < kL; ++s) lk[s] = kEmpty;
    kth = kEmpty;
    kd = INFINITY;
    cnt = 0;
    total = 0;
    queue = queue_keys;
    if constexpr (Above) floor = floor_key;
  }

  // Offer this lane's candidates of U successive rounds: distances d2[u]
  // of columns col + 32 u. Every lane of the warp calls it together. One
  // vote on d2 <= the K-th d2 covers the U rounds; past it, each round's
  // keys are tested exactly, (d2, index) against the K-th key, the
  // survivors queued, and the warp merges once per group if kFlushAt
  // keys are queued or a lane's queue could not take another group.
  template <int U>
  __device__ __forceinline__ void add(const float (&d2)[U], int col) {
    static_assert(U < Q, "a queue must hold a group of rounds");
    bool near = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if constexpr (Above) {
        near |= d2[u] <= kd && d2[u] >= key_d2(floor);
      } else {
        near |= d2[u] <= kd;
      }
    }
    if (!__any_sync(kFull, near)) return;
    const int lane = lane_id();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const Key key = make_key(d2[u], col + 32 * u);
      bool admit = key < kth;
      if constexpr (Above) admit = admit && key > floor;
      total += __popc(__ballot_sync(kFull, admit));
      if (admit) queue[32 * cnt++ + lane] = key;
    }
    if (total >= kFlushAt || __any_sync(kFull, cnt > Q - U)) merge();
  }

  // Merge every lane's queue into the list (warp-uniform call): the
  // queued keys move to the front of the queue area (a ballot and a
  // prefix popcount per slot; a key never moves past an unread one), then
  // go 32 at a time through sort32 and merge_chunk.
  __device__ __forceinline__ void merge() {
    const int lane = lane_id();
    const unsigned below = (1u << lane) - 1u;
    const int slots = __reduce_max_sync(kFull, cnt);
    int off = 0;
    for (int s = 0; s < slots; ++s) {
      const bool has = s < cnt;
      const unsigned m = __ballot_sync(kFull, has);
      const Key k = has ? queue[32 * s + lane] : kEmpty;
      __syncwarp();
      if (has) queue[off + __popc(m & below)] = k;
      off += __popc(m);
    }
    __syncwarp();
    for (int base = 0; base < total; base += 32) {
      Key c = base + lane < total ? queue[base + lane] : kEmpty;
      sort32(c);
      merge_chunk(c);
    }
    __syncwarp();
    cnt = 0;
    total = 0;
    kth = __shfl_sync(kFull, lk[(K - 1) / 32], (K - 1) & 31);
    kd = key_d2(kth);
  }

  // The list keeps the 32 * kL smallest of itself and a sorted chunk of
  // 32: the chunk, reversed, meets the list's last 32 entries; the
  // elementwise minima form a bitonic sequence with the list's first
  // entries, which a bitonic merge sorts.
  __device__ __forceinline__ void merge_chunk(Key c) {
    const Key r = __shfl_xor_sync(kFull, c, 31);
    if (r < lk[kL - 1]) lk[kL - 1] = r;
    if constexpr (kL == 2) {
      if (lk[1] < lk[0]) {
        const Key t = lk[0];
        lk[0] = lk[1];
        lk[1] = t;
      }
    }
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
#pragma unroll
      for (int s = 0; s < kL; ++s) exchange(lk[s], stride, true);
    }
  }

  // Flush the queues; afterwards list entry e (< K) is key e.
  __device__ __forceinline__ void finish() {
    if (total) merge();
  }
};

// ---- The block scan of both kernels

constexpr int kWarps = 8;   // warps a block
constexpr int kRows = 2;    // queries a warp scores each column against
constexpr int kQueue = 8;   // queued keys a lane, per query
constexpr int kUnroll = 2;  // rounds of 32 columns a vote covers
constexpr int kTile = 512;  // columns a shared-memory tile
constexpr int kStaged = kTile / (kWarps * 32);  // columns a thread stages

template <int K, bool Above = false>
using Select = WarpSelect<K, kQueue, Above>;

// One thread's share of a column tile, read from device memory ahead of
// its turn: a column past n as NaN coordinates, whose distance no key
// beats.
struct Stage {
  float x[kStaged], y[kStaged], z[kStaged];

  template <class Fetch>
  __device__ __forceinline__ void fetch(const Fetch& column, int base,
                                        int n) {
#pragma unroll
    for (int i = 0; i < kStaged; ++i) {
      const int c = base + threadIdx.x + i * kWarps * 32;
      const float3 p = c < n ? column(c) : make_float3(NAN, NAN, NAN);
      x[i] = p.x;
      y[i] = p.y;
      z[i] = p.z;
    }
  }

  __device__ __forceinline__ void store(float4* tile) const {
#pragma unroll
    for (int i = 0; i < kStaged; ++i) {
      tile[threadIdx.x + i * kWarps * 32] = make_float4(x[i], y[i], z[i], 0.f);
    }
  }
};

// The K nearest of columns [0, n) for each of this warp's kRows queries:
// queries q0 .. q0 + kRows - 1 of `queries` ((n_live, 3) f32; one past
// n_live admits nothing). column(c) gives column c's coordinates, NaN
// for a column that must never be selected. Every thread of the block
// calls it with the same n (it synchronises the block); a warp without
// live queries only stages tiles. On return, entry s * 32 + lane of
// sel[r].lk is query q0 + r's key s * 32 + lane, (+inf, 0) where there
// is none. With Above, floor_of(q) is query q's floor key (asked only
// for a live query).
struct NoFloor {
  __device__ Key operator()(int) const { return kEmpty; }
};

template <int K, bool Above, class Fetch, class Floor = NoFloor>
__device__ __forceinline__ void select_block(const float* queries, int q0,
                                             int n_live, int n,
                                             const Fetch& column,
                                             Select<K, Above> (&sel)[kRows],
                                             const Floor& floor_of = {}) {
  __shared__ float4 tiles[2][kTile];
  __shared__ Key queues[kWarps][kRows][Select<K, Above>::kQueueKeys];
  const int warp = threadIdx.x >> 5;
  const int lane = lane_id();
  const bool live = q0 < n_live;  // uniform over the warp

  float qx[kRows], qy[kRows], qz[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if constexpr (Above) {
      sel[r].init(queues[warp][r],
                  q0 + r < n_live ? floor_of(q0 + r) : kEmpty);
    } else {
      sel[r].init(queues[warp][r]);
    }
    qx[r] = qy[r] = qz[r] = NAN;
    if (q0 + r < n_live) {
      const float* p = queries + (size_t)(q0 + r) * 3;
      qx[r] = p[0];
      qy[r] = p[1];
      qz[r] = p[2];
    }
  }

  // One barrier a tile separates the scoring of one buffer from the
  // store into the other.
  Stage staged;
  staged.fetch(column, 0, n);
  staged.store(tiles[0]);
  __syncthreads();
  for (int base = 0, buf = 0; base < n; base += kTile, buf ^= 1) {
    const bool more = base + kTile < n;  // uniform over the block
    if (more) staged.fetch(column, base + kTile, n);
    if (live) {
      // every lane runs the same iterations; lane l takes columns
      // j + 32 u + l (NaN past n)
      const int padded = min(kTile, n - base + 32 * kUnroll - 1) &
                         -(32 * kUnroll);
      const float4* tile = tiles[buf];
      for (int j = 0; j < padded; j += 32 * kUnroll) {
        float4 c[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) c[u] = tile[j + 32 * u + lane];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float d2[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            d2[u] = pair_d2(qx[r], qy[r], qz[r], c[u]);
          }
          sel[r].add(d2, base + j + lane);
        }
      }
    }
    if (more) staged.store(tiles[buf ^ 1]);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) sel[r].finish();
}

}  // namespace ptw_select
