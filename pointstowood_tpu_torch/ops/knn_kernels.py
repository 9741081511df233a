"""k-nearest selection kernels (port of pointstowood_tpu/ops/pallas_knn.py).

Three wrappers, each beside its plain PyTorch version:

* ``knn_topk`` (CUDA ``ptw_knn_topk``, csrc/knn.cu) replaces the Pallas
  ``group_min_topk`` and the forward half of ``group_min_topk_t``;
* ``knn_top2`` (CUDA ``ptw_knn_top2_split``) replaces the Pallas ``top2``
  and the transpose half of ``group_min_topk_t``;
* ``group_min`` (CUDA ``ptw_group_min``, csrc/group_min.cu) replaces the
  Pallas ``group_min``: the first stage of the two-stage fast kNN.

The selections return the exact top-k by squared distance, ascending, ties
to the lower column index, with the TRUE d2 (+inf for masked columns and
unfilled slots; idx 0 there; a NaN distance is never selected).
``knn_topk`` runs the warp selection of csrc/select.cuh, shared with
``pair_select``, at K = 2/8/16/32/64, and a k past 64 in passes of
K = 64, each above the last key of the pass before (``topk_plan``,
``select_plain_above``); ``knn_top2``
splits each row's columns over the lanes of a group, as many as the host
picks (``top2_lanes``). Both equal ``select_plain`` bit for bit. A wrapper
runs the plain version only when
its inputs lie on the CPU; on a CUDA tensor it launches the kernel or
raises. Each wrapper counts its kernel launches in its ``launches``
attribute.

The shape gates of the JAX package (``supported``, ``topk_supported``,
``transpose_supported``, ``top2_supported``) are copied as plain Python,
and ``fast_route`` applies them as the JAX fast kNN does, so both packages
take the same route at every shape.
"""

from __future__ import annotations

import math

import torch

from pointstowood_tpu_torch.ops import build

# --- shape gates, copied from pallas_knn.py -------------------------------

QUERY_BLOCK = 128
_HALVES = 2
G_MAX = 8
N_BLOCK_MAX = 16384
_SLICE_BITS = 3
_TQ_BITS = 13
TOP2_GROUPS = 256
TOP2_QUERY_BLOCK = 256
_SLOT2_BITS = 6


def supported(n: int, k: int) -> int:
    """Largest valid group count for n sources (0 = kernel not usable)."""
    g = G_MAX
    while g > 1 and (n % (g * 128) or (n // g) < k):
        g //= 2
    if g <= 1 or n < 2048 or g % _HALVES:
        return 0
    return g


def _topk_fold(npg: int) -> int:
    """Second-fold column width for npg first-fold groups (0 = none)."""
    for fold in (256, 128):
        if npg % fold == 0 and npg // fold <= (1 << _SLICE_BITS):
            return fold
    return 0


def topk_supported(n: int, k: int) -> int:
    """Group count for the JAX fused top-k kernel (0 = not usable)."""
    g = supported(n, k)
    if not g or n > N_BLOCK_MAX:
        return 0
    fold = _topk_fold(n // g)
    if not fold or k > 2 * fold:
        return 0
    return g


def transpose_supported(q_n: int, n: int, k: int) -> int:
    """Group count for the JAX transpose top-k kernel (0 = not usable)."""
    g = topk_supported(n, k)
    if not g:
        return 0
    if q_n + (-q_n) % QUERY_BLOCK > (1 << _TQ_BITS):
        return 0
    return g


def top2_supported(n: int) -> bool:
    """Shape constraints of the JAX folded top-2 kernel."""
    return (
        n >= 2 * TOP2_GROUPS
        and n % (2 * TOP2_GROUPS) == 0
        and n // TOP2_GROUPS <= (1 << _SLOT2_BITS)
    )


def fast_route(n: int, k: int) -> str:
    """The JAX fast kNN's route for n sources and k neighbours
    (pointstowood_tpu/ops/knn.py ``_fast_knn``): "top2" (the folded top-2
    kernel), "topk" (the in-kernel top-k), "two_stage" (``group_min``, a
    top-k over the group minima, ``member_index``) or "approx" (XLA's
    ``_approx_knn``, where no kernel's shape gate admits n)."""
    if k == 2 and top2_supported(n):
        return "top2"
    if topk_supported(n, k):
        return "topk"
    if supported(n, k):
        return "two_stage"
    return "approx"


def n_block(n: int) -> int:
    """Sources per block of the block-local grouping (pallas_knn.py
    ``_n_block``): the largest of 16384/8192/4096/2048 dividing n, else
    n."""
    for b in (N_BLOCK_MAX, 8192, 4096, 2048):
        if n % b == 0 and b <= n:
            return b
    return n


def member_index(gidx: torch.Tensor, slot: torch.Tensor, n: int,
                 g: int) -> torch.Tensor:
    """Source column of (global group index, member slot) under the
    block-local grouping (pallas_knn.py ``member_index``): block
    gidx // (n_block/g), column block * n_block + slot * n_block/g +
    gidx % (n_block/g). Returns int64."""
    nb = n_block(n)
    npg = nb // g
    gidx, slot = gidx.long(), slot.long()
    return (gidx // npg) * nb + slot * npg + gidx % npg


# --- plain versions ---------------------------------------------------------

_CHUNK_ELEMS = 1 << 23  # distance-matrix elements per plain-version chunk


def pair_d2(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Squared distances rows (B, R, 3) x cols (B, C, 3) -> (B, R, C) in
    the kernels' order: ((dx*dx + dy*dy) + dz*dz), one rounding per op."""
    sq = []
    for a in range(3):
        diff = rows[:, :, None, a] - cols[:, None, :, a]
        sq.append(diff * diff)
    return (sq[0] + sq[1]) + sq[2]


def select_plain(rows: torch.Tensor, cols: torch.Tensor,
                 col_mask: torch.Tensor, k: int):
    """Plain version of both kernels: exact top-k of the masked squared
    distances per row (stable sort: ties to the lower column index).
    Returns (d2 (B, R, k) f32, idx (B, R, k) int32); slots beyond the
    valid columns hold (+inf, 0). A NaN distance counts as +inf, as in the
    kernels, which never select one: a row of NaN distances is all
    (+inf, 0)."""
    return _select(rows, cols, col_mask, k, None)


def select_plain_above(rows: torch.Tensor, cols: torch.Tensor,
                       col_mask: torch.Tensor, k: int,
                       floor_d2: torch.Tensor, floor_idx: torch.Tensor):
    """Plain version of one pass of ``knn_topk`` past k = 64
    (``ptw_knn_topk_above``): per row, the k smallest keys (d2, column)
    strictly above the row's floor key (floor_d2, floor_idx) (B, R), in
    ``select_plain``'s order and with its empty slots. Passes whose floor
    is the key in the last slot of the pass before join into
    ``select_plain``; a floor of (+inf, 0) gives an empty pass."""
    return _select(rows, cols, col_mask, k, (floor_d2, floor_idx))


def _select(rows, cols, col_mask, k, floor):
    b, n_rows, _ = rows.shape
    n_cols = cols.shape[1]
    kk = min(k, n_cols)
    out_d = torch.full((b, n_rows, k), math.inf, device=rows.device)
    out_i = torch.zeros((b, n_rows, k), dtype=torch.int32, device=rows.device)
    step = max(1, _CHUNK_ELEMS // max(1, b * n_cols))
    col_idx = torch.arange(n_cols, device=rows.device)
    for lo in range(0, n_rows, step):
        d = pair_d2(rows[:, lo:lo + step], cols)
        keep = col_mask[:, None, :] & ~torch.isnan(d)
        if floor is not None:
            fd = floor[0][:, lo:lo + step, None]
            fi = floor[1][:, lo:lo + step, None]
            keep &= (d > fd) | ((d == fd) & (col_idx > fi))
        d = torch.where(keep, d, math.inf)
        vals, order = torch.sort(d, dim=-1, stable=True)
        vals, order = vals[..., :kk], order[..., :kk]
        out_d[:, lo:lo + step, :kk] = vals
        out_i[:, lo:lo + step, :kk] = torch.where(
            torch.isfinite(vals), order, 0).to(torch.int32)
    return out_d, out_i


def group_min_plain(rows: torch.Tensor, cols: torch.Tensor,
                    col_mask: torch.Tensor, g: int):
    """Plain version of ``group_min``: per row and group, the smallest
    masked squared distance over the group's g members and the slot that
    holds it (a strict ``<`` scan over the slots: ties and an all-masked
    group keep the lower slot, as the Pallas kernel's ``da < m``).
    Returns (minima (B, R, C/g) f32, +inf for all-masked groups;
    slots (B, R, C/g) uint8)."""
    b, n_rows, _ = rows.shape
    n_cols = cols.shape[1]
    nb = n_block(n_cols)
    npg = nb // g
    out_m = torch.empty((b, n_rows, n_cols // g), device=rows.device)
    out_s = torch.empty((b, n_rows, n_cols // g), dtype=torch.uint8,
                        device=rows.device)
    step = max(1, _CHUNK_ELEMS // max(1, b * n_cols))
    for lo in range(0, n_rows, step):
        d = pair_d2(rows[:, lo:lo + step], cols)
        d = torch.where(col_mask[:, None, :], d, math.inf)
        # column bk * nb + a * npg + jj is member a of group bk * npg + jj
        d = d.view(b, d.shape[1], n_cols // nb, g, npg)
        m = d[:, :, :, 0]
        slot = torch.zeros(m.shape, dtype=torch.uint8, device=rows.device)
        for a in range(1, g):
            upd = d[:, :, :, a] < m
            m = torch.where(upd, d[:, :, :, a], m)
            slot.masked_fill_(upd, a)
        out_m[:, lo:lo + step] = m.reshape(b, -1, n_cols // g)
        out_s[:, lo:lo + step] = slot.reshape(b, -1, n_cols // g)
    return out_m, out_s


# --- kernel wrappers --------------------------------------------------------

_TOPK_INSTANCES = (2, 8, 16, 32, 64)


def topk_plan(k: int) -> tuple[int, int]:
    """(K, passes) of the ``knn_topk`` launches that serve k >= 1: one
    launch of the smallest instance of ``_TOPK_INSTANCES`` not below k, or,
    past the largest, ceil(k / 64) passes of K = 64 (the first through
    ``ptw_knn_topk``, each later one through ``ptw_knn_topk_above``). The
    wrapper keeps the first k slots."""
    if k < 1:
        raise ValueError(f"knn_topk: k={k} < 1")
    for inst in _TOPK_INSTANCES:
        if inst >= k:
            return inst, 1
    top = _TOPK_INSTANCES[-1]
    return top, -(-k // top)


def topk_instance(k: int) -> int:
    """K of the ``ptw_knn_topk`` instance that serves k (of every pass,
    past 64)."""
    return topk_plan(k)[0]


TOP2_LANES = (2, 4, 8, 16, 32)  # the lane counts it is built for
# about one wave of 32 resident warps on each of the H100's 132 SMs
_TOP2_MIN_WARPS = 4096


def top2_lanes(b: int, n_rows: int) -> int:
    """The host's choice of lanes a row group for ``knn_top2``: the fewest
    that give the launch 4096 warps, about one wave of 32 resident warps an
    SM (32 where none does). Each lane more halves a lane's columns but
    makes every block read all columns for fewer rows, and adds merges: on
    the H100 the fastest lane count at each canonical shape gave about
    4096 warps (``chip_smoke.py`` phase ``top2_lanes`` times every one)."""
    rows_a_thread = 2  # csrc/knn.cu kTop2Rows
    for lanes in TOP2_LANES:
        if b * n_rows * lanes // (rows_a_thread * 32) >= _TOP2_MIN_WARPS:
            return lanes
    return TOP2_LANES[-1]


def _check_inputs(rows, cols, col_mask, name):
    if rows.dim() != 3 or rows.shape[-1] != 3 or cols.dim() != 3 \
            or cols.shape[-1] != 3 or rows.shape[0] != cols.shape[0] \
            or tuple(col_mask.shape) != tuple(cols.shape[:2]):
        raise ValueError(f"{name}: bad shapes rows {tuple(rows.shape)} "
                         f"cols {tuple(cols.shape)} mask "
                         f"{tuple(col_mask.shape)}")
    if rows.dtype != torch.float32 or cols.dtype != torch.float32 \
            or col_mask.dtype != torch.bool:
        raise TypeError(f"{name}: expects f32 points and a bool mask")
    if not (rows.device == cols.device == col_mask.device):
        raise ValueError(f"{name}: inputs on different devices")


def _launch_select(owner, fn, rows, cols, col_mask, k_out, extra=()):
    name = owner.__name__
    if rows.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {rows.device}")
    rows, cols, col_mask = (t.contiguous() for t in (rows, cols, col_mask))
    b, n_rows, n_cols = rows.shape[0], rows.shape[1], cols.shape[1]
    out_d = torch.empty((b, n_rows, k_out), dtype=torch.float32,
                        device=rows.device)
    out_i = torch.empty((b, n_rows, k_out), dtype=torch.int32,
                        device=rows.device)
    if b and n_rows:
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        args = [rows.data_ptr(), cols.data_ptr(), col_mask.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(), b, n_rows, n_cols,
                *extra]
        build.check(fn(*args, stream), name)
        owner.launches += 1
    return out_d, out_i


def knn_topk(rows: torch.Tensor, cols: torch.Tensor,
             col_mask: torch.Tensor, k: int):
    """Exact top-k nearest valid columns per row: rows (B, R, 3) f32,
    cols (B, C, 3) f32, col_mask (B, C) bool -> (d2 (B, R, k) f32,
    idx (B, R, k) int32). CUDA: the launches of ``topk_plan(k)``: for
    k <= 64 one ``ptw_knn_topk`` kernel, else passes of K = 64, each
    written into its slice of one (B, R, 64 * passes) output (the first k
    slots kept); ``launches`` counts every pass."""
    _check_inputs(rows, cols, col_mask, "knn_topk")
    if rows.device.type == "cpu":
        return select_plain(rows, cols, col_mask, k)
    inst, passes = topk_plan(k)
    lib = build.library("knn")
    if passes == 1:
        d, i = _launch_select(knn_topk, lib.ptw_knn_topk, rows, cols,
                              col_mask, inst, (inst,))
        if inst != k:
            d, i = d[..., :k].contiguous(), i[..., :k].contiguous()
        return d, i
    # pass r writes slice r of a (passes, B, R, 64) output, above the last
    # slot of slice r - 1
    rows, cols, col_mask = (t.contiguous() for t in (rows, cols, col_mask))
    b, n_rows, n_cols = rows.shape[0], rows.shape[1], cols.shape[1]
    out_d = torch.empty((passes, b, n_rows, inst), dtype=torch.float32,
                        device=rows.device)
    out_i = torch.empty((passes, b, n_rows, inst), dtype=torch.int32,
                        device=rows.device)
    if b and n_rows:
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        ins = (rows.data_ptr(), cols.data_ptr(), col_mask.data_ptr())
        build.check(lib.ptw_knn_topk(
            *ins, out_d[0].data_ptr(), out_i[0].data_ptr(), b, n_rows,
            n_cols, inst, stream), "knn_topk")
        knn_topk.launches += 1
        for r in range(1, passes):
            build.check(lib.ptw_knn_topk_above(
                *ins, out_d[r - 1].data_ptr(), out_i[r - 1].data_ptr(),
                out_d[r].data_ptr(), out_i[r].data_ptr(), b, n_rows, n_cols,
                stream), "knn_topk")
            knn_topk.launches += 1
    return (out_d.permute(1, 2, 0, 3).reshape(b, n_rows, -1)[..., :k]
            .contiguous(),
            out_i.permute(1, 2, 0, 3).reshape(b, n_rows, -1)[..., :k]
            .contiguous())


knn_topk.launches = 0


def knn_top2(rows: torch.Tensor, cols: torch.Tensor,
             col_mask: torch.Tensor, lanes: int | None = None):
    """Exact top-2 nearest valid columns per row (same contract as
    ``knn_topk`` with k = 2). CUDA: the ``ptw_knn_top2_split`` kernel with
    ``lanes`` lanes a row group (default ``top2_lanes`` of the shape)."""
    _check_inputs(rows, cols, col_mask, "knn_top2")
    if rows.device.type == "cpu":
        return select_plain(rows, cols, col_mask, 2)
    lanes = lanes or top2_lanes(rows.shape[0], rows.shape[1])
    lib = build.library("knn")
    return _launch_select(knn_top2, lib.ptw_knn_top2_split, rows, cols,
                          col_mask, 2, (lanes,))


knn_top2.launches = 0

_GROUP_SIZES = (2, 4, 8)


def group_min(rows: torch.Tensor, cols: torch.Tensor,
              col_mask: torch.Tensor, g: int):
    """Grouped minima of the two-stage fast kNN: rows (B, R, 3) f32, cols
    (B, C, 3) f32, col_mask (B, C) bool, g in {2, 4, 8} with C a multiple
    of g * 128 -> (minima (B, R, C/g) f32, slots (B, R, C/g) uint8).
    Group j of block bk = j // (n_block/g) holds the columns
    bk * n_block + a * n_block/g + j % (n_block/g) for slots a < g
    (``n_block(C)``, the JAX block-local grouping); ``member_index`` maps
    (j, slot) back to the column. The minimum is the true squared distance
    in the difference form, +inf where every member is masked. CUDA: the
    ``ptw_group_min`` kernel."""
    _check_inputs(rows, cols, col_mask, "group_min")
    n_cols = cols.shape[1]
    if g not in _GROUP_SIZES or n_cols % (g * 128):
        raise ValueError(f"group_min: g={g} does not tile {n_cols} columns "
                         f"(g in {_GROUP_SIZES}, columns a multiple of "
                         "g * 128)")
    if rows.device.type == "cpu":
        return group_min_plain(rows, cols, col_mask, g)
    if rows.device.type != "cuda":
        raise RuntimeError(f"group_min: no kernel for device {rows.device}")
    lib = build.library("group_min")
    rows, cols, col_mask = (t.contiguous() for t in (rows, cols, col_mask))
    b, n_rows = rows.shape[0], rows.shape[1]
    out_m = torch.empty((b, n_rows, n_cols // g), dtype=torch.float32,
                        device=rows.device)
    out_s = torch.empty((b, n_rows, n_cols // g), dtype=torch.uint8,
                        device=rows.device)
    if b and n_rows:
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        build.check(lib.ptw_group_min(
            rows.data_ptr(), cols.data_ptr(), col_mask.data_ptr(),
            out_m.data_ptr(), out_s.data_ptr(), b, n_rows, n_cols, g,
            n_block(n_cols), stream), "group_min")
        group_min.launches += 1
    return out_m, out_s


group_min.launches = 0
