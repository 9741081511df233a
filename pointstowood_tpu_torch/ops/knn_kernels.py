"""k-nearest selection kernels (port of pointstowood_tpu/ops/pallas_knn.py).

Four wrappers, each beside its plain PyTorch version:

* ``knn_topk`` (CUDA ``ptw_knn_topk``, csrc/knn.cu) replaces the Pallas
  ``group_min_topk`` and the forward half of ``group_min_topk_t``;
* ``knn_top2`` (CUDA ``ptw_knn_top2_split``) replaces the Pallas ``top2``
  and the transpose half of ``group_min_topk_t``;
* ``group_min`` (CUDA ``ptw_group_min``, csrc/group_min.cu) replaces the
  Pallas ``group_min``: the first stage of the two-stage fast kNN;
* ``knn_topk_dim`` (CUDA ``ptw_knn_dim_filter``, ``ptw_knn_dim_rescore``,
  ``ptw_knn_dim_exhaustive`` and ``ptw_knn_topk_dim``, csrc/knn_dim.cu)
  replaces ``group_min_topk`` and ``group_min`` where the JAX fast kNN
  searches D > 3 dimensions (``ATSearchKNN``'s embedding): the exact
  top-k by the true D-dimensional d2 (``pair_d2_dim``,
  ``select_plain_dim``), through a certified TF32 filter on the tensor
  cores (plain arithmetic: ``filter_plain``) and an exact rescore.

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
# The D-dim plain version makes D passes over each chunk: a chunk that
# stays in a CPU's caches keeps it quick there
_DIM_CHUNK_ELEMS = 1 << 20


def pair_d2(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Squared distances rows (B, R, 3) x cols (B, C, 3) -> (B, R, C) in
    the kernels' order: ((dx*dx + dy*dy) + dz*dz), one rounding per op."""
    sq = []
    for a in range(3):
        diff = rows[:, :, None, a] - cols[:, None, :, a]
        sq.append(diff * diff)
    return (sq[0] + sq[1]) + sq[2]


def pair_d2_dim(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Squared distances rows (B, R, D) x cols (B, C, D) -> (B, R, C) in
    ``knn_topk_dim``'s order: a left-to-right fp32 sum over d of
    (r_d - c_d)^2, one rounding per operation (acc = acc + diff * diff,
    from diff_0 * diff_0). At D = 3 it is ``pair_d2``'s float."""
    diff = rows[:, :, None, 0] - cols[:, None, :, 0]
    acc = diff * diff
    for a in range(1, rows.shape[-1]):
        torch.sub(rows[:, :, None, a], cols[:, None, :, a], out=diff)
        acc += diff.mul_(diff)
    return acc


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


def select_plain_dim(rows: torch.Tensor, cols: torch.Tensor,
                     col_mask: torch.Tensor, k: int):
    """Plain version of ``knn_topk_dim``: ``select_plain``'s contract
    (stable ties to the lower column, a NaN distance as +inf, empty slots
    (+inf, 0)) over rows (B, R, D) and cols (B, C, D) by
    ``pair_d2_dim``."""
    return _select(rows, cols, col_mask, k, None, pair_d2_dim,
                   _DIM_CHUNK_ELEMS)


def select_plain_dim_above(rows: torch.Tensor, cols: torch.Tensor,
                           col_mask: torch.Tensor, k: int,
                           floor_d2: torch.Tensor, floor_idx: torch.Tensor):
    """Plain version of one pass of ``knn_topk_dim`` past k = 64: the k
    smallest ``pair_d2_dim`` keys strictly above each row's floor key, as
    ``select_plain_above``."""
    return _select(rows, cols, col_mask, k, (floor_d2, floor_idx),
                   pair_d2_dim, _DIM_CHUNK_ELEMS)


def _select(rows, cols, col_mask, k, floor, dist=pair_d2,
            chunk_elems=_CHUNK_ELEMS):
    b, n_rows, _ = rows.shape
    n_cols = cols.shape[1]
    kk = min(k, n_cols)
    out_d = torch.full((b, n_rows, k), math.inf, device=rows.device)
    out_i = torch.zeros((b, n_rows, k), dtype=torch.int32, device=rows.device)
    step = max(1, chunk_elems // max(1, b * n_cols))
    col_idx = torch.arange(n_cols, device=rows.device)
    for lo in range(0, n_rows, step):
        d = dist(rows[:, lo:lo + step], cols)
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


def _check_inputs(rows, cols, col_mask, name, dim=3):
    """Raise unless rows (B, R, dim) and cols (B, C, dim) are f32 and
    col_mask (B, C) bool, all on one device (dim None: any D >= 1, the
    same for both)."""
    d = rows.shape[-1] if dim is None else dim
    if rows.dim() != 3 or rows.shape[-1] != d or cols.dim() != 3 \
            or cols.shape[-1] != d or d < 1 or rows.shape[0] != cols.shape[0] \
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


# --- knn_topk_dim: the certified filter, the rescore, the exhaustive rows

DIM_CANDIDATES = 512  # M: a row's candidate list; past it the exhaustive scan
_FILTER_TILE = 128  # columns a filter tile (csrc/knn_dim.cu kFCols)
_FILTER_PRIME = 8  # tiles that fill the lists before any is listed (kFPrime)


def dim_padded(d: int, unit: int = 8) -> int:
    """D rounded up to a multiple of ``unit``: Dp (8), the exact copy's
    width, or the TF32 copy's (32, the filter's staged chunk)."""
    return -(-d // unit) * unit


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as ``cvt.rna.tf32.f32``: round to nearest, ties away
    from zero, at the 13 dropped mantissa bits (the magnitude's bits plus
    half of the last kept bit, then truncated; a carry may reach +-inf).
    Non-finite values pass through."""
    bits = x.contiguous().view(torch.int32)
    out = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """float64 s = a + b and its exact error e (Knuth's TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _directed(s: torch.Tensor, e, up: bool) -> torch.Tensor:
    """The exact value s + e (float64 pair, |e| <= half an ulp of s)
    rounded to fp32 up (``__f*_ru``) or down (``__f*_rd``)."""
    f = s.float()
    fd = f.double()
    if up:
        bump = (fd < s) | ((fd == s) & (e > 0))
        return torch.where(bump, torch.nextafter(f, torch.full_like(
            f, math.inf)), f)
    bump = (fd > s) | ((fd == s) & (e < 0))
    return torch.where(bump, torch.nextafter(f, torch.full_like(
        f, -math.inf)), f)


def _add(a, b, up):
    return _directed(*_two_sum(a.double(), b.double()), up)


def _mul(a, b, up):
    return _directed(a.double() * b.double(), 0.0, up)  # exact in float64


def _fma(a, b, c, up):
    return _directed(*_two_sum(a.double() * b.double(), c.double()), up)


def _sqrt_up(x):
    f = torch.sqrt(x.double()).float()
    xd = x.double()
    f = torch.where(f.double() ** 2 < xd,
                    torch.nextafter(f, torch.full_like(f, math.inf)), f)
    lower = torch.nextafter(f, torch.full_like(f, -math.inf))
    return torch.where((lower >= 0) & (lower.double() ** 2 >= xd), lower, f)


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _point_terms(n: torch.Tensor, dim: int, rows: bool):
    """(Nhi, Nlo, Q) of points of fp32 squared norm n, as the kernel's
    ``point_terms`` (csrc/knn_dim.cu: the certificate's per-point terms,
    every operation rounded up or down as there); NaN where n is not
    finite."""
    g = _f32((dim + 6) * 2.0 ** -23)
    tiny = _f32((dim + 32) * 2.0 ** -149)
    a = _sqrt_up(_mul(_add(n, tiny, True), _add(_f32(1.0), 2 * g, True),
                      True))
    e = _add(_mul(g, _mul(a, a, True), True), tiny, True)
    f = _mul(_mul(_sqrt_up(_f32(float(dim))), _f32(2.0 ** -124), True), a,
             True)
    k0 = _f32((dim + 8) * 2.0 ** -124 if rows else 0.0)
    p = _add(_add(e, f, True), k0, True)
    a_acc = _f32(2 * (dim + 8) * 2.0 ** -23)
    c_s = _add(_f32(2.0 ** -10 + 2.0 ** -22),
               _mul(_f32(1 + 2.0 ** -10 + 2.0 ** -22), a_acc, True), True)
    q = _mul(_sqrt_up(2 * c_s), a, True)
    bad = ~torch.isfinite(n)
    nan = torch.full_like(n, math.nan)
    return (torch.where(bad, nan, _add(n, p, True)),
            torch.where(bad, nan, _add(n, -p, False)),
            torch.where(bad, nan, q))


def _div_up(a, b):
    """a / b (fp32 tensors, b > 0) rounded up (``__fdiv_ru``)."""
    f = (a.double() / b.double()).float()
    return torch.where(f.double() * b.double() < a.double(),
                       torch.nextafter(f, torch.full_like(f, math.inf)), f)


def filter_factors(dim: int):
    """(1 + g rounded up, 1 - g rounded down, their ratio rounded up),
    g = (D + 2) 2^-23: the plain sum's relative error. The kernel keeps
    U and L without these factors (p <= (1 + g) U, p >= (1 - g) L) and
    holds L against tau times the ratio."""
    g = _f32((dim + 2) * 2.0 ** -23)
    up, dn = _add(_f32(1.0), g, True), _add(_f32(1.0), -g, False)
    return up, dn, _div_up(up, dn)


def filter_bounds_plain(rows: torch.Tensor, cols: torch.Tensor,
                        seed: int = 0):
    """Plain version of the filter's arithmetic (``knn_topk_dim``'s
    certificate, csrc/knn_dim.cu), for tests and chip_smoke.py: TF32
    products (``tf32_round`` of both sides) summed in fp32 in an order
    shuffled by ``seed`` (the tensor cores' order is unspecified), squared
    norms summed in fp32 in another shuffled order, and per pair, as the
    kernel keeps them, U = (Nhi_r + Nhi_c - 2 s) + Q_r Q_c rounded up and
    L = (Nlo_r + Nlo_c - 2 s) - Q_r Q_c rounded down. Returns (U, L),
    each (B, R, C) f32: (1 + g) U >= every ``pair_d2_dim`` >= (1 - g) L
    where the bounds are not NaN (``filter_factors``,
    ``filter_p_bounds``)."""
    dim = rows.shape[-1]
    gen = torch.Generator().manual_seed(seed)

    def norms(x):
        n = torch.zeros(x.shape[:2])
        for d in torch.randperm(dim, generator=gen).tolist():
            n = n + x[..., d] * x[..., d]
        return n

    rt, ct = tf32_round(rows), tf32_round(cols)
    s = torch.zeros(rows.shape[0], rows.shape[1], cols.shape[1])
    for d in torch.randperm(dim, generator=gen).tolist():
        s = s + rt[:, :, None, d] * ct[:, None, :, d]
    nhi_r, nlo_r, q_r = (t[:, :, None] for t in _point_terms(
        norms(rows), dim, True))
    nhi_c, nlo_c, q_c = (t[:, None, :] for t in _point_terms(
        norms(cols), dim, False))
    two = _f32(-2.0)
    u = _fma(q_r, q_c, _fma(two, s, _add(nhi_r, nhi_c, True), True), True)
    lo = _fma(-q_r, q_c, _fma(two, s, _add(nlo_r, nlo_c, False), False),
              False)
    return u, lo


def filter_p_bounds(u: torch.Tensor, lo: torch.Tensor, dim: int):
    """The bounds on ``pair_d2_dim`` that the kernel's U and L stand for:
    (1 + g) U rounded up, (1 - g) L rounded down."""
    up, dn, _ = filter_factors(dim)
    return _mul(u, up, True), _mul(lo, dn, False)


def _lane_groups(v: torch.Tensor) -> torch.Tensor:
    """(B, R, C) -> (B, R, T, 8, 16): tile, lane group (wn, t) of the
    kernel's fragment layout (column c = 128 tile + 64 wn + 8 nt + 2 t +
    j), the group's 16 columns of the tile; padded with +inf."""
    b, n_rows, n_cols = v.shape
    v = torch.nn.functional.pad(v, (0, (-n_cols) % _FILTER_TILE),
                                value=math.inf)
    v = v.view(b, n_rows, -1, 2, 8, 4, 2).permute(0, 1, 2, 3, 5, 4, 6)
    return v.reshape(b, n_rows, v.shape[2], 8, 16)


def _kept(k: int) -> tuple[int, int, int]:
    """(K, KL, run) of the filter for k: each lane group keeps its KL =
    min(8, max(1, K / 4)) smallest U; the running threshold takes the
    largest of the groups' entry ``run`` = max(1, K / 8) - 1."""
    inst = topk_instance(k)
    return inst, min(8, max(1, inst // 4)), max(1, inst // 8) - 1


def filter_tau_plain(u: torch.Tensor, col_mask: torch.Tensor,
                     k: int) -> torch.Tensor:
    """The filter's threshold tau (B, R) from U (B, R, C), as the kernel
    takes it: each of a row's 8 lane groups (``_lane_groups``) keeps its
    KL = min(8, max(1, K / 4)) smallest valid U >= 0 (K =
    ``topk_instance(k)``), and tau is the K-th smallest of the 8 KL kept
    values (+inf unless K of them are finite): an upper bound on the row's
    K-th smallest ``pair_d2_dim``."""
    inst, kl, _ = _kept(k)
    v = torch.where(col_mask[:, None, :] & (u >= 0), u, math.inf)
    g = _lane_groups(v).transpose(2, 3)
    kept = g.reshape(*g.shape[:3], -1).sort(dim=-1).values[..., :kl]
    return kept.reshape(*kept.shape[:2], -1).sort(dim=-1).values[
        ..., inst - 1]


def filter_candidates_plain(u: torch.Tensor, lo: torch.Tensor,
                            col_mask: torch.Tensor, k: int,
                            dim: int) -> torch.Tensor:
    """The columns the kernel's single sweep lists (B, R, C) bool: it
    visits tiles 0 .. T - 1, then 0 .. W - 1 again (W = min(8, T)); a
    visit below T puts the tile's U into the lane groups' lists, a visit
    from W on lists each valid column with !(L > tau_run), tau_run the
    largest of the 8 groups' ``run``-th kept U after the visits before
    (8 (run + 1) >= K distinct columns lie at or below it, so tau_run >=
    tau; L is held against it times ``filter_factors``' ratio). A
    superset of the survivors; the kernel's warps may see a sibling's list
    of the same visit, so it can list fewer."""
    inst, kl, run = _kept(k)
    ratio = filter_factors(dim)[2]
    valid = col_mask[:, None, :].expand_as(u)
    v = _lane_groups(torch.where(valid & (u >= 0), u, math.inf))
    ok = _lane_groups(torch.where(valid, 0.0, math.inf)) == 0
    low = _lane_groups(lo)
    b, n_rows, n_tiles = v.shape[:3]
    listed = torch.zeros(low.shape, dtype=torch.bool)
    kept = torch.full((b, n_rows, 8, kl), math.inf)
    tau_run = torch.full((b, n_rows), math.inf)
    prime = min(_FILTER_PRIME, n_tiles)
    for visit in range(n_tiles + prime):
        tile = visit % n_tiles
        if visit >= prime:
            listed[:, :, tile] = ok[:, :, tile] & ~(
                low[:, :, tile] > _mul(tau_run, ratio, True)[..., None, None])
        if visit < n_tiles:
            kept = torch.cat([kept, v[:, :, tile]], -1).sort(
                dim=-1).values[..., :kl]
            tau_run = kept[..., run].max(dim=-1).values
    out = listed.view(b, n_rows, n_tiles, 2, 4, 8, 2).permute(
        0, 1, 2, 3, 5, 4, 6).reshape(b, n_rows, -1)
    return out[..., :u.shape[-1]]


def filter_plain(rows: torch.Tensor, cols: torch.Tensor,
                 col_mask: torch.Tensor, k: int, seed: int = 0):
    """Plain version of ``knn_topk_dim``'s filter: (U, L, tau, survivors
    (B, R, C) bool), U, L and tau in the kernel's units (without the
    factors of ``filter_factors``). A valid column survives unless
    L > tau times the factors' ratio, so a NaN bound survives; the
    selection over the survivors is ``select_plain_dim``'s."""
    u, lo = filter_bounds_plain(rows, cols, seed)
    tau = filter_tau_plain(u, col_mask, k)
    ratio = filter_factors(rows.shape[-1])[2]
    return u, lo, tau, col_mask[:, None, :] & ~(
        lo > _mul(tau, ratio, True)[..., None])


def _dim_scratch(rows: torch.Tensor, cols: torch.Tensor) -> dict:
    """The filter's scratch: exact and TF32 copies padded to Dp, the
    per-point terms, the candidate lists and their counts."""
    b, n_rows, n_cols = rows.shape[0], rows.shape[1], cols.shape[1]
    dp, dt = dim_padded(rows.shape[2]), dim_padded(rows.shape[2], 32)

    def f32(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=rows.device)

    return {"dp": dp, "dt": dt, "rows_x": f32(b, n_rows, dp),
            "rows_t": f32(b, n_rows, dt), "rows_p": f32(b, n_rows, 4),
            "cols_x": f32(b, n_cols, dp), "cols_t": f32(b, n_cols, dt),
            "cols_p": f32(b, n_cols, 4),
            "cand": f32(b, n_rows, DIM_CANDIDATES, dtype=torch.int32),
            "cand_l": f32(b, n_rows, DIM_CANDIDATES),
            "counts": f32(b, n_rows, dtype=torch.int32),
            "tau": f32(b, n_rows)}


def _dim_filter(lib, rows, cols, col_mask, s: dict, inst: int, stream):
    """Prep and filter (``ptw_knn_dim_filter``): fills ``s``."""
    b, n_rows, n_cols, dim = (rows.shape[0], rows.shape[1], cols.shape[1],
                              rows.shape[2])
    build.check(lib.ptw_knn_dim_filter(
        rows.data_ptr(), cols.data_ptr(), col_mask.data_ptr(),
        *(s[n].data_ptr() for n in ("rows_x", "rows_t", "rows_p", "cols_x",
                                    "cols_t", "cols_p", "cand", "cand_l",
                                    "counts", "tau")),
        b, n_rows, n_cols, dim, s["dp"], s["dt"], inst, DIM_CANDIDATES,
        stream), "knn_topk_dim filter")


def _dim_rescore(lib, s: dict, out_d, out_i, inst: int, stream):
    """The exact top-K of the rows whose candidates fit in M."""
    b, n_rows, n_cols = (s["rows_x"].shape[0], s["rows_x"].shape[1],
                         s["cols_x"].shape[1])
    build.check(lib.ptw_knn_dim_rescore(
        *(s[n].data_ptr() for n in ("rows_x", "cols_x", "cand", "cand_l",
                                    "counts", "tau")),
        out_d.data_ptr(), out_i.data_ptr(), b, n_rows, n_cols, s["dp"], inst,
        DIM_CANDIDATES, stream),
        "knn_topk_dim rescore")


def _dim_exhaustive(lib, rows, cols, col_mask, s: dict, out_d, out_i,
                    inst: int, stream):
    """The exhaustive scan of the rows with more than M candidates (the
    device reads the counts: blocks without such a row exit)."""
    b, n_rows, n_cols, dim = (rows.shape[0], rows.shape[1], cols.shape[1],
                              rows.shape[2])
    build.check(lib.ptw_knn_dim_exhaustive(
        rows.data_ptr(), cols.data_ptr(), col_mask.data_ptr(),
        s["counts"].data_ptr(), out_d.data_ptr(), out_i.data_ptr(), b,
        n_rows, n_cols, dim, inst, DIM_CANDIDATES, stream),
        "knn_topk_dim exhaustive")


def _dim_launches(rows, cols, col_mask, k: int, counted: bool):
    """``knn_topk_dim``'s launches on CUDA tensors: (d2, idx, the first
    pass's scratch, or None where there is no row). ``counted`` adds each
    launch to the wrapper's counts."""
    inst, passes = topk_plan(k)
    lib = build.library("knn_dim")
    rows, cols, col_mask = (t.contiguous() for t in (rows, cols, col_mask))
    b, n_rows, n_cols, dim = (rows.shape[0], rows.shape[1], cols.shape[1],
                              rows.shape[2])
    out_d = torch.empty((passes, b, n_rows, inst), dtype=torch.float32,
                        device=rows.device)
    out_i = torch.empty((passes, b, n_rows, inst), dtype=torch.int32,
                        device=rows.device)
    s = None
    if b and n_rows:
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        s = _dim_scratch(rows, cols)
        _dim_filter(lib, rows, cols, col_mask, s, inst, stream)
        _dim_rescore(lib, s, out_d[0], out_i[0], inst, stream)
        _dim_exhaustive(lib, rows, cols, col_mask, s, out_d[0], out_i[0],
                        inst, stream)
        if counted:
            knn_topk_dim.filter_launches += 1
            knn_topk_dim.rescore_launches += 1
            knn_topk_dim.exhaustive_launches += 1
            knn_topk_dim.launches += 1
        for r in range(1, passes):
            build.check(lib.ptw_knn_topk_dim(
                rows.data_ptr(), cols.data_ptr(), col_mask.data_ptr(),
                out_d[r - 1].data_ptr(), out_i[r - 1].data_ptr(),
                out_d[r].data_ptr(), out_i[r].data_ptr(), b, n_rows, n_cols,
                dim, inst, stream), "knn_topk_dim")
            if counted:
                knn_topk_dim.exhaustive_launches += 1
                knn_topk_dim.launches += 1
    return (out_d.permute(1, 2, 0, 3).reshape(b, n_rows, -1)[..., :k]
            .contiguous(),
            out_i.permute(1, 2, 0, 3).reshape(b, n_rows, -1)[..., :k]
            .contiguous(), s)


def knn_topk_dim(rows: torch.Tensor, cols: torch.Tensor,
                 col_mask: torch.Tensor, k: int):
    """Exact top-k nearest valid columns per row by the D-dimensional d2
    (``pair_d2_dim``): rows (B, R, D) f32, cols (B, C, D) f32, col_mask
    (B, C) bool -> (d2 (B, R, k) f32, idx (B, R, k) int32), with
    ``select_plain_dim``'s contract. CUDA (csrc/knn_dim.cu), the passes
    of ``topk_plan(k)``, each written into its slice of one
    (passes, B, R, 64) output (the first k slots kept): the first a
    certified TF32 tensor-core filter (``filter_launches``), the exact
    rescore of each row's survivors (``rescore_launches``) and the
    exhaustive scan of the rows with more than ``DIM_CANDIDATES``
    (``exhaustive_launches``); past k = 64 each later pass an exhaustive
    scan above the last slot of the pass before. ``launches`` counts the
    passes. No launch waits for the host."""
    _check_inputs(rows, cols, col_mask, "knn_topk_dim", dim=None)
    if rows.device.type == "cpu":
        return select_plain_dim(rows, cols, col_mask, k)
    if rows.device.type != "cuda":
        raise RuntimeError(f"knn_topk_dim: no kernel for device "
                           f"{rows.device}")
    return _dim_launches(rows, cols, col_mask, k, counted=True)[:2]


knn_topk_dim.launches = 0
knn_topk_dim.filter_launches = 0
knn_topk_dim.rescore_launches = 0
knn_topk_dim.exhaustive_launches = 0


def knn_topk_dim_survivors(rows: torch.Tensor, cols: torch.Tensor,
                           col_mask: torch.Tensor, k: int):
    """``knn_topk_dim``'s result and what its filter kept in that same
    call (its first pass, K = ``topk_instance(k)``): (d2, idx, {"rows";
    "mean", "max": survivors a row (the candidates with !(L > tau), which
    the rescore scores; over the rows whose list holds all its
    candidates); "candidates_mean", "candidates_max": candidates a row;
    "over_capacity": rows with more candidates than ``DIM_CANDIDATES``,
    which that call's exhaustive scan served; and "capacity"}). CUDA: the
    wrapper's launches, not counted, and one read of a reduction of the
    first pass's scratch; CPU: ``select_plain_dim``, ``filter_plain`` and
    ``filter_candidates_plain``. For tests and chip_smoke.py; the wrapper
    itself never reads a count."""
    _check_inputs(rows, cols, col_mask, "knn_topk_dim_survivors", dim=None)
    if rows.device.type == "cpu":
        d2, idx = select_plain_dim(rows, cols, col_mask, k)
        u, lo, _, surv = filter_plain(rows, cols, col_mask, k)
        counts = filter_candidates_plain(u, lo, col_mask, k,
                                         rows.shape[-1]).sum(-1)
        survivors = surv.sum(-1)
    elif rows.device.type != "cuda":
        raise RuntimeError(f"knn_topk_dim_survivors: no kernel for device "
                           f"{rows.device}")
    else:
        d2, idx, s = _dim_launches(rows, cols, col_mask, k, counted=False)
        counts = s["counts"]
        listed = torch.arange(DIM_CANDIDATES, device=rows.device) \
            < counts[..., None]
        survivors = (listed & ~(s["cand_l"] > s["tau"][..., None])).sum(-1)
    fits = counts <= DIM_CANDIDATES
    kept = survivors[fits].float()
    mean, top, c_mean, c_max, over = torch.stack([
        kept.mean() if kept.numel() else kept.new_tensor(math.nan),
        kept.max() if kept.numel() else kept.new_tensor(math.nan),
        counts.float().mean(), counts.max().float(),
        (~fits).sum().float()]).tolist()
    return d2, idx, {"rows": counts.numel(), "mean": mean, "max": top,
                     "candidates_mean": c_mean, "candidates_max": int(c_max),
                     "over_capacity": int(over), "capacity": DIM_CANDIDATES}
