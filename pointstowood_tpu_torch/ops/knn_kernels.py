"""k-nearest selection kernels (port of pointstowood_tpu/ops/pallas_knn.py).

Two wrappers, each beside its plain PyTorch version:

* ``knn_topk`` (CUDA ``ptw_knn_topk``, csrc/knn.cu) replaces the Pallas
  ``group_min_topk`` and the forward half of ``group_min_topk_t``;
* ``knn_top2`` (CUDA ``ptw_knn_top2``) replaces the Pallas ``top2`` and
  the transpose half of ``group_min_topk_t``.

Both return the exact top-k by squared distance, ascending, ties to the
lower column index, with the TRUE d2 (+inf for masked columns and unfilled
slots; idx 0 there). A wrapper runs the plain version only when its inputs
lie on the CPU; on a CUDA tensor it launches the kernel or raises. Each
wrapper counts its kernel launches in its ``launches`` attribute.

The shape gates of the JAX package (``supported``, ``topk_supported``,
``transpose_supported``, ``top2_supported``) are copied as plain Python:
the kernels here have no shape limit, but ``model.network`` routes each
stage the way the JAX package does, so both take the same path.
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
    valid columns hold (+inf, 0)."""
    b, n_rows, _ = rows.shape
    n_cols = cols.shape[1]
    kk = min(k, n_cols)
    out_d = torch.full((b, n_rows, k), math.inf, device=rows.device)
    out_i = torch.zeros((b, n_rows, k), dtype=torch.int32, device=rows.device)
    step = max(1, _CHUNK_ELEMS // max(1, b * n_cols))
    for lo in range(0, n_rows, step):
        d = pair_d2(rows[:, lo:lo + step], cols)
        d = torch.where(col_mask[:, None, :], d, math.inf)
        vals, order = torch.sort(d, dim=-1, stable=True)
        vals, order = vals[..., :kk], order[..., :kk]
        out_d[:, lo:lo + step, :kk] = vals
        out_i[:, lo:lo + step, :kk] = torch.where(
            torch.isfinite(vals), order, 0).to(torch.int32)
    return out_d, out_i


# --- kernel wrappers --------------------------------------------------------

_TOPK_INSTANCES = (8, 16, 32)


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


def _launch_select(owner, fn, rows, cols, col_mask, k_out, k_arg):
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
                out_d.data_ptr(), out_i.data_ptr(), b, n_rows, n_cols]
        if k_arg is not None:
            args.append(k_arg)
        build.check(fn(*args, stream), name)
        owner.launches += 1
    return out_d, out_i


def knn_topk(rows: torch.Tensor, cols: torch.Tensor,
             col_mask: torch.Tensor, k: int):
    """Exact top-k nearest valid columns per row: rows (B, R, 3) f32,
    cols (B, C, 3) f32, col_mask (B, C) bool -> (d2 (B, R, k) f32,
    idx (B, R, k) int32). CUDA: the ``ptw_knn_topk`` kernel for k <= 32
    (instantiated at K = 8/16/32, the first k slots kept)."""
    _check_inputs(rows, cols, col_mask, "knn_topk")
    if rows.device.type == "cpu":
        return select_plain(rows, cols, col_mask, k)
    inst = next((c for c in _TOPK_INSTANCES if c >= k), None)
    if inst is None:
        raise ValueError(f"knn_topk: k={k} exceeds {_TOPK_INSTANCES[-1]}")
    lib = build.library("knn")
    d, i = _launch_select(knn_topk, lib.ptw_knn_topk, rows, cols, col_mask,
                          inst, inst)
    if inst != k:
        d, i = d[..., :k].contiguous(), i[..., :k].contiguous()
    return d, i


knn_topk.launches = 0


def knn_top2(rows: torch.Tensor, cols: torch.Tensor,
             col_mask: torch.Tensor):
    """Exact top-2 nearest valid columns per row (same contract as
    ``knn_topk`` with k = 2). CUDA: the ``ptw_knn_top2`` kernel."""
    _check_inputs(rows, cols, col_mask, "knn_top2")
    if rows.device.type == "cpu":
        return select_plain(rows, cols, col_mask, 2)
    lib = build.library("knn")
    return _launch_select(knn_top2, lib.ptw_knn_top2, rows, cols, col_mask,
                          2, None)


knn_top2.launches = 0
