"""Static-shape voxel-grid clustering (port of pointstowood_tpu/ops/voxel.py).

Replacement for torch-cluster ``voxel_grid`` + PyG ``consecutive_cluster``
(reference: pointstowood/src/model.py:103-106): cells are packed into
int32-range ids and one representative per occupied cell is selected with
a sort, into a fixed-capacity index array + mask.

The functions are batched over a leading B axis (the JAX package vmaps its
single-sample versions) and agree with the JAX package bit for bit:

* the murmur3 finalizer runs on uint32 in JAX; torch has no uint32
  arithmetic, so it runs on int64 masked to 32 bits after every multiply
  and shift;
* JAX's two-key stable sort (cell id, hash) becomes one stable sort of the
  packed int64 key ``id << 32 | hash`` (ids are non-negative, PAD_CELL is
  2^31 - 1, so the key never overflows);
* the cell division divides by a tensor, never by a Python scalar: on CUDA
  PyTorch turns division by a scalar into a multiply by its reciprocal,
  which rounds differently.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_AXIS_BITS = 10
_AXIS_SIZE = 1 << _AXIS_BITS
# Sentinel id for padded points: sorts after every real cell id.
PAD_CELL = (1 << 31) - 1
_U32 = 0xFFFFFFFF


def check_voxel_pack_range(extent_m: float, resolution_m: float) -> None:
    """Guard for the packed cell-id range: a tile spanning more than 2^10
    cells per axis at the finest sampling resolution would alias inside
    ``voxel_cell_ids``."""
    cells = math.ceil(float(extent_m) / float(resolution_m))
    if cells > _AXIS_SIZE:
        raise ValueError(
            f"voxel sampling grid overflow: a {extent_m} m tile at "
            f"{resolution_m} m resolution spans {cells} cells per axis, but "
            f"packed cell ids support at most {_AXIS_SIZE}. Use a smaller "
            f"--grid_size or a coarser SA resolution."
        )


def voxel_cell_ids(pos: torch.Tensor, size: float,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Packed cell id per point: pos (B, N, 3) -> (B, N) int64 holding
    int32-range values.

    The grid origin is the per-sample minimum of the valid points; invalid
    points get PAD_CELL. Cell coordinates are clipped to the packable
    range. z-major packing makes ascending ids the (z, y, x)-lexicographic
    order of torch_cluster's x-fastest grid ids."""
    pos = pos.float()
    if mask is None:
        origin = pos.amin(dim=1, keepdim=True)
    else:
        origin = torch.where(mask[..., None], pos, math.inf).amin(
            dim=1, keepdim=True)
    step = torch.tensor(size, dtype=torch.float32, device=pos.device)
    cells = torch.floor((pos - origin) / step).to(torch.int64)
    cells = cells.clamp(0, _AXIS_SIZE - 1)
    ids = ((cells[..., 2] << (2 * _AXIS_BITS))
           | (cells[..., 1] << _AXIS_BITS) | cells[..., 0])
    if mask is not None:
        ids = torch.where(mask, ids, PAD_CELL)
    return ids


def _mix_bits(x: torch.Tensor) -> torch.Tensor:
    """Deterministic 32-bit integer hash (finalizer of murmur3), on int64
    holding uint32 values."""
    x = x.to(torch.int64) & _U32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _U32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _U32
    x = x ^ (x >> 16)
    return x


def voxel_representatives(ids: torch.Tensor, capacity: int,
                          mask: torch.Tensor | None = None,
                          priority: str = "hash"):
    """One representative point per occupied cell: ids (B, N) ->
    (idx (B, capacity) int64, valid (B, capacity) bool).

    priority="hash": within a cell, and among cells when they overflow
    ``capacity``, points are ordered by a hash of their index (spatially
    unbiased, deterministic). priority="last": the last occurrence in
    array order represents its cell and kept centres come in ascending
    cell-id order (the reference's CPU consecutive_cluster semantics)."""
    b, n = ids.shape
    dev = ids.device
    if mask is not None:
        ids = torch.where(mask, ids, PAD_CELL)
    ar = torch.arange(n, device=dev, dtype=torch.int64).expand(b, n)
    if priority == "last":
        order = torch.sort(ids, dim=1, stable=True).indices
        sorted_ids = torch.gather(ids, 1, order)
        is_last = torch.ones_like(sorted_ids, dtype=torch.bool)
        is_last[:, :-1] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
        is_rep = is_last & (sorted_ids != PAD_CELL)
        key = torch.where(is_rep, ar, n)
        kept = torch.sort(key, dim=1, stable=True).indices[:, :capacity]
        valid = torch.gather(key, 1, kept) < n
        idx = torch.gather(order, 1, kept)
        return torch.where(valid, idx, 0), valid
    if priority != "hash":
        raise ValueError(f"unknown voxel priority {priority!r}")
    prio = _mix_bits(ar)
    order = torch.sort((ids << 32) | prio, dim=1, stable=True).indices
    sorted_ids = torch.gather(ids, 1, order)
    sorted_prio = torch.gather(prio, 1, order)
    is_first = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_first[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    is_rep = is_first & (sorted_ids != PAD_CELL)
    key = torch.where(is_rep, sorted_prio, _U32)
    perm = torch.sort(key, dim=1, stable=True).indices[:, :capacity]
    valid = torch.gather(key, 1, perm) != _U32
    idx = torch.gather(order, 1, perm)
    return torch.where(valid, idx, 0), valid


def voxel_cell_ids_np(pos, size, origin=None) -> np.ndarray:
    """Host int64 cell ids with no packing limit (the JAX package's
    ``voxel_cell_ids_np``): x-major lexicographic ids over the occupied
    extent, origin the minimum of ``pos`` unless given. For clouds that
    span hundreds of metres (``tools/pathlength.py``)."""
    pos = np.asarray(pos)
    if origin is None:
        origin = pos.min(axis=0)
    cells = np.floor((pos - origin) / float(size)).astype(np.int64)
    extent = cells.max(axis=0) + 1
    return (cells[:, 0] * extent[1] + cells[:, 1]) * extent[2] + cells[:, 2]
