"""Host-side preprocessing: ground normalization, reflectance quantile
normalization, and multi-scale voxel tiling (port of
pointstowood_tpu/data/tiling.py on column tables, numpy only; its
steps are the tracer's ``ingest.*`` spans).

Reimplements the reference Voxelise pipeline
(reference: pointstowood/src/preprocessing.py:9-131) as vectorized numpy:
one argsort + split per grid scale instead of a per-voxel loop. Tiles are
returned in memory as float32 arrays (``vxdir`` also writes them as
``voxel_N.npy``).

The tiles are bit-identical to the JAX package's for the same cloud and
seed (points, grid_size, cell_id and indices): the same numpy calls draw
from ``default_rng(seed)`` in the same cell order across scales.

Behavioural notes vs the reference (as in the JAX package):
  * Cells are clustered on x/y/z only, unless ``cluster_features`` asks
    for the reference's full-feature clustering (preprocessing.py:58).
  * Oversized cells are subsampled as the reference does
    (preprocessing.py:116-120): reflectance-weighted sampling without
    replacement when reflectance is present, uniform WITH replacement
    otherwise.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List

import numpy as np

from pointstowood_tpu_torch.config import TilingConfig
from pointstowood_tpu_torch.ops.normalization import (
    ground_normalize_np,
    quantile_normalize_np,
)
from pointstowood_tpu_torch.utils import trace


@dataclasses.dataclass
class Tile:
    """One voxel tile: float32 points [x, y, z, reflectance, (label)]."""

    points: np.ndarray  # (n, 4) predict / (n, 5) train
    grid_size: float
    # packed cell id within its grid scale (-1 = unknown); lets device
    # fusion map original points back to the tile that classified them
    cell_id: int = -1
    # original-cloud row per tile row (None = unknown)
    indices: np.ndarray | None = None

    def __len__(self):
        return self.points.shape[0]


NAN_CELL = np.int64(-(2 ** 62))  # sentinel id for non-finite rows


def _finite_origin(feats: np.ndarray):
    """(finite mask, origin, cleaned feats) or None when no row is finite.
    Non-finite rows take the origin, so they cannot poison the extents."""
    finite = np.isfinite(feats).all(axis=1)
    if finite.all():
        return finite, feats.min(axis=0), feats
    if finite.any():
        origin = feats[finite].min(axis=0)
        return finite, origin, np.where(finite[:, None], feats, origin)
    return None


def _pack(cells: np.ndarray) -> np.ndarray:
    extent = cells.max(axis=0) + 1
    ids = cells[:, 0]
    for d in range(1, cells.shape[1]):
        ids = ids * extent[d] + cells[:, d]
    return ids


def cell_ids_for(feats: np.ndarray, size: float) -> np.ndarray:
    """Packed voxel cell id per point. Origin and extents come from the
    cloud itself, so recomputing on the same cloud reproduces the ids the
    tiles were built from. Non-finite rows get ``NAN_CELL``."""
    found = _finite_origin(feats)
    if found is None:
        return np.full(feats.shape[0], NAN_CELL)
    finite, origin, clean = found
    cells = np.floor((clean - origin) / size).astype(np.int64)
    return np.where(finite, _pack(cells), NAN_CELL)


def cell_ids_multi(feats: np.ndarray, sizes) -> np.ndarray:
    """``cell_ids_for`` for several grid sizes in one pass: (n, len(sizes))
    int64. A scale whose ratio to the finest is an exact power of two
    derives its integer cells by right-shifting the finest scale's
    (scaling by a power of two commutes with fp rounding, so the fold
    reproduces ``cell_ids_for`` bit for bit). The canonical dual grid
    [2.0, 4.0] takes the folded path."""
    sizes = [float(s) for s in sizes]
    n = feats.shape[0]
    out = np.empty((n, len(sizes)), np.int64)
    found = _finite_origin(feats)
    if found is None:
        out[:] = NAN_CELL
        return out
    finite, origin, clean = found
    rel = clean - origin
    base = min(sizes)
    base_cells = None
    for si, s in enumerate(sizes):
        ratio = s / base
        k = int(ratio).bit_length() - 1 if ratio >= 1 else -1
        if base_cells is not None and k >= 0 and ratio == float(2 ** k):
            cells = base_cells >> k  # rel >= 0, so >> is the exact floor
        else:
            cells = np.floor(rel / s).astype(np.int64)
            if s == base:
                base_cells = cells
        out[:, si] = np.where(finite, _pack(cells), NAN_CELL)
    return out


def _split_by_cell(feats: np.ndarray, size: float):
    """(cell_id, point-index array) per occupied (size^D) voxel cell."""
    ids = cell_ids_for(feats, size)
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    boundaries = np.flatnonzero(np.diff(sorted_ids)) + 1
    groups = np.split(order, boundaries)
    group_ids = sorted_ids[np.concatenate([[0], boundaries])]
    return list(zip(group_ids.tolist(), groups))


def xyz_of(pc: dict) -> np.ndarray:
    """(n, 3) x/y/z of a column table, in the columns' common dtype."""
    return np.stack([np.asarray(pc[c]) for c in ("x", "y", "z")], axis=1)


def preprocess_cloud(
    pc: dict,
    config: TilingConfig,
    with_labels: bool = False,
    seed: int = 141190,
    vxdir: str | None = None,
) -> List[Tile]:
    """Normalize and tile a canonicalized cloud (x, y, z, reflectance, ...).

    Adds the ``n_z`` height-normalized column to ``pc`` (the reference
    writes it back at preprocessing.py:131). Returns the tile list; with
    ``vxdir`` also writes each tile as ``voxel_{i}.npy`` plus metadata
    sidecars."""
    rng = np.random.default_rng(seed)
    xyz_any = xyz_of(pc)
    if "n_z" not in pc:
        with trace.span("ingest.ground"):
            pc["n_z"] = ground_normalize_np(
                xyz_any, grid_resolution=config.ground_grid)

    xyz = xyz_any.astype(np.float32)
    refl = np.asarray(pc["reflectance"]).astype(np.float32)
    reflectance_not_zero = not np.all(refl == 0)
    if reflectance_not_zero:
        with trace.span("ingest.reflectance"):
            refl = quantile_normalize_np(refl)

    columns = [xyz, refl[:, None]]
    if with_labels:
        columns.append(np.asarray(pc["label"]).astype(np.float32)[:, None])
    data = np.concatenate(columns, axis=1)

    # sampling weight for oversized cells (preprocessing.py:98-104)
    if reflectance_not_zero:
        weight = refl - refl.min()
        weight = np.where(np.isfinite(weight), weight, 0.0) + 1e-8
    else:
        weight = None

    if config.cluster_features:
        cluster_arr = np.concatenate(
            [data, np.asarray(pc["n_z"]).astype(np.float32)[:, None]], axis=1)
    else:
        cluster_arr = xyz

    tiles: List[Tile] = []
    for size in config.grid_size:
        with trace.span("ingest.cells", scale=float(size)):
            for cid, cell_idx in _split_by_cell(cluster_arr, float(size)):
                if cell_idx.shape[0] < config.min_pts:
                    continue
                if cell_idx.shape[0] > config.max_pts:
                    if weight is not None:
                        # Efraimidis-Spirakis keys: torch.multinomial's
                        # weighted draw without replacement, vectorized
                        w = weight[cell_idx]
                        keys = np.log(rng.random(cell_idx.shape[0])) / w
                        top = np.argpartition(keys, -config.max_pts)
                        cell_idx = cell_idx[top[-config.max_pts:]]
                    else:
                        cell_idx = cell_idx[rng.integers(
                            0, cell_idx.shape[0], size=config.max_pts)]
                keep = ~np.isnan(data[cell_idx]).any(axis=1)
                cell_idx = cell_idx[keep]
                if cell_idx.shape[0] == 0:
                    continue
                tiles.append(Tile(points=data[cell_idx],
                                  grid_size=float(size), cell_id=int(cid),
                                  indices=cell_idx.astype(np.int64)))

    if vxdir is not None:
        os.makedirs(vxdir, exist_ok=True)
        # continue numbering after tiles already in the directory, as the
        # reference does (preprocessing.py:110)
        start = len(glob.glob(os.path.join(vxdir, "voxel_*.npy")))
        for i, t in enumerate(tiles):
            stem = os.path.join(vxdir, f"voxel_{start + i}")
            np.save(stem + ".npy", t.points)
            np.save(stem + ".meta.npy", np.array(
                [(t.grid_size, t.cell_id)],
                dtype=[("grid_size", "f8"), ("cell_id", "i8")]))
            if t.indices is not None:
                np.save(stem + ".indices.npy", t.indices)
    return tiles


def load_tiles(vxdir: str) -> List[Tile]:
    """Read tiles written by ``preprocess_cloud(vxdir=...)``, restoring
    grid_size/cell_id/indices from the sidecars when present."""
    tiles = []
    for f in sorted(
        glob.glob(os.path.join(vxdir, "voxel_*[0-9].npy")),
        key=lambda p: int(os.path.splitext(os.path.basename(p))[0].split("_")[1]),
    ):
        grid_size, cell_id = 0.0, -1
        meta = f[: -len(".npy")] + ".meta.npy"
        if os.path.exists(meta):
            m = np.load(meta)
            grid_size = float(m["grid_size"][0])
            cell_id = int(m["cell_id"][0])
        idx_file = f[: -len(".npy")] + ".indices.npy"
        indices = np.load(idx_file) if os.path.exists(idx_file) else None
        tiles.append(Tile(points=np.load(f), grid_size=grid_size,
                          cell_id=cell_id, indices=indices))
    return tiles
