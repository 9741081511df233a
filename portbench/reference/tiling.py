"""Plain numpy reference of the tiling and batching of a cloud.

The reference Voxelise pipeline (pointstowood/src/preprocessing.py:9-131)
as the port and the JAX package define it: heights above a 5 m ground
grid, reflectance quantile-normalised to [-1, 1], one tile per occupied
cell of each grid size with at least ``min_pts`` points, cells past
``max_pts`` subsampled by reflectance-weighted draws without replacement
(Efraimidis-Spirakis keys from ``default_rng(141190)`` in cell order
over the scales). Then the padded batches: each tile centred on its mean
and scaled by its largest norm, tiles bucketed into capacities (powers of
two from 256 with the 1.5x steps for inference, steps of 8 for training,
sparse buckets merged upwards).
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfinv

TILING_SEED = 141190
GROUND_GRID = 5.0
MERGE_FRACTION = 0.08


def quantile_normalize(r: np.ndarray) -> np.ndarray:
    r = np.asarray(r, np.float32)
    n = r.shape[0]
    ranks = np.argsort(np.argsort(r, kind="stable"), kind="stable")
    q = (ranks.astype(np.float32) + 1.0) / (n + 1.0)
    q = np.clip(q, 1e-7, 1.0 - 1e-7)
    z = erfinv(2.0 * q - 1.0).astype(np.float32) * np.float32(np.sqrt(2.0))
    return 2.0 * (z - z.min()) / (z.max() - z.min()) - 1.0


def ground_heights(xyz: np.ndarray) -> np.ndarray:
    """z above the lowest point of the point's 5 m x 5 m column."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    xi = np.floor((x - x.min()) / GROUND_GRID).astype(np.int64)
    yi = np.floor((y - y.min()) / GROUND_GRID).astype(np.int64)
    cell = xi * (yi.max() + 1) + yi
    low = np.full(cell.max() + 1, np.inf)
    np.minimum.at(low, cell, z)
    return (z - low[cell]).astype(np.float32)


def cell_ids(xyz32: np.ndarray, size: float) -> np.ndarray:
    """Packed cell id of each point on a grid from the cloud's minimum."""
    cells = np.floor((xyz32 - xyz32.min(axis=0)) / size).astype(np.int64)
    ext = cells.max(axis=0) + 1
    return (cells[:, 0] * ext[1] + cells[:, 1]) * ext[2] + cells[:, 2]


def tile_cloud(xyz: np.ndarray, refl: np.ndarray, grid_sizes, min_pts: int,
               max_pts: int, labels: np.ndarray | None = None):
    """The tiles of one cloud: a list of dicts with ``points`` (n, 4|5)
    float32 [x, y, z, reflectance, (label)], ``grid_size``, ``cell_id``
    and ``indices`` (the cloud rows). Also returns the (n, 1) heights."""
    rng = np.random.default_rng(TILING_SEED)
    heights = ground_heights(xyz)
    xyz32 = xyz.astype(np.float32)
    r = np.asarray(refl, np.float32)
    weighted = not np.all(r == 0)
    if weighted:
        r = quantile_normalize(r)
    cols = [xyz32, r[:, None]]
    if labels is not None:
        cols.append(np.asarray(labels, np.float32)[:, None])
    data = np.concatenate(cols, axis=1)
    weight = (r - r.min() + 1e-8) if weighted else None
    tiles = []
    for size in grid_sizes:
        ids = cell_ids(xyz32, float(size))
        order = np.argsort(ids, kind="stable")
        sids = ids[order]
        cuts = np.flatnonzero(np.diff(sids)) + 1
        for cid, rows in zip(sids[np.concatenate([[0], cuts])].tolist(),
                             np.split(order, cuts)):
            if rows.size < min_pts:
                continue
            if rows.size > max_pts:
                if weight is not None:
                    keys = np.log(rng.random(rows.size)) / weight[rows]
                    rows = rows[np.argpartition(keys, -max_pts)[-max_pts:]]
                else:
                    rows = rows[rng.integers(0, rows.size, size=max_pts)]
            rows = rows[~np.isnan(data[rows]).any(axis=1)]
            if rows.size:
                tiles.append({"points": data[rows], "grid_size": float(size),
                              "cell_id": int(cid),
                              "indices": rows.astype(np.int64)})
    return tiles, heights


def capacities(min_pts: int, max_pts: int, step: int, half: bool):
    caps, c = [], 256
    while c < max_pts:
        if c >= min_pts:
            caps.append(c)
        c *= step
    caps.append(max_pts)
    if half:
        extra = [c * 3 // 2 for c in caps
                 if (c * 3 // 2) % 1024 == 0 and min_pts <= c * 3 // 2 < max_pts]
        caps = sorted(set(caps) | set(extra))
    return caps


def _fit(caps, n):
    return next((c for c in caps if n <= c), caps[-1])


def inference_capacities(sizes, min_pts: int, max_pts: int):
    """The padded capacity of each tile of an inference run: the smallest
    bucket that holds it, buckets holding under 8% of the padded points
    merged into the next."""
    caps = capacities(min_pts, max_pts, 2, True)
    tile_cap = [_fit(caps, n) for n in sizes]
    counts = {}
    for c in tile_cap:
        counts[c] = counts.get(c, 0) + 1
    total = sum(c * k for c, k in counts.items())
    merged = True
    while merged and len(counts) > 1:
        merged = False
        present = sorted(counts)
        for i, c in enumerate(present[:-1]):
            if c * counts[c] < MERGE_FRACTION * total:
                counts[present[i + 1]] += counts.pop(c)
                merged = True
                break
    kept = sorted(counts)
    return [next((k for k in kept if k >= c), kept[-1]) for c in tile_cap]


def pad(points_list, capacity: int, with_labels: bool = False) -> dict:
    """Tiles (n_i, 4|5) -> one padded batch: centred positions, reflectance,
    mask, scale factor (largest norm), shift, labels."""
    b = len(points_list)
    out = {"pos": np.zeros((b, capacity, 3), np.float32),
           "refl": np.zeros((b, capacity), np.float32),
           "mask": np.zeros((b, capacity), bool),
           "sf": np.ones(b, np.float32),
           "shift": np.zeros((b, 3), np.float32)}
    if with_labels:
        out["labels"] = np.zeros((b, capacity), np.float32)
    for i, t in enumerate(points_list):
        n = min(t.shape[0], capacity)
        if n == 0:
            continue
        xyz = t[:n, :3].astype(np.float32)
        s = xyz.mean(axis=0)
        xyz = xyz - s
        out["pos"][i, :n] = xyz
        out["refl"][i, :n] = t[:n, 3]
        out["mask"][i, :n] = True
        out["sf"][i] = max(float(np.sqrt((xyz ** 2).sum(axis=1)).max()), 1e-12)
        out["shift"][i] = s
        if with_labels:
            out["labels"][i, :n] = t[:n, 4]
    return out


def training_batches(tiles, batch_size: int, min_pts: int, max_pts: int,
                     seed: int, epoch: int = 0):
    """The shuffled mixed-size batches of one training epoch (the
    reference's shuffled DataLoader): tiles in ``default_rng(seed +
    epoch)`` order, ``batch_size`` a batch (the last padded with empty
    tiles), each padded to its largest tile's bucket."""
    caps = capacities(min_pts, max_pts, 8, False)
    order = np.arange(len(tiles))
    np.random.default_rng(seed + epoch).shuffle(order)
    for lo in range(0, len(order), batch_size):
        pts = [tiles[i]["points"] for i in order[lo:lo + batch_size]]
        cap = _fit(caps, max(p.shape[0] for p in pts))
        pts += [np.zeros((0, pts[0].shape[1]), np.float32)] * (
            batch_size - len(pts))
        yield pad(pts, cap, with_labels=True)
