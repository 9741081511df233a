"""Plain reference of the fusion of tile predictions onto the cloud.

Every point of the cloud takes the median of its nearest classified
points' wood probabilities as ``pwood`` and, at ``any_wood == 1``, the
probability-weighted vote of their thresholded predictions as ``label``
(else: wood where any neighbour's prediction exceeds ``any_wood``)
(pointstowood/src/predicter.py:107-142). Where the neighbours are
searched is the port's and the JAX package's definition, not the
published global search:

* two grid scales (the pair path): the 64 nearest points of the union of
  the point's fine tile and its coarse tile (a cell without a tile takes
  the tile of that scale with the nearest centroid); probabilities on
  the 10-bit payload grid, ``pwood`` on a 2046-step grid;
* one grid scale (the index path): the 32 nearest points of the point's
  own tile (by the configuration's 3-D search over a window of the next
  power of two from 2048 rows), and, for a point whose cell has no tile,
  the 32 nearest classified points of the whole cloud.

``rows`` are the cloud rows judged; ``probs_for(tile_ids)`` returns the
reference probabilities of those tiles (tile id -> (n,) float32).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.net import knn
from portbench.reference.tiling import cell_ids

PAYLOAD_MAX = 1023
PWOOD_STEPS = 2046


def _vote(p: np.ndarray, valid: np.ndarray, is_wood: float, any_wood: float):
    """(label, median) of each row of neighbour probabilities p (n, k)
    over its valid slots, in float32 as the program rounds them."""
    p = p.astype(np.float32)
    cnt = valid.sum(1)
    ps = np.sort(np.where(valid, p, np.inf), axis=1)
    k = p.shape[1]
    lo = np.clip((cnt - 1) // 2, 0, k - 1)
    hi = np.clip(cnt // 2, 0, k - 1)
    r = np.arange(len(p))
    med = np.where(cnt > 0, (ps[r, lo] + ps[r, hi]) * np.float32(0.5),
                   np.float32(0.0))
    c = p >= is_wood
    if any_wood == 1:
        vote1 = np.where(valid & c, p, 0).sum(1, dtype=np.float32)
        vote0 = np.where(valid & ~c, p, 0).sum(1, dtype=np.float32)
        label = vote1 > vote0
    else:
        label = (valid & (c.astype(np.float32) > any_wood)).any(1)
    return label.astype(np.float64), med


def _tile_of_cells(tiles, scale, ids):
    sel = [t for t, tile in enumerate(tiles) if tile["grid_size"] == scale]
    by_cell = {tiles[t]["cell_id"]: t for t in sel}
    return np.array([by_cell.get(int(c), -1) for c in ids]), sel


def pair_path(tiles, xyz, rows, probs_for, is_wood, any_wood, device):
    k = 64 if any_wood == 1 else 32
    xyz32 = xyz.astype(np.float32)
    scales = sorted({t["grid_size"] for t in tiles})
    owner = np.empty((len(rows), 2), np.int64)
    for si, scale in enumerate(scales):
        ids = cell_ids(xyz32, scale)[rows]
        own, sel = _tile_of_cells(tiles, scale, ids)
        miss = np.flatnonzero(own < 0)
        if miss.size:
            cents = np.stack([tiles[t]["points"][:, :3].mean(axis=0)
                              for t in sel])
            d2 = ((xyz32[rows[miss]][:, None, :] - cents[None]) ** 2).sum(-1)
            own[miss] = np.asarray(sel)[np.argmin(d2, axis=1)]
        owner[:, si] = own
    probs = probs_for(sorted(set(owner.ravel().tolist())))
    label = np.empty(len(rows))
    pwood = np.empty(len(rows))
    for pair in {tuple(p) for p in owner.tolist()}:
        sel = np.flatnonzero((owner[:, 0] == pair[0]) & (owner[:, 1] == pair[1]))
        src = np.concatenate([tiles[t]["points"][:, :3] for t in pair])
        pay = np.concatenate([probs[t] for t in pair])
        pay = np.round(np.clip(pay.astype(np.float32), 0, 1)
                       * np.float32(PAYLOAD_MAX)) / np.float32(PAYLOAD_MAX)
        q = torch.from_numpy(xyz32[rows[sel]]).to(device)[None]
        s = torch.from_numpy(src).to(device)[None]
        ones = torch.ones(s.shape[:2], dtype=torch.bool, device=device)
        idx, _, valid = knn(q, s, min(k, src.shape[0]),
                            torch.ones(q.shape[:2], dtype=torch.bool,
                                       device=device), ones)
        idx, valid = idx[0].cpu().numpy(), valid[0].cpu().numpy()
        lab, med = _vote(pay[idx], valid, is_wood, any_wood)
        label[sel] = lab
        code = np.round(np.clip(med, 0, 1) * np.float32(PWOOD_STEPS))
        pwood[sel] = code.astype(np.float64) * (1.0 / PWOOD_STEPS)
    return label, pwood


def next_cap(n: int) -> int:
    cap = 2048
    while cap < n:
        cap *= 2
    return cap


def index_path(tiles, xyz, rows, probs_for, is_wood, any_wood, device):
    from scipy.spatial import cKDTree

    k = 64 if any_wood == 1 else 32
    (scale,) = {t["grid_size"] for t in tiles}
    if k != 32:
        raise ValueError("the index path serves one grid scale at k = 32")
    xyz32 = xyz.astype(np.float32)
    own, _ = _tile_of_cells(tiles, scale, cell_ids(xyz32, scale)[rows])
    src_tile = np.concatenate([np.full(len(t["points"]), i)
                               for i, t in enumerate(tiles)])
    src_row = np.concatenate([np.arange(len(t["points"])) for t in tiles])
    nbr_tile = np.empty((len(rows), k), np.int64)
    nbr_row = np.empty((len(rows), k), np.int64)
    miss = np.flatnonzero(own < 0)
    if miss.size:
        allpts = np.concatenate([t["points"][:, :3] for t in tiles])
        _, gi = cKDTree(allpts).query(xyz[rows[miss]], k=k)
        nbr_tile[miss], nbr_row[miss] = src_tile[gi], src_row[gi]
    for t in sorted(set(own[own >= 0].tolist())):
        sel = np.flatnonzero(own == t)
        pts = tiles[t]["points"][:, :3]
        cap = next_cap(len(pts))
        s = torch.zeros((1, cap, 3), device=device)
        s[0, :len(pts)] = torch.from_numpy(pts).to(device)
        smask = torch.arange(cap, device=device)[None] < len(pts)
        q = torch.from_numpy(xyz32[rows[sel]]).to(device)[None]
        idx, _, _ = knn(q, s, k, torch.ones(q.shape[:2], dtype=torch.bool,
                                            device=device), smask)
        nbr_tile[sel] = t
        nbr_row[sel] = idx[0].cpu().numpy()
    probs = probs_for(sorted(set(nbr_tile.ravel().tolist())))
    p = np.stack([probs[t][r] for t, r in zip(nbr_tile.ravel(),
                                               nbr_row.ravel())]
                 ).reshape(nbr_tile.shape)
    label, med = _vote(p, np.ones_like(p, dtype=bool), is_wood, any_wood)
    return label, med.astype(np.float64)
