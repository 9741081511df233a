"""Reflectance quantile normalization and ground height normalization
(copy of the host numpy half of pointstowood_tpu/ops/normalization.py:
``quantile_normalize_np`` and ``ground_normalize_np``).

The arithmetic is the JAX package's numpy and ``scipy.special.erfinv`` in
float32, call for call, so the results are bit-identical to it
(``torch.special.erfinv`` rounds differently). Reference:
pointstowood/src/preprocessing.py:18-30 (quantile normalization) and
:37-53 (coarse ground model).
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfinv as _erfinv_np

_SQRT2 = float(np.sqrt(2.0))


def quantile_normalize_np(reflectance: np.ndarray) -> np.ndarray:
    """Rank -> empirical quantile -> inverse-normal -> min-max rescale to
    [-1, 1]: quantile (rank+1)/(n+1) clamped to [1e-7, 1-1e-7],
    erfinv(2q-1)*sqrt(2), then a linear rescale. Ties break by input
    order (argsort of argsort), as in the reference."""
    r = np.asarray(reflectance, dtype=np.float32)
    if np.isnan(r).any():
        raise ValueError("Input reflectance tensor contains NaN values.")
    n = r.shape[0]
    ranks = np.argsort(np.argsort(r, kind="stable"), kind="stable")
    q = (ranks.astype(np.float32) + 1.0) / (n + 1.0)
    q = np.clip(q, 1e-7, 1.0 - 1e-7)
    z = _erfinv_np(2.0 * q - 1.0).astype(np.float32) * _SQRT2
    zmin, zmax = z.min(), z.max()
    return 2.0 * (z - zmin) / (zmax - zmin) - 1.0


def ground_normalize_np(xyz: np.ndarray, grid_resolution: float = 5.0) -> np.ndarray:
    """Height above a coarse per-cell ground model: n_z = z - min z of the
    point's (grid_resolution x grid_resolution) xy cell (reference
    gpu_ground, preprocessing.py:37-53), as a sort + segment-min."""
    xyz = np.asarray(xyz)
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    xi = np.floor((x - x.min()) / grid_resolution).astype(np.int64)
    yi = np.floor((y - y.min()) / grid_resolution).astype(np.int64)
    cell = xi * (yi.max() + 1) + yi
    order = np.argsort(cell, kind="stable")
    sc = cell[order]
    new_seg = np.empty(sc.shape[0], bool)
    new_seg[0] = True
    np.not_equal(sc[1:], sc[:-1], out=new_seg[1:])
    starts = np.flatnonzero(new_seg)
    seg_min = np.minimum.reduceat(z[order], starts)
    rank = np.cumsum(new_seg) - 1
    out = np.empty(z.shape[0], np.float32)
    out[order] = (z[order] - seg_min[rank]).astype(np.float32)
    return out
