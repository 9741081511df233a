"""Host-path fusion of per-tile predictions onto the original cloud (port
of pointstowood_tpu/predict/fusion.py on column tables).

Every original point queries its k nearest classified points with an
exact global search (scipy ``cKDTree``, all cores), then takes the median
of their wood probabilities as ``pwood`` and a probability-weighted vote
as ``label`` (reference: pointstowood/src/predicter.py:107-142). The
median and vote run as plain torch on the fusion device.

This is the path for tilings that the device pair path declines (one
grid scale, ``cluster_features``, ``min_pts < 32``; see
``device_fusion.declines``), and for every tiling when the working
directory holds the reference's neighbour cache ``nbrs.npy``: its (N, k)
indices of the original points into the classified rows are used as they
are, with no search (reference predicter.py:131-134, JAX
predict/fusion.py:189-192).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pointstowood_tpu_torch.data.tiling import xyz_of
from pointstowood_tpu_torch.utils.device import resolve_device

# the reference's fusion neighbour cache, read from the working directory
NBRS_CACHE = "nbrs.npy"


def _fuse_chunk(prob: torch.Tensor, idx: torch.Tensor, is_wood: float,
               any_wood: float):
    """Median prob + vote for one (n, k) index chunk (the JAX
    ``_fuse_chunk``). prob (M,) f32 classified wood probabilities; each
    neighbour's prediction is prob >= is_wood. The median averages the two
    middle values (``jnp.median``; ``torch.median`` would return the lower
    one)."""
    p = prob[idx]  # (n, k)
    c = (p >= is_wood).to(p.dtype)
    k = p.shape[1]
    ps = torch.sort(p, dim=1).values
    pwood = (ps[:, (k - 1) // 2] + ps[:, k // 2]) * 0.5
    if any_wood == 1:
        # probability-weighted vote between class 0 and 1; ties -> 0
        zero = torch.zeros_like(p)
        vote1 = torch.where(c == 1, p, zero).sum(1)
        vote0 = torch.where(c == 0, p, zero).sum(1)
        label = (vote1 > vote0).to(torch.float32)
    else:
        # any neighbour predicted wood (pred > any_wood, pred in {0, 1})
        label = (c > any_wood).any(1).to(torch.float32)
    return label, pwood


def _auto_chunk(k: int) -> int:
    """Queries per fusion chunk: ~3 (chunk, k) fp32 temporaries capped
    near 512 MB, a power of two."""
    n = max(1 << 16, (1 << 29) // (12 * k))
    return 1 << (n.bit_length() - 1)


def knn_indices(source_xyz: np.ndarray, query_xyz: np.ndarray,
                k: int) -> np.ndarray:
    """Exact (N, k) nearest-source indices per query (scipy cKDTree over
    every core)."""
    from scipy.spatial import cKDTree

    _, idx = cKDTree(source_xyz).query(query_xyz, k=k, workers=-1)
    if k == 1:
        idx = idx[:, None]
    return idx


def fuse_labels(
    classified: np.ndarray,
    query_xyz: np.ndarray,
    is_wood: float,
    any_wood: float,
    chunk: int | None = None,
    indices: np.ndarray | None = None,
    device=None,
) -> np.ndarray:
    """(N, 2) float64 [label, pwood] for every query point, on ``device``
    (default CUDA).

    classified: (M, >=5) rows [x, y, z, ..., pred, prob] as
    ``run_inference`` returns them (prob last). k = 64 neighbours when
    any_wood == 1, else 32 (reference predicter.py:137)."""
    dev = resolve_device(device)
    k = 64 if any_wood == 1 else 32
    m = classified.shape[0]
    k = min(k, m)
    if chunk is None:
        chunk = _auto_chunk(k)
    if indices is None:
        indices = knn_indices(classified[:, :3], query_xyz, k)
    prob = torch.from_numpy(classified[:, -1].astype(np.float32)).to(dev)
    out = np.zeros((query_xyz.shape[0], 2), np.float64)
    for start in range(0, query_xyz.shape[0], chunk):
        idx = torch.from_numpy(
            np.ascontiguousarray(indices[start:start + chunk], np.int64)
        ).to(dev)
        label, pwood = _fuse_chunk(prob, idx, is_wood, any_wood)
        out[start:start + chunk, 0] = label.cpu().numpy()
        out[start:start + chunk, 1] = pwood.cpu().numpy()
    return out


class Fusion:
    """Reference PointCloudClassifier equivalent (predicter.py:107-142)."""

    def __init__(self, is_wood: float, any_wood: float, device=None):
        self.is_wood = is_wood
        self.any_wood = any_wood
        self.device = device

    def collect_predictions(self, classification: np.ndarray | None,
                            original: dict,
                            indices: np.ndarray | None = None,
                            fused: np.ndarray | None = None) -> dict:
        """A new column table: ``original``'s columns (less ``pleaf``) with
        ``label`` and ``pwood`` set. ``indices``: optional precomputed
        (N, k) neighbour indices of the original points into the
        classified rows, else those of ``nbrs.npy`` in the working
        directory where it exists, else an exact search; ``fused``:
        optional precomputed (N, 2) [label, pwood] (the device pair
        path). The caller's table is not modified."""
        out = {c: v for c, v in original.items() if c != "pleaf"}
        if fused is None and indices is None and os.path.exists(NBRS_CACHE):
            indices = np.load(NBRS_CACHE)
            n = len(out["x"])
            if indices.ndim != 2 or indices.shape[0] != n:
                raise ValueError(
                    f"{NBRS_CACHE}: indices of shape {indices.shape} do not "
                    f"name k neighbours for each of the {n} points")
        if fused is None:
            fused = fuse_labels(classification, xyz_of(out), self.is_wood,
                                self.any_wood, indices=indices,
                                device=self.device)
        out["label"] = fused[:, 0]
        out["pwood"] = fused[:, 1]
        return out
