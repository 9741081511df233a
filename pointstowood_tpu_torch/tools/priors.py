"""Geometric priors: eigen-feature (linearity/planarity) per point (port
of pointstowood_tpu/tools/priors.py as torch tensor code on the device).

Rebuilds the archived prior computation
(reference: pointstowood/archive/prior_gpu.py:56-85): per point, take the
k nearest neighbors, form the 3x3 neighborhood covariance, compute its
eigenvalue ratios, and output max(linearity, planarity) — a wood-ness
geometric prior. Neighbour indices come from the host kNN
(``predict/fusion.knn_indices``), as in the JAX package; the covariances
and the closed-form symmetric 3x3 eigenvalues (no LAPACK) run on the
device in chunks of ``chunk`` points. Every step is elementwise fp32
(fp64 where a fused multiply-add or a square root must round once), in
a fixed order, so the card, the CPU and the JAX tool's CPU code round
alike (``_eigvals_sym3x3`` says why that matters); no TF32 product (the
JAX package's ``Precision.HIGHEST``). Each point's row is computed
alone, so the last chunk needs no padding.

Run: python -m pointstowood_tpu_torch.tools.priors cloud.ply --k 128
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from pointstowood_tpu_torch.data.tiling import xyz_of
from pointstowood_tpu_torch.io import extra_columns, load_file, save_file
from pointstowood_tpu_torch.predict.fusion import knn_indices
from pointstowood_tpu_torch.utils.device import resolve_device


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 a * b + c rounded once: the product is exact in fp64, the sum
    is rounded to fp64 and then to fp32 (the two roundings differ from
    one only where the first lands on a tie of the second)."""
    return (a.double() * b.double() + c.double()).float()


def _fma_sum(pairs) -> torch.Tensor:
    """sum of a * b over ``pairs`` in order, as one chain of fused
    multiply-adds (the first product rounded alone)."""
    (a, b), *rest = pairs
    s = a * b
    for a, b in rest:
        s = _fma(a, b, s)
    return s


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices: the rule of Sarrus's six
    products in ``jnp.linalg.det``'s 3x3 order, each later product fused
    into the running sum."""
    def e(i, j):
        return m[..., i, j]

    s = _fma(e(0, 0) * e(1, 1), e(2, 2), e(0, 1) * e(1, 2) * e(2, 0))
    s = _fma(e(0, 2) * e(1, 0), e(2, 1), s)
    s = _fma(-(e(0, 2) * e(1, 1)), e(2, 0), s)
    s = _fma(-(e(0, 0) * e(1, 2)), e(2, 1), s)
    return _fma(-(e(0, 1) * e(1, 0)), e(2, 2), s)


def _eigvals_sym3x3(cov: torch.Tensor) -> torch.Tensor:
    """Eigenvalues (descending) of symmetric (..., 3, 3) fp32 matrices,
    closed form (trigonometric; no LAPACK).

    Near a line the angle's cosine r lies within rounding of 1, where
    arccos turns each ulp of r into ~1e-4 of the priors: every step up to
    r rounds as the JAX tool's CPU code does (sums in index order, fused
    multiply-adds, constant divisors as reciprocal products)."""
    third = 1.0 / 3.0
    q = (cov[..., 0, 0] + cov[..., 1, 1] + cov[..., 2, 2]) * third
    eye = torch.eye(3, dtype=torch.bool, device=cov.device)
    a_q = torch.where(eye, cov - q[..., None, None], cov)
    flat = a_q.flatten(-2)
    p2 = _fma_sum([(flat[..., i], flat[..., i]) for i in range(9)])
    p2 = p2 * (1.0 / 6.0)
    # sqrt in fp64, then rounded: correctly rounded on every device
    p = torch.sqrt(torch.clamp(p2, min=1e-30).double()).float()
    r = torch.clamp(_det3(a_q / p[..., None, None]) * 0.5, -1.0, 1.0)
    phi = torch.arccos(r) * third
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return torch.stack([e1, e2, e3], dim=-1)


def _prior_chunk(nbr_xyz: torch.Tensor) -> torch.Tensor:
    """(n, k, 3) fp32 neighbor coordinates -> (n,) max(linearity,
    planarity).

    Matches prior_gpu.py:67-77 including its quirks: ratios NaN -> 0,
    linearity/planarity NaN-or-zero -> 0.5. The mean and the covariance
    are summed over the k neighbours in order (the covariance as fused
    multiply-adds, see ``_eigvals_sym3x3``)."""
    k = nbr_xyz.shape[1]
    total = nbr_xyz[:, 0]
    for j in range(1, k):
        total = total + nbr_xyz[:, j]
    centered = nbr_xyz - (total * (1.0 / k))[:, None]
    c = [centered[..., i] for i in range(3)]
    s = {(i, j): _fma_sum(list(zip(c[i].unbind(1), c[j].unbind(1))))
         * (1.0 / k) for i in range(3) for j in range(i, 3)}
    cov = torch.stack([torch.stack([s[min(i, j), max(i, j)] for j in range(3)],
                                   -1) for i in range(3)], -2)
    evals = _eigvals_sym3x3(cov)
    ratios = evals / evals.sum(dim=1, keepdim=True)
    ratios = torch.where(torch.isnan(ratios), 0.0, ratios)
    lin = (ratios[:, 0] - ratios[:, 1]) / ratios[:, 0]
    lin = torch.where(torch.isnan(lin) | (lin == 0), 0.5, lin)
    pla = (ratios[:, 1] - ratios[:, 2]) / ratios[:, 0]
    pla = torch.where(torch.isnan(pla) | (pla == 0), 0.5, pla)
    return torch.maximum(lin, pla)


def geometric_priors(xyz: np.ndarray, k: int = 128, chunk: int = 1 << 17,
                     indices: np.ndarray | None = None,
                     device=None) -> np.ndarray:
    """max(linearity, planarity) per point over its k-neighborhood, (n,)
    float32, computed on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    xyz = np.asarray(xyz, dtype=np.float64)
    k = min(k, xyz.shape[0])
    if indices is None:
        indices = knn_indices(xyz, xyz, k)
    pts = torch.from_numpy(xyz.astype(np.float32)).to(dev)
    n = xyz.shape[0]
    out = np.zeros(n, np.float32)
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        idx = torch.from_numpy(
            np.ascontiguousarray(indices[start:end, :k], np.int64)).to(dev)
        out[start:end] = _prior_chunk(pts[idx]).cpu().numpy()
    return out


def main(argv=None, device=None):
    p = argparse.ArgumentParser()
    p.add_argument("point_cloud")
    p.add_argument("--k", type=int, default=128)
    args = p.parse_args(argv)
    pc = load_file(args.point_cloud)
    pc["prior"] = geometric_priors(xyz_of(pc), k=args.k, device=device)
    out = args.point_cloud.replace(".ply", "_prior.ply")
    save_file(out, pc, additional_fields=extra_columns(pc))
    print(f"Saved {out}")


if __name__ == "__main__":
    main()
