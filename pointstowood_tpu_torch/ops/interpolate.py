"""Masked kNN inverse-distance interpolation (port of
pointstowood_tpu/ops/interpolate.py).

Replacement for PyG ``knn_interpolate`` in the FP decoder stages
(reference: pointstowood/src/model.py:149): each target averages the
features of its k nearest valid sources, weighted by
1 / max(d^2, 1e-16). Every route ends in ``interp_blend``, whose
``InterpBlend`` Function gives x its gradient (the backward kernel
``interp_blend_bwd`` on the card); the routes differ only in where the
(idx, d2) neighbours come from, and ``model.network.Net.stage_routes``
alone chooses among them.
"""

from __future__ import annotations

import math

import torch

from pointstowood_tpu_torch.ops.interp_kernels import (
    fused_supported,
    interp_blend,
)
from pointstowood_tpu_torch.ops.knn import knn_masked
from pointstowood_tpu_torch.ops.knn_kernels import knn_top2


def uses_fused_kernel(t_n: int, s_n: int, channels: int, k: int,
                      method: str, fused_max_sources: int) -> bool:
    """Whether the JAX package's FP stage takes its fused Pallas kernel at
    these static shapes (copied decision; ``fused_max_sources`` is 4096 in
    training and 2048 otherwise). ``model.network`` asks it once per stage
    and routes both the SA and the FP stage from the answer."""
    if k != 2 or method != "fast" or s_n > fused_max_sources:
        return False
    return fused_supported(t_n, s_n, channels)


def knn_interpolate_batched(
    x: torch.Tensor,
    pos: torch.Tensor,
    target_pos: torch.Tensor,
    k: int = 2,
    source_mask: torch.Tensor | None = None,
    target_mask: torch.Tensor | None = None,
    method: str = "exact",
    fused: bool = False,
    precomputed: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """x (B, S, C), pos (B, S, 3), target_pos (B, T, 3) -> (B, T, C) in
    x.dtype.

    Neighbour routes, decided by the caller:
      * ``precomputed=(idx, d2)``: the SA stage's transpose top-2
        (``ops/knn.knn_topk_with_transpose``), d2 +inf where invalid;
      * ``fused=True``: the port of the JAX fused kernel — ``knn_top2``
        then ``interp_blend`` (k must be 2);
      * otherwise the gather path: ``knn_masked`` search, then d2
        recomputed in fp32 from the gathered positions (as the JAX gather
        path does).
    Targets with no valid neighbour (padding) get zeros. Differentiable in
    x only: positions and neighbours are network inputs.
    """
    smask = (torch.ones(pos.shape[:2], dtype=torch.bool, device=pos.device)
             if source_mask is None else source_mask)
    tmask = (torch.ones(target_pos.shape[:2], dtype=torch.bool,
                        device=pos.device)
             if target_mask is None else target_mask)
    if precomputed is not None:
        idx, d2 = precomputed
    elif fused:
        if k != 2:
            raise ValueError("the fused interpolation route needs k == 2")
        d2, idx = knn_top2(target_pos.float().contiguous(),
                           pos.float().contiguous(), smask)
    else:
        # imported here: model/ imports this module
        from pointstowood_tpu_torch.model.pointconv import gather_rows

        idx, _, valid = knn_masked(target_pos, pos, k, query_mask=tmask,
                                   source_mask=smask, method=method)
        rel = gather_rows(pos.float(), idx) - target_pos.float()[:, :, None]
        sq = rel * rel
        d2 = torch.where(valid, (sq[..., 0] + sq[..., 1]) + sq[..., 2],
                         math.inf)
    return interp_blend(x, idx, d2, tmask)
