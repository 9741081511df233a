"""Fixed-k PointNet set-abstraction convolution (port of
pointstowood_tpu/model/pointconv.py).

The reference's edge-list PointNetConv (pointstowood/src/pointnet.py:
20-132) becomes: gather the (B, S, k) neighbourhoods, build per-edge
messages ``[x_j, (pos_j - pos_i) / (max_dist_i + 1e-8), reflectance_j]``,
run the local MLP over the dense (B, S, k, C) block and take a masked max
over k. Geometry stays fp32; the MLP runs in the compute dtype.

Positions are network inputs and carry no gradient (the JAX package's
dead-tail gather VJP); features get theirs through ``index_select``'s
backward, an index_add. The masked max is ``amax``, whose gradient splits
among ties as ``jnp.max``'s does (``max(dim)`` would give it to one).
"""

from __future__ import annotations

import torch
from torch import nn

from pointstowood_tpu_torch.model.layers import RefMLP


def gather_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: arr (B, N, C), idx (B, ...) -> (B, ..., C),
    as one flat gather from (B*N, C) with offset indices."""
    b, n, c = arr.shape
    offs = torch.arange(b, device=idx.device, dtype=torch.int64) * n
    flat = (idx.reshape(b, -1).long() + offs[:, None]).reshape(-1)
    return arr.reshape(b * n, c).index_select(0, flat).reshape(
        idx.shape + (c,))


class PointConv(nn.Module):
    """One set-abstraction conv over a padded batch.

    forward(x, pos4, center_idx, nbr_idx, nbr_valid, center_valid,
    radius=None, stem_edge=None, sf=None, use_running_average=True):
      x: (B, N, C_in) source features, or None when ``stem_edge`` is given
        (SA1 recomputes the stem on the gathered positions: the stem is a
        per-point function of the unscaled position, and gather commutes
        with it);
      pos4: (B, N, 4) xyz divided by the per-sample scale factor, plus
        unscaled reflectance;
      center_idx (B, S), nbr_idx (B, S, k), nbr_valid (B, S, k),
      center_valid (B, S);
      radius: optional (B, 1, 1) cap in the scaled frame (SA1);
      sf: (B,) scale factors (needed with stem_edge);
      use_running_average: BatchNorm mode of the local MLP, whose batch
        statistics run over the valid neighbours after the radius cap.
    Returns (B, S, C_out), zero at centres without a valid neighbour.
    """

    def __init__(self, channels: tuple, dtype=torch.float32):
        super().__init__()
        self.local_nn = RefMLP(channels, dtype)
        self.dtype = dtype

    def forward(self, x, pos4, center_idx, nbr_idx, nbr_valid, center_valid,
                radius=None, stem_edge=None, sf=None, use_running_average=True):
        dt = self.dtype
        pos_j = gather_rows(pos4, nbr_idx)                 # (B, S, k, 4)
        pos_i = gather_rows(pos4, center_idx)              # (B, S, 4)
        rel = pos_j[..., :3] - pos_i[:, :, None, :3]       # (B, S, k, 3)
        sq = rel * rel
        # sqrt(sum + tiny), as the JAX package (a zero distance has a NaN
        # norm gradient there)
        dist = torch.sqrt(sq.sum(-1) + 1e-24)
        if radius is not None:
            nbr_valid = nbr_valid & (dist <= radius)
        max_dist = torch.where(nbr_valid, dist, 0.0).amax(-1, keepdim=True)
        geo = (rel / (max_dist[..., None] + 1e-8)).to(dt)
        refl_j = pos_j[..., 3:4].to(dt)
        if stem_edge is not None:
            pos_un = pos_j[..., :3] * sf[:, None, None, None]
            parts = [stem_edge(pos_un).to(dt), geo, refl_j]
        elif x is None:
            parts = [geo, refl_j]
        else:
            parts = [gather_rows(x, nbr_idx).to(dt), geo, refl_j]
        msg = self.local_nn(torch.cat(parts, dim=-1), mask=nbr_valid,
                            use_running_average=use_running_average)
        neg = torch.finfo(msg.dtype).min
        out = torch.where(nbr_valid[..., None], msg, neg).amax(dim=-2)
        any_nbr = nbr_valid.any(-1) & center_valid
        return torch.where(any_nbr[..., None], out, 0.0).to(msg.dtype)
