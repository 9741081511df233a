"""Poly-1 focal loss on sigmoid logits (port of
pointstowood_tpu/train/loss.py).

Reimplementation of the reference Poly1FocalLoss
(reference: pointstowood/src/loss.py:6-79), including its stability
clamps: logits to [-10, 10], CE to <=100, focal weight to <=2, poly term to
<=100, final loss to [0, 100], NaN -> 0. The trainer instantiates it with
gamma=2, alpha=None, label_smoothing=0.1, reduction='mean'
(reference trainer.py:116).
"""

from __future__ import annotations

import torch

from pointstowood_tpu_torch.parallel.mesh import all_reduce_sum_


def _clip(x: torch.Tensor, lo: float | None = None,
          hi: float | None = None) -> torch.Tensor:
    """jnp.clip: maximum, then minimum, so that a value exactly at a bound
    splits its gradient between the two operands as JAX's does
    (torch.clamp would pass all of it)."""
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor):
    """Numerically stable binary cross entropy with logits."""
    return (torch.maximum(logits, logits.new_tensor(0.0)) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def poly1_focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    epsilon: float = 0.1,
    gamma: float = 2.0,
    alpha: float | None = None,
    label_smoothing: float | None = None,
    mask: torch.Tensor | None = None,
    reduction: str = "mean",
    eps: float = 1e-6,
    group=None,
):
    """Returns (loss, gamma) like the reference forward (loss.py:79).

    ``group`` (a ``parallel.DataGroup``; with ``mask`` and
    ``reduction="mean"``): ``logits`` are this process's rows of a global
    batch, and the masked mean divides this process's sum by the global
    batch's count of valid points. The processes' losses then add up to
    the global batch's, and so do their gradients (the trainer sums
    them, as the JAX package's partitioner does)."""
    logits = _clip(logits.float(), -10.0, 10.0)
    labels = labels.float()
    if label_smoothing is not None:
        labels = labels * (1.0 - label_smoothing) + 0.5 * label_smoothing

    p = _clip(torch.sigmoid(logits), eps, 1.0 - eps)
    ce = _clip(_bce_with_logits(logits, labels), hi=100.0)
    pt = _clip(labels * p + (1.0 - labels) * (1.0 - p), eps, 1.0 - eps)
    focal_weight = _clip(torch.pow(1.0 - pt, gamma), hi=2.0)
    loss = focal_weight * ce
    if alpha is not None:
        alpha_t = alpha * labels + (1.0 - alpha) * (1.0 - labels)
        loss = alpha_t * loss
    poly = _clip(epsilon * torch.pow(1.0 - pt, gamma + 1.0), hi=100.0)
    loss = _clip(loss + poly, 0.0, 100.0)
    loss = torch.where(torch.isnan(loss), 0.0, loss)

    if mask is not None:
        m = mask.to(loss.dtype)
        if reduction == "mean":
            count = all_reduce_sum_(group, torch.sum(m))
            loss = torch.sum(loss * m) / _clip(count, 1.0)
        elif reduction == "sum":
            loss = torch.sum(loss * m)
        else:
            loss = loss * m
    elif reduction == "mean":
        loss = torch.mean(loss)
    elif reduction == "sum":
        loss = torch.sum(loss)
    return loss, gamma
