"""Fixed-count masked sampling (port of pointstowood_tpu/ops/sampling.py).

The reference samples a dynamic 50% of the points at train time
(pointstowood/src/model.py:97-101); here the selection is compacted into
a static number of slots with a validity mask, over a (B, N) batch. The
draw comes from a caller-given ``torch.Generator``: JAX's PRNG cannot be
matched, so the tests hold the draw to its invariants.
"""

from __future__ import annotations

import torch


def compact_indices(select: torch.Tensor, capacity: int):
    """Compact the indices of True entries of ``select`` (B, N) into
    ``capacity`` slots. Returns (idx (B, capacity) int64 ascending, valid
    (B, capacity) bool); overflow keeps the lowest indices, empty slots
    hold index 0."""
    n = select.shape[-1]
    ar = torch.arange(n, device=select.device).expand_as(select)
    key = torch.where(select, ar, n)
    key = torch.sort(key, dim=-1).values[..., :capacity]
    if key.shape[-1] < capacity:
        key = torch.nn.functional.pad(key, (0, capacity - key.shape[-1]),
                                      value=n)
    valid = key < n
    return torch.where(valid, key, 0), valid


def random_sample(mask: torch.Tensor, capacity: int,
                  generator: torch.Generator | None,
                  fraction: float = 0.5, group=None):
    """Uniformly draw ``floor(n_valid * fraction)`` valid points of each
    row of ``mask`` (B, N) without replacement into ``capacity`` slots
    (reference random_sample, model.py:97-101: exactly 50%, sorted
    indices). ``generator`` lives on ``mask``'s device. Returns (idx (B,
    capacity) int64 ascending, valid (B, capacity) bool).

    ``group`` (a ``parallel.DataGroup``): ``mask`` holds this process's
    rows of a global batch of B * W rows (``parallel.shard_rows``); the
    scores of the whole global batch are drawn and this process's rows
    kept, so each process picks the centres one process would pick for
    the same rows, and every generator advances alike."""
    b, n = mask.shape
    n_valid = mask.sum(-1)
    n_take = torch.clamp((n_valid * fraction).to(torch.int64), max=capacity)
    if group is None or group.world_size == 1:
        score = torch.rand((b, n), generator=generator, device=mask.device)
    else:
        score = torch.rand((b * group.world_size, n), generator=generator,
                           device=mask.device)[group.rank * b:
                                               (group.rank + 1) * b]
    score = torch.where(mask, score, torch.inf)  # invalid points sort last
    order = torch.argsort(score, dim=-1)
    chosen = torch.arange(n, device=mask.device) < n_take[:, None]
    select = torch.zeros_like(mask).scatter(1, order, chosen)
    return compact_indices(select, capacity)
