"""Segment reductions over padded id arrays (port of
pointstowood_tpu/ops/segment.py).

Masked replacements for the torch-scatter kernels the reference leans on
(scatter_max at pointnet.py:122, scatter_min at preprocessing.py:49,
global_max_pool at model.py:136), in plain torch (``scatter_reduce``,
``index_add``): the port depends on no torch-scatter. ``segment_ids``
(M,) labels the rows of ``data`` (M, ...); ids outside
[0, num_segments) are dropped, as JAX's segment ops drop them, and so
are rows where ``mask`` (M,) is False. Like the rest of the port's model, the
network itself needs none of them (fixed-k gathers and masked axis
reductions).
"""

from __future__ import annotations

import torch


def _kept(data, segment_ids, num_segments, mask):
    """(ids with the dropped rows' set to 0, kept (M, 1, ...) bool)."""
    ids = segment_ids.long()
    kept = (ids >= 0) & (ids < num_segments)
    if mask is not None:
        kept = kept & mask
    return (torch.where(kept, ids, 0),
            kept.reshape((-1,) + (1,) * (data.dim() - 1)))


def _reduce(data, segment_ids, num_segments, mask, fill, how):
    ids, kept = _kept(data, segment_ids, num_segments, mask)
    rows = torch.where(kept, data, fill)
    out = torch.full((num_segments,) + tuple(data.shape[1:]), fill,
                     dtype=data.dtype, device=data.device)
    index = ids.reshape(kept.shape).expand_as(rows)
    return out.scatter_reduce(0, index, rows, how, include_self=True)


def segment_max(data, segment_ids, num_segments: int, mask=None):
    """Per-segment max; empty segments yield 0 (torch-scatter's fill of
    the output's default value for 'max' on floats)."""
    out = _reduce(data, segment_ids, num_segments, mask, -torch.inf, "amax")
    return torch.where(torch.isfinite(out), out, 0.0)


def segment_min(data, segment_ids, num_segments: int, mask=None):
    """Per-segment min; empty segments yield 0."""
    out = _reduce(data, segment_ids, num_segments, mask, torch.inf, "amin")
    return torch.where(torch.isfinite(out), out, 0.0)


def segment_sum(data, segment_ids, num_segments: int, mask=None):
    """Per-segment sum; empty segments yield 0."""
    ids, kept = _kept(data, segment_ids, num_segments, mask)
    rows = torch.where(kept, data, data.new_zeros(()))
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, ids, rows)


def segment_mean(data, segment_ids, num_segments: int, mask=None):
    """Per-segment mean over the kept rows; empty segments yield 0."""
    total = segment_sum(data, segment_ids, num_segments, mask)
    ones = torch.ones(segment_ids.shape, dtype=torch.float32,
                      device=data.device)
    count = segment_sum(ones, segment_ids, num_segments, mask)
    count = count.reshape(count.shape + (1,) * (total.dim() - count.dim()))
    return total / torch.clamp(count, min=1.0)
