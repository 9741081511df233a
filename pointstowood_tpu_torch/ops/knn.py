"""Fixed-k masked neighbour search (port of pointstowood_tpu/ops/knn.py).

Dense (B, Q, k) neighbour index arrays plus validity masks replace the
torch-cluster ``knn`` edge lists of the reference
(pointstowood/src/model.py:117-120). All functions are batched over a
leading B axis.

Two methods:

* ``"exact"``: plain fp32 top-k that ranks by the JAX exact path's
  expansion ``||q||^2 - 2 q.s + ||s||^2`` (clamped at 0) — the parity path;
* ``"fast"``: the CUDA kernels of ``ops/knn_kernels.py``, routed as the
  JAX ``_fast_knn`` routes (``knn_kernels.fast_route``): where JAX takes
  its folded top-2 or in-kernel top-k, the exact fp32 selections
  ``knn_top2``/``knn_topk``; where it takes the two-stage path (sources
  past one 16384 block, or without a second fold), ``group_min`` over
  block-local groups of g strided sources, ``torch.topk`` over the group
  minima and ``member_index``; where it falls back to XLA's
  ``_approx_knn`` (small or unaligned N), ``knn_top2``/``knn_topk`` again:
  they have no shape limit.

Return contract (both methods, as in the JAX package): idx is 0 where
invalid, d2 is +inf where invalid, and valid is the query mask AND a finite
d2.
"""

from __future__ import annotations

import math

import torch

from pointstowood_tpu_torch.ops.knn_kernels import (
    fast_route,
    group_min,
    knn_top2,
    knn_topk,
    member_index,
    supported,
)

_EXACT_CHUNK_ELEMS = 1 << 23


def _exact_knn(q, s, smask, k):
    """fp32 top-k ranked like pointstowood_tpu's _exact_knn: expansion
    form, ties to the lower source index (stable sort)."""
    b, n_q, _ = q.shape
    n = s.shape[1]
    q_sq = (q * q).sum(-1, keepdim=True)
    s_sq = (s * s).sum(-1)[:, None, :]
    out_d = torch.empty((b, n_q, k), device=q.device)
    out_i = torch.empty((b, n_q, k), dtype=torch.int64, device=q.device)
    step = max(1, _EXACT_CHUNK_ELEMS // max(1, b * n))
    for lo in range(0, n_q, step):
        qc = q[:, lo:lo + step]
        cross = torch.matmul(qc, s.transpose(1, 2))
        d2 = q_sq[:, lo:lo + step] - 2.0 * cross + s_sq
        d2 = torch.where(smask[:, None, :], d2.clamp_min(0.0), math.inf)
        vals, order = torch.sort(d2, dim=-1, stable=True)
        out_d[:, lo:lo + step] = vals[..., :k]
        out_i[:, lo:lo + step] = order[..., :k]
    return out_i, out_d


def _two_stage_knn(q, s, smask, k):
    """The JAX two-stage fast kNN (knn.py:169-188): ``group_min`` folds
    the sources into block-local groups of g, a top-k over the (B, Q, N/g)
    group minima picks k groups, and ``member_index`` maps each group's
    winning slot back to its source. JAX selects with XLA's
    ``approx_min_k``, which sits outside any Pallas kernel and lowers to an
    exact top-k on the CPU; the port takes ``torch.topk``. The minima are
    already the exact difference-form d2, so the selected values need no
    recompute (JAX re-gathers because its values are slot-packed
    ``||s||^2 - 2 q.s``)."""
    n = s.shape[1]
    g = supported(n, k)
    gmin, slot = group_min(q, s, smask, g)
    d2, gidx = torch.topk(gmin, k, dim=-1, largest=False, sorted=True)
    return member_index(gidx, torch.gather(slot, -1, gidx), n, g), d2


def knn_masked(query_pos: torch.Tensor, source_pos: torch.Tensor, k: int,
               query_mask: torch.Tensor | None = None,
               source_mask: torch.Tensor | None = None,
               method: str = "exact"):
    """k nearest valid sources per query.

    Args:
      query_pos: (B, Q, 3); source_pos: (B, N, 3) (cast to fp32).
      k: neighbours; query_mask (B, Q) / source_mask (B, N): bool.
      method: "exact" (plain parity path) or "fast" (CUDA kernels, routed
        by ``fast_route``).

    Returns idx (B, Q, k) int64 (0 where invalid), d2 (B, Q, k) fp32
    (+inf where invalid), valid (B, Q, k) bool.
    """
    q = query_pos.float()
    s = source_pos.float()
    b, n = s.shape[0], s.shape[1]
    smask = (torch.ones((b, n), dtype=torch.bool, device=s.device)
             if source_mask is None else source_mask)
    k_eff = min(k, n)
    if method == "exact":
        idx, d2 = _exact_knn(q, s, smask, k_eff)
    elif method == "fast":
        q, s = q.contiguous(), s.contiguous()
        if fast_route(n, k_eff) == "two_stage":
            idx, d2 = _two_stage_knn(q, s, smask, k_eff)
        elif k_eff == 2:
            d2, idx = knn_top2(q, s, smask)
        else:
            d2, idx = knn_topk(q, s, smask, k_eff)
        idx = idx.long()
    else:
        raise ValueError(f"unknown kNN method {method!r}")
    if k_eff < k:
        pad = k - k_eff
        idx = torch.nn.functional.pad(idx, (0, pad))
        d2 = torch.nn.functional.pad(d2, (0, pad), value=math.inf)
    valid = torch.isfinite(d2)
    if query_mask is not None:
        valid = valid & query_mask[..., None]
    return (torch.where(valid, idx, 0), torch.where(valid, d2, math.inf),
            valid)


def knn_topk_with_transpose(query_pos: torch.Tensor,
                            source_pos: torch.Tensor, k: int,
                            query_mask: torch.Tensor,
                            source_mask: torch.Tensor):
    """Fast-path kNN that also returns the transpose top-2.

    The SA stage's kNN (queries = sampled centres, sources = the stage
    cloud) and the FP decoder's k=2 interpolation search (targets = the
    stage cloud, sources = those centres) are transposes of one distance
    matrix, so the FP neighbours come from the same stage: ``knn_topk``
    gives the forward top-k, ``knn_top2`` with the roles swapped (rows =
    sources, columns = centres, the query mask as the column mask) the
    transpose. The distance is symmetric bit for bit (a difference is
    negated exactly), so t_d2 is what the FP stage's own search would get.

    Returns idx (B, Q, k) int64, valid (B, Q, k), t_idx (B, N, 2) int64,
    t_valid (B, N, 2), t_d2 (B, N, 2) fp32 (+inf where invalid). Invalid
    slots hold index 0.
    """
    q = query_pos.float().contiguous()
    s = source_pos.float().contiguous()
    d2, idx = knn_topk(q, s, source_mask, k)
    valid = torch.isfinite(d2) & query_mask[..., None]
    t_d2, t_idx = knn_top2(s, q, query_mask)
    t_valid = torch.isfinite(t_d2) & source_mask[..., None]
    return (
        torch.where(valid, idx.long(), 0),
        valid,
        torch.where(t_valid, t_idx.long(), 0),
        t_valid,
        torch.where(t_valid, t_d2, math.inf),
    )
