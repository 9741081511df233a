"""Inverse-distance blend kernels (port of the forward and the backward of
pointstowood_tpu/ops/pallas_interp.py ``fp_interpolate_fast``).

``interp_blend`` (CUDA ``ptw_interp_blend``, csrc/interp.cu) turns each
target's k selected sources (idx, d2) into
``sum_i w_i x[idx_i] / max(sum_i w_i, 1e-16)`` with
``w_i = 1 / max(d2_i, 1e-16)`` (0 for an empty slot, d2 = +inf), in fp32,
written in x's dtype; masked targets get 0. With the top-2 selection of
``ops/knn_kernels.knn_top2`` this is the function the TPU kernel computes
as a thresholded dense ``W @ feats``, except that the TPU threshold also
admits exact distance ties and, for ~1/256 of rows, the 3rd-nearest
source (see csrc/interp.cu).

``interp_blend`` is differentiable in x through ``InterpBlend``, whose
backward is ``interp_blend_bwd``: for each source row, the sum of
``w_ti * (d_y[b, t] / den_t)`` over the live entries e = t * k + i that
name it, in ascending e, in fp32, written in d_y's dtype, as the TPU
kernel's custom VJP returns ``d_feat.astype(d_y.dtype)``. Positions get no
gradient. On the card it is two steps: ``blend_bwd_lists`` (CUDA
``ptw_blend_bwd_lists``) builds the inverse lists, CSR by source, and the
gather (CUDA ``ptw_blend_bwd_gather``) sorts each list and sums it in one
warp, so the result is the same on every run and equals
``blend_bwd_plain`` bit for bit.

Each wrapper runs its plain version only for CPU tensors; on a CUDA tensor
it launches its kernel or raises. ``interp_blend.launches``,
``blend_bwd_lists.launches`` and ``interp_blend_bwd.launches`` (the
gather) count kernel launches.
"""

from __future__ import annotations

import torch

from pointstowood_tpu_torch.ops import build
from pointstowood_tpu_torch.ops.knn_kernels import (
    TOP2_QUERY_BLOCK,
    top2_supported,
)

# JAX kernel tiling, kept for the shape gate below.
T_BLOCK = 256
S_BLOCK = 2048


def fused_supported(t: int, s: int, c: int) -> bool:
    """Shape gate of the JAX fused interpolation kernel (copied): the
    port routes FP stages the way the JAX package does."""
    return (
        t % T_BLOCK == 0
        and t % TOP2_QUERY_BLOCK == 0
        and s % S_BLOCK == 0
        and c % 128 == 0
        and top2_supported(s)
    )


def blend_plain(x: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor,
                target_mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel, same arithmetic in the same order."""
    b, _, c = x.shape
    k = idx.shape[-1]
    w = torch.reciprocal(torch.clamp(d2, min=1e-16))
    den = torch.zeros(d2.shape[:2], dtype=torch.float32, device=x.device)
    acc = torch.zeros(idx.shape[:2] + (c,), dtype=torch.float32,
                      device=x.device)
    rows = torch.arange(b, device=x.device)[:, None]
    for i in range(k):
        wi = w[..., i]
        den = den + wi
        f = x[rows, idx[..., i].long()].float()
        # where(), not f * 0: features of an empty slot may be garbage
        acc = acc + torch.where(wi[..., None] > 0, wi[..., None] * f, 0.0)
    y = acc / torch.clamp(den, min=1e-16)[..., None]
    return torch.where(target_mask[..., None], y, 0.0).to(x.dtype)


def blend_bwd_lists_plain(idx: torch.Tensor, d2: torch.Tensor,
                          target_mask: torch.Tensor, n_src: int):
    """Plain version of ``blend_bwd_lists``: the inverse lists of the
    backward, CSR by source. Returns (offsets (B * S + 1,) int32, entries
    (n_live,) int32, weights (n_live,) f32, dens (n_live,) f32): list
    (b, s) is positions ``offsets[b * S + s]:offsets[b * S + s + 1]``,
    each the id e = t * k + i of a live entry naming s (target unmasked,
    w > 0), in ascending e, with its weight w_ti = 1 / max(d2, 1e-16) and
    its target's den_t = max(sum_i w_ti, 1e-16) (summed in slot order);
    masked targets and empty slots are in no list, whatever their idx
    holds."""
    b, n_tgt, k = idx.shape
    dev = idx.device
    w = torch.reciprocal(torch.clamp(d2, min=1e-16))
    den = torch.zeros((b, n_tgt), dtype=torch.float32, device=dev)
    for i in range(k):
        den = den + w[..., i]
    den = torch.clamp(den, min=1e-16)
    live = (w > 0) & target_mask[..., None]
    flat = (idx.long() + torch.arange(b, device=dev)[:, None, None]
            * n_src)[live]
    ids = torch.arange(n_tgt * k, device=dev).view(1, n_tgt, k).expand(
        b, n_tgt, k)[live]
    # live entries come in ascending (b, e); a stable sort by source keeps
    # that order inside each list
    order = torch.sort(flat, stable=True).indices
    offsets = torch.zeros(b * n_src + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(torch.bincount(flat, minlength=b * n_src), 0)
    dens = den[..., None].expand(b, n_tgt, k)[live]
    return (offsets.int(), ids[order].int(), w[live][order],
            dens[order])


def blend_bwd_gather_plain(d_y: torch.Tensor, offsets: torch.Tensor,
                           entries: torch.Tensor, weights: torch.Tensor,
                           dens: torch.Tensor, n_src: int,
                           k: int) -> torch.Tensor:
    """Plain version of the gather: each list summed in its order (as
    ``blend_bwd_lists_plain`` orders it), term by term
    ``w * (d_y / den)`` in fp32 from +0, rank by rank (one step adds the
    r-th entry of every list at once, so no two adds meet), cast to d_y's
    dtype."""
    b, n_tgt, c = d_y.shape
    dev = d_y.device
    offsets = offsets.long()
    counts = offsets[1:] - offsets[:-1]
    cell = torch.repeat_interleave(torch.arange(b * n_src, device=dev),
                                   counts)
    rank = torch.arange(cell.numel(), device=dev) - offsets[:-1][cell]
    trow = cell // n_src * n_tgt + entries.long() // k
    term = weights[:, None] * (d_y.reshape(-1, c)[trow].float()
                               / dens[:, None])
    acc = torch.zeros((b * n_src, c), dtype=torch.float32, device=dev)
    by_rank = torch.sort(rank, stable=True).indices
    lo = 0
    for n in (torch.bincount(rank).tolist() if rank.numel() else []):
        sel = by_rank[lo:lo + n]
        lo += n
        acc[cell[sel]] = acc[cell[sel]] + term[sel]
    return acc.reshape(b, n_src, c).to(d_y.dtype)


def blend_bwd_plain(d_y: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor,
                    target_mask: torch.Tensor, n_src: int) -> torch.Tensor:
    """Plain version of the backward (lists, then gather): each
    contribution ``w_i * (d_y / den)`` rounded as the kernel rounds it,
    the contributions to one source row added in ascending entry order
    t * k + i, the same on every device and every run."""
    return blend_bwd_gather_plain(
        d_y, *blend_bwd_lists_plain(idx, d2, target_mask, n_src), n_src,
        idx.shape[-1])


_SCAN_TILE = 4096  # counts a block of the list build's scan (csrc/interp.cu)


def _check_cuda(name: str, lead: torch.Tensor, *others: torch.Tensor) -> None:
    if lead.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {lead.device}")
    if any(t.device != lead.device for t in others):
        raise ValueError(f"{name}: inputs on different devices")
    if lead.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: features must be bf16 or f32, "
                        f"got {lead.dtype}")


def _vec_width(name: str, dtype: torch.dtype, c: int) -> None:
    vec = 8 if dtype == torch.bfloat16 else 4
    if c % vec:
        raise ValueError(f"{name}: needs C % {vec} == 0, got C={c}")


def _blend_forward(x: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor,
                   target_mask: torch.Tensor) -> torch.Tensor:
    """Forward of ``InterpBlend``: the plain version for CPU tensors, else
    one launch of the forward kernel (inputs checked by ``interp_blend``:
    idx int32, all contiguous, on one CUDA device)."""
    if x.device.type == "cpu":
        return blend_plain(x, idx, d2, target_mask)
    b, n_src, c = x.shape
    k = idx.shape[-1]
    n_tgt = idx.shape[1]
    y = torch.empty((b, n_tgt, c), dtype=x.dtype, device=x.device)
    if b and n_tgt:
        lib = build.library("interp")
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(lib.ptw_interp_blend(
            x.data_ptr(), idx.data_ptr(), d2.data_ptr(),
            target_mask.data_ptr(), y.data_ptr(), b, n_src, n_tgt, c, k,
            int(x.dtype == torch.bfloat16), stream), "interp_blend")
        interp_blend.launches += 1
    return y


def blend_bwd_lists(idx: torch.Tensor, d2: torch.Tensor,
                    target_mask: torch.Tensor, n_src: int):
    """The inverse lists of the backward: idx (B, T, k), d2 (B, T, k) f32,
    target_mask (B, T) bool -> (offsets (B * S + 1,) int32, entries int32,
    weights f32, dens f32), as ``blend_bwd_lists_plain`` gives them for
    CPU tensors. CUDA: ``ptw_blend_bwd_lists``, which fills each list in
    no fixed order (the gather orders it); entries, weights and dens are
    then the first three columns of one (B * T * k, 4) int32 buffer (one
    16-byte word an entry), of which ``offsets[-1]`` rows are written.
    Needs B, T, S >= 1."""
    if idx.device.type == "cpu":
        return blend_bwd_lists_plain(idx, d2, target_mask, n_src)
    _check_cuda("blend_bwd_lists", d2, idx, target_mask)
    b, n_tgt, k = idx.shape
    if not (b and n_tgt and n_src) or b * n_tgt * k >= 2**31:
        raise ValueError(f"blend_bwd_lists: needs 1 <= B, T, S and "
                         f"B*T*k < 2^31, got {b}, {n_tgt}, {n_src}, k={k}")
    idx = idx.to(torch.int32).contiguous()
    d2 = d2.contiguous()
    target_mask = target_mask.contiguous()
    dev = idx.device
    # the counts, then the tiles' bases of the scan and a done counter
    counts = torch.empty(b * n_src + -(-b * n_src // _SCAN_TILE) + 2,
                         dtype=torch.int32, device=dev)
    offsets = torch.empty(b * n_src + 1, dtype=torch.int32, device=dev)
    ranks = torch.empty((b, n_tgt, k), dtype=torch.int32, device=dev)
    packed = torch.empty((b * n_tgt * k, 4), dtype=torch.int32, device=dev)
    lib = build.library("interp")
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.ptw_blend_bwd_lists(
        idx.data_ptr(), d2.data_ptr(), target_mask.data_ptr(),
        counts.data_ptr(), offsets.data_ptr(), ranks.data_ptr(),
        packed.data_ptr(), b, n_src, n_tgt, k, stream), "blend_bwd_lists")
    blend_bwd_lists.launches += 1
    return (offsets, packed[:, 0], packed[:, 1].view(torch.float32),
            packed[:, 2].view(torch.float32))


def interp_blend_bwd(d_y: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor,
                     target_mask: torch.Tensor, n_src: int) -> torch.Tensor:
    """Gradient of ``interp_blend`` with respect to x: d_y (B, T, C)
    bf16/f32, idx (B, T, k), d2 (B, T, k) f32, target_mask (B, T) bool ->
    (B, n_src, C) in d_y.dtype. CUDA: ``blend_bwd_lists``, then the gather
    ``ptw_blend_bwd_gather``."""
    if d_y.device.type == "cpu":
        return blend_bwd_plain(d_y, idx, d2, target_mask, n_src)
    _check_cuda("interp_blend_bwd", d_y, idx, d2, target_mask)
    b, n_tgt, c = d_y.shape
    k = idx.shape[-1]
    _vec_width("interp_blend_bwd", d_y.dtype, c)
    if not (b and n_tgt and n_src):
        return torch.zeros((b, n_src, c), dtype=d_y.dtype, device=d_y.device)
    offsets, entries = blend_bwd_lists(idx, d2, target_mask, n_src)[:2]
    d_y = d_y.contiguous()
    d_x = torch.empty((b, n_src, c), dtype=d_y.dtype, device=d_y.device)
    order = torch.empty(entries.shape, dtype=torch.int32, device=d_y.device)
    # a warp per source row and 32 vectors of 16 bytes (csrc/interp.cu)
    chunks = max(1, -(-c // (256 if d_y.dtype == torch.bfloat16 else 128)))
    redo = torch.empty(1 + b * n_src * chunks, dtype=torch.int32,
                       device=d_y.device)
    lib = build.library("interp")
    stream = torch.cuda.current_stream(d_y.device).cuda_stream
    # entries: column 0 of the lists' packed (n, 4) buffer, the gather's
    # input
    build.check(lib.ptw_blend_bwd_gather(
        d_y.data_ptr(), offsets.data_ptr(), entries.data_ptr(),
        order.data_ptr(), redo.data_ptr(), d_x.data_ptr(), b, n_src, n_tgt,
        c, k, int(d_y.dtype == torch.bfloat16), stream), "interp_blend_bwd")
    interp_blend_bwd.launches += 1
    return d_x


class InterpBlend(torch.autograd.Function):
    """``interp_blend`` with a gradient for x. The backward recomputes the
    weights and their sum from the saved (idx, d2, target_mask), as the TPU
    kernel recomputes W, and returns no gradient for the neighbour
    arrays."""

    @staticmethod
    def forward(ctx, x, idx, d2, target_mask):
        ctx.save_for_backward(idx, d2, target_mask)
        ctx.n_src = x.shape[1]
        return _blend_forward(x, idx, d2, target_mask)

    @staticmethod
    def backward(ctx, d_y):
        idx, d2, target_mask = ctx.saved_tensors
        d_x = None
        if ctx.needs_input_grad[0]:
            d_x = interp_blend_bwd(d_y, idx, d2, target_mask, ctx.n_src)
        return d_x, None, None, None


def interp_blend(x: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor,
                 target_mask: torch.Tensor) -> torch.Tensor:
    """x (B, S, C) bf16/f32, idx (B, T, k) int, d2 (B, T, k) f32,
    target_mask (B, T) bool -> (B, T, C) in x.dtype, differentiable in x
    on every device (``InterpBlend``)."""
    b = x.shape[0]
    if idx.dim() != 3 or idx.shape[0] != b or d2.shape != idx.shape \
            or tuple(target_mask.shape) != tuple(idx.shape[:2]):
        raise ValueError(
            f"interp_blend: bad shapes x {tuple(x.shape)} idx "
            f"{tuple(idx.shape)} d2 {tuple(d2.shape)} mask "
            f"{tuple(target_mask.shape)}")
    if d2.dtype != torch.float32 or target_mask.dtype != torch.bool:
        raise TypeError("interp_blend: d2 must be f32, target_mask bool")
    if x.device.type != "cpu":
        _check_cuda("interp_blend", x, idx, d2, target_mask)
        _vec_width("interp_blend", x.dtype, x.shape[-1])
        x = x.contiguous()
        idx = idx.to(torch.int32).contiguous()
        d2 = d2.contiguous()
        target_mask = target_mask.contiguous()
    return InterpBlend.apply(x, idx, d2, target_mask)


interp_blend.launches = 0
blend_bwd_lists.launches = 0
interp_blend_bwd.launches = 0
