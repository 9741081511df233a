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
backward is ``interp_blend_bwd`` (CUDA ``ptw_interp_blend_bwd``):
``d_x[b, idx_ti] += (w_ti / den_t) * d_y[b, t]``, accumulated in fp32 and
cast to x's dtype, as the TPU kernel's custom VJP returns
``d_feat.astype(d_y.dtype)``. Positions get no gradient.

Each wrapper runs its plain version only for CPU tensors; on a CUDA tensor
it launches its kernel or raises. ``interp_blend.launches`` and
``interp_blend_bwd.launches`` count kernel launches.
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
_MAX_K = 8


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


def blend_bwd_plain(d_y: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor,
                    target_mask: torch.Tensor, n_src: int) -> torch.Tensor:
    """Plain version of the backward kernel: each contribution
    ``w_i * (d_y / den)`` is rounded as the kernel rounds it; the sums into
    one source row are taken in index_add_'s order."""
    b, _, c = d_y.shape
    k = idx.shape[-1]
    w = torch.reciprocal(torch.clamp(d2, min=1e-16))
    den = torch.zeros(d2.shape[:2], dtype=torch.float32, device=d_y.device)
    for i in range(k):
        den = den + w[..., i]
    den = torch.clamp(den, min=1e-16)
    g = torch.where(target_mask[..., None], d_y.float() / den[..., None], 0.0)
    acc = torch.zeros((b * n_src, c), dtype=torch.float32, device=d_y.device)
    offs = torch.arange(b, device=d_y.device)[:, None] * n_src
    for i in range(k):
        wi = w[..., i, None]
        contrib = torch.where(wi > 0, wi * g, 0.0)
        acc.index_add_(0, (idx[..., i].long() + offs).reshape(-1),
                       contrib.reshape(-1, c))
    return acc.reshape(b, n_src, c).to(d_y.dtype)


def _check_cuda(name: str, lead: torch.Tensor, *others: torch.Tensor) -> None:
    if lead.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {lead.device}")
    if any(t.device != lead.device for t in others):
        raise ValueError(f"{name}: inputs on different devices")
    if lead.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: features must be bf16 or f32, "
                        f"got {lead.dtype}")


def _vec_width(name: str, dtype: torch.dtype, c: int, k: int) -> None:
    vec = 8 if dtype == torch.bfloat16 else 4
    if c % vec or not 1 <= k <= _MAX_K:
        raise ValueError(f"{name}: needs C % {vec} == 0 and "
                         f"1 <= k <= {_MAX_K}, got C={c}, k={k}")


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


def interp_blend_bwd(d_y: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor,
                     target_mask: torch.Tensor, n_src: int) -> torch.Tensor:
    """Gradient of ``interp_blend`` with respect to x: d_y (B, T, C)
    bf16/f32, idx (B, T, k), d2 (B, T, k) f32, target_mask (B, T) bool ->
    (B, n_src, C) in d_y.dtype."""
    if d_y.device.type == "cpu":
        return blend_bwd_plain(d_y, idx, d2, target_mask, n_src)
    _check_cuda("interp_blend_bwd", d_y, idx, d2, target_mask)
    b, n_tgt, c = d_y.shape
    k = idx.shape[-1]
    _vec_width("interp_blend_bwd", d_y.dtype, c, k)
    d_y = d_y.contiguous()
    idx = idx.to(torch.int32).contiguous()
    d2 = d2.contiguous()
    target_mask = target_mask.contiguous()
    acc = torch.empty((b, n_src, c), dtype=torch.float32, device=d_y.device)
    if not (b and n_tgt and n_src):
        return acc.zero_().to(d_y.dtype)
    d_x = acc if d_y.dtype == torch.float32 else torch.empty(
        (b, n_src, c), dtype=d_y.dtype, device=d_y.device)
    lib = build.library("interp")
    stream = torch.cuda.current_stream(d_y.device).cuda_stream
    build.check(lib.ptw_interp_blend_bwd(
        d_y.data_ptr(), idx.data_ptr(), d2.data_ptr(), target_mask.data_ptr(),
        acc.data_ptr(), d_x.data_ptr(), b, n_src, n_tgt, c, k,
        int(d_y.dtype == torch.bfloat16), stream), "interp_blend_bwd")
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
        _vec_width("interp_blend", x.dtype, x.shape[-1], idx.shape[-1])
        x = x.contiguous()
        idx = idx.to(torch.int32).contiguous()
        d2 = d2.contiguous()
        target_mask = target_mask.contiguous()
    return InterpBlend.apply(x, idx, d2, target_mask)


interp_blend.launches = 0
interp_blend_bwd.launches = 0
