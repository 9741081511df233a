"""Inverse-distance blend kernel (port of the forward of
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

The wrapper runs the plain version only for CPU tensors; on a CUDA tensor
it launches the kernel or raises. ``interp_blend.launches`` counts kernel
launches. The backward of the TPU kernel waits for the training slice.
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


def interp_blend(x: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor,
                 target_mask: torch.Tensor) -> torch.Tensor:
    """x (B, S, C) bf16/f32, idx (B, T, k) int, d2 (B, T, k) f32,
    target_mask (B, T) bool -> (B, T, C) in x.dtype."""
    b, n_src, c = x.shape
    if idx.dim() != 3 or idx.shape[0] != b or d2.shape != idx.shape \
            or tuple(target_mask.shape) != tuple(idx.shape[:2]):
        raise ValueError(
            f"interp_blend: bad shapes x {tuple(x.shape)} idx "
            f"{tuple(idx.shape)} d2 {tuple(d2.shape)} mask "
            f"{tuple(target_mask.shape)}")
    if d2.dtype != torch.float32 or target_mask.dtype != torch.bool:
        raise TypeError("interp_blend: d2 must be f32, target_mask bool")
    if x.device.type == "cpu":
        return blend_plain(x, idx, d2, target_mask)
    if x.device.type != "cuda":
        raise RuntimeError(f"interp_blend: no kernel for device {x.device}")
    if any(t.device != x.device for t in (idx, d2, target_mask)):
        raise ValueError("interp_blend: inputs on different devices")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"interp_blend: x must be bf16 or f32, got {x.dtype}")
    vec = 8 if x.dtype == torch.bfloat16 else 4
    k = idx.shape[-1]
    if c % vec or not 1 <= k <= _MAX_K:
        raise ValueError(f"interp_blend: needs C % {vec} == 0 and "
                         f"1 <= k <= {_MAX_K}, got C={c}, k={k}")
    x = x.contiguous()
    idx = idx.to(torch.int32).contiguous()
    d2 = d2.contiguous()
    target_mask = target_mask.contiguous()
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


interp_blend.launches = 0
