"""Farthest-point sampling over padded rows: the plain PyTorch version and
the CUDA kernel (``ptw_fps``, csrc/fps.cu).

Point Transformer's TransitionDown (``model/point_transformer.py``)
samples each stage's centres this way (pointops.furthestsampling in the
published code). The JAX package has no such sampling, so no TPU kernel
is replaced.

Semantics, for each row of pos (B, N, 3) f32 with mask (B, N) bool:
``counts[b]`` picks (at most m), each the valid point farthest from the
picks before it. A point's distance starts at +inf (valid) or -1
(invalid: never picked); a pick is the arg-max of the distances, the
lowest index on ties (the first pick is the row's first valid point);
after a pick each distance becomes ``where(d < dist, d, dist)``, d the
float32 squared distance ((dx*dx + dy*dy) + dz*dz), one rounding per
operation. Returns idx (B, m) int64 (0 in the slots past the row's
count) and valid (B, m) bool (slot < count). The kernel equals
``fps_plain`` bit for bit; the wrapper runs the plain version only for
CPU tensors, and on a CUDA tensor launches the kernel or raises.
``fps.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import math

import torch

from pointstowood_tpu_torch.ops import build

MAX_POINTS = 32768  # points a row the kernel takes (csrc/fps.cu)


def fps_plain(pos: torch.Tensor, mask: torch.Tensor, counts: torch.Tensor,
              m: int):
    """Plain version of the kernel, the same arithmetic in the same
    order."""
    b, n, _ = pos.shape
    dist = torch.where(mask, math.inf, -1.0).float()
    idx = torch.zeros((b, m), dtype=torch.int64, device=pos.device)
    rows = torch.arange(b, device=pos.device)
    steps = min(m, int(counts.max())) if b else 0
    for t in range(steps):
        pick = torch.argmax(dist, dim=1)  # the first maximum
        idx[:, t] = pick
        c = pos[rows, pick]
        dx = pos[..., 0] - c[:, None, 0]
        dy = pos[..., 1] - c[:, None, 1]
        dz = pos[..., 2] - c[:, None, 2]
        d = (dx * dx + dy * dy) + dz * dz
        dist = torch.where(d < dist, d, dist)
    valid = torch.arange(m, device=pos.device) < counts[:, None]
    return torch.where(valid, idx, 0), valid


def fps(pos: torch.Tensor, mask: torch.Tensor, counts: torch.Tensor, m: int):
    """pos (B, N, 3) f32, mask (B, N) bool, counts (B,) int64 (picks a
    row, clamped to m by the kernel), m >= 1 output slots -> (idx (B, m)
    int64, valid (B, m) bool)."""
    if pos.dim() != 3 or pos.shape[-1] != 3 \
            or tuple(mask.shape) != tuple(pos.shape[:2]) \
            or tuple(counts.shape) != (pos.shape[0],) or m < 1:
        raise ValueError(f"fps: bad shapes pos {tuple(pos.shape)} mask "
                         f"{tuple(mask.shape)} counts {tuple(counts.shape)}"
                         f" m={m}")
    if pos.dtype != torch.float32 or mask.dtype != torch.bool \
            or counts.dtype != torch.int64:
        raise TypeError("fps: expects f32 points, a bool mask and int64 "
                        "counts")
    if not pos.device == mask.device == counts.device:
        raise ValueError("fps: inputs on different devices")
    if pos.device.type == "cpu":
        return fps_plain(pos, mask, counts, m)
    if pos.device.type != "cuda":
        raise RuntimeError(f"fps: no kernel for device {pos.device}")
    b, n = mask.shape
    if n > MAX_POINTS:
        raise ValueError(f"fps: {n} points a row; the kernel takes at most "
                         f"{MAX_POINTS}")
    out = torch.empty((b, m), dtype=torch.int64, device=pos.device)
    counts = counts.contiguous()
    if b and n:
        pos, mask = pos.contiguous(), mask.contiguous()
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        build.check(build.library("fps").ptw_fps(
            pos.data_ptr(), mask.data_ptr(), counts.data_ptr(),
            out.data_ptr(), b, n, m, stream), "fps")
        fps.launches += 1
    else:
        out.zero_()
    valid = torch.arange(m, device=pos.device) < counts[:, None]
    return out, valid


fps.launches = 0
