"""Pair selection for device fusion (port of the Pallas
``group_min_payload`` of pointstowood_tpu/ops/pallas_knn.py together with
the ``approx_min_k`` + ``unpack_payload`` that follow it in
pointstowood_tpu/predict/tpu_fusion.py ``_pair_group``).

``pair_select`` (CUDA ``ptw_pair_select``, csrc/fusion.cu) sits beside its
plain PyTorch version ``pair_select_plain``. For each entry e and each of
its first ``q_len[e]`` queries it returns the ``k`` nearest rows of the
entry's union (fine region ``[off_f, off_f + len_f)`` then coarse region
``[off_c, off_c + len_c)`` of the flat source arrays) as (d2, payload):
ascending true squared distances, ties to the lower union index, and the
source's 10-bit payload. Slots without a source and dead queries hold
(+inf, 0). The selection is exact where the JAX one is a group fold plus
``approx_min_k`` at recall 0.8: the same function, not the same blocks.

The wrapper runs the plain version only when its inputs lie on the CPU;
on a CUDA tensor it launches the kernel or raises. It counts its kernel
launches in ``pair_select.launches``.
"""

from __future__ import annotations

import math

import torch

from pointstowood_tpu_torch.ops import build
from pointstowood_tpu_torch.ops.knn_kernels import pair_d2

PAYLOAD_BITS = 10
PAYLOAD_MAX = (1 << PAYLOAD_BITS) - 1
K_CHOICES = (32, 64)
MAX_ENTRIES = 65535  # the kernel's grid.y


def quantize_payload(probs: torch.Tensor) -> torch.Tensor:
    """round(clip(p, 0, 1) * 1023) as int32, in float32 like the JAX
    payload (tpu_fusion.py:470-473)."""
    return torch.round(torch.clamp(probs.float(), 0.0, 1.0)
                       * float(PAYLOAD_MAX)).to(torch.int32)


def pair_select_plain(queries, q_len, src_xyz, src_pay, regions, k: int):
    """Plain version: per entry, the difference-form d2 of its live
    queries against its union, a stable ascending sort, and a payload
    gather. Same contract as ``pair_select``."""
    n_e, n_q, _ = queries.shape
    dev = queries.device
    out_d = torch.full((n_e, n_q, k), math.inf, device=dev)
    out_p = torch.zeros((n_e, n_q, k), dtype=torch.int32, device=dev)
    lens = q_len.cpu().tolist()
    regs = regions.cpu().tolist()
    for e in range(n_e):
        ql = min(int(lens[e]), n_q)
        off_f, len_f, off_c, len_c = regs[e]
        if ql <= 0:
            continue
        rows = torch.cat([torch.arange(off_f, off_f + len_f, device=dev),
                          torch.arange(off_c, off_c + len_c, device=dev)])
        kk = min(k, rows.numel())
        if kk == 0:
            continue
        d = pair_d2(queries[e:e + 1, :ql], src_xyz[rows][None])[0]
        vals, order = torch.sort(d, dim=1, stable=True)
        out_d[e, :ql, :kk] = vals[:, :kk]
        out_p[e, :ql, :kk] = src_pay[rows][order[:, :kk]]
    return out_d, out_p


def _check(queries, q_len, src_xyz, src_pay, regions, k):
    n_e = queries.shape[0] if queries.dim() == 3 else -1
    if queries.dim() != 3 or queries.shape[-1] != 3 \
            or src_xyz.dim() != 2 or src_xyz.shape[-1] != 3 \
            or tuple(q_len.shape) != (n_e,) \
            or tuple(regions.shape) != (n_e, 4) \
            or tuple(src_pay.shape) != (src_xyz.shape[0],):
        raise ValueError(
            f"pair_select: bad shapes queries {tuple(queries.shape)} q_len "
            f"{tuple(q_len.shape)} src {tuple(src_xyz.shape)} pay "
            f"{tuple(src_pay.shape)} regions {tuple(regions.shape)}")
    if queries.dtype != torch.float32 or src_xyz.dtype != torch.float32 \
            or q_len.dtype != torch.int32 or src_pay.dtype != torch.int32 \
            or regions.dtype != torch.int32:
        raise TypeError("pair_select: expects f32 points and int32 "
                        "lengths, payloads and regions")
    devs = {t.device for t in (queries, q_len, src_xyz, src_pay, regions)}
    if len(devs) != 1:
        raise ValueError("pair_select: inputs on different devices")
    if k not in K_CHOICES:
        raise ValueError(f"pair_select: k={k} not in {K_CHOICES}")


def pair_select(queries: torch.Tensor, q_len: torch.Tensor,
                src_xyz: torch.Tensor, src_pay: torch.Tensor,
                regions: torch.Tensor, k: int):
    """Exact k nearest union rows per live query: queries (E, Q, 3) f32,
    q_len (E,) int32, src_xyz (N, 3) f32, src_pay (N,) int32, regions
    (E, 4) int32 [off_f, len_f, off_c, len_c] -> (d2 (E, Q, k) f32,
    payload (E, Q, k) int32), k in {32, 64}. The regions must lie inside
    the N source rows (the caller's plan guarantees it; the kernel does
    not check). CUDA: the ``ptw_pair_select`` kernel, one launch."""
    _check(queries, q_len, src_xyz, src_pay, regions, k)
    dev = queries.device
    if dev.type == "cpu":
        return pair_select_plain(queries, q_len, src_xyz, src_pay, regions,
                                 k)
    if dev.type != "cuda":
        raise RuntimeError(f"pair_select: no kernel for device {dev}")
    n_e, n_q, _ = queries.shape
    if n_e > MAX_ENTRIES:
        raise ValueError(f"pair_select: {n_e} entries exceed {MAX_ENTRIES} "
                         "per launch")
    queries, q_len, src_xyz, src_pay, regions = (
        t.contiguous() for t in (queries, q_len, src_xyz, src_pay, regions))
    out_d = torch.empty((n_e, n_q, k), dtype=torch.float32, device=dev)
    out_p = torch.empty((n_e, n_q, k), dtype=torch.int32, device=dev)
    if n_e and n_q:
        lib = build.library("fusion")
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(lib.ptw_pair_select(
            queries.data_ptr(), q_len.data_ptr(), src_xyz.data_ptr(),
            src_pay.data_ptr(), regions.data_ptr(), out_d.data_ptr(),
            out_p.data_ptr(), n_e, n_q, k, stream), "pair_select")
        pair_select.launches += 1
    return out_d, out_p


pair_select.launches = 0
