"""Masked batch-statistic BatchNorm for training as streaming passes: the
CUDA kernels (``ptw_bn_reduce``, ``ptw_bn_finalize``,
``ptw_bn_elementwise``, csrc/batchnorm.cu) and their plain PyTorch
transcription.

``model.layers.MaskedBatchNorm`` trains with the statistics of the valid
rows of its (..., C) input. On a CUDA tensor with no data group it runs
``batch_norm_train``, the autograd Function below; CPU tensors and data
groups keep ``layers._BatchStatsNorm``, the plain torch form, which this
computes pass by pass with the same rounding of every element.

The algorithm, on the (rows, C) view of x (bf16 or fp32, read in its own
dtype) with one validity byte a row, m:

forward
  1. ``STAT1``: per block, Σ x over its valid rows and their count;
     ``finalize`` sums the blocks' partials in a fixed order (float64,
     rounded once to float32; ``reduce_plain`` sums every row's terms
     so). Then on (C,) tensors, as the plain code:
     n = clamp(count, 1), mean = Σx / n.
  2. ``STAT2``: per block, Σ (x - mean)² over its valid rows (the plain
     code's two-pass variance); finalized, var = Σ / n,
     r = rsqrt(var + eps).
  3. ``APPLY``: y = ((x - mean) * r) * weight + bias on every row, written
     once in x's dtype.

backward, from gy (x's dtype), d = x - mean
  4. ``GRAD``: over every row Σ gy (the bias's gradient), Σ gy (d r) (the
     weight's), Σ (gy w) d and Σ (gy w) r, and over the valid rows Σ d;
     finalized. Then, on (C,) tensors: g_s2 = Σ (gy w) d * -0.5 * r³ / n
     (the plain code's) and g_mean = -(Σ (gy w) r + 2 Σ d * g_s2): the
     plain code's -Σ g_d with g_d = (gy w) r + [valid] (2 d) g_s2, summed
     by its two parts.
  5. ``GRAD_INPUT``: g_x = ((gy w) r + [valid] (2 d) g_s2)
     + [valid] g_mean / n, written once in x's dtype.

Every term and elementwise step is rounded as the plain code rounds it,
so given the same (C,) vectors y and g_x equal the plain expressions bit
for bit; only the order of the large sums differs. A block's partials go
to its own row of a (blocks, width) float32 scratch, summed in a fixed
order, with no atomics, so the result repeats bit for bit on one card.
Masked rows enter no statistic (they may hold any value, ±inf
included); their y and g_x are the plain code's. n = 0 (no valid row)
normalises with mean 0 and var 0, as the plain code does.

Blocks: ``layout`` gives each block tc threads across a row's channel
groups (8 channels a thread where C % 8 == 0 and the tensors are
16-byte aligned, else one) and rpb rows at once; block b of
``reduce_blocks`` takes the row groups b, b + G, b + 2G, ... (at
most ``CHAIN`` of them, so no float32 sum runs long).
``batch_norm_train.launches``
counts the kernels' launches (five a forward, three a backward).
"""

from __future__ import annotations

import torch

from pointstowood_tpu_torch.ops import build

THREADS = 256      # a block's threads (csrc/batchnorm.cu kThreads)
STAT1, STAT2, GRAD = 0, 1, 2     # ptw_bn_reduce modes
APPLY, GRAD_INPUT = 0, 1         # ptw_bn_elementwise modes
_WIDTH = {STAT1: lambda c: c + 1, STAT2: lambda c: c, GRAD: lambda c: 5 * c}
_BLOCKS_PER_SM = {STAT1: 3, STAT2: 3, GRAD: 2}  # csrc kResidentOf
CHAIN = 64         # row groups a thread of a reduction sums at most
_SMS: dict = {}


def layout(c: int, vec: bool) -> tuple[int, int]:
    """(tc, rpb): threads across a row's channel groups and rows a block
    takes at once, for C channels, 8 a thread (``vec``) or one."""
    cv = c // 8 if vec else c
    tc = min(cv, THREADS)
    return tc, THREADS // tc


def reduce_blocks(mode: int, rows: int, c: int, vec: bool,
                  sms: int) -> int:
    """Blocks of a reduction pass: whole waves of the blocks the card
    holds at once (``_BLOCKS_PER_SM`` a multiprocessor), enough that a
    thread sums at most ``CHAIN`` row groups in sequence, and at most one
    a row group."""
    groups = -(-rows // layout(c, vec)[1])
    wave = _BLOCKS_PER_SM[mode] * sms
    return max(1, min(groups, wave * -(-groups // (wave * CHAIN))))


def _sms(device: torch.device) -> int:
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def _vec(c: int, *tensors) -> bool:
    """8 channels a thread: C % 8 == 0 and every tensor 16-byte aligned."""
    return c % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors
                              if t is not None)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


# ---- plain versions: the kernels' passes in torch


def reduce_plain(mode, x2, m1, gy2, mean, r, weight) -> torch.Tensor:
    """One reduction pass and its finalize: (width,) float32, each row's
    float32 terms as the kernel rounds them, summed over all rows in
    float64 and rounded once (the kernel sums them in another order)."""
    v = m1[:, None]
    xf = x2.float()
    if mode == STAT1:
        terms = [torch.where(v, xf, 0.0), v.float()]
    elif mode == STAT2:
        d = xf - mean
        terms = [torch.where(v, d * d, 0.0)]
    else:
        g = gy2.float()
        d = xf - mean
        gw = g * weight
        terms = [g, g * (d * r), gw * d, gw * r, torch.where(v, d, 0.0)]
    return torch.cat(terms, dim=1).double().sum(0).float()


def elementwise_plain(mode, x2, m1, gy2, mean, r, weight, v1, v2=None):
    """``APPLY`` (v1 = bias) or ``GRAD_INPUT`` (v1 = g_s2, v2 = g_mean /
    n): the plain code's expressions, in x's dtype."""
    d = x2.float() - mean
    if mode == APPLY:
        out = d * r * weight + v1
    else:
        v = m1[:, None]
        g_d = gy2.float() * weight * r + torch.where(v, 2.0 * d * v1, 0.0)
        out = g_d + torch.where(v, v2, 0.0)
    return out.to(x2.dtype)


# ---- the passes: plain versions for CPU tensors, else the kernels


def _reduce(mode, x2, m1, gy2=None, mean=None, r=None, weight=None):
    """A reduction pass and its finalize: (width,) float32 sums."""
    rows, c = x2.shape
    width = _WIDTH[mode](c)
    if rows == 0:
        return torch.zeros(width, device=x2.device)
    if x2.device.type == "cpu":
        return reduce_plain(mode, x2, m1, gy2, mean, r, weight)
    vec = _vec(c, x2, gy2)
    blocks = reduce_blocks(mode, rows, c, vec, _sms(x2.device))
    part = torch.empty((blocks, width), device=x2.device)
    out = torch.empty(width, device=x2.device)
    lib = build.library("batchnorm")
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    build.check(lib.ptw_bn_reduce(
        mode, x2.data_ptr(), m1.data_ptr(), _ptr(gy2), _ptr(mean), _ptr(r),
        _ptr(weight), part.data_ptr(), rows, c, width, int(vec),
        int(x2.dtype == torch.bfloat16), blocks, stream), "batchnorm reduce")
    build.check(lib.ptw_bn_finalize(part.data_ptr(), out.data_ptr(), blocks,
                                    width, stream), "batchnorm finalize")
    batch_norm_train.launches += 2
    return out


def _elementwise(mode, x2, m1, gy2, mean, r, weight, v1, v2=None):
    """An elementwise pass: (rows, C) in x's dtype."""
    rows, c = x2.shape
    if x2.device.type == "cpu" or rows == 0:
        return elementwise_plain(mode, x2, m1, gy2, mean, r, weight, v1, v2)
    out = torch.empty_like(x2)
    vec = _vec(c, x2, out, gy2)
    # a grid-stride loop: the statistics passes' grid serves it
    blocks = reduce_blocks(STAT1, rows, c, vec, _sms(x2.device))
    build.check(build.library("batchnorm").ptw_bn_elementwise(
        mode, x2.data_ptr(), m1.data_ptr(), _ptr(gy2), mean.data_ptr(),
        r.data_ptr(), weight.data_ptr(), v1.data_ptr(), _ptr(v2),
        out.data_ptr(), rows, c, int(vec), int(x2.dtype == torch.bfloat16),
        blocks, torch.cuda.current_stream(x2.device).cuda_stream),
        "batchnorm elementwise")
    batch_norm_train.launches += 1
    return out


def batch_stats(x2, m1, eps: float):
    """Passes 1-2: (mean, var, n, r), float32, from the valid rows."""
    s = _reduce(STAT1, x2, m1)
    n = torch.clamp(s[-1], min=1.0)
    mean = s[:-1] / n
    var = _reduce(STAT2, x2, m1, mean=mean) / n
    return mean, var, n, torch.rsqrt(var + eps)


def grad_sums(x2, m1, gy2, mean, r, weight, n):
    """Pass 4: (g_weight, g_bias, g_s2, g_mean), float32 (C,)."""
    c = x2.shape[1]
    s = _reduce(GRAD, x2, m1, gy2, mean, r, weight).view(5, c)
    g_bias, g_weight, g_r, g_xr, s_d = s.unbind(0)
    g_s2 = g_r * (-0.5) * r ** 3 / n
    g_mean = -(g_xr + 2.0 * s_d * g_s2)
    return g_weight, g_bias, g_s2, g_mean


class FusedBatchStatsNorm(torch.autograd.Function):
    """``layers._BatchStatsNorm`` (one process, float32 sums) in the
    passes above: forward(x (..., C) bf16 or fp32, m bool broadcastable to
    (..., 1), weight, bias fp32 (C,), eps) -> (y in x's dtype, mean, var,
    n) float32, the last three without gradient. Saves x in its own
    dtype, the row mask and (C,) vectors."""

    @staticmethod
    def forward(ctx, x, m, weight, bias, eps):
        c = x.shape[-1]
        x2 = x.contiguous().view(-1, c)
        m1 = m.expand(x.shape[:-1] + (1,)).reshape(-1).contiguous()
        mean, var, n, r = batch_stats(x2, m1, eps)
        y = _elementwise(APPLY, x2, m1, None, mean, r, weight, bias)
        ctx.save_for_backward(x2, m1, mean, r, weight, n)
        ctx.mark_non_differentiable(mean, var, n)
        return y.view(x.shape), mean, var, n

    @staticmethod
    def backward(ctx, gy, *_):
        x2, m1, mean, r, weight, n = ctx.saved_tensors
        gy2 = gy.contiguous().view(x2.shape)
        g_weight, g_bias, g_s2, g_mean = grad_sums(x2, m1, gy2, mean, r,
                                                   weight, n)
        g_x = _elementwise(GRAD_INPUT, x2, m1, gy2, mean, r, weight, g_s2,
                           g_mean / n)
        return g_x.view(gy.shape), None, g_weight, g_bias, None


def batch_norm_train(x: torch.Tensor, m: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float):
    """Masked batch-statistic BatchNorm of x (..., C), bf16 or fp32, with
    validity m (bool, broadcastable to (..., 1)): (y in x's dtype, mean,
    var, n), float32 statistics of the valid rows. CPU tensors run the
    plain transcription; CUDA tensors the kernels."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"batch_norm_train: x must be bf16 or fp32, got "
                        f"{x.dtype}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32 \
            or m.dtype != torch.bool:
        raise TypeError("batch_norm_train: needs fp32 weight and bias and a "
                        "bool mask")
    c = x.shape[-1]
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,) \
            or m.shape[-1] != 1:
        raise ValueError(f"batch_norm_train: bad shapes x {tuple(x.shape)} "
                         f"m {tuple(m.shape)} weight {tuple(weight.shape)}")
    if not x.device == m.device == weight.device == bias.device:
        raise ValueError("batch_norm_train: inputs on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"batch_norm_train: no kernel for {x.device}")
    return FusedBatchStatsNorm.apply(x, m, weight, bias, eps)


batch_norm_train.launches = 0
