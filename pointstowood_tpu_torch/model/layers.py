"""Building blocks of the backbone (port of
pointstowood_tpu/model/layers.py).

The module tree and parameter names follow the reference's torch modules
(pointstowood/src/model.py), so ``Net.state_dict()`` has the reference's
key layout and a reference ``.pth`` loads with ``load_state_dict``.

Compute dtype: like flax ``Dense(dtype=bf16)``, a linear layer casts its
input, weight and bias to the compute dtype and adds the bias after the
product; BatchNorm computes in fp32 and returns its input's dtype. The
casts are explicit (no autocast), so the CPU and the GPU follow one path.

Every block takes the validity ``mask`` of its elements and a
``use_running_average`` flag, as the JAX modules do. With running
averages, BatchNorm is a fixed affine and the mask is not read; with batch
statistics it is taken over the valid elements only, and the running
statistics are updated in place.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
from torch import nn

from pointstowood_tpu_torch.parallel.mesh import spans_processes


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
          dtype: torch.dtype, per_sample: bool = False) -> torch.Tensor:
    """flax Dense semantics: (x @ W^T) + b, all in ``dtype``. weight is
    (out, in), or (out, in, 1) for a 1x1 Conv1d.

    ``per_sample`` (a module under a data group): one product a sample of
    the leading (batch) axis. A BLAS picks its kernel, and with it the
    order of each dot product's sums, by the product's shape, so a
    sample's rows then come out the same whatever the number of samples
    beside it: a batch split over processes computes what the whole batch
    computes in one (with batched products cuBLAS put a split fp32 train
    step 1.5% from a group of one's on a gradient tensor, where the CPU's
    BLAS stayed within 8e-7). Each sample casts the weight and bias itself, so its
    share of their gradients comes back to float32 before the shares are
    summed (in ``dtype`` a share summed with the others would round at
    each addition, and differently for each split)."""
    if weight.dim() == 3:
        weight = weight[..., 0]
    if per_sample and x.dim() > 2:
        return torch.stack([dense(xi, weight, bias, dtype)
                            for xi in x.unbind(0)])
    y = torch.matmul(x.to(dtype), weight.to(dtype).t())
    if bias is not None:
        y = y + bias.to(dtype)
    return y


class _BatchStatsNorm(torch.autograd.Function):
    """Masked batch-statistic normalisation, (x - mean) * rsqrt(var + eps)
    * weight + bias, with its own backward (as ``nn.SyncBatchNorm``). It
    saves x, the mask and per-channel vectors only, where autograd through
    the same expressions would keep several activations' worth.

    Every sum over the batch (the count, Σx and Σ(x - mean)² forward;
    Σ dL/dxhat (x - mean), Σ dL/d(x - mean) and the weight's and bias's
    gradients backward) accumulates in ``sum_dtype``: float32 for one
    process, the sums the JAX package takes; float64 under a data group,
    rounded to float32 once. With ~1e-16 relative error before that
    rounding the float32 results do not depend on the order of the terms,
    so they come out the same however the batch is split over processes
    (float32 sums in a split-dependent order lie a few ulp apart, which
    the network's ~45 batch-statistic BatchNorms amplify to percents of a
    gradient). Elementwise work stays in float32. With ``process_group``
    the four sums of the statistics and their gradients go over the group
    (count and Σx in one collective), and a process whose rows are all
    padding joins them all the same; the parameters' gradients are this
    process's share (the trainer sums them over the group). The mask is
    applied with where(), never by multiplying: masked lanes can hold inf
    garbage, and inf * 0 = NaN would poison the statistic.

    forward(x fp32 (..., C), m bool (..., 1), weight, bias, eps,
    process_group, sum_dtype) -> (y, mean, var, n) fp32, the last three
    without gradient (for the running update)."""

    @staticmethod
    def forward(ctx, x, m, weight, bias, eps, process_group, sum_dtype):
        dims = tuple(range(x.dim() - 1))
        sums = torch.cat([torch.where(m, x, 0.0).sum(dims, dtype=sum_dtype),
                          m.sum(dtype=sum_dtype).reshape(1)])
        if process_group is not None:
            dist.all_reduce(sums, group=process_group)
        n = torch.clamp(sums[-1], min=1.0)
        mean = (sums[:-1] / n).float()
        d = x - mean
        s2 = torch.where(m, torch.square(d), 0.0).sum(dims, dtype=sum_dtype)
        if process_group is not None:
            dist.all_reduce(s2, group=process_group)
        var = (s2 / n).float()
        n = n.float()
        r = torch.rsqrt(var + eps)
        y = d * r * weight + bias
        ctx.save_for_backward(x, m, mean, r, weight, n)
        ctx.process_group, ctx.sum_dtype = process_group, sum_dtype
        ctx.mark_non_differentiable(mean, var, n)
        return y, mean, var, n

    @staticmethod
    def backward(ctx, gy, *_):
        x, m, mean, r, weight, n = ctx.saved_tensors
        pg, sd = ctx.process_group, ctx.sum_dtype
        dims = tuple(range(x.dim() - 1))
        d = x - mean
        g_bias = gy.sum(dims, dtype=sd).float()
        g_weight = (gy * (d * r)).sum(dims, dtype=sd).float()
        g_xhat = gy * weight
        # through rsqrt(var + eps): var = Σ m d² / n
        g_r = (g_xhat * d).sum(dims, dtype=sd)
        if pg is not None:
            dist.all_reduce(g_r, group=pg)
        g_s2 = (g_r * (-0.5) * r.to(sd) ** 3 / n).float()
        g_d = g_xhat * r + torch.where(m, 2.0 * d * g_s2, 0.0)
        # through mean = Σ m x / n, which every d subtracts
        g_mean = -g_d.sum(dims, dtype=sd)
        if pg is not None:
            dist.all_reduce(g_mean, group=pg)
        g_x = g_d + torch.where(m, (g_mean / n).float(), 0.0)
        return g_x, None, g_weight, g_bias, None, None, None


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm over all non-channel dims, restricted to valid elements:
    (x - mean) * rsqrt(var + eps) * weight + bias in fp32, cast back to
    x.dtype. Subclasses BatchNorm1d for the reference's parameter and
    buffer names.

    torch.nn.BatchNorm1d semantics, as the JAX module: with batch
    statistics (``use_running_average=False``) it normalises with the
    biased variance of the valid elements (``_BatchStatsNorm``) and
    updates ``running = (1 - momentum) * running + momentum * batch``
    with the *unbiased* variance ``var * n / max(n - 1, 1)`` (n = number
    of valid elements); otherwise it normalises with the running
    statistics.

    ``data_group`` (a ``parallel.DataGroup``, None by default; set by
    ``set_data_group``), after ``nn.SyncBatchNorm``'s ``process_group``:
    the batch statistics and their gradients are those of the group's
    global batch, summed in float64, so every process normalises, and
    updates its running statistics, as one process with the whole batch
    and a group of one does. Without a group the sums are float32, as the
    JAX package's (one process's step is held to the JAX package's, its
    counts exactly, by tests/test_torch_train.py)."""

    data_group = None

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                use_running_average: bool = True) -> torch.Tensor:
        x32 = x.float()
        if use_running_average:
            y = (x32 - self.running_mean) * torch.rsqrt(self.running_var
                                                        + self.eps)
            return (y * self.weight + self.bias).to(x.dtype)
        if mask is None:
            mask = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
        group = self.data_group
        y, mean, var, n = _BatchStatsNorm.apply(
            x32, m, self.weight, self.bias, self.eps,
            group.process_group if spans_processes(group) else None,
            torch.float32 if group is None else torch.float64)
        with torch.no_grad():
            mo = self.momentum
            unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
            self.running_mean.copy_((1 - mo) * self.running_mean + mo * mean)
            self.running_var.copy_((1 - mo) * self.running_var
                                   + mo * unbiased)
        return y.to(x.dtype)


def set_data_group(net: nn.Module, group) -> nn.Module:
    """Run ``net`` over ``group`` (a ``parallel.DataGroup``, or None for
    this process alone): the ``data_group`` of every module of ``net``
    that has one. Every ``MaskedBatchNorm`` (in ``Net`` and in the
    attention modules alike) then takes the global batch's statistics,
    every SA stage draws the global batch's training centres and every
    module with products runs them a sample at a time (``dense``), so
    that a run split over the group's processes computes what one process
    computes with the whole batch. Returns ``net``."""
    for mod in net.modules():
        if hasattr(mod, "data_group"):
            mod.data_group = group
    return net


class RefMLP(nn.Sequential):
    """The reference MLP factory (model.py:198-202): for channels
    [c0, ..., cn], block i is Linear -> ReLU, plus a BatchNorm after the
    ReLU on every block but the first. Keys: ``{i-1}.0`` linear,
    ``{i-1}.2`` BatchNorm."""

    def __init__(self, channels: Sequence[int], dtype=torch.float32):
        blocks = []
        for i in range(1, len(channels)):
            layers = [nn.Linear(channels[i - 1], channels[i]), nn.ReLU()]
            if i != 1:
                layers.append(MaskedBatchNorm(channels[i]))
            blocks.append(nn.Sequential(*layers))
        super().__init__(*blocks)
        self.dtype = dtype

    data_group = None  # set_data_group: products a sample (dense)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                use_running_average: bool = True) -> torch.Tensor:
        x = x.to(self.dtype)
        per_sample = self.data_group is not None
        for block in self:
            lin = block[0]
            x = torch.relu(dense(x, lin.weight, lin.bias, self.dtype,
                                 per_sample))
            if len(block) > 2:
                x = block[2](x, mask, use_running_average)
        return x


class DepthwiseSeparableBlock(nn.Module):
    """DepthwiseSeparableConv1d with kernel_size=1 (model.py:18-44):
    depthwise (a per-channel affine) -> BN -> ReLU -> pointwise -> BN ->
    ReLU."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.depthwise_conv = nn.Conv1d(features, features, 1, groups=features)
        self.depthwise_bn = MaskedBatchNorm(features)
        self.pointwise_conv = nn.Conv1d(features, features, 1)
        self.pointwise_bn = MaskedBatchNorm(features)
        self.dtype = dtype

    data_group = None  # set_data_group: products a sample (dense)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                use_running_average: bool = True) -> torch.Tensor:
        dt = self.dtype
        ura = use_running_average
        dw = self.depthwise_conv
        x = x * dw.weight.reshape(-1).to(dt) + dw.bias.to(dt)
        x = torch.relu(self.depthwise_bn(x, mask, ura))
        pw = self.pointwise_conv
        x = dense(x, pw.weight, pw.bias, dt, self.data_group is not None)
        return torch.relu(self.pointwise_bn(x, mask, ura))


class InvertedResidualBlock(nn.Module):
    """MobileNet-style inverted residual over per-point features
    (model.py:46-85); in == out features, so the shortcut is the
    identity."""

    def __init__(self, features: int, expansion_factor: int = 4,
                 dtype=torch.float32):
        super().__init__()
        e = features * expansion_factor
        self.expand = nn.Sequential(nn.Conv1d(features, e, 1),
                                    MaskedBatchNorm(e), nn.ReLU())
        self.conv = nn.Sequential(
            DepthwiseSeparableBlock(e, dtype), MaskedBatchNorm(e), nn.ReLU(),
            DepthwiseSeparableBlock(e, dtype), MaskedBatchNorm(e),
        )
        self.project = nn.Sequential(nn.Conv1d(e, features, 1),
                                     MaskedBatchNorm(features))
        self.shortcut = nn.Sequential()
        self.dtype = dtype

    data_group = None  # set_data_group: products a sample (dense)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                use_running_average: bool = True) -> torch.Tensor:
        dt = self.dtype
        m, ura = mask, use_running_average
        per_sample = self.data_group is not None
        x = x.to(dt)
        conv = self.expand[0]
        h = dense(x, conv.weight, conv.bias, dt, per_sample)
        h = torch.relu(self.expand[1](h, m, ura))
        h = torch.relu(self.conv[1](self.conv[0](h, m, ura), m, ura))
        h = self.conv[4](self.conv[3](h, m, ura), m, ura)
        conv = self.project[0]
        h = self.project[1](dense(h, conv.weight, conv.bias, dt, per_sample),
                            m, ura)
        return torch.relu(h + x)


class ReflectanceGate(nn.Module):
    """The reference's ReflectanceYesNo module (model.py:155-175). Its
    output is identically 1 (a hard gumbel-softmax over one logit); the
    parameters exist so checkpoint keys match. They get no gradient (their
    ``grad`` stays None), and the trainer still decays them, as optax does
    with the zero gradients JAX gives them."""

    def __init__(self, hidden_dim: int = 32):
        super().__init__()
        self.fc1 = nn.Linear(1, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.fc3 = nn.Linear(hidden_dim, 1)

    def forward(self, reflectance: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(reflectance)


class ReflectanceWeighting(nn.Module):
    """The reference's ReflectanceWeighting module (model.py:177-196; JAX
    ``model/layers.py:187-215``): a two-layer ReLU MLP over each point's
    reflectance, mean-pooled over the valid points of each tile, projected
    to one ReLU'd weight per tile and broadcast back to every point of
    it. Dead code upstream, as in the JAX package: the reference Net never
    builds it, so no checkpoint holds its parameters and ``Net`` does not
    use it. Keys ``fc1``, ``fc2``, ``fc3``, the flax module's names
    (``utils.checkpoint_convert.state_dict_from_flax`` carries them as the
    gate's).

    forward(reflectance (..., N), mask (..., N) bool or None) -> (..., N)
    fp32."""

    def __init__(self, hidden_dim: int = 32):
        super().__init__()
        self.fc1 = nn.Linear(1, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.fc3 = nn.Linear(hidden_dim, 1)

    def forward(self, reflectance: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        f32 = torch.float32
        h = torch.relu(dense(reflectance[..., None], self.fc1.weight,
                             self.fc1.bias, f32))
        h = torch.relu(dense(h, self.fc2.weight, self.fc2.bias, f32))
        if mask is None:
            pooled = h.mean(-2)
        else:
            m = mask[..., None]
            pooled = torch.where(m, h, 0.0).sum(-2) / torch.clamp(
                m.to(h.dtype).sum(-2), min=1.0)
        w = torch.relu(dense(pooled, self.fc3.weight, self.fc3.bias, f32))
        return w.expand(reflectance.shape)
