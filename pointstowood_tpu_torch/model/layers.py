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
from torch import nn


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
          dtype: torch.dtype) -> torch.Tensor:
    """flax Dense semantics: (x @ W^T) + b, all in ``dtype``. weight is
    (out, in), or (out, in, 1) for a 1x1 Conv1d."""
    if weight.dim() == 3:
        weight = weight[..., 0]
    y = torch.matmul(x.to(dtype), weight.to(dtype).t())
    if bias is not None:
        y = y + bias.to(dtype)
    return y


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm over all non-channel dims, restricted to valid elements:
    (x - mean) * rsqrt(var + eps) * weight + bias in fp32, cast back to
    x.dtype. Subclasses BatchNorm1d for the reference's parameter and
    buffer names.

    torch.nn.BatchNorm1d semantics, as the JAX module: with batch
    statistics (``use_running_average=False``) it normalises with the
    biased variance of the valid elements and updates
    ``running = (1 - momentum) * running + momentum * batch`` with the
    *unbiased* variance ``var * n / max(n - 1, 1)`` (n = number of valid
    elements); otherwise it normalises with the running statistics."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                use_running_average: bool = True) -> torch.Tensor:
        x32 = x.float()
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            if mask is None:
                mask = torch.ones(x.shape[:-1], dtype=torch.bool,
                                  device=x.device)
            dims = tuple(range(x.dim() - 1))
            # where(), never x * mask: masked lanes can hold inf garbage
            # and inf * 0 = NaN would poison the whole statistic
            m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
            n = torch.clamp(m.sum(dtype=torch.float32), min=1.0)
            mean = torch.where(m, x32, 0.0).sum(dims) / n
            var = torch.where(m, torch.square(x32 - mean), 0.0).sum(dims) / n
            with torch.no_grad():
                mo = self.momentum
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                self.running_mean.copy_(
                    (1 - mo) * self.running_mean + mo * mean)
                self.running_var.copy_(
                    (1 - mo) * self.running_var + mo * unbiased)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight + self.bias
        return y.to(x.dtype)


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

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                use_running_average: bool = True) -> torch.Tensor:
        x = x.to(self.dtype)
        for block in self:
            lin = block[0]
            x = torch.relu(dense(x, lin.weight, lin.bias, self.dtype))
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

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                use_running_average: bool = True) -> torch.Tensor:
        dt = self.dtype
        ura = use_running_average
        dw = self.depthwise_conv
        x = x * dw.weight.reshape(-1).to(dt) + dw.bias.to(dt)
        x = torch.relu(self.depthwise_bn(x, mask, ura))
        pw = self.pointwise_conv
        x = dense(x, pw.weight, pw.bias, dt)
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

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                use_running_average: bool = True) -> torch.Tensor:
        dt = self.dtype
        m, ura = mask, use_running_average
        x = x.to(dt)
        conv = self.expand[0]
        h = dense(x, conv.weight, conv.bias, dt)
        h = torch.relu(self.expand[1](h, m, ura))
        h = torch.relu(self.conv[1](self.conv[0](h, m, ura), m, ura))
        h = self.conv[4](self.conv[3](h, m, ura), m, ura)
        conv = self.project[0]
        h = self.project[1](dense(h, conv.weight, conv.bias, dt), m, ura)
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
