"""Building blocks of the backbone, eval mode (port of
pointstowood_tpu/model/layers.py).

The module tree and parameter names follow the reference's torch modules
(pointstowood/src/model.py), so ``Net.state_dict()`` has the reference's
key layout and a reference ``.pth`` loads with ``load_state_dict``.

Compute dtype: like flax ``Dense(dtype=bf16)``, a linear layer casts its
input, weight and bias to the compute dtype and adds the bias after the
product; BatchNorm computes in fp32 and returns its input's dtype. The
casts are explicit (no autocast), so the CPU and the GPU follow one path.

This slice ports inference only: BatchNorm always uses its running
statistics, which makes the JAX package's validity masks irrelevant here
(they only select the elements of the batch statistics).
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
    """BatchNorm over all non-channel dims with running statistics (eval):
    (x - mean) * rsqrt(var + eps) * weight + bias in fp32, cast back to
    x.dtype. Subclasses BatchNorm1d for the reference's parameter and
    buffer names."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = (x32 - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for block in self:
            lin = block[0]
            x = torch.relu(dense(x, lin.weight, lin.bias, self.dtype))
            if len(block) > 2:
                x = block[2](x)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        dw = self.depthwise_conv
        x = x * dw.weight.reshape(-1).to(dt) + dw.bias.to(dt)
        x = torch.relu(self.depthwise_bn(x))
        pw = self.pointwise_conv
        x = dense(x, pw.weight, pw.bias, dt)
        return torch.relu(self.pointwise_bn(x))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        conv = self.expand[0]
        h = torch.relu(self.expand[1](dense(x, conv.weight, conv.bias, dt)))
        h = torch.relu(self.conv[1](self.conv[0](h)))
        h = self.conv[4](self.conv[3](h))
        conv = self.project[0]
        h = self.project[1](dense(h, conv.weight, conv.bias, dt))
        return torch.relu(h + x)


class ReflectanceGate(nn.Module):
    """The reference's ReflectanceYesNo module (model.py:155-175). Its
    output is identically 1 (a hard gumbel-softmax over one logit); the
    parameters exist so checkpoint keys match."""

    def __init__(self, hidden_dim: int = 32):
        super().__init__()
        self.fc1 = nn.Linear(1, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.fc3 = nn.Linear(hidden_dim, 1)

    def forward(self, reflectance: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(reflectance)
