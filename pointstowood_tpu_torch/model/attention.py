"""Attention variants of the backbone (port of
pointstowood_tpu/model/attention.py).

The archived attention components of the reference, in the dense padded
layout, behind ``Net(attention_knn=..., attention_conv=...)``:

* ``PositionalEncoding`` / ``AdaptiveBlending`` / ``ATSearchKNN``: a
  learned feature-space neighbour search (reference:
  pointstowood/archive/attknnv3.py): a sinusoidal encoding of xyz,
  learned blending weights of positions and features, a per-sample
  standardisation, then the kNN of the centres in that
  (3 + 2A + C_in)-dimensional embedding. The search returns indices
  only, so the blending weights get no gradient (the train step gives
  them a zero one, and AdamW still decays them, as optax does).
* ``AttentivePointConv``: QKV attention messages over each neighbourhood
  (reference: pointstowood/src/pointnetatt.py), LayerNorm -> MLP ->
  output projection, an optional local MLP, and a masked max.

Module and parameter names follow the JAX package's (``encoding``,
``blending.feat1`` ..., ``qkv_proj``, ``norm``, ``mlp``, ``out_proj``,
``local_nn``), so ``utils/checkpoint_convert`` maps its variables.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from pointstowood_tpu_torch.model.layers import RefMLP, dense
from pointstowood_tpu_torch.model.pointconv import gather_rows
from pointstowood_tpu_torch.ops.knn import knn_masked


# The encoding's bands: linearly spaced from 1 to MAX_FREQ (attknnv3.py)
MAX_FREQ = 10.0
NUM_BANDS = 64


def band_frequencies(max_freq: float, num_bands: int) -> np.ndarray:
    """The frequency bands of ``PositionalEncoding``: ``jnp.linspace(1.0,
    max_freq, num_bands)``'s formula, start * (1 - i / (n - 1)) + stop *
    i / (n - 1) for i < n - 1, then stop, each operation rounded to fp32
    (float32 numpy). ``torch.linspace`` interpolates from both ends instead
    (22 of the 64 default bands differ from these, by up to 2 ulps); the
    JAX package's own bands depend on how XLA divides on its device (on
    the CPU 10-11 of them lie 1-2 ulps away)."""
    f32 = np.float32
    if num_bands == 1:
        return np.array([1.0], f32)
    step = np.arange(num_bands - 1, dtype=f32) / f32(num_bands - 1)
    out = f32(1.0) * (f32(1.0) - step) + f32(max_freq) * step
    return np.concatenate([out, [f32(max_freq)]]).astype(f32)


class PositionalEncoding(nn.Module):
    """Sinusoidal encoding of xyz (attknnv3.py:12-28): sin and cos of each
    coordinate times each band, laid out (axis, band, sin/cos) on the last
    axis and cut to ``d_model`` channels. No parameters."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model
        self.register_buffer(
            "freq", torch.from_numpy(band_frequencies(MAX_FREQ, NUM_BANDS)),
            persistent=False)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        x_freq = xyz[..., None] * self.freq                  # (..., 3, F)
        enc = torch.stack([torch.sin(x_freq), torch.cos(x_freq)], dim=-1)
        return enc.reshape(xyz.shape[:-1] + (-1,))[..., :self.d_model]


class AdaptiveBlending(nn.Module):
    """Learned position-vs-feature blending weights (attknnv3.py:30-50):
    two two-layer MLPs to one logit each, softmaxed against each other.
    Returns (feature weight, position weight), each (..., 1)."""

    def __init__(self, feat_in: int, pos_in: int, attention_dim: int):
        super().__init__()
        self.feat1 = nn.Linear(feat_in, attention_dim)
        self.feat2 = nn.Linear(attention_dim, 1)
        self.pos1 = nn.Linear(pos_in, attention_dim)
        self.pos2 = nn.Linear(attention_dim, 1)

    data_group = None  # layers.set_data_group: products a sample (dense)

    def forward(self, features, pos):
        f32 = torch.float32
        per_sample = self.data_group is not None

        def mlp(x, l1, l2):
            h = torch.relu(dense(x, l1.weight, l1.bias, f32, per_sample))
            return dense(h, l2.weight, l2.bias, f32, per_sample)

        soft = torch.softmax(torch.cat([mlp(features, self.feat1, self.feat2),
                                        mlp(pos, self.pos1, self.pos2)], -1),
                             dim=-1)
        return soft[..., :1], soft[..., 1:2]


class ATSearchKNN(nn.Module):
    """Feature-space kNN (attknnv3.py:52-83).

    forward(x (B, N, C_in), pos4 (B, N, 4) *unscaled* xyz + reflectance,
    mask (B, N), center_idx (B, S), center_valid (B, S)) -> (nbr_idx
    (B, S, k) int64, nbr_valid (B, S, k)). The embedding [pos_enc * pw,
    feats * fw] (pos_enc = [xyz, enc], feats = [x, enc], enc of
    ``attention_dim`` channels) is standardised per sample over its valid
    points (population variance, / (std + 1e-8)), and each centre's k
    nearest valid points in it are found by ``knn_masked``: on the card
    with ``method="fast"`` that is ``knn_topk_dim``."""

    def __init__(self, k: int, attention_dim: int, in_channels: int,
                 knn_method: str = "fast"):
        super().__init__()
        self.k = k
        self.knn_method = knn_method
        self.encoding = PositionalEncoding(attention_dim)
        self.blending = AdaptiveBlending(in_channels + attention_dim,
                                         3 + attention_dim, attention_dim)

    @torch.no_grad()
    def forward(self, x, pos4, mask, center_idx, center_valid):
        pos3 = pos4[..., :3]
        enc = self.encoding(pos3)
        feats = torch.cat([x.float(), enc], dim=-1)
        pos_enc = torch.cat([pos3, enc], dim=-1)
        fw, pw = self.blending(feats, pos_enc)
        combined = torch.cat([pos_enc * pw, feats * fw], dim=-1)
        # per-sample standardisation over the valid points (attknnv3.py:
        # 7-10 normalises per batch id with scatter mean/std)
        m = mask[..., None].to(combined.dtype)
        count = torch.clamp(m.sum(1, keepdim=True), min=1.0)
        mean = (combined * m).sum(1, keepdim=True) / count
        var = (torch.square(combined - mean) * m).sum(1, keepdim=True) / count
        combined = (combined - mean) / (torch.sqrt(var) + 1e-8)
        centers = gather_rows(combined, center_idx)
        nbr_idx, _, nbr_valid = knn_masked(
            centers, combined, self.k, query_mask=center_valid,
            source_mask=mask, method=self.knn_method)
        return nbr_idx, nbr_valid


class LayerNorm(nn.LayerNorm):
    """flax.linen.LayerNorm over the last axis: eps 1e-6, statistics in
    fp32 (mean, and the variance as E[x^2] - E[x]^2 clipped at 0),
    (x - mean) * (rsqrt(var + eps) * weight) + bias, cast back to x's
    dtype. Parameters ``weight``/``bias`` (flax ``scale``/``bias``)."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(x.dtype)


class AttentivePointConv(nn.Module):
    """QKV neighbourhood attention conv (pointnetatt.py:1-117) in the
    dense fixed-k layout.

    forward(x (B, N, C_in), pos4 (B, N, 4) scaled xyz + reflectance,
    center_idx (B, S), nbr_idx (B, S, k), nbr_valid (B, S, k),
    center_valid (B, S), radius=None (SA1's (B, 1, 1) cap, applied before
    the neighbourhood's max distance), use_running_average=True) ->
    (B, S, C_out). Messages [rel-pos / max_dist, reflectance_j, x_j] go
    through bias-free q/k/v projections of a = max(C_in // 2, 32)
    channels; the softmax over each neighbourhood runs in fp32 with
    invalid slots at -inf (a neighbourhood with none valid gives zeros);
    then LayerNorm -> ReLU(mlp) -> out_proj, ``local_nn`` (a reference MLP
    of widths ``local_channels``, from C_in; batch statistics over the
    valid edges) and a masked max, zero where a centre has no valid
    neighbour."""

    def __init__(self, in_channels: int, local_channels: tuple,
                 dtype=torch.float32):
        super().__init__()
        a = max(in_channels // 2, 32)
        self.a = a
        self.dtype = dtype
        self.qkv_proj = nn.Linear(in_channels + 4, 3 * a, bias=False)
        self.norm = LayerNorm(a)
        self.mlp = nn.Linear(a, a, bias=False)
        self.out_proj = nn.Linear(a, in_channels, bias=False)
        self.local_nn = RefMLP(local_channels, dtype)

    data_group = None  # layers.set_data_group: products a sample (dense)

    def forward(self, x, pos4, center_idx, nbr_idx, nbr_valid, center_valid,
                radius=None, use_running_average: bool = True):
        dt = self.dtype
        gathered = gather_rows(torch.cat([x.float(), pos4], dim=-1), nbr_idx)
        pos_j, x_j = gathered[..., -4:], gathered[..., :-4]
        pos_i = gather_rows(pos4, center_idx)
        rel = pos_j[..., :3] - pos_i[:, :, None, :3]
        # sqrt(sum + tiny), as the JAX package (a zero distance has a NaN
        # norm gradient there)
        dist = torch.sqrt((rel * rel).sum(-1) + 1e-24)
        if radius is not None:
            nbr_valid = nbr_valid & (dist <= radius)
        max_dist = torch.where(nbr_valid, dist, 0.0).amax(-1, keepdim=True)
        geo = rel / (max_dist[..., None] + 1e-8)
        combined = torch.cat([geo, pos_j[..., 3:4], x_j], dim=-1).to(dt)

        per_sample = self.data_group is not None
        qkv = dense(combined, self.qkv_proj.weight, None, dt, per_sample)
        q, k, v = qkv.split(self.a, dim=-1)
        logits = (q * k).sum(-1) * (float(self.a) ** -0.5)
        logits = torch.where(nbr_valid, logits.float(), -math.inf)
        attn = torch.where(nbr_valid, torch.softmax(logits, dim=-1), 0.0)
        out = self.norm(v * attn[..., None].to(v.dtype))
        out = torch.relu(dense(out, self.mlp.weight, None, dt, per_sample))
        out = dense(out, self.out_proj.weight, None, dt, per_sample)
        out = self.local_nn(out, mask=nbr_valid,
                            use_running_average=use_running_average)
        neg = torch.finfo(out.dtype).min
        agg = torch.where(nbr_valid[..., None], out, neg).amax(dim=-2)
        any_nbr = nbr_valid.any(-1) & center_valid
        return torch.where(any_nbr[..., None], agg, 0.0).to(out.dtype)
