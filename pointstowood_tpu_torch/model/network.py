"""The wood/leaf segmentation backbone (port of
pointstowood_tpu/model/network.py).

A PointNet++-style encoder/decoder over padded (B, N) tile batches
(reference: pointstowood/src/model.py:204-245): stem MLP [3 -> C]; three
set-abstraction stages at voxel resolutions 0.04/0.08/0.16 with local
MLPs [C+4, 2C, 4C] / [4C+4, 6C, 8C] / [8C+4, 12C, 16C], each followed by an
inverted residual block; a global max-pool stage [16C+3, 16C, 16C]; four
feature-propagation stages with k=2 inverse-distance interpolation (FP4
from the single global vector is an exact broadcast); and a
Conv1d -> BN -> ReLU -> Conv1d head.

Neighbour routes: ``Net.stage_routes`` decides, once per level, whether
the SA stage also returns the transpose top-2 for its FP stage
("transpose"), or the FP stage searches itself ("fused" or "gather", the
JAX package's two search routes). It applies the JAX package's rule and
shape gates, so both packages take the same route at every shape.

Attention variants, as the JAX ``Net``'s flags: ``attention_knn``
replaces the SA2/SA3 neighbour search by ``ATSearchKNN`` (SA1 keeps its
radius kNN), and those levels then take no transpose route: their FP
stages search for themselves, as in the JAX package, whose attention
stages ignore the transpose; ``attention_conv`` replaces each SA stage's
PointConv by ``AttentivePointConv``, SA1's included, which then takes the
stem's output as features (no per-edge stem).

Two modes, as the JAX ``Net(training, use_running_average)``: the
sampling mode (``training``: exactly 50% of the valid points at random,
drawn from a caller-given ``torch.Generator``; otherwise voxel
representatives) and the BatchNorm mode (``use_running_average``:
running statistics, or masked batch statistics that also update them)
are two arguments; by default they pair up. The BatchNorm recalibration
of the trainer runs eval sampling with batch statistics.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pointstowood_tpu_torch.model.attention import (
    ATSearchKNN,
    AttentivePointConv,
)
from pointstowood_tpu_torch.model.layers import (
    InvertedResidualBlock,
    MaskedBatchNorm,
    RefMLP,
    ReflectanceGate,
    dense,
)
from pointstowood_tpu_torch.model.pointconv import PointConv, gather_rows
from pointstowood_tpu_torch.ops.interpolate import (
    knn_interpolate_batched,
    uses_fused_kernel,
)
from pointstowood_tpu_torch.ops.knn import knn_masked, knn_topk_with_transpose
from pointstowood_tpu_torch.ops.knn_kernels import transpose_supported
from pointstowood_tpu_torch.ops.sampling import random_sample
from pointstowood_tpu_torch.ops.voxel import (
    voxel_cell_ids,
    voxel_representatives,
)

# Largest FP source count the JAX package hands to its fused
# interpolation kernel (network.py: fused_bound): training differentiates
# through it, where the fused route also wins at FP2's 4096 sources.
FUSED_MAX_SOURCES_EVAL = 2048
FUSED_MAX_SOURCES_TRAIN = 4096


class SAStage(nn.Module):
    """One set-abstraction stage: voxel-sample centres, gather fixed-k
    neighbourhoods, PointConv, inverted residual block (reference
    SAModule, model.py:87-127). ``attention_knn`` searches the
    neighbourhoods with ``ATSearchKNN`` (``atsearch``) where the stage has
    no radius; ``attention_conv`` makes ``conv`` an
    ``AttentivePointConv`` over the stage's input features (of
    nn_channels[0] - 4 channels)."""

    def __init__(self, resolution: float, k: int, nn_channels: tuple,
                 out_features: int, use_radius: bool,
                 knn_method: str = "fast", voxel_priority: str = "hash",
                 dtype=torch.float32, attention_knn: bool = False,
                 attention_conv: bool = False):
        super().__init__()
        self.resolution = resolution
        self.k = k
        self.use_radius = use_radius
        self.knn_method = knn_method
        self.voxel_priority = voxel_priority
        self.attention_conv = attention_conv
        self.reflectanceyesno = ReflectanceGate()
        in_channels = nn_channels[0] - 4
        self.atsearch = (
            ATSearchKNN(k, nn_channels[0] // 2, in_channels, knn_method)
            if attention_knn and not use_radius else None)
        self.conv = (
            AttentivePointConv(in_channels,
                               (in_channels,) + tuple(nn_channels[1:]), dtype)
            if attention_conv else PointConv(nn_channels, dtype))
        self.residual_block = InvertedResidualBlock(out_features, dtype=dtype)
        # the data-parallel group whose global batch the training centres
        # are drawn for (layers.set_data_group)
        self.data_group = None

    def forward(self, x, pos3, refl, mask, sf, capacity: int,
                training: bool = False, use_running_average: bool = True,
                generator: torch.Generator | None = None, stem_edge=None,
                want_transpose: bool = False):
        """``capacity``: static number of centre slots (N / 2 of this
        stage's input by default). ``training`` samples the centres at
        random from ``generator``, else takes voxel representatives. A
        stage with ``atsearch`` returns no transpose (the JAX stage
        ignores ``want_transpose`` there; ``Net.stage_routes`` never asks
        it for one)."""
        refl = refl * self.reflectanceyesno(refl)
        if training:
            center_idx, center_valid = random_sample(
                mask, capacity, generator, fraction=0.5,
                group=self.data_group)
        else:
            ids = voxel_cell_ids(pos3, self.resolution, mask=mask)
            center_idx, center_valid = voxel_representatives(
                ids, capacity, mask=mask, priority=self.voxel_priority)
        pos4 = torch.cat([pos3 / sf[:, None, None], refl[..., None]], dim=-1)
        centers = gather_rows(pos3, center_idx)
        transpose = None
        if self.atsearch is not None:
            # the learned feature-space search takes unscaled positions
            nbr_idx, nbr_valid = self.atsearch(
                x, torch.cat([pos3, refl[..., None]], dim=-1), mask,
                center_idx, center_valid)
        elif want_transpose:
            nbr_idx, nbr_valid, t_idx, _, t_d2 = knn_topk_with_transpose(
                centers, pos3, self.k, center_valid, mask)
            transpose = (t_idx, t_d2)
        else:
            nbr_idx, _, nbr_valid = knn_masked(
                centers, pos3, self.k, query_mask=center_valid,
                source_mask=mask, method=self.knn_method)
        radius = None
        if self.use_radius:
            # radius search in unscaled coordinates (model.py:117-118) is
            # a cap of radius / sf in the conv's scaled frame; a tensor
            # divide, as in the JAX package
            radius = (torch.full_like(sf, self.resolution * 2) / sf)[
                :, None, None]
        ura = use_running_average
        if self.attention_conv:
            x = self.conv(x, pos4, center_idx, nbr_idx, nbr_valid,
                          center_valid, radius=radius,
                          use_running_average=ura)
        else:
            x = self.conv(None if stem_edge is not None else x, pos4,
                          center_idx, nbr_idx, nbr_valid, center_valid,
                          radius=radius, stem_edge=stem_edge, sf=sf,
                          use_running_average=ura)
        x = self.residual_block(x, center_valid, ura)
        refl = torch.gather(refl, 1, center_idx)
        return x, centers, refl, center_valid, transpose


class _Head(nn.Module):
    """Holds a reference MLP under the key ``NN`` (sa4/fp modules)."""

    def __init__(self, widths, dtype):
        super().__init__()
        self.NN = RefMLP(widths, dtype)

    def forward(self, x, mask=None, use_running_average: bool = True):
        return self.NN(x, mask, use_running_average)


class Net(nn.Module):
    """Full backbone.

    forward(pos3 (B, N, 3) centred xyz, refl (B, N), mask (B, N) bool,
    sf (B,) per-sample scale factor, training=False,
    use_running_average=None, generator=None) -> (B, N) fp32 logits
    (num_classes == 1) or (B, N, num_classes). ``training`` selects random
    50% sampling (from ``generator``) and the training fused-route bound;
    ``use_running_average`` defaults to ``not training``.
    ``attention_knn`` / ``attention_conv``: the JAX package's attention
    variants (module docstring).
    """

    def __init__(self, num_classes: int = 1, channels: int = 32, k: int = 32,
                 sa_resolutions: Sequence[float] = (0.04, 0.08, 0.16),
                 stage_fractions: Sequence[float] = (0.5, 0.5, 0.5),
                 fp_k: int = 2, knn_method: str = "fast",
                 voxel_priority: str = "hash", transpose_knn: bool = True,
                 attention_knn: bool = False, attention_conv: bool = False,
                 dtype=torch.float32):
        super().__init__()
        c = channels
        self.num_classes = num_classes
        self.channels = c
        self.k = k
        self.sa_resolutions = tuple(sa_resolutions)
        self.stage_fractions = tuple(stage_fractions)
        self.fp_k = fp_k
        self.knn_method = knn_method
        self.voxel_priority = voxel_priority
        self.transpose_knn = transpose_knn
        self.attention_knn = attention_knn
        self.attention_conv = attention_conv
        self.dtype = dtype
        self.stem_mlp = RefMLP((3, c), dtype)
        self._sa_specs = [
            ((c + 4, c * 2, c * 4), c * 4, True),
            ((c * 4 + 4, c * 6, c * 8), c * 8, False),
            ((c * 8 + 4, c * 12, c * 16), c * 16, False),
        ]
        for i, ((nn_ch, out_f, use_rad), res) in enumerate(
                zip(self._sa_specs, self.sa_resolutions)):
            setattr(self, f"sa{i + 1}_module", SAStage(
                res, k, nn_ch, out_f, use_radius=use_rad,
                knn_method=knn_method, voxel_priority=voxel_priority,
                dtype=dtype, attention_knn=attention_knn,
                attention_conv=attention_conv))
        self.sa4_module = _Head((c * 16 + 3, c * 16, c * 16), dtype)
        self.fp4_module = _Head((c * 32, c * 24, c * 16), dtype)
        self.fp3_module = _Head((c * 24, c * 20, c * 16), dtype)
        self.fp2_module = _Head((c * 20, c * 16, c * 16), dtype)
        self.fp1_module = _Head((c * 17, c * 16, c * 16), dtype)
        self.conv1 = nn.Conv1d(c * 16, c * 16, 1)
        self.conv2 = nn.Conv1d(c * 16, num_classes, 1)
        self.norm = MaskedBatchNorm(c * 16)
        # layers.set_data_group: the head's products a sample
        self.data_group = None

    def capacities(self, n: int) -> list[int]:
        caps, cap = [], n
        for f in self.stage_fractions:
            cap = max(int(cap * f), 1)
            caps.append(cap)
        return caps

    def stage_routes(self, n: int, training: bool = False) -> list[str]:
        """Neighbour route of each level i (SA_{i+1} and the FP stage that
        interpolates back onto its sources), decided here only:
        "transpose" (the SA kNN also returns the FP top-2), "fused" or
        "gather" (the FP stage searches). Same rule as the JAX Net: the
        fused route takes up to 4096 sources in training and 2048
        otherwise; the transpose is wanted where the FP stage would gather
        anyway or has more than 2048 sources, and taken where the JAX
        transpose kernel's shape gate admits it. Under ``attention_knn``
        levels 1-2 (SA2, SA3) search with ``ATSearchKNN`` and take no
        transpose."""
        caps = self.capacities(n)
        src = [n] + caps[:-1]
        bound = FUSED_MAX_SOURCES_TRAIN if training else FUSED_MAX_SOURCES_EVAL
        routes = []
        for i in range(3):
            fused = uses_fused_kernel(src[i], caps[i], self.channels * 16,
                                      self.fp_k, self.knn_method, bound)
            want_t = (self.fp_k == 2 and self.transpose_knn
                      and (not fused or caps[i] > 2048))
            if (want_t and self.knn_method == "fast"
                    and not (self.attention_knn and i > 0)
                    and transpose_supported(caps[i], src[i], self.k)):
                routes.append("transpose")
            else:
                routes.append("fused" if fused else "gather")
        return routes

    def forward(self, pos3, refl, mask, sf, training: bool = False,
                use_running_average: bool | None = None,
                generator: torch.Generator | None = None):
        ura = (not training) if use_running_average is None \
            else use_running_average
        if training and generator is None:
            raise ValueError("Net: training samples centres at random and "
                             "needs a torch.Generator")
        n = pos3.shape[1]
        caps = self.capacities(n)
        routes = self.stage_routes(n, training)
        x0 = self.stem_mlp(pos3, mask, ura)
        xs, poss, masks = [x0], [pos3], [mask]
        transposes = [None, None, None]
        x, p, r, m = x0, pos3, refl, mask
        for i in range(3):
            stage = getattr(self, f"sa{i + 1}_module")
            x, p, r, m, transposes[i] = stage(
                x, p, r, m, sf, caps[i], training=training,
                use_running_average=ura, generator=generator,
                stem_edge=(self.stem_mlp
                           if i == 0 and not self.attention_conv else None),
                want_transpose=routes[i] == "transpose")
            xs.append(x)
            poss.append(p)
            masks.append(m)

        # global stage (model.py:129-140): MLP on [x, pos3], masked max
        g = self.sa4_module(torch.cat([x, p.to(x.dtype)], dim=-1), m, ura)
        g = torch.where(m[..., None], g, torch.finfo(g.dtype).min).amax(1)
        # all-padding samples would pool to finfo.min and overflow the
        # downstream bf16 products: zero them
        g = torch.where(m.any(1)[:, None], g, 0.0)

        y = g[:, None, :].expand(g.shape[0], caps[2], g.shape[-1])
        y = self.fp4_module(torch.cat([y, xs[3]], dim=-1), masks[3], ura)
        for head, lvl in ((self.fp3_module, 2), (self.fp2_module, 1),
                          (self.fp1_module, 0)):
            interp = knn_interpolate_batched(
                y, poss[lvl + 1], poss[lvl], k=self.fp_k,
                source_mask=masks[lvl + 1], target_mask=masks[lvl],
                method=self.knn_method, fused=routes[lvl] == "fused",
                precomputed=transposes[lvl])
            y = head(torch.cat([interp.to(self.dtype), xs[lvl]], dim=-1),
                     masks[lvl], ura)

        # head (model.py:220-222, 241-243): Conv1d -> BN -> ReLU -> Conv1d
        per_sample = self.data_group is not None
        y = dense(y, self.conv1.weight, self.conv1.bias, self.dtype,
                  per_sample)
        y = torch.relu(self.norm(y, mask, ura))
        y = dense(y, self.conv2.weight, self.conv2.bias, self.dtype,
                  per_sample).float()
        if self.num_classes == 1:
            y = y[..., 0]
        return y
