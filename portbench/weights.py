"""Seeded weights of a configuration, made on the device.

The checkpoint layout is the ``state_dict`` of the configuration's
architecture (``arch/<name>.py``, its ``param_shapes``: keys and shapes
from the configuration alone); the program loads it strictly, so a
layout that differs fails the load. Values come from one normal draw of
a ``torch.Generator`` on the device: linear and 1x1 conv weights
He-scaled, biases N(0, 0.05), BatchNorm scales 1 + N(0, 0.1) and shifts
N(0, 0.1), running statistics (0, 1).

``calibrate`` makes an eval network whose probabilities spread over both
classes: the reference network's batch statistics over a batch of the
plot's points become the running statistics (each variance floored at
its layer's median, ``VAR_FLOOR``: a channel nearly constant on that
batch would otherwise scale other tiles' activations without bound, and
the network's outputs then swing by whole units under rounding), and the
head's last layer (the architecture's ``HEAD``) centres and scales the
logits (median 0, median absolute deviation ``LOGIT_SPREAD``), so that
few probabilities saturate.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import arch

LOGIT_SPREAD = 1.0
VAR_FLOOR = 1.0


def make_weights(model: dict, seed: int, device) -> dict:
    """The seeded float32 weights (int64 batch counters) on ``device``."""
    shapes = arch.load(model).param_shapes(model)
    floats = {k: s for k, s in shapes.items()
              if not k.endswith("num_batches_tracked")}
    total = sum(int(np.prod(s)) for s in floats.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, s in floats.items():
        n = int(np.prod(s))
        v = draw[at:at + n].view(s)
        at += n
        if k.endswith("running_mean"):
            v = torch.zeros_like(v)
        elif k.endswith("running_var"):
            v = torch.ones_like(v)
        elif "depthwise_conv" in k:
            v = v * 0.1 + (1.0 if k.endswith("weight") else 0.0)
        elif len(s) >= 2:
            v = v * float(np.sqrt(2.0 / s[1]))
        elif k.endswith(".bias") and f"{k[:-5]}.running_mean" in floats:
            v = v * 0.1
        elif k.endswith(".weight"):
            v = 1.0 + 0.1 * v
        else:
            v = v * 0.05
        out[k] = v.contiguous()
    for k in shapes:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64, device=device)
    return out


def calibration_batch(table: dict, seed: int, n_tiles: int, capacity: int,
                      cell: float = 4.0, min_points: int = 1024) -> dict:
    """``n_tiles`` tiles of the plot's points: the points of random
    ``cell``-sided voxels holding at least ``min_points``, subsampled to
    ``capacity``, reflectance as normal scores in [-1, 1] of its rank in
    the plot (the tiling's normalisation)."""
    from scipy.special import erfinv

    from portbench.reference.tiling import pad

    rng = np.random.default_rng(seed)
    xyz = np.stack([table["x"], table["y"], table["z"]], 1)
    r = np.asarray(table["intensity"])
    rank = np.argsort(np.argsort(r, kind="stable"), kind="stable")
    z = erfinv(2 * (rank + 1.0) / (len(r) + 1.0) - 1)
    refl = 2 * (z - z.min()) / (z.max() - z.min()) - 1
    ijk = np.floor((xyz - xyz.min(axis=0)) / cell).astype(np.int64)
    ext = ijk.max(axis=0) + 1
    keys = (ijk[:, 0] * ext[1] + ijk[:, 1]) * ext[2] + ijk[:, 2]
    cells, counts = np.unique(keys, return_counts=True)
    cells = cells[counts >= min(min_points, counts.max())]
    tiles = []
    for key in rng.choice(cells, size=min(n_tiles, len(cells)), replace=False):
        rows = np.flatnonzero(keys == key)
        if len(rows) > capacity:
            rows = rng.choice(rows, capacity, replace=False)
        tiles.append(np.concatenate([xyz[rows], refl[rows, None]],
                                    1).astype(np.float32))
    return pad(tiles, capacity)


def calibrate(weights: dict, model: dict, batch: dict, device) -> dict:
    """Running statistics from the reference network's batch statistics
    on ``batch`` (eval sampling; variances at least ``VAR_FLOOR`` times
    their layer's median), then the head's last layer scaled and
    shifted so that the logits over its valid points have median 0 and
    median absolute deviation ``LOGIT_SPREAD``. Returns new weights."""
    net_arch = arch.load(model)
    w = dict(weights)
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    with torch.no_grad():
        net = net_arch.Reference(w, model)
        net.forward(t["pos"], t["refl"], t["mask"], t["sf"],
                    training=False, batch_stats=True)
        for name, (mean, var, _) in net.stats.items():
            w[f"{name}.running_mean"] = mean.clone()
            w[f"{name}.running_var"] = torch.maximum(
                var, VAR_FLOOR * var.median())
        logits = net_arch.Reference(w, model).forward(
            t["pos"], t["refl"], t["mask"], t["sf"])
        z = logits[t["mask"]]
        mid = z.median()
        spread = (z - mid).abs().median().clamp(min=1e-6) / LOGIT_SPREAD
        head = net_arch.HEAD
        w[f"{head}.weight"] = w[f"{head}.weight"] / spread
        w[f"{head}.bias"] = (w[f"{head}.bias"] - mid) / spread
    return w
