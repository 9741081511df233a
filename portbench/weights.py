"""Seeded weights of a configuration, made on the device.

The checkpoint layout is the reference's ``Net`` state_dict (keys and
shapes from the configuration alone, ``param_shapes``); the program loads
it strictly, so a layout that differs fails the load. Values come from
one normal draw of a ``torch.Generator`` on the device: linear and 1x1
conv weights He-scaled, biases N(0, 0.05), BatchNorm scales 1 + N(0, 0.1)
and shifts N(0, 0.1), running statistics (0, 1).

``calibrate`` makes an eval network whose probabilities spread over both
classes: the reference network's batch statistics over a batch of the
plot's points become the running statistics (each variance floored at
its layer's median, ``VAR_FLOOR``: a channel nearly constant on that
batch would otherwise scale other tiles' activations without bound, and
the network's outputs then swing by whole units under rounding), and the
head's last layer
centres and scales the logits (median 0, median absolute deviation
``LOGIT_SPREAD``), so that few probabilities saturate.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.net import RefNet

LOGIT_SPREAD = 1.0
VAR_FLOOR = 1.0


def _bn(out: dict, name: str, n: int) -> None:
    for p in ("weight", "bias", "running_mean", "running_var"):
        out[f"{name}.{p}"] = (n,)
    out[f"{name}.num_batches_tracked"] = ()


def _lin(out: dict, name: str, n_out: int, n_in: int, conv: bool = False):
    out[f"{name}.weight"] = (n_out, n_in, 1) if conv else (n_out, n_in)
    out[f"{name}.bias"] = (n_out,)


def param_shapes(model: dict) -> dict:
    """name -> shape of every tensor of the state_dict."""
    c = model["channels"]
    out: dict = {}
    _lin(out, "stem_mlp.0.0", c, 3)
    specs = [(c + 4, 2 * c, 4 * c), (4 * c + 4, 6 * c, 8 * c),
             (8 * c + 4, 12 * c, 16 * c)]
    for i, (a, b, d) in enumerate(specs):
        s = f"sa{i + 1}_module"
        _lin(out, f"{s}.reflectanceyesno.fc1", 32, 1)
        _lin(out, f"{s}.reflectanceyesno.fc2", 32, 32)
        _lin(out, f"{s}.reflectanceyesno.fc3", 1, 32)
        if model.get("attention_knn") and i > 0:
            att, cin = a // 2, a - 4
            _lin(out, f"{s}.atsearch.blending.feat1", att, cin + att)
            _lin(out, f"{s}.atsearch.blending.feat2", 1, att)
            _lin(out, f"{s}.atsearch.blending.pos1", att, 3 + att)
            _lin(out, f"{s}.atsearch.blending.pos2", 1, att)
        _lin(out, f"{s}.conv.local_nn.0.0", b, a)
        _lin(out, f"{s}.conv.local_nn.1.0", d, b)
        _bn(out, f"{s}.conv.local_nn.1.2", d)
        r, e = f"{s}.residual_block", 4 * d
        _lin(out, f"{r}.expand.0", e, d, conv=True)
        _bn(out, f"{r}.expand.1", e)
        for j in (0, 3):
            out[f"{r}.conv.{j}.depthwise_conv.weight"] = (e, 1, 1)
            out[f"{r}.conv.{j}.depthwise_conv.bias"] = (e,)
            _bn(out, f"{r}.conv.{j}.depthwise_bn", e)
            _lin(out, f"{r}.conv.{j}.pointwise_conv", e, e, conv=True)
            _bn(out, f"{r}.conv.{j}.pointwise_bn", e)
        _bn(out, f"{r}.conv.1", e)
        _bn(out, f"{r}.conv.4", e)
        _lin(out, f"{r}.project.0", d, e, conv=True)
        _bn(out, f"{r}.project.1", d)
    for name, widths in (("sa4", (16 * c + 3, 16 * c, 16 * c)),
                         ("fp4", (32 * c, 24 * c, 16 * c)),
                         ("fp3", (24 * c, 20 * c, 16 * c)),
                         ("fp2", (20 * c, 16 * c, 16 * c)),
                         ("fp1", (17 * c, 16 * c, 16 * c))):
        _lin(out, f"{name}_module.NN.0.0", widths[1], widths[0])
        _lin(out, f"{name}_module.NN.1.0", widths[2], widths[1])
        _bn(out, f"{name}_module.NN.1.2", widths[2])
    _lin(out, "conv1", 16 * c, 16 * c, conv=True)
    _bn(out, "norm", 16 * c)
    _lin(out, "conv2", model["num_classes"], 16 * c, conv=True)
    return out


def make_weights(model: dict, seed: int, device) -> dict:
    """The seeded float32 weights (int64 batch counters) on ``device``."""
    shapes = param_shapes(model)
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
    w = dict(weights)
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    with torch.no_grad():
        net = RefNet(w, model)
        net.forward(t["pos"], t["refl"], t["mask"], t["sf"],
                    training=False, batch_stats=True)
        for name, (mean, var, _) in net.stats.items():
            w[f"{name}.running_mean"] = mean.clone()
            w[f"{name}.running_var"] = torch.maximum(
                var, VAR_FLOOR * var.median())
        logits = RefNet(w, model).forward(t["pos"], t["refl"], t["mask"],
                                          t["sf"])
        z = logits[t["mask"]]
        mid = z.median()
        spread = (z - mid).abs().median().clamp(min=1e-6) / LOGIT_SPREAD
        w["conv2.weight"] = w["conv2.weight"] / spread
        w["conv2.bias"] = (w["conv2.bias"] - mid) / spread
    return w
