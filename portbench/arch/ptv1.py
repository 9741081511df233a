"""Point Transformer, ``pointtransformer_seg50`` (arXiv:2012.09164;
POSTECH-CVLab/point-transformer model/pointtransformer/pointtransformer_seg.py):
the program's ``pointstowood_tpu_torch.model.PointTransformerSeg``, its
``state_dict`` layout (the published names), its plain reference
(``reference/point_transformer.py``) and its roofline operations and
product FLOPs.

Levels, for a tile of n valid points: n_1 = n, n_l = n_{l-1} // 4 (the
valid centres of farthest-point sampling); planes C_l = channels x (1,
2, 4, 8, 16); K_l = nsample. Operations of a forward:

* ``fps`` at levels 2-5: 10 FMA-free operations a (pick, valid point)
  pair (3 differences, 3 squares, 2 sums, the minimum and the
  comparison); bytes: the valid points and their mask in (13 bytes a
  point), the picks out (8 bytes each);
* ``search``: each level's self-search (n_l x n_l, k = K_l), each
  centre search (n_l x n_{l-1}, k = K_l) and each interpolation's
  (n_{l-1} x n_l, k = 3);
* ``blend`` (and ``blend_bwd`` in training) of each TransitionUp: C_{l-1}
  channels at k = 3.

Product FLOPs count every linear layer, the per-pair ones of delta
(3 -> 3 -> C) and of the weights (C -> C/8 -> C/8) at the valid pairs
(n_l x min(K_l, n_l)) and the TransitionDown's at n_l x min(K_l, n_{l-1});
2 a multiply-add, the backward twice the forward.
"""

from __future__ import annotations

import torch

from portbench import roofline
from portbench.reference.point_transformer import (
    RefPointTransformer as Reference,
)

HEAD = "cls.3"
KERNELS = {"fps": ["fps_kernel"]}
FPS_OPS_PER_PAIR = 10
IN_CHANNELS = 4


def build(model: dict) -> torch.nn.Module:
    from pointstowood_tpu_torch.model import PointTransformerSeg

    m = model
    return PointTransformerSeg(
        num_classes=m["num_classes"], channels=m["channels"],
        blocks=tuple(m["blocks"]), stride=tuple(m["stride"]),
        nsample=tuple(m["nsample"]), share_planes=m["share_planes"],
        in_channels=IN_CHANNELS, knn_method=m["knn_mode"],
        dtype=getattr(torch, m["compute_dtype"]))


def cli_args(model: dict) -> list:
    return ["--arch", "ptv1", "--channels", str(model["channels"]),
            "--dtype", model["compute_dtype"]]


def _planes(model: dict) -> list:
    return [model["channels"] * f for f in (1, 2, 4, 8, 16)]


def _bn(out: dict, name: str, n: int) -> None:
    for p in ("weight", "bias", "running_mean", "running_var"):
        out[f"{name}.{p}"] = (n,)
    out[f"{name}.num_batches_tracked"] = ()


def _lin(out: dict, name: str, n_out: int, n_in: int, bias: bool = True):
    out[f"{name}.weight"] = (n_out, n_in)
    if bias:
        out[f"{name}.bias"] = (n_out,)


def _block(out: dict, name: str, c: int, share: int) -> None:
    g = c // share
    _lin(out, f"{name}.linear1", c, c, bias=False)
    _bn(out, f"{name}.bn1", c)
    t = f"{name}.transformer2"
    for proj in ("linear_q", "linear_k", "linear_v"):
        _lin(out, f"{t}.{proj}", c, c)
    _lin(out, f"{t}.linear_p.0", 3, 3)
    _bn(out, f"{t}.linear_p.1", 3)
    _lin(out, f"{t}.linear_p.3", c, 3)
    _bn(out, f"{t}.linear_w.0", c)
    _lin(out, f"{t}.linear_w.2", g, c)
    _bn(out, f"{t}.linear_w.3", g)
    _lin(out, f"{t}.linear_w.5", g, g)
    _bn(out, f"{name}.bn2", c)
    _lin(out, f"{name}.linear3", c, c, bias=False)
    _bn(out, f"{name}.bn3", c)


def param_shapes(model: dict) -> dict:
    """name -> shape of every tensor of the state_dict, in its order."""
    planes, share = _planes(model), model["share_planes"]
    out: dict = {}
    cin = IN_CHANNELS
    for i, c in enumerate(planes):
        _lin(out, f"enc{i + 1}.0.linear", c,
             cin + (3 if model["stride"][i] != 1 else 0), bias=False)
        _bn(out, f"enc{i + 1}.0.bn", c)
        for j in range(1, model["blocks"][i]):
            _block(out, f"enc{i + 1}.{j}", c, share)
        cin = c
    for i in reversed(range(5)):
        c, name = planes[i], f"dec{i + 1}.0"
        if i == 4:
            _lin(out, f"{name}.linear1.0", c, 2 * c)
            _bn(out, f"{name}.linear1.1", c)
            _lin(out, f"{name}.linear2.0", c, c)
        else:
            _lin(out, f"{name}.linear1.0", c, c)
            _bn(out, f"{name}.linear1.1", c)
            _lin(out, f"{name}.linear2.0", c, cin)
            _bn(out, f"{name}.linear2.1", c)
        _block(out, f"dec{i + 1}.1", c, share)
        cin = c
    c = planes[0]
    _lin(out, "cls.0", c, c)
    _bn(out, "cls.1", c)
    _lin(out, HEAD, model["num_classes"], c)
    return out


def hook(work, net) -> None:
    """Per forward, the valid points of each tile (the levels follow from
    them), and whether the forward builds a graph. The run is traced, so
    the network's training graphs are captured again with device stamps
    (``trace_graphs``): the traced window replays the graphs that the
    untraced window replays, and its spans are read from their stamps."""
    def record(_mod, args, _out):
        if work.tracer.active:
            work.forwards.append(({"n": args[2].sum(1)},
                                  torch.is_grad_enabled()))

    net.register_forward_hook(record)
    net.trace_graphs()


def levels(n: int, model: dict) -> list:
    """Valid points of each level for a tile of n."""
    out = [n]
    for s in model["stride"][1:]:
        out.append(out[-1] // s)
    return out


def _sum(values) -> float:
    return float(sum(values))


def forward_ops(ns: list, model: dict, training: bool) -> list:
    """The operations of one forward (and its backward in training) of
    tiles of ``ns`` valid points."""
    lv = [levels(n, model) for n in ns]
    planes, ks = _planes(model), model["nsample"]
    out = []
    for i in range(5):
        cur = [t[i] for t in lv]
        out.append(roofline.search(_sum(c * c for c in cur), _sum(cur),
                                   _sum(cur), ks[i]))
        if not i:
            continue
        up = [t[i - 1] for t in lv]
        out.append(roofline.op(
            "fps", FPS_OPS_PER_PAIR * _sum(c * u for c, u in zip(cur, up)),
            13 * _sum(up) + 8 * _sum(cur), "fma_free_ops"))
        pairs = _sum(c * u for c, u in zip(cur, up))
        out.append(roofline.search(pairs, _sum(cur), _sum(up), ks[i]))
        out.append(roofline.search(pairs, _sum(up), _sum(cur), 3))
        out.append(roofline.blend(_sum(up), _sum(cur), planes[i - 1], 3))
        if training:
            out.append(roofline.blend_bwd(_sum(up), _sum(cur), planes[i - 1],
                                          3))
    return out


def forward_macs(n: int, model: dict) -> float:
    """Multiply-adds of the network's products for one tile of n valid
    points."""
    planes, ks = _planes(model), model["nsample"]
    g = [c // model["share_planes"] for c in planes]
    lv = levels(n, model)
    m = lv[0] * IN_CHANNELS * planes[0]  # enc1.0
    for i, (c, k, nl) in enumerate(zip(planes, ks, lv)):
        pairs = nl * min(k, nl)
        block = 5 * nl * c * c + pairs * (3 * 3 + 3 * c + c * g[i]
                                          + g[i] * g[i])
        m += model["blocks"][i] * block  # blocks - 1 encoder, 1 decoder
        if i:
            m += nl * min(k, lv[i - 1]) * (3 + planes[i - 1]) * c
    c5 = planes[4]
    m += c5 * c5 + lv[4] * 2 * c5 * c5  # dec5.0
    for i in range(4):
        m += lv[i] * planes[i] ** 2 + lv[i + 1] * planes[i + 1] * planes[i]
    m += lv[0] * (planes[0] ** 2 + planes[0] * model["num_classes"])
    return float(m)


def forward_work(counts: dict, model: dict, grad: bool) -> tuple:
    ns = [int(n) for n in counts["n"].tolist()]
    flops = 2 * sum(forward_macs(n, model) for n in ns) * (3 if grad else 1)
    return forward_ops(ns, model, grad), flops
