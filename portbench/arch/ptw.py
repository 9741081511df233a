"""The PointsToWood ``Net`` (pointstowood/src/model.py:204-245) and its
``attention_knn`` variant: the program's ``pointstowood_tpu_torch.model.Net``,
its ``state_dict`` layout, its plain reference (``reference/net.py``)
and its roofline operations and FLOPs (``roofline.forward_ops``,
``roofline.net_flops``)."""

from __future__ import annotations

import torch

from portbench import roofline
from portbench.reference.net import RefNet as Reference

HEAD = "conv2"
KERNELS: dict = {}


def build(model: dict) -> torch.nn.Module:
    from pointstowood_tpu_torch.model import Net

    m = model
    return Net(num_classes=m["num_classes"], channels=m["channels"],
               k=m["k"], sa_resolutions=tuple(m["sa_resolutions"]),
               stage_fractions=tuple(m["stage_fractions"]),
               fp_k=m["fp_k"], knn_method=m["knn_mode"],
               voxel_priority=m["voxel_priority"],
               attention_knn=m.get("attention_knn", False),
               dtype=getattr(torch, m["compute_dtype"]))


def cli_args(model: dict) -> list:
    return ["--channels", str(model["channels"]),
            "--dtype", model["compute_dtype"]]


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
    _lin(out, HEAD, model["num_classes"], 16 * c, conv=True)
    return out


def hook(work, net) -> None:
    """Per forward, the valid points and the valid centres of the three
    SA stages, and whether the forward builds a graph."""
    for i in range(3):
        def record(_mod, args, out, i=i):
            if not work.tracer.active:
                return
            if i == 0:
                work.forwards.append(({"n": args[3].sum(1)},
                                      torch.is_grad_enabled()))
            work.forwards[-1][0][f"s{i + 1}"] = out[3].sum(1)

        getattr(net, f"sa{i + 1}_module").register_forward_hook(record)


def forward_work(counts: dict, model: dict, grad: bool) -> tuple:
    counts = {k: v.tolist() for k, v in counts.items()}
    return (roofline.forward_ops(counts, model, grad),
            roofline.net_flops(counts, model, grad))
