"""Checkpoint conversion for the port (own copy of the key map of
pointstowood_tpu/utils/checkpoint_convert.py).

The port's ``Net.state_dict()`` has the reference Net's key layout
(reference: pointstowood/src/model.py:204-224), so a reference ``.pth``
state_dict loads with ``Net.load_state_dict``. ``state_dict_from_flax``
turns the JAX package's variables (``{"params": ..., "batch_stats": ...}``
nested dicts of numpy arrays) into that layout, and
``flax_from_state_dict`` turns a state_dict back into those variables.

Layout conversions (flax -> torch):
  Dense kernel (in, out)          -> Linear weight (out, in)
  Dense kernel (in, out)          -> Conv1d k=1 weight (out, in, 1)
  per-channel dw_scale (C,)       -> depthwise Conv1d weight (C, 1, 1)
  BN scale/bias + mean/var stats  -> weight/bias + running_mean/var
  Dense(use_bias=False) kernel    -> bias-free Linear weight (out, in)
  LayerNorm scale/bias            -> LayerNorm weight/bias

The attention variants' variables (``Net(attention_knn=True)``'s
``atsearch`` blending MLPs, ``Net(attention_conv=True)``'s attention
convs) have entries of their own (``build_key_map``'s flags); the two
converters walk the map with both, and a block absent from their input is
absent from their output.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _mlp_entries(torch_prefix: str, n_layers: int) -> Dict[str, Tuple[str, str]]:
    """Reference MLP(channels) key map: block i (1-based) is
    Seq(Lin, ReLU[, BN]) at index i-1; BN present for i != 1 at slot 2."""
    out = {}
    for i in range(1, n_layers + 1):
        out[f"{torch_prefix}.{i-1}.0"] = ("linear", f"lin{i}")
        if i != 1:
            out[f"{torch_prefix}.{i-1}.2"] = ("bn", f"bn{i}")
    return out


def _irb_entries(torch_prefix: str) -> Dict[str, Tuple[str, str]]:
    """InvertedResidualBlock map (model.py:46-85); flax paths are relative
    to the residual_block module."""
    p = torch_prefix
    return {
        f"{p}.expand.0": ("conv1d", "expand"),
        f"{p}.expand.1": ("bn", "expand_bn"),
        f"{p}.conv.0.depthwise_conv": ("depthwise", "ds1"),
        f"{p}.conv.0.depthwise_bn": ("bn", "ds1/dw_bn"),
        f"{p}.conv.0.pointwise_conv": ("conv1d", "ds1/pw"),
        f"{p}.conv.0.pointwise_bn": ("bn", "ds1/pw_bn"),
        f"{p}.conv.1": ("bn", "mid_bn"),
        f"{p}.conv.3.depthwise_conv": ("depthwise", "ds2"),
        f"{p}.conv.3.depthwise_bn": ("bn", "ds2/dw_bn"),
        f"{p}.conv.3.pointwise_conv": ("conv1d", "ds2/pw"),
        f"{p}.conv.3.pointwise_bn": ("bn", "ds2/pw_bn"),
        f"{p}.conv.4": ("bn", "out_bn"),
        f"{p}.project.0": ("conv1d", "project"),
        f"{p}.project.1": ("bn", "project_bn"),
    }


def build_key_map(attention_knn: bool = False,
                  attention_conv: bool = False) -> Dict[str, Tuple[str, str]]:
    """torch module path -> (kind, flax path) for the reference Net, or
    for ``Net(attention_knn=..., attention_conv=...)``: SA2/SA3's
    ``atsearch.blending`` linears, and every SA stage's attention conv
    (bias-free ``qkv_proj``, ``mlp``, ``out_proj``, the LayerNorm
    ``norm``; its ``local_nn`` has PointConv's keys)."""
    m: Dict[str, Tuple[str, str]] = {}
    for k, (kind, path) in _mlp_entries("stem_mlp", 1).items():
        m[k] = (kind, f"stem_mlp/{path}")
    for i in (1, 2, 3):
        sa = f"sa{i}_module"
        for k, (kind, path) in _mlp_entries(f"{sa}.conv.local_nn", 2).items():
            m[k] = (kind, f"{sa}/conv/local_nn/{path}")
        if attention_conv:
            for name in ("qkv_proj", "mlp", "out_proj"):
                m[f"{sa}.conv.{name}"] = ("linear_nobias", f"{sa}/conv/{name}")
            m[f"{sa}.conv.norm"] = ("layernorm", f"{sa}/conv/norm")
        if attention_knn and i > 1:
            for name in ("feat1", "feat2", "pos1", "pos2"):
                m[f"{sa}.atsearch.blending.{name}"] = (
                    "linear", f"{sa}/atsearch/blending/{name}")
        for k, (kind, path) in _irb_entries(f"{sa}.residual_block").items():
            m[k] = (kind, f"{sa}/residual_block/{path}")
        for fc in ("fc1", "fc2", "fc3"):
            m[f"{sa}.reflectanceyesno.{fc}"] = (
                "linear", f"{sa}/reflectanceyesno/{fc}")
    for k, (kind, path) in _mlp_entries("sa4_module.NN", 2).items():
        m[k] = (kind, f"sa4_module/{path}")
    for i in (4, 3, 2, 1):
        for k, (kind, path) in _mlp_entries(f"fp{i}_module.NN", 2).items():
            m[k] = (kind, f"fp{i}_module/{path}")
    m["conv1"] = ("conv1d", "conv1")
    m["conv2"] = ("conv1d", "conv2")
    m["norm"] = ("bn", "norm")
    return m


# Every entry of every variant: the converters take what their input holds.
_FULL_MAP = build_key_map(attention_knn=True, attention_conv=True)


def _get(tree: dict, path: str):
    node = tree
    for part in path.split("/"):
        if node is None or part not in node:
            return None
        node = node[part]
    return node


def _fp32_numpy(tree):
    """The tree with every torch tensor leaf (a ``.ckpt``'s bf16 leaves)
    as an fp32 numpy array."""
    if isinstance(tree, dict):
        return {k: _fp32_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", torch.float32).numpy()
    return tree


def state_dict_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """flax variables (nested dicts of arrays) -> reference-layout
    state_dict of fp32 torch tensors. Blocks absent from ``variables``
    are absent from the result (load with ``strict=False`` to keep the
    module's own values there)."""
    variables = _fp32_numpy(variables)
    params = variables.get("params", {})
    batch_stats = variables.get("batch_stats", {})

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd: Dict[str, torch.Tensor] = {}
    for torch_path, (kind, flax_path) in _FULL_MAP.items():
        p = _get(params, flax_path)
        if p is None:
            continue
        if kind == "linear":
            sd[f"{torch_path}.weight"] = t(np.asarray(p["kernel"]).T)
            sd[f"{torch_path}.bias"] = t(p["bias"])
        elif kind == "linear_nobias":
            sd[f"{torch_path}.weight"] = t(np.asarray(p["kernel"]).T)
        elif kind == "layernorm":
            sd[f"{torch_path}.weight"] = t(p["scale"])
            sd[f"{torch_path}.bias"] = t(p["bias"])
        elif kind == "conv1d":
            sd[f"{torch_path}.weight"] = t(np.asarray(p["kernel"]).T[..., None])
            sd[f"{torch_path}.bias"] = t(p["bias"])
        elif kind == "depthwise":
            sd[f"{torch_path}.weight"] = t(
                np.asarray(p["dw_scale"]).reshape(-1, 1, 1))
            sd[f"{torch_path}.bias"] = t(p["dw_bias"])
        elif kind == "bn":
            sd[f"{torch_path}.weight"] = t(p["scale"])
            sd[f"{torch_path}.bias"] = t(p["bias"])
            stats = _get(batch_stats, flax_path)
            if stats is not None:
                sd[f"{torch_path}.running_mean"] = t(stats["mean"])
                sd[f"{torch_path}.running_var"] = t(stats["var"])
                sd[f"{torch_path}.num_batches_tracked"] = torch.tensor(0)
    return sd



def _set(tree: dict, path: str, **leaves) -> None:
    node = tree
    for part in path.split("/"):
        node = node.setdefault(part, {})
    node.update({k: v for k, v in leaves.items() if v is not None})


def flax_from_state_dict(state_dict) -> dict:
    """Reference-layout state_dict -> the JAX package's variables
    ``{"params": ..., "batch_stats": ...}`` as nested dicts of fp32 numpy
    arrays: the inverse of ``state_dict_from_flax``, walking the same key
    map, and the tree that the JAX package's
    ``convert_torch_state_dict`` returns for the same state_dict (any
    ``module.`` prefix stripped). Raises on a weight or statistic the key
    map does not cover, so a ``.ckpt`` written from it is complete."""
    sd = {}
    for key, value in state_dict.items():
        key = key[len("module."):] if key.startswith("module.") else key
        if isinstance(value, torch.Tensor):
            value = value.detach().to("cpu", torch.float32).numpy()
        sd[key] = np.asarray(value, dtype=np.float32)
    params: dict = {}
    batch_stats: dict = {}
    used = set()
    for torch_path, (kind, flax_path) in _FULL_MAP.items():
        w = sd.get(f"{torch_path}.weight")
        b = sd.get(f"{torch_path}.bias")
        if w is None:
            continue
        used.update(f"{torch_path}.{n}" for n in (
            "weight", "bias", "running_mean", "running_var",
            "num_batches_tracked"))
        if kind in ("linear", "linear_nobias"):
            _set(params, flax_path, kernel=w.T, bias=b)
        elif kind == "layernorm":
            _set(params, flax_path, scale=w, bias=b)
        elif kind == "conv1d":
            _set(params, flax_path, kernel=w[..., 0].T, bias=b)
        elif kind == "depthwise":
            _set(params, flax_path, dw_scale=w.reshape(-1), dw_bias=b)
        elif kind == "bn":
            _set(params, flax_path, scale=w, bias=b)
            _set(batch_stats, flax_path,
                 mean=sd.get(f"{torch_path}.running_mean"),
                 var=sd.get(f"{torch_path}.running_var"))
    missed = sorted(set(sd) - used)
    if missed:
        raise KeyError(f"no flax leaf for {missed[:5]} "
                       f"({len(missed)} state_dict entries)")
    return {"params": params, "batch_stats": batch_stats}
