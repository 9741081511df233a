"""Checkpoints of the port (counterpart of
pointstowood_tpu/utils/checkpoint.py).

The port writes and reads reference-layout torch checkpoints
(``.pth``/``.pt``). ``save_checkpoint`` writes
``{"model_state_dict": state_dict}`` (reference trainer.py:82,306);
``load_checkpoint`` reads that layout or a bare state_dict, with any ``module.`` prefix of a DataParallel model
stripped (reference trainer.py:70-73, predicter.py:100-103). The JAX
package's flax msgpack checkpoints are not read here: write a ``.pth``
from them with the JAX package's
``pointstowood_tpu.utils.checkpoint_convert.save_torch_checkpoint``.
"""

from __future__ import annotations

import os

import torch

_MODULE = "module."


def _check_suffix(path: str) -> None:
    if not (path.endswith(".pth") or path.endswith(".pt")):
        raise ValueError(
            f"{path}: pointstowood_tpu_torch reads and writes .pth/.pt "
            "checkpoints only; convert a flax msgpack checkpoint with "
            "pointstowood_tpu.utils.checkpoint_convert.save_torch_checkpoint")


def save_checkpoint(path: str, state) -> None:
    """Write ``{"model_state_dict": ...}`` of a module (or of a
    state_dict) to ``path`` (.pth/.pt) as CPU tensors, atomically (a
    temporary file, then a rename)."""
    _check_suffix(path)
    sd = state.state_dict() if isinstance(state, torch.nn.Module) else state
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model_state_dict": sd}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, net: torch.nn.Module) -> torch.nn.Module:
    """Load a reference-layout ``.pth``/``.pt`` checkpoint into ``net``
    (strict: every key must match) and return ``net``."""
    _check_suffix(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = (ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict)
             else ckpt)
    state = {(k[len(_MODULE):] if k.startswith(_MODULE) else k): v
             for k, v in state.items()}
    net.load_state_dict(state)
    return net
