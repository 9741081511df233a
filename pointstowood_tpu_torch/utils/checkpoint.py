"""Checkpoint loading for the port (counterpart of
pointstowood_tpu/utils/checkpoint.py ``load_checkpoint``).

The port reads reference-layout torch checkpoints (``.pth``/``.pt``):
either ``{"model_state_dict": state_dict}`` (reference trainer.py:82,306)
or a bare state_dict, with any ``module.`` prefix of a DataParallel model
stripped (reference trainer.py:70-73, predicter.py:100-103). The JAX
package's flax msgpack checkpoints are not read here: write a ``.pth``
from them with the JAX package's
``pointstowood_tpu.utils.checkpoint_convert.save_torch_checkpoint``.
"""

from __future__ import annotations

import torch

_MODULE = "module."


def load_checkpoint(path: str, net: torch.nn.Module) -> torch.nn.Module:
    """Load a reference-layout ``.pth``/``.pt`` checkpoint into ``net``
    (strict: every key must match) and return ``net``."""
    if not (path.endswith(".pth") or path.endswith(".pt")):
        raise ValueError(
            f"{path}: pointstowood_tpu_torch reads .pth/.pt checkpoints "
            "only; convert a flax msgpack checkpoint with "
            "pointstowood_tpu.utils.checkpoint_convert.save_torch_checkpoint")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = (ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict)
             else ckpt)
    state = {(k[len(_MODULE):] if k.startswith(_MODULE) else k): v
             for k, v in state.items()}
    net.load_state_dict(state)
    return net
