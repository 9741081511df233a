"""Checkpoints of the port (counterpart of
pointstowood_tpu/utils/checkpoint.py).

Two formats, chosen by the file's suffix as the JAX package chooses them:

* ``.pth``/``.pt``: reference-layout torch checkpoints.
  ``save_checkpoint`` writes ``{"model_state_dict": state_dict}``
  (reference trainer.py:82,306); ``load_checkpoint`` reads that layout or
  a bare state_dict, with any ``module.`` prefix of a DataParallel model
  stripped (reference trainer.py:70-73, predicter.py:100-103).
* any other suffix (the JAX package writes ``.ckpt``): flax msgpack, the
  variables ``{"params": ..., "batch_stats": ...}``, read and written by
  the port's own codec (``utils/msgpack.py``) and mapped through
  ``checkpoint_convert``; neither flax nor msgpack is needed.
"""

from __future__ import annotations

import os

import torch

from pointstowood_tpu_torch.utils import msgpack
from pointstowood_tpu_torch.utils.checkpoint_convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)

_MODULE = "module."


def _is_torch(path: str) -> bool:
    """True for a ``.pth``/``.pt`` name, False for a flax msgpack one."""
    return path.endswith(".pth") or path.endswith(".pt")


def save_checkpoint(path: str, state) -> None:
    """Write a module's (or a state_dict's) weights to ``path``: as
    ``{"model_state_dict": ...}`` of CPU tensors for ``.pth``/``.pt``, else
    as the JAX package's flax msgpack variables. Atomic: a temporary file,
    then a rename."""
    sd = state.state_dict() if isinstance(state, torch.nn.Module) else state
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    tmp = f"{path}.{os.getpid()}.tmp"
    if _is_torch(path):
        torch.save({"model_state_dict": sd}, tmp)
    else:
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(flax_from_state_dict(sd)))
    os.replace(tmp, path)


def load_checkpoint(path: str, net: torch.nn.Module) -> torch.nn.Module:
    """Load a ``.pth``/``.pt`` checkpoint, or a flax msgpack one (any other
    suffix), into ``net`` (strict: every key must match) and return
    ``net``."""
    if _is_torch(path):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        state = (ckpt.get("model_state_dict", ckpt)
                 if isinstance(ckpt, dict) else ckpt)
        state = {(k[len(_MODULE):] if k.startswith(_MODULE) else k): v
                 for k, v in state.items()}
    else:
        with open(path, "rb") as f:
            variables = msgpack.unpackb(f.read())
        if not (isinstance(variables, dict) and "params" in variables):
            raise ValueError(f"{path}: not a flax variables checkpoint")
        state = state_dict_from_flax(variables)
    net.load_state_dict(state)
    return net
