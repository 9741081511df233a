"""Device choice of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else CUDA. Raises when CUDA is asked for (or
    defaulted to) and absent: the entry points never fall back to the CPU
    silently; pass ``device="cpu"`` for the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def pin_cuda_device(index: int) -> torch.device:
    """Make ``cuda:index`` this process's current card, so that
    ``resolve_device()`` (``cuda``) and every default CUDA tensor and
    generator land there: one card per process of a data-parallel run."""
    torch.cuda.set_device(index)
    return torch.device("cuda", index)
