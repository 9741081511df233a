from pointstowood_tpu_torch.model.layers import (
    InvertedResidualBlock,
    MaskedBatchNorm,
    RefMLP,
)
from pointstowood_tpu_torch.model.network import Net

__all__ = ["Net", "MaskedBatchNorm", "RefMLP", "InvertedResidualBlock"]
