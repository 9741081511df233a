from pointstowood_tpu_torch.model.layers import (
    InvertedResidualBlock,
    MaskedBatchNorm,
    RefMLP,
)
from pointstowood_tpu_torch.model.network import Net
from pointstowood_tpu_torch.model.point_transformer import PointTransformerSeg

__all__ = ["Net", "PointTransformerSeg", "MaskedBatchNorm", "RefMLP",
           "InvertedResidualBlock"]
