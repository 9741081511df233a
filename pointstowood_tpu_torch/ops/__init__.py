"""ops layer of the PyTorch port (see the package docstring)."""

from pointstowood_tpu_torch.ops.knn import knn_masked, radius_masked
from pointstowood_tpu_torch.ops.segment import (
    segment_max,
    segment_mean,
    segment_min,
    segment_sum,
)

__all__ = [
    "knn_masked",
    "radius_masked",
    "segment_max",
    "segment_min",
    "segment_sum",
    "segment_mean",
]
