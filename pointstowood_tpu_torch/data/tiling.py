"""Tile container (port of the ``Tile`` dataclass of
pointstowood_tpu/data/tiling.py; the pandas-based ``preprocess_cloud``
waits for the port's host layer)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Tile:
    """One voxel tile: float32 points [x, y, z, reflectance, (label)]."""

    points: np.ndarray  # (n, 4) predict / (n, 5) train
    grid_size: float
    # packed cell id within its grid scale (-1 = unknown)
    cell_id: int = -1
    # original-cloud row per tile row (None = unknown)
    indices: np.ndarray | None = None

    def __len__(self):
        return self.points.shape[0]
