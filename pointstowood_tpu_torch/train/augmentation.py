"""Host-side per-tile augmentation (copy of
pointstowood_tpu/train/augmentation.py, numpy only: the draws come in the
same order from the same generator).

Reimplements the reference policy (reference:
pointstowood/src/augmentation.py:41-55), applied in the dataset before
centering (trainer.py:52-53):
  * P(0.25): zero out reflectance (train and test modes);
  * train mode, P in [0.25, 0.5): add N(0, 0.1) noise to reflectance;
  * independent P(0.25): rotate xyz by random Euler angles in [-90, 90]
    degrees about all three axes (roll @ pitch @ yaw order,
    augmentation.py:5-12).
The rescale/point-noise/downsample augments exist in the reference but are
commented out of the policy (augmentation.py:51-54); they are provided as
functions for completeness and likewise not wired in.
"""

from __future__ import annotations

import numpy as np


def rotate_3d(points: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    angles = np.deg2rad(rng.uniform(size=3) * 180.0 - 90.0)
    c, s = np.cos(angles), np.sin(angles)
    roll = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]], np.float32)
    pitch = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]], np.float32)
    yaw = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]], np.float32)
    return points.astype(np.float32) @ roll @ pitch @ yaw


def random_rescale(points, rng, scale_range=(0.9, 1.1)):
    s = rng.uniform(*scale_range)
    return points * np.float32(s)


def random_noise_addition(points, rng, max_std_dev=0.00333):
    std = np.clip(rng.uniform() * max_std_dev, 0.0001, max_std_dev)
    return points + rng.normal(0.0, std, size=points.shape).astype(points.dtype)


def augment_tile(points: np.ndarray, rng: np.random.Generator,
                 mode: str = "train") -> np.ndarray:
    """Apply the live policy to a tile array [x, y, z, reflectance, ...]."""
    points = points.copy()
    rand_refl = rng.uniform()
    rand_pos = rng.uniform()
    if rand_refl < 0.25:
        points[:, 3] = 0.0
    elif mode == "train" and rand_refl < 0.5:
        points[:, 3] = points[:, 3] + rng.normal(0.0, 0.1, size=points.shape[0]).astype(
            np.float32
        )
    if rand_pos < 0.25:
        points[:, :3] = rotate_3d(points[:, :3], rng)
    return points
