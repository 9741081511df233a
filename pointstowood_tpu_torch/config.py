"""Typed configuration of the port (copy of pointstowood_tpu/config.py's
TilingConfig, ModelConfig, PredictConfig and TrainConfig).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class TilingConfig:
    """Voxel tiling parameters (reference: pointstowood/src/preprocessing.py:9-16)."""

    grid_size: Sequence[float] = (2.0, 4.0)
    min_pts: int = 128
    max_pts: int = 16384
    # Accepted for CLI parity; the reference accepts --resolution but never
    # uses it (pointspacing is overwritten at preprocessing.py:16 and
    # downsample() is never called).
    resolution: float = 0.01
    # 2D grid resolution for the coarse ground model used for height
    # normalization (hardcoded 5.0 m at reference preprocessing.py:40).
    ground_grid: float = 5.0
    # False (default): tiles cluster on x/y/z only — spatial tiling as the
    # reference intends. True: parity mode reproducing the reference's
    # accidental behavior of clustering on its FULL feature tensor
    # [x, y, z, reflectance, (label), n_z] (preprocessing.py:58 passes
    # self.pos to voxel_grid), which additionally splits cells at
    # reflectance/height-band boundaries. Measured effect: see
    # scripts/tiling_deviation_experiment.py and BASELINE.md.
    cluster_features: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Backbone hyperparameters (reference: pointstowood/src/model.py:204-224)."""

    num_classes: int = 1
    channels: int = 32  # "C" in the reference
    k: int = 32  # neighbors per center at every SA stage
    # Per-SA-stage voxel sampling resolutions (eval-time sampling) and the
    # radius cap applied at stage 1 (radius = 2 * resolution,
    # reference model.py:117-118).
    sa_resolutions: Sequence[float] = (0.04, 0.08, 0.16)
    # Static per-stage capacity as a fraction of the previous stage's
    # capacity. Training uses exact 50% random sampling like the reference
    # (model.py:97-101); eval voxel sampling is compacted into the same
    # static budget (overflow keeps lowest point indices).
    stage_fractions: Sequence[float] = (0.5, 0.5, 0.5)
    fp_k: int = 2  # kNN-interpolate neighbors in FP modules (model.py:215-218)
    # 'fast': the CUDA top-k kernels (exact fp32 selection); 'exact': the
    # plain fp32 streaming top-k parity path. See ops/knn.py.
    knn_mode: str = "fast"
    # Kept for config parity with the JAX package, whose fast path needs a
    # recall target; the port's kernels select exactly and ignore it.
    knn_recall: float = 0.9
    # MLP/conv activation compute dtype; 'bfloat16' is the TPU analogue of
    # the reference's AMP autocast, 'float32' the exact parity path.
    compute_dtype: str = "bfloat16"
    # Eval-time voxel representative choice: 'hash' (spatially unbiased
    # overflow, default) or 'last' (reference consecutive_cluster parity;
    # see ops/voxel.voxel_representatives).
    voxel_priority: str = "hash"


@dataclasses.dataclass(frozen=True)
class PredictConfig:
    """Inference parameters (reference: pointstowood/predict.py:61-74)."""

    batch_size: int = 8
    is_wood: float = 0.5
    any_wood: float = 1.0
    # k for the fusion kNN query (reference predicter.py:137: 64 when
    # any_wood == 1 else 32).
    output_fmt: str = "ply"
    # Compute dtype for the forward pass. The reference infers under AMP
    # (fp16); the port follows the JAX package with bf16.
    dtype: str = "bfloat16"
    # Fusion path: 'auto' takes the device pair path
    # (predict/device_fusion.py) where the tiling allows it, else the
    # device index path where it serves (one grid scale at k = 32), else
    # the host path (predict/fusion.py); 'tpu' (the JAX flag's spelling)
    # takes the pair path, else the index path; 'host' takes the host
    # path. See predict/predicter.py semantic_segmentation.
    fusion: str = "auto"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training parameters (reference: pointstowood/train.py:58-76, src/trainer.py:96-123)."""

    num_epochs: int = 2
    batch_size: int = 2
    learning_rate: float = 1e-4
    weight_decay: float = 1e-2
    tune: bool = False  # low-LR cosine-warmup-restarts schedule
    tune_lr: float = 1e-6
    augmentation: bool = False
    test: bool = False
    stop_early: bool = False
    checkpoint_saves: int = 1
    label_smoothing: float = 0.1
    focal_gamma: float = 2.0
    poly_epsilon: float = 0.1
    grad_clip_norm: float = 1.0
    seed: int = 141190  # reference trainer.py:25
    dtype: str = "float32"
