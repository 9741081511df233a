"""Inference engine: padded tile batches -> per-point wood probabilities
(port of ``build_net``, ``_forward`` and ``run_inference`` of
pointstowood_tpu/predict/predicter.py).

Tiles stream through ``forward_probs`` one padded batch at a time; the
probabilities come back with the per-tile centring undone
(reference predicter.py:211-214). Fusion onto the original cloud waits for
the port's host layer.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pointstowood_tpu_torch.config import (
    ModelConfig,
    PredictConfig,
    TilingConfig,
)
from pointstowood_tpu_torch.data.dataset import TileBatcher
from pointstowood_tpu_torch.data.tiling import Tile
from pointstowood_tpu_torch.model import Net
from pointstowood_tpu_torch.ops.voxel import check_voxel_pack_range


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


def build_net(model_cfg: ModelConfig, device=None) -> Net:
    """The eval-mode Net of a model config, on ``device`` (default CUDA).
    Load weights with ``net.load_state_dict`` (reference layout; see
    utils/checkpoint_convert.py)."""
    dev = resolve_device(device)
    net = Net(
        num_classes=model_cfg.num_classes,
        channels=model_cfg.channels,
        k=model_cfg.k,
        sa_resolutions=tuple(model_cfg.sa_resolutions),
        stage_fractions=tuple(model_cfg.stage_fractions),
        fp_k=model_cfg.fp_k,
        knn_method=model_cfg.knn_mode,
        voxel_priority=model_cfg.voxel_priority,
        dtype=getattr(torch, model_cfg.compute_dtype),
    )
    return net.to(dev).eval()


def forward_probs(net: Net, pos, refl, mask, sf) -> torch.Tensor:
    """sigmoid(nan_to_num(logits)) of one padded batch (the JAX
    ``_forward``)."""
    with torch.inference_mode():
        return torch.sigmoid(torch.nan_to_num(net(pos, refl, mask, sf)))


def run_inference(
    tiles: Sequence[Tile],
    net: Net,
    predict_cfg: PredictConfig,
    tiling_cfg: TilingConfig,
    device=None,
) -> np.ndarray:
    """Classify all tiles; returns (M, 5) float64 rows [x, y, z, pred,
    prob] for every valid tile point, tiles in batcher order (reference
    predicter.py:192-217). ``net`` must live on ``device`` (default
    CUDA). The host readback of batch i overlaps the device work of batch
    i+1 (two batches in flight)."""
    dev = resolve_device(device)
    check_voxel_pack_range(max(tiling_cfg.grid_size), min(net.sa_resolutions))
    batcher = TileBatcher(
        tiles, batch_size=predict_cfg.batch_size,
        min_pts=tiling_cfg.min_pts, max_pts=tiling_cfg.max_pts,
        capacity_step=2, scale_batch=True,
    )
    outputs = []
    pending = []  # (device probs, host batch)

    def drain(entry):
        probs_dev, batch = entry
        probs = probs_dev.float().cpu().numpy()
        preds = (probs >= predict_cfg.is_wood).astype(np.float64)
        xyz = (batch.pos.astype(np.float64)
               + batch.shift[:, None, :].astype(np.float64))
        out = np.concatenate(
            [xyz, preds[..., None], probs.astype(np.float64)[..., None]],
            axis=-1)
        outputs.append(out[batch.mask])

    for _, batch, _ in batcher:
        pos, refl, mask, sf = (
            torch.from_numpy(a).to(dev, non_blocking=True)
            for a in (batch.pos, batch.reflectance, batch.mask, batch.sf))
        pending.append((forward_probs(net, pos, refl, mask, sf), batch))
        if len(pending) > 2:
            drain(pending.pop(0))
    while pending:
        drain(pending.pop(0))
    if not outputs:
        raise ValueError("no tiles to classify (cloud smaller than min_pts?)")
    return np.vstack(outputs)
