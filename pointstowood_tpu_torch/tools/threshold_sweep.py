"""--is-wood threshold sweep over a labeled cloud (port of
pointstowood_tpu/tools/threshold_sweep.py).

BASELINE config 2 calls for an is-wood 0.50 threshold sweep on a single
tree. The classifier forward is threshold-independent (thresholding
happens on the sigmoid probabilities, reference predicter.py:202, and
again inside the fusion vote), so the sweep classifies once
(``run_inference`` on the device, through the port's kernels) and re-runs
only the fusion per threshold (``fuse_labels`` on the device over one
shared set of host kNN indices), reporting metrics against a ``truth``
column when present (``tools/scores.py``).

Run: python -m pointstowood_tpu_torch.tools.threshold_sweep cloud.ply
     --model model.ckpt --thresholds 0.3 0.4 0.5 0.6 0.7
"""

from __future__ import annotations

import argparse

import numpy as np

from pointstowood_tpu_torch.config import (
    ModelConfig,
    PredictConfig,
    TilingConfig,
)
from pointstowood_tpu_torch.data.tiling import preprocess_cloud, xyz_of
from pointstowood_tpu_torch.io import load_file
from pointstowood_tpu_torch.io.loader import canonicalize_columns
from pointstowood_tpu_torch.predict.fusion import fuse_labels, knn_indices
from pointstowood_tpu_torch.predict.predicter import build_net, run_inference
from pointstowood_tpu_torch.tools import scores
from pointstowood_tpu_torch.utils.checkpoint import load_checkpoint
from pointstowood_tpu_torch.utils.device import resolve_device


def sweep(classified: np.ndarray, pc: dict, thresholds, any_wood: float = 1.0,
          device=None):
    """Yield (threshold, labels (N,2)) re-fusing cached per-point probs on
    ``device`` (default CUDA).

    ``classified`` columns are [x, y, z, pred, prob]; fuse_labels derives
    predictions from prob >= is_wood itself, so each sweep step only
    re-runs the median/vote math over the shared neighbor indices.
    """
    dev = resolve_device(device)
    query = xyz_of(pc)
    k = 64 if any_wood == 1 else 32
    k = min(k, classified.shape[0])
    indices = knn_indices(classified[:, :3], query, k)  # shared across sweeps
    for t in thresholds:
        yield t, fuse_labels(classified, query, is_wood=t, any_wood=any_wood,
                             indices=indices, device=dev)


def main(argv=None, device=None):
    """Print the sweep's table; returns its rows as dicts: threshold,
    labels ((N, 2) [label, pwood] of every point), wood_frac, and
    balanced_acc and f1 where the cloud has a truth column."""
    p = argparse.ArgumentParser()
    p.add_argument("point_cloud")
    p.add_argument("--model", required=True)
    p.add_argument("--thresholds", type=float, nargs="+",
                   default=[0.3, 0.4, 0.5, 0.6, 0.7])
    p.add_argument("--grid_size", type=float, nargs="+", default=[2.0, 4.0])
    p.add_argument("--min_pts", type=int, default=128)
    p.add_argument("--max_pts", type=int, default=16384)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--channels", type=int, default=32)
    p.add_argument("--any-wood", type=float, default=1.0)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    pc_raw = load_file(args.point_cloud)
    truth = pc_raw.get("truth")
    pc, _, _ = canonicalize_columns(pc_raw, mode="predict")
    tiling = TilingConfig(grid_size=tuple(args.grid_size),
                          min_pts=args.min_pts, max_pts=args.max_pts)
    tiles = preprocess_cloud(pc, tiling)
    net = load_checkpoint(args.model,
                          build_net(ModelConfig(channels=args.channels),
                                    device=dev))
    classified = run_inference(tiles, net,
                               PredictConfig(batch_size=args.batch_size),
                               tiling, device=dev)
    print("threshold  wood_frac"
          + ("  balanced_acc  f1" if truth is not None else ""))
    table = []
    for t, labels in sweep(classified, pc, args.thresholds,
                           any_wood=args.any_wood, device=dev):
        row = {"threshold": t, "labels": labels,
               "wood_frac": float(labels[:, 0].mean())}
        line = f"{t:9.2f}  {row['wood_frac']:9.3f}"
        if truth is not None:
            row["balanced_acc"] = scores.balanced_accuracy(truth > 0,
                                                           labels[:, 0] > 0)
            row["f1"] = scores.f1(truth > 0, labels[:, 0] > 0)
            line += f"  {row['balanced_acc']:12.3f}  {row['f1']:.3f}"
        print(line)
        table.append(row)
    return table


if __name__ == "__main__":
    main()
