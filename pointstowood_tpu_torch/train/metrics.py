"""Binary segmentation metrics with the reference's batchwise averaging
(port of pointstowood_tpu/train/metrics.py).

The reference computes sklearn precision/recall/balanced-accuracy/F1 per
batch and averages across batches (reference:
pointstowood/src/trainer.py:198-202), a mean of per-batch metrics, not a
pooled confusion matrix. ``binary_counts`` runs on the device and returns
the per-batch confusion counts; ``batch_metrics`` applies the sklearn
formulas on the host (including zero_division=0 and balanced accuracy
averaged over the classes present in y_true).
"""

from __future__ import annotations

import numpy as np
import torch


def binary_counts(preds: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """(tp, fp, tn, fn) over valid points, as a (4,) fp32 tensor."""
    preds = preds.float()
    labels = labels.float()
    m = torch.ones_like(labels) if mask is None else mask.float()
    tp = torch.sum(m * preds * labels)
    fp = torch.sum(m * preds * (1 - labels))
    tn = torch.sum(m * (1 - preds) * (1 - labels))
    fn = torch.sum(m * (1 - preds) * labels)
    return torch.stack([tp, fp, tn, fn])


def batch_metrics(counts) -> dict:
    """sklearn-equivalent binary metrics from (tp, fp, tn, fn)."""
    if isinstance(counts, torch.Tensor):
        counts = counts.detach().cpu().numpy()
    tp, fp, tn, fn = [float(c) for c in np.asarray(counts)]
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) > 0 else 0.0)
    # balanced accuracy: mean recall over classes present in y_true
    recalls = []
    if (tp + fn) > 0:
        recalls.append(tp / (tp + fn))
    if (tn + fp) > 0:
        recalls.append(tn / (tn + fp))
    balanced_accuracy = float(np.mean(recalls)) if recalls else 0.0
    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "balanced_accuracy": balanced_accuracy,
    }
