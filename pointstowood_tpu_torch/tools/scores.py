"""Binary classification scores in numpy, with sklearn's semantics
(``precision_score``, ``recall_score``, ``f1_score`` with
``zero_division=0``, and ``balanced_accuracy_score``), for the tools and
``chip_smoke.py``: the card's machine has no sklearn.

Labels are binarised as the JAX tools pass them (``> 0`` is class 1).
"""

from __future__ import annotations

import warnings

import numpy as np


def _counts(truth, pred):
    t = np.asarray(truth) > 0
    p = np.asarray(pred) > 0
    tp = int(np.count_nonzero(t & p))
    return tp, int(np.count_nonzero(~t & p)), int(np.count_nonzero(t & ~p))


def _ratio(num: float, den: float) -> float:
    """num / den, 0 where den is 0 (sklearn's ``zero_division=0``)."""
    return float(num / den) if den else 0.0


def precision(truth, pred) -> float:
    """tp / (tp + fp); 0 with no predicted positive."""
    tp, fp, _ = _counts(truth, pred)
    return _ratio(tp, tp + fp)


def recall(truth, pred) -> float:
    """tp / (tp + fn); 0 with no true positive."""
    tp, _, fn = _counts(truth, pred)
    return _ratio(tp, tp + fn)


def f1(truth, pred) -> float:
    """2 tp / (2 tp + fp + fn); 0 where that is 0 / 0."""
    tp, fp, fn = _counts(truth, pred)
    return _ratio(2 * tp, 2 * tp + fp + fn)


def balanced_accuracy(truth, pred, sample_weight=None) -> float:
    """The mean of the per-class recall, each class's weight the sum of
    ``sample_weight`` over its points (1 each by default). A class that
    ``pred`` names but ``truth`` holds no weight of has no recall: it is
    dropped with a warning, as sklearn drops it."""
    truth, pred = np.asarray(truth), np.asarray(pred)
    w = (np.ones(truth.shape, np.float64) if sample_weight is None
         else np.asarray(sample_weight, np.float64))
    classes = np.union1d(truth, pred)
    recalls = []
    for c in classes:
        den = w[truth == c].sum()
        if den:
            recalls.append(w[(truth == c) & (pred == c)].sum() / den)
    if len(recalls) < len(classes):
        warnings.warn("y_pred contains classes not in y_true")
    if not recalls:
        return float("nan")
    return float(np.mean(recalls))
