"""The data and the score of ``chip_smoke.py``'s phase ``accuracy`` (its
port of scripts/c32_accuracy_and_knn_deviation.py, with no pandas, sklearn
or JAX): its ``make_forest`` gives the arrays of
scripts/accuracy_smoke.py's, and its numpy balanced accuracy is
sklearn's ``balanced_accuracy_score``."""

import warnings

import numpy as np
import pytest
from sklearn.metrics import balanced_accuracy_score

from chip_smoke import balanced_accuracy, make_forest
from scripts.accuracy_smoke import make_forest as reference_forest


@pytest.mark.parametrize("seed, n_trees, pts", [
    (1, 4, 25000),   # the phase's training forest
    (99, 4, 25000),  # its held-out forest
    (7, 2, 1001),    # counts that do not divide by 3 or 2
])
def test_make_forest_equals_the_scripts(seed, n_trees, pts):
    got = make_forest(seed, n_trees=n_trees, pts_per_tree=pts)
    want = reference_forest(seed, n_trees=n_trees, pts_per_tree=pts)
    assert list(got) == list(want.columns)
    for c in want.columns:
        assert got[c].dtype == want[c].dtype, c
        assert np.array_equal(got[c], want[c].to_numpy()), c


@pytest.mark.parametrize("seed", range(6))
def test_balanced_accuracy_is_sklearns(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 500))
    truth = (rng.uniform(size=n) < rng.uniform(0.05, 0.95)).astype(
        np.float64)
    pred = np.where(rng.uniform(size=n) < 0.7, truth, 1 - truth)
    if seed == 4:
        pred = np.ones(n)  # every point labelled wood
    if seed == 5:
        truth = np.zeros(n)  # one class present: its recall alone
    with warnings.catch_warnings():
        # sklearn warns where a predicted class is absent from the truth
        warnings.simplefilter("ignore")
        want = balanced_accuracy_score(truth, pred)
    assert balanced_accuracy(truth, pred) == pytest.approx(want, abs=1e-12)
