"""The port's HDBSCAN (pointstowood_tpu_torch.tools.hdbscan, numpy) against
sklearn's ``HDBSCAN`` (imported here only): the same labels, cluster
numbering included, for the calls ``tools/instance.py`` makes
(min_cluster_size 3 on 3-D bands and 2-D points; 2 with
``allow_single_cluster`` on 2-D centroids) and their neighbours, on
seeded blobs, trunk-ring bands, noise, duplicates and grids.

Ties: duplicated points and grid points make many mutual-reachability
distances equal. The port builds the same minimum spanning tree edge for
edge (Prim from point 0, sklearn's choice among equal edges) and sorts it
with the same ``np.argsort``, so the merges at equal distances come in
sklearn's order: the labels are held equal on those cases too."""

import warnings

import numpy as np
import pytest
from sklearn.cluster import HDBSCAN as SklearnHDBSCAN

from pointstowood_tpu_torch.tools.hdbscan import HDBSCAN


def _cloud(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "blobs2d" or kind == "blobs3d":
        d = 2 if kind == "blobs2d" else 3
        centres = rng.uniform(-5, 5, (int(rng.integers(2, 5)), d))
        return np.concatenate([
            c + rng.normal(0, rng.uniform(0.1, 0.8),
                           (int(rng.integers(4, 60)), d))
            for c in centres])
    if kind == "bands":  # 0.2 m slices of three trunks' rings
        n = int(rng.integers(60, 300))
        th = rng.uniform(0, 2 * np.pi, n)
        r = rng.uniform(0.05, 0.2, n)
        cx = rng.integers(0, 3, n) * 3.0
        return np.stack([cx + r * np.cos(th), r * np.sin(th),
                         rng.uniform(0, 0.2, n)], 1)
    if kind == "noise":
        return rng.uniform(0, 10, (int(rng.integers(20, 150)), 3))
    if kind == "duplicates":
        base = rng.normal(size=(int(rng.integers(4, 30)), 2))
        return base[rng.integers(0, len(base), int(rng.integers(20, 100)))]
    if kind == "grid":
        g = np.stack(np.meshgrid(np.arange(6.0), np.arange(6.0)), -1)
        keep = int(rng.integers(8, 37))
        return g.reshape(-1, 2)[rng.permutation(36)][:keep]
    if kind == "centroids":  # instance's lowest-cluster medians
        trunks = rng.uniform(0, 20, (int(rng.integers(1, 5)), 2))
        return np.concatenate(
            [t + rng.normal(0, 0.05, (int(rng.integers(1, 6)), 2))
             for t in trunks])
    raise ValueError(kind)


CASES = [(kind, seed, m, single)
         for kind in ("blobs2d", "blobs3d", "bands", "noise", "duplicates",
                      "grid", "centroids")
         for seed in (0, 1, 2)
         for m, single in ((3, False), (2, True))]
CASES += [("bands", 5, 2, False), ("blobs3d", 7, 3, True),
          ("duplicates", 9, 3, True), ("noise", 4, 5, False)]


@pytest.mark.parametrize("kind, seed, m, single", CASES,
                         ids=[f"{k}-{s}-m{m}-{'single' if a else 'eom'}"
                              for k, s, m, a in CASES])
def test_labels_equal_sklearns(kind, seed, m, single):
    x = _cloud(kind, seed)
    if len(x) < m:
        x = np.concatenate([x, x + 0.01])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn's `copy` FutureWarning
        want = SklearnHDBSCAN(min_cluster_size=m, allow_single_cluster=single,
                              copy=False).fit_predict(x)
    got = HDBSCAN(min_cluster_size=m,
                  allow_single_cluster=single).fit_predict(x)
    assert np.array_equal(got, want)


def test_the_cases_find_clusters_and_noise():
    """The cases are not all noise or all one cluster."""
    labels = [HDBSCAN(min_cluster_size=m, allow_single_cluster=a)
              .fit_predict(_cloud(k, s)) for k, s, m, a in CASES]
    assert sum(lab.max() >= 1 for lab in labels) >= len(CASES) // 2
    assert sum((lab == -1).any() for lab in labels) >= len(CASES) // 4


@pytest.mark.parametrize("n, m", [(1, 2), (2, 3)])
def test_too_few_points_raise_as_sklearns(n, m):
    x = np.zeros((n, 2))
    with pytest.raises(ValueError):
        SklearnHDBSCAN(min_cluster_size=m, copy=False).fit_predict(x)
    with pytest.raises(ValueError):
        HDBSCAN(min_cluster_size=m).fit_predict(x)
