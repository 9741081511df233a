"""The reference's fusion neighbour cache ``nbrs.npy`` in the PyTorch port:
where the working directory holds it, fusion takes its indices as they
are, with no search, on the host path, as the JAX package does
(pointstowood_tpu/predict/predicter.py:233, predict/fusion.py:189-192).
Before, the port ignored the file, so the same inputs in such a directory
fused differently from JAX."""

import numpy as np
import pandas as pd
import pytest
import torch

from pointstowood_tpu.predict import fusion as j_fusion
from pointstowood_tpu_torch.config import (
    ModelConfig,
    PredictConfig,
    TilingConfig,
)
from pointstowood_tpu_torch.data.tiling import preprocess_cloud
from pointstowood_tpu_torch.predict import device_fusion
from pointstowood_tpu_torch.predict import fusion as t_fusion
from pointstowood_tpu_torch.predict import predicter as t_predicter


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test processes share the host's cores: pin torch's
    intra-op threads (see tests/test_torch_net.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cloud(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n // 3)
    r = rng.uniform(0, 0.2, n // 3)
    trunk = np.stack([3 + r * np.cos(theta), 3 + r * np.sin(theta),
                      rng.uniform(0, 5, n // 3)], 1)
    crown = np.stack([3 + rng.normal(0, 1.2, n - n // 3),
                      3 + rng.normal(0, 1.2, n - n // 3),
                      4 + rng.normal(0, 0.8, n - n // 3)], 1)
    xyz = np.concatenate([trunk, crown])
    return {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "reflectance": rng.normal(size=n)}


def _classified(m=2500, seed=1):
    """(m, 5) rows [x, y, z, pred, prob] with a wood field near the
    trunk axis."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 6, (m, 3))
    prob = 1 / (1 + np.exp((np.linalg.norm(xyz[:, :2] - 3.0, axis=1) - 0.8)
                           * 4))
    return np.concatenate([xyz, (prob >= 0.5)[:, None], prob[:, None]], 1)


def _no_search(*args, **kwargs):
    raise AssertionError("a neighbour search ran although nbrs.npy exists")


@pytest.mark.parametrize("any_wood", [1.0, 0.5])
def test_collect_predictions_matches_jax_from_nbrs(tmp_path, monkeypatch,
                                                   any_wood):
    """One nbrs.npy in the working directory: the port's and JAX's
    Fusion.collect_predictions give identical label and pwood, and those
    of the cached indices (arbitrary rows, not the nearest), with no
    search."""
    table, classified = _cloud(), _classified()
    k = 64 if any_wood == 1 else 32
    rng = np.random.default_rng(2)
    nbrs = rng.integers(0, len(classified), (len(table["x"]), k))
    np.save(tmp_path / "nbrs.npy", nbrs)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(t_fusion, "knn_indices", _no_search)
    monkeypatch.setattr(j_fusion, "knn_indices", _no_search)
    got = t_fusion.Fusion(0.5, any_wood, device="cpu").collect_predictions(
        classified, table)
    want = j_fusion.Fusion(0.5, any_wood).collect_predictions(
        classified, pd.DataFrame(table))
    for c in ("label", "pwood"):
        assert np.array_equal(got[c], want[c].to_numpy()), c
    xyz = np.stack([table[c] for c in "xyz"], 1)
    direct = t_fusion.fuse_labels(classified, xyz, 0.5, any_wood,
                                  indices=nbrs, device="cpu")
    assert np.array_equal(got["label"], direct[:, 0])
    assert np.array_equal(got["pwood"], direct[:, 1])
    # the cache is not what a search would find
    monkeypatch.undo()
    searched = t_fusion.fuse_labels(classified, xyz, 0.5, any_wood,
                                    device="cpu")
    assert not np.array_equal(searched[:, 1], direct[:, 1])


def test_collect_predictions_rejects_a_cache_of_other_rows(tmp_path,
                                                           monkeypatch):
    table, classified = _cloud(), _classified()
    np.save(tmp_path / "nbrs.npy", np.zeros((len(table["x"]) - 1, 64),
                                            np.int64))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="nbrs.npy"):
        t_fusion.Fusion(0.5, 1.0, device="cpu").collect_predictions(
            classified, table)


@pytest.fixture(scope="module")
def plot():
    from pointstowood_tpu_torch.io.loader import canonicalize_columns

    pc, _, _ = canonicalize_columns(_cloud(), mode="predict")
    tiling = TilingConfig(grid_size=(2.0, 4.0), min_pts=64, max_pts=1024)
    tiles = preprocess_cloud(pc, tiling)
    net = t_predicter.build_net(ModelConfig(channels=8,
                                            compute_dtype="float32"),
                                device="cpu")
    return pc, tiles, tiling, net


@pytest.mark.parametrize("mode", ["auto", "tpu"])
def test_semantic_segmentation_takes_the_cached_host_path(
        plot, tmp_path, monkeypatch, capsys, mode):
    """With nbrs.npy in the working directory, semantic_segmentation takes
    neither the pair path nor the index path (the dual grid would take
    the pair path without it) and makes no search: its labels are the
    cached indices' fusion of run_inference's rows."""
    pc, tiles, tiling, net = plot
    cfg = PredictConfig(batch_size=4, fusion=mode)
    n = len(pc["x"])
    classified = t_predicter.run_inference(tiles, net, cfg, tiling,
                                           device="cpu")
    rng = np.random.default_rng(3)
    nbrs = rng.integers(0, len(classified), (n, 64))
    np.save(tmp_path / "nbrs.npy", nbrs)
    monkeypatch.chdir(tmp_path)
    for mod, name in ((t_predicter, "knn_indices"),
                      (t_fusion, "knn_indices"),
                      (device_fusion, "plan_fusion"),
                      (device_fusion, "fusion_indices"),
                      (device_fusion, "fuse_on_device"),
                      (device_fusion, "sink_for")):
        monkeypatch.setattr(mod, name, _no_search)
    capsys.readouterr()
    out = t_predicter.semantic_segmentation(pc, tiles, net, cfg, tiling,
                                            device="cpu")
    line = [s for s in capsys.readouterr().out.splitlines()
            if s.startswith("fusion:")]
    assert len(line) == 1 and "nbrs.npy" in line[0], line
    assert f"{n} points, 0 searched on the host" in line[0]
    want = t_fusion.fuse_labels(classified, np.stack(
        [pc[c] for c in "xyz"], 1), 0.5, 1.0, indices=nbrs, device="cpu")
    assert np.array_equal(out["label"], want[:, 0])
    assert np.array_equal(out["pwood"], want[:, 1])
