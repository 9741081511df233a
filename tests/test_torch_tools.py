"""The port's analysis tools (pointstowood_tpu_torch.tools) against the JAX
package's tools (pointstowood_tpu.tools) on the same seeded inputs, on the
CPU: ``split_ply``, ``collect_attribute``, ``clustering``,
``height_normalisation``, ``pathlength`` and ``voxel_cell_ids_np`` bit for
bit; ``compare``'s table within 1e-12 of pandas plus sklearn and its
``results.csv`` equal to JAX's; ``scores`` within 1e-12 of sklearn;
``threshold_sweep``'s ``sweep`` on one classified array (labels equal,
pwood within 1e-7) and its ``main`` against JAX's on a C=8 ``.ckpt``
(wood fraction and BA within 0.01: the port's kNN is exact where JAX's
fast route approximates). The cases cover tests/test_tools.py's."""

import os
import re
import warnings

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn import metrics

from pointstowood_tpu.io import read_ply as j_read_ply
from pointstowood_tpu.io import write_ply as j_write_ply
from pointstowood_tpu.ops.voxel import voxel_cell_ids_np as j_voxel_ids
from pointstowood_tpu.tools import clustering as j_clustering
from pointstowood_tpu.tools import collect_attribute as j_collect
from pointstowood_tpu.tools import compare as j_compare
from pointstowood_tpu.tools import height_normalisation as j_height
from pointstowood_tpu.tools import pathlength as j_path
from pointstowood_tpu.tools import split_ply as j_split
from pointstowood_tpu.tools import threshold_sweep as j_sweep
from pointstowood_tpu_torch.io import read_ply, write_ply
from pointstowood_tpu_torch.ops.voxel import voxel_cell_ids_np
from pointstowood_tpu_torch.tools import (
    clustering,
    collect_attribute,
    compare,
    height_normalisation,
    pathlength,
    scores,
    split_ply,
    threshold_sweep,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes on the host's cores at once;
    a full team of torch intra-op threads per process makes each wait for
    cores the others hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _table(df: pd.DataFrame) -> dict:
    return {c: df[c].to_numpy() for c in df.columns}


def _frame(rng, n, scale=1.0, **extra):
    df = pd.DataFrame(rng.uniform(0, scale, (n, 3)), columns=["x", "y", "z"])
    for name, col in extra.items():
        df[name] = col
    return df


# ---------------------------------------------------------------- voxel ids


@pytest.mark.parametrize("size, origin", [(0.05, None), (0.5, None),
                                          (2.0, (-3.0, 1.0, 0.5))])
def test_voxel_cell_ids_np_equals_jax(size, origin):
    rng = np.random.default_rng(3)
    pos = rng.uniform(-40, 400, (5000, 3))
    got = voxel_cell_ids_np(pos, size, origin)
    want = j_voxel_ids(pos, size, origin)
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)


# --------------------------------------------------------------- clustering


@pytest.mark.parametrize("case", ["two_blobs", "size_filter", "max_size",
                                  "chain"])
def test_euclidean_cluster_equals_jax(case):
    rng = np.random.default_rng(141190)
    if case == "chain":
        xyz = np.cumsum(rng.normal(0, 0.03, (400, 3)), axis=0)
        kw = dict(tolerance=0.05)
    else:
        a = rng.normal(0, 0.01, size=(50, 3))
        b = rng.normal(0, 0.01, size=(3 if case != "two_blobs" else 60, 3))
        xyz = np.concatenate([a, b + 10.0, rng.normal(0, 0.01, (20, 3)) - 5])
        xyz = xyz[rng.permutation(len(xyz))]
        kw = {"two_blobs": dict(tolerance=0.5),
              "size_filter": dict(tolerance=0.5, min_size=10),
              "max_size": dict(tolerance=0.5, min_size=2, max_size=30)}[case]
    got = clustering.euclidean_cluster(xyz, **kw)
    want = j_clustering.euclidean_cluster(xyz, **kw)
    assert np.array_equal(got, want)
    assert (got >= 0).any()


# ------------------------------------------------------ height normalisation


def _ground_scenes(rng):
    n = 500
    flat = pd.concat([
        pd.DataFrame({"x": rng.uniform(0, 10, n), "y": rng.uniform(0, 10, n),
                      "z": 5.0 + rng.normal(0, 0.01, n),
                      "label": np.full(n, 2.0)}),
        pd.DataFrame({"x": rng.uniform(0, 10, n), "y": rng.uniform(0, 10, n),
                      "z": rng.uniform(10, 20, n), "label": np.zeros(n)}),
    ], ignore_index=True)
    m = 300
    holes = pd.DataFrame({
        "x": np.concatenate([rng.uniform(0, 5, m), rng.uniform(5, 10, m)]),
        "y": rng.uniform(0, 10, 2 * m),
        "z": np.concatenate([np.full(m, 2.0), rng.uniform(10, 12, m)]),
        "label": np.concatenate([np.full(m, 2.0), np.zeros(m)]),
        "pwood": rng.uniform(size=2 * m),
    })
    no_ground = pd.DataFrame({"x": rng.uniform(0, 3, 200),
                              "y": rng.uniform(0, 3, 200),
                              "z": rng.uniform(1, 4, 200),
                              "label": np.zeros(200)})
    return {"flat": flat, "holes": holes, "no_ground": no_ground}


@pytest.mark.parametrize("scene", ["flat", "holes", "no_ground"])
def test_normalise_height_equals_jax(scene):
    df = _ground_scenes(np.random.default_rng(141190))[scene]
    pc = _table(df)
    before = {c: v.copy() for c, v in pc.items()}
    got = height_normalisation.normalise_height(pc)
    want = j_height.normalise_height(df)
    assert list(got) == list(want.columns)
    for c in want.columns:
        assert np.array_equal(got[c], want[c].to_numpy()), c
    assert list(pc) == list(before)  # the input table is left as it was
    assert all(np.array_equal(pc[c], before[c]) for c in before)


# --------------------------------------------------------------- pathlength


def _line(n=100, top=10.0):
    z = np.linspace(0, top, n)
    return np.stack([np.zeros(n), np.zeros(n), z], axis=1)


def _path_cases():
    rng = np.random.default_rng(141190)
    line = _line()
    gap = np.concatenate([_line(40, 2.0),
                          np.stack([np.zeros(20), np.zeros(20),
                                    np.linspace(3, 4, 20)], 1)])
    walk = np.cumsum(rng.normal(0, 0.05, size=(200, 3)), axis=0)
    blob = np.concatenate([_line(50, 5.0),
                           rng.normal(0, 0.01, (10, 3)) + [50, 0, 10]])
    return {
        "line_knn": (line, dict(knn=3)),
        "disconnected_fill": (blob, dict(knn=3)),
        "line_grown": (line, dict(knn=10, method="grown")),
        "gap_bridging": (gap, dict(knn=60, method="grown",
                                   nbrs_threshold=0.15,
                                   nbrs_threshold_step=0.05)),
        "walk_knn": (walk, dict(knn=20)),
        "walk_grown": (walk, dict(knn=20, method="grown")),
        "walk_base_kpairs": (walk, dict(knn=30, method="grown", kpairs=1,
                                        base_location=17)),
    }


@pytest.mark.parametrize("case", list(_path_cases()))
def test_pathlengths_equal_jax(case):
    xyz, kw = _path_cases()[case]
    got = pathlength.pathlengths(xyz, **kw)
    want = j_path.pathlengths(xyz, **kw)
    assert np.array_equal(got, want)
    assert np.isfinite(got).all()


def test_grow_graph_edges_equal_jax():
    xyz = _path_cases()["gap_bridging"][0]
    got = pathlength.grow_graph_edges(xyz, 0, knn=60)
    want = j_path.grow_graph_edges(xyz, 0, knn=60)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("voxel, kw", [(0.5, dict(knn=5)),
                                       (0.05, dict(knn=100, method="grown"))])
def test_pathlengths_downsampled_equal_jax(voxel, kw):
    rng = np.random.default_rng(5)
    xyz = np.concatenate([_line(400),
                          rng.normal(0, 0.2, (300, 3)) + [0, 0, 6]])
    got = pathlength.pathlengths_downsampled(xyz, voxel, **kw)
    want = j_path.pathlengths_downsampled(xyz, voxel, **kw)
    assert np.array_equal(got, want)


def test_pathlength_cli_writes_the_column(tmp_path):
    xyz = _line(60)
    write_ply(str(tmp_path / "p.ply"), {"x": xyz[:, 0], "y": xyz[:, 1],
                                        "z": xyz[:, 2], "truth": np.ones(60)})
    pathlength.main([str(tmp_path / "p.ply"), "--knn", "4"])
    out = read_ply(str(tmp_path / "p_pathlength.ply"))
    assert list(out) == ["x", "y", "z", "truth", "pathlength"]
    assert np.array_equal(out["pathlength"], j_path.pathlengths(xyz, knn=4))


# ------------------------------------------------- collect_attribute, split


def test_collect_attributes_equals_jax():
    rng = np.random.default_rng(141190)
    src = _frame(rng, 100, label=np.arange(100).astype(float),
                 pwood=rng.uniform(size=100))
    for shift, cutoff in ((1e-6, None), (100.0, 0.5),
                          (rng.normal(0, 0.05, (100, 3)), 0.06)):
        tgt = src[["x", "y", "z"]].copy() + shift
        got = collect_attribute.collect_attributes(
            _table(tgt), _table(src), ["label", "pwood"], cutoff)
        want = j_collect.collect_attributes(tgt.copy(), src,
                                            ["label", "pwood"], cutoff)
        assert list(got) == list(want.columns)
        for c in want.columns:
            assert np.array_equal(got[c], want[c].to_numpy()), c
    assert (got["label"] == 0).any() and (got["label"] > 0).any()


def test_split_ply_equals_jax(tmp_path):
    rng = np.random.default_rng(141190)
    df = _frame(rng, 500, scale=10.0, truth=rng.integers(0, 2, 500) * 1.0)
    for who in ("jax", "port"):
        (tmp_path / who).mkdir()
        j_write_ply(str(tmp_path / who / "c.ply"), df)
    j_parts = j_split.split_and_save_ply(str(tmp_path / "jax" / "c.ply"))
    parts = split_ply.split_and_save_ply(str(tmp_path / "port" / "c.ply"),
                                         percentile=80.0)
    for p, jp in zip(parts, j_parts):
        assert os.path.basename(p) == os.path.basename(jp)
        got, want = read_ply(p), j_read_ply(jp)
        assert list(got) == list(want.columns)
        for c in want.columns:
            assert np.array_equal(got[c], want[c].to_numpy()), c
    a, b = (read_ply(p) for p in parts)
    assert len(a["x"]) + len(b["x"]) == 500
    assert a["x"].max() <= b["x"].min()


# ------------------------------------------------------------------ scores


def _score_cases():
    rng = np.random.default_rng(11)
    n = 300
    truth = rng.integers(0, 2, n)
    pred = np.where(rng.uniform(size=n) < 0.8, truth, 1 - truth)
    w = rng.uniform(0, 3, n)
    return {
        "plain": (truth, pred, None),
        "weighted": (truth, pred, w),
        "weights_with_zeros": (truth, pred, np.where(truth > 0, w, 0.0)),
        "one_class_absent": (np.zeros(n, int), pred, None),
        "no_predicted_positive": (truth, np.zeros(n, int), None),
        "no_true_positive_weighted": (np.zeros(n, int), np.zeros(n, int), w),
        "perfect": (truth, truth, w),
    }


@pytest.mark.parametrize("case", list(_score_cases()))
def test_scores_are_sklearns(case):
    truth, pred, w = _score_cases()[case]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ba = scores.balanced_accuracy(truth, pred, sample_weight=w)
    with warnings.catch_warnings(record=True) as sk_caught:
        warnings.simplefilter("always")
        want_ba = metrics.balanced_accuracy_score(truth, pred,
                                                  sample_weight=w)
    assert ba == pytest.approx(want_ba, abs=1e-12)
    # a class absent from the truth is dropped with a warning, as sklearn
    assert bool(caught) == bool([x for x in sk_caught
                                 if "not in y_true" in str(x.message)])
    for ours, theirs in ((scores.precision, metrics.precision_score),
                         (scores.recall, metrics.recall_score),
                         (scores.f1, metrics.f1_score)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = theirs(truth, pred, zero_division=0)
        assert ours(truth, pred) == pytest.approx(want, abs=1e-12)


# ------------------------------------------------------------------ compare


def _compare_dir(root, rng, with_pathlength=True):
    """Two plots of Poland, one of Spain, one unpaired; FSCT's label 2 is
    wood; one ours file lacks a pathlength column."""
    os.makedirs(root, exist_ok=True)
    for name, n, acc in (("pol_plot1", 400, 0.9), ("pol_plot2", 300, 0.7),
                         ("spa_a", 250, 0.8)):
        truth = rng.integers(0, 2, n).astype(float)
        base = _frame(rng, n, scale=5.0)
        ours = base.copy()
        ours["truth"] = truth
        ours["label"] = np.where(rng.uniform(size=n) < acc, truth, 1 - truth)
        if with_pathlength and name != "pol_plot2":
            ours["pathlength"] = rng.uniform(0, 20, n)
        fsct = base.copy()
        fsct["truth"] = truth
        fsct["label"] = np.where(rng.uniform(size=n) < acc - 0.1,
                                 truth * 2.0, rng.integers(0, 3, n) * 1.0)
        j_write_ply(os.path.join(root, f"{name}_ours.ply"), ours)
        j_write_ply(os.path.join(root, f"{name}_fsct.ply"), fsct)
    j_write_ply(os.path.join(root, "fin_lonely_fsct.ply"),
                _frame(rng, 10, truth=np.ones(10), label=np.ones(10)))


@pytest.mark.parametrize("with_pathlength", [True, False])
def test_compare_directory_equals_pandas_and_sklearn(tmp_path,
                                                     with_pathlength):
    _compare_dir(str(tmp_path), np.random.default_rng(141190),
                 with_pathlength)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_compare.compare_directory(str(tmp_path))
    got = compare.compare_directory(str(tmp_path))
    assert list(got) == list(want.columns)
    for c in want.columns:
        if want[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c], want[c].to_numpy(),
                                       rtol=0, atol=1e-12)
        else:
            assert got[c].tolist() == want[c].tolist(), c
    assert set(got["model"]) == {"ours", "fsct"}
    assert ("weighted_balanced_accuracy" in got) == with_pathlength


@pytest.mark.parametrize("with_pathlength", [True, False])
def test_results_csv_equals_jax(tmp_path, capsys, with_pathlength):
    for who in ("jax", "port"):
        _compare_dir(str(tmp_path / who), np.random.default_rng(7),
                     with_pathlength)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_compare.main([str(tmp_path / "jax")])
    compare.main([str(tmp_path / "port")])
    want = (tmp_path / "jax" / "results.csv").read_text()
    got = (tmp_path / "port" / "results.csv").read_text()
    assert got == want
    back = pd.read_csv(tmp_path / "port" / "results.csv",
                       index_col=["country", "model"])
    pd.testing.assert_frame_equal(
        back, pd.read_csv(tmp_path / "jax" / "results.csv",
                          index_col=["country", "model"]))


def test_compare_perfect_predictions_and_empty_dir(tmp_path, capsys):
    """tests/test_tools.py's case: perfect labels score BA 1 for both
    models; a directory without pairs says so."""
    rng = np.random.default_rng(141190)
    n = 400
    truth = rng.integers(0, 2, n).astype(float)
    base = _frame(rng, n, scale=5.0)
    j_write_ply(str(tmp_path / "pol_plot_ours.ply"),
                base.assign(truth=truth, label=truth))
    j_write_ply(str(tmp_path / "pol_plot_fsct.ply"),
                base.assign(truth=truth, label=np.where(truth > 0, 2.0, 0.0)))
    got = compare.compare_directory(str(tmp_path))
    assert set(got["model"]) == {"ours", "fsct"}
    assert (got["balanced_accuracy"] == 1.0).all()
    assert (got["country"] == "Poland").all()
    (tmp_path / "empty").mkdir()
    compare.main([str(tmp_path / "empty")])
    assert "no paired files found" in capsys.readouterr().out


# -------------------------------------------------------- threshold sweep


def _classified(rng, m=400):
    return np.concatenate(
        [rng.uniform(0, 5, size=(m, 3)), np.zeros((m, 1)),
         rng.uniform(0, 1, size=(m, 1))], axis=1)


@pytest.mark.parametrize("any_wood", [1.0, 0.5])
def test_sweep_equals_jax(any_wood):
    rng = np.random.default_rng(141190)
    classified = _classified(rng)
    pc = _frame(rng, 200, scale=5.0)
    thresholds = [0.2, 0.5, 0.8]
    got = list(threshold_sweep.sweep(classified, _table(pc), thresholds,
                                     any_wood=any_wood, device="cpu"))
    want = list(j_sweep.sweep(classified, pc, thresholds, any_wood=any_wood))
    fracs = []
    for (t, labels), (jt, jlabels) in zip(got, want):
        assert t == jt and labels.shape == jlabels.shape == (200, 2)
        assert np.array_equal(labels[:, 0], jlabels[:, 0])
        np.testing.assert_allclose(labels[:, 1], jlabels[:, 1], rtol=0,
                                   atol=1e-7)
        fracs.append(labels[:, 0].mean())
    # raising the threshold can only shrink the wood fraction
    assert fracs[0] >= fracs[1] >= fracs[2]
    if any_wood == 1.0:
        assert fracs[0] > 0.5 and fracs[2] < 0.5


def _sweep_table(text):
    rows = [line.split() for line in text.splitlines()
            if re.match(r"^\s+\d\.\d\d\s", line)]
    return np.array(rows, dtype=float)


def test_threshold_sweep_main_matches_jax(tmp_path, capsys, monkeypatch):
    """Both CLIs on one labelled tree and one C=8 ``.ckpt`` (seeded weights
    in the flax layout, written by the JAX package's ``save_checkpoint``):
    the same thresholds, wood fraction and BA within 0.01 of JAX's.

    Both build their ``ModelConfig`` in fp32 with the exact kNN, the
    predict CLI test's ``--dtype float32 --exact_knn`` (the sweep has no
    such flags). At the CLI's defaults, bf16 with JAX's approximate fast
    kNN, random weights put half the points within that route's error of
    the 0.5 threshold."""
    import functools

    from chip_smoke import seeded_flax_variables
    from pointstowood_tpu import config as j_config
    from pointstowood_tpu.utils.checkpoint import save_checkpoint
    from pointstowood_tpu_torch.config import ModelConfig
    from pointstowood_tpu_torch.predict.predicter import build_net

    for module, cls in ((j_config, j_config.ModelConfig),
                        (threshold_sweep, ModelConfig)):
        monkeypatch.setattr(module, "ModelConfig", functools.partial(
            cls, knn_mode="exact", compute_dtype="float32"))

    rng = np.random.default_rng(7)
    n1, n2 = 1500, 2500
    theta = rng.uniform(0, 2 * np.pi, n1)
    r = rng.uniform(0, 0.15, n1)
    trunk = np.stack([r * np.cos(theta), r * np.sin(theta),
                      rng.uniform(0, 6, n1)], 1)
    crown = np.stack([rng.normal(0, 1.2, n2), rng.normal(0, 1.2, n2),
                      4 + rng.normal(0, 1, n2)], 1)
    xyz = np.concatenate([trunk, crown])
    cloud = str(tmp_path / "tree.ply")
    j_write_ply(cloud, pd.DataFrame({
        "x": xyz[:, 0] + 100, "y": xyz[:, 1] + 50, "z": xyz[:, 2],
        "scalar_Refl": np.concatenate([rng.normal(2, 0.3, n1),
                                       rng.normal(-1, 0.5, n2)]),
        "truth": np.concatenate([np.ones(n1), np.zeros(n2)])}))
    model = str(tmp_path / "m.ckpt")
    net = build_net(ModelConfig(channels=8), device="cpu")
    save_checkpoint(model, seeded_flax_variables(net, 2))
    args = [cloud, "--model", model, "--channels", "8", "--min_pts", "512",
            "--max_pts", "1024", "--batch_size", "4",
            "--thresholds", "0.3", "0.4", "0.5", "0.6", "0.7"]
    j_sweep.main(args)
    want = _sweep_table(capsys.readouterr().out)
    rows = threshold_sweep.main(args, device="cpu")
    got = _sweep_table(capsys.readouterr().out)
    assert want.shape == got.shape == (5, 4)
    assert np.array_equal(got[:, 0], want[:, 0])
    print(np.hstack([want, got]))
    np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], rtol=0, atol=0.01)
    assert [row["threshold"] for row in rows] == [0.3, 0.4, 0.5, 0.6, 0.7]
    for row, line in zip(rows, got):
        assert round(row["wood_frac"], 3) == line[1]
        assert round(row["balanced_acc"], 3) == line[2]
    # not a constant labelling: the sweep moves the wood fraction
    assert got[0, 1] > got[-1, 1]
