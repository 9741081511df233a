"""The port's fusion (pointstowood_tpu_torch.predict.device_fusion and
.fusion, and the plain version of the ``pair_select`` kernel) against the
JAX package and a numpy brute force, on the CPU.

The port's pair selection is exact where JAX's is a group fold plus
``approx_min_k`` at recall 0.8, so the pair path is held to the JAX
package's own bar against exact host fusion (tests/test_tpu_fusion.py):
label agreement >= 0.98 and mean |delta pwood| < 0.02. Measured against
JAX's fuse_on_device on the 6000-point dual-grid cloud: label agreement
0.99767 and mean |delta pwood| 0.00331 at any_wood 1.0; 1.0 and 0.00259
at any_wood 2.0 (where ``c > any_wood`` labels nothing wood, as in the
reference). The host path's median and vote equal JAX's within 1e-6.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from pointstowood_tpu.config import TilingConfig as JTilingConfig
from pointstowood_tpu.data.dataset import TileBatcher as JBatcher
from pointstowood_tpu.data.tiling import preprocess_cloud as j_preprocess
from pointstowood_tpu.io.loader import canonicalize_columns as j_canon
from pointstowood_tpu.predict import fusion as j_fusion
from pointstowood_tpu.predict import tpu_fusion as j_tpu_fusion
from pointstowood_tpu_torch.config import PredictConfig
from pointstowood_tpu_torch.config import TilingConfig as TTilingConfig
from pointstowood_tpu_torch.data.dataset import TileBatcher as TBatcher
from pointstowood_tpu_torch.data.tiling import preprocess_cloud as t_preprocess
from pointstowood_tpu_torch.io.loader import canonicalize_columns as t_canon
from pointstowood_tpu_torch.ops.fusion_kernels import (
    pair_select,
    pair_select_plain,
)
from pointstowood_tpu_torch.predict import device_fusion
from pointstowood_tpu_torch.predict import fusion as t_fusion
from pointstowood_tpu_torch.predict.predicter import tile_batcher

_KW = dict(grid_size=(2.0, 4.0), min_pts=64, max_pts=4096)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes on the host's cores at once,
    and a full team of torch intra-op threads per process makes each wait
    for cores the others hold (on the full suite this file took 47 s,
    against ~10 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cloud(n=6000, seed=0):
    """tests/test_tpu_fusion.py's trunk-and-crown cloud."""
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


def _field(xyz):
    """tests/test_tpu_fusion.py's probability field: wood near the trunk
    axis."""
    return 1 / (1 + np.exp((np.linalg.norm(xyz[:, :2] - 3.0, axis=1) - 0.4)
                           * 4))


@pytest.fixture(scope="module")
def scene():
    cloud = _cloud()
    jdf, _, _ = j_canon(pd.DataFrame(cloud), mode="predict")
    j_tiles = j_preprocess(jdf, JTilingConfig(**_KW))
    j_order = JBatcher(j_tiles, batch_size=4, min_pts=64,
                       max_pts=4096).tile_order()
    tpc, _, _ = t_canon(dict(cloud), mode="predict")
    tiles = t_preprocess(tpc, TTilingConfig(**_KW))
    order = TBatcher(tiles, batch_size=4, min_pts=64,
                     max_pts=4096).tile_order()
    assert order == j_order
    classified_xyz = np.concatenate([tiles[t].points[:, :3] for t in order])
    prob = _field(classified_xyz)
    classified = np.concatenate(
        [classified_xyz, (prob >= 0.5)[:, None], prob[:, None]], axis=1)
    query_xyz = np.stack([tpc[c] for c in ("x", "y", "z")], 1)
    return tiles, j_tiles, order, classified, query_xyz


def _sink(tiles):
    """The FlatSink of the serving path's batcher on the CPU, each batch
    written with the field at its positions + tile shifts, as the model
    phase writes its probabilities."""
    batcher = tile_batcher(tiles, PredictConfig(batch_size=4),
                           TTilingConfig(**_KW))
    sink = device_fusion.sink_for(tiles, batcher, "cpu")
    for _, batch, _ in batcher:
        xyz = batch.pos + batch.shift[:, None, :]
        sink.write(torch.from_numpy(batch.pos), batch.shift, torch.from_numpy(
            _field(xyz.reshape(-1, 3)).reshape(xyz.shape[:2])
            .astype(np.float32)))
    return sink


@pytest.fixture(scope="module")
def flat(scene):
    """(layout, resident arrays) of the scene's FlatSink."""
    sink = _sink(scene[0])
    return sink.layout, sink.arrays()


def _fuse(tiles, flat, query_xyz, any_wood=1.0, min_pts=64):
    layout, arrays = flat
    plan = device_fusion.plan_fusion(tiles, query_xyz, min_pts, layout)
    return device_fusion.fuse_on_device(plan, arrays, query_xyz, 0.5,
                                        any_wood, device="cpu")


@pytest.fixture(scope="module")
def jax_fused(scene):
    """JAX fuse_on_device at any_wood 1.0 and 2.0, computed once."""
    _, j_tiles, order, classified, query_xyz = scene
    prob = classified[:, -1].astype(np.float32)
    return {aw: j_tpu_fusion.fuse_on_device(
        j_tiles, order, prob, query_xyz, 0.5, aw, _KW["min_pts"],
        _KW["max_pts"]) for aw in (1.0, 2.0)}


def _brute(queries, q_len, src, regions, k):
    """numpy brute force in the kernels' float32 order of operations and a
    stable sort: per entry, (union rows, d2) of the k nearest."""
    out = []
    for e in range(len(q_len)):
        of, lf, oc, lc = regions[e]
        rows = np.concatenate([np.arange(of, of + lf), np.arange(oc, oc + lc)])
        diff = queries[e, :q_len[e], None, :] - src[rows][None]
        sq = diff * diff
        d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        order = np.argsort(d, axis=1, kind="stable")[:, :k]
        out.append((rows[order], np.take_along_axis(d, order, 1)))
    return out


@pytest.mark.parametrize("k", [32, 64])
def test_pair_select_plain_matches_brute_force(k):
    rng = np.random.default_rng(k)
    n = 900
    src = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    src[450:600] = src[0:150]  # fine/coarse duplicates: exact d2 ties
    pay = torch.arange(n, dtype=torch.int32)  # payload = row: sets compare
    q_len = np.array([70, 0, 5, 33], np.int32)
    regions = np.array([[0, 300, 450, 400], [0, 10, 10, 10],
                        [100, 20, 800, 30], [600, 40, 0, 0]], np.int32)
    queries = rng.uniform(0, 2, (4, 70, 3)).astype(np.float32)
    d, p = pair_select(torch.from_numpy(queries), torch.from_numpy(q_len),
                       torch.from_numpy(src), pay, torch.from_numpy(regions),
                       k)
    d, p = d.numpy(), p.numpy()
    for e, (rows, d32) in enumerate(_brute(queries, q_len, src, regions, k)):
        ql = int(q_len[e])
        kk = rows.shape[1]
        assert np.array_equal(p[e, :ql, :kk], rows)
        assert np.array_equal(d[e, :ql, :kk], d32)
        assert np.isinf(d[e, :ql, kk:]).all() and (p[e, :ql, kk:] == 0).all()
        assert np.isinf(d[e, ql:]).all() and (p[e, ql:] == 0).all()


def test_pair_select_ties_go_to_the_lower_union_index():
    src = np.zeros((6, 3), np.float32)
    src[:, 0] = [0.0, 1.0, 2.0, 0.0, 1.0, 2.0]  # coarse rows repeat fine
    pay = torch.arange(6, dtype=torch.int32)
    q = torch.zeros((1, 1, 3))
    d, p = pair_select_plain(q, torch.tensor([1], dtype=torch.int32),
                             torch.from_numpy(src), pay,
                             torch.tensor([[3, 3, 0, 3]], dtype=torch.int32),
                             32)
    # union = rows 3, 4, 5 (fine) then 0, 1, 2 (coarse)
    assert p[0, 0, :6].tolist() == [3, 0, 4, 1, 5, 2]
    assert d[0, 0, :6].tolist() == [0, 0, 1, 1, 4, 4]


@pytest.mark.parametrize("any_wood", [1.0, 2.0])
def test_fuse_on_device_matches_jax(scene, flat, jax_fused, any_wood):
    tiles, _, _, classified, query_xyz = scene
    got = _fuse(tiles, flat, query_xyz, any_wood)
    want = jax_fused[any_wood]
    assert got.shape == want.shape == (len(query_xyz), 2)
    agree = float((got[:, 0] == want[:, 0]).mean())
    dp = float(np.abs(got[:, 1] - want[:, 1]).mean())
    print(f"any_wood={any_wood}: label agreement {agree}, "
          f"mean |d pwood| {dp}")
    assert agree >= 0.98
    assert dp < 0.02
    # pwood lives on the 1/2046 grid of medians of 10-bit payloads
    assert np.allclose(got[:, 1] * 2046, np.round(got[:, 1] * 2046))
    # and the pair path agrees with exact host fusion at the same bar
    host = t_fusion.fuse_labels(classified, query_xyz, 0.5, any_wood,
                                device="cpu")
    assert (got[:, 0] == host[:, 0]).mean() >= 0.98
    assert np.abs(got[:, 1] - host[:, 1]).mean() < 0.02


def test_resident_flat_arrays_fuse_like_the_uploaded_ones(scene, flat):
    """The FlatSink arrays (batch layout with padding rows, positions +
    shift written per batch) fuse like flat arrays built on the host from
    the tile points and the classified probabilities, back to back in
    batcher order: the layout and the sink's writes change no result."""
    tiles, _, order, classified, query_xyz = scene
    lens = np.array([len(t) for t in tiles], np.int64)
    off = np.zeros(len(tiles), np.int64)
    off[order] = np.cumsum(lens[order]) - lens[order]
    tight = device_fusion.FlatLayout(off, lens, lens.sum(), [0])
    uploaded = (torch.from_numpy(classified[:, :3].astype(np.float32)),
                torch.from_numpy(classified[:, -1].astype(np.float32)))
    got = _fuse(tiles, flat, query_xyz)
    want = _fuse(tiles, (tight, uploaded), query_xyz)
    assert (got[:, 0] == want[:, 0]).mean() >= 0.999
    assert np.abs(got[:, 1] - want[:, 1]).max() <= 2 / 2046
    layout, (xyz, _) = flat
    assert layout.flat_len > len(classified)  # padding rows exist
    for t in order:
        o, n = int(layout.off[t]), int(layout.lens[t])
        np.testing.assert_allclose(xyz[o:o + n].numpy(),
                                   tiles[t].points[:, :3], atol=1e-5)
    with pytest.raises(RuntimeError, match="batches"):
        device_fusion.FlatSink(layout, "cpu").arrays()


def test_nan_query_rows_fuse_to_zero(scene, flat):
    tiles, _, _, _, query_xyz = scene
    qn = query_xyz.copy()
    qn[7] = np.nan
    got = _fuse(tiles, flat, qn)
    assert got[7, 0] == 0.0 and got[7, 1] == 0.0
    ok = np.ones(len(qn), bool)
    ok[7] = False
    prev = _fuse(tiles, flat, query_xyz)
    assert np.array_equal(got[ok], prev[ok])


def test_query_slots_take_the_later_duplicate():
    perm = np.array([2, 0, -1, 2, 1, -1], np.int64)
    plan = device_fusion.FusionPlan(None, 4, perm, np.zeros(0, np.int32),
                                    np.zeros((0, 4), np.int32), 0)
    assert plan.query_slots().tolist() == [1, 4, 3, 6]


def test_single_scale_and_other_declined_tilings(scene, flat):
    tiles, _, _, _, query_xyz = scene
    single = [t for t in tiles if t.grid_size == 2.0]
    assert device_fusion.plan_fusion(single, query_xyz, 64, flat[0]) is None
    assert device_fusion.plan_fusion(tiles, query_xyz, 16, flat[0]) is None
    assert "two grid scales" in device_fusion.declines(single, 64)
    assert "min_pts" in device_fusion.declines(tiles, 16)
    assert "cluster_features" in device_fusion.declines(tiles, 64, True)
    assert device_fusion.declines(tiles, 64) is None


@pytest.mark.parametrize("m", [500, 33])
@pytest.mark.parametrize("any_wood", [1.0, 0.9, 2.0])
def test_fuse_labels_matches_jax(any_wood, m):
    """Same indices into the same probabilities: the median of an even
    neighbour count averages the two middle values (k = 64/32), an odd
    one (k = m = 33) takes the middle."""
    rng = np.random.default_rng(9)
    prob = rng.uniform(0, 1, (m, 1))
    prob[::5] = prob[1]  # repeated values around the median
    classified = np.concatenate(
        [rng.uniform(0, 5, (m, 3)), (prob >= 0.5), prob], axis=1)
    query = rng.uniform(0, 5, (300, 3))
    k = min(64 if any_wood == 1 else 32, m)
    idx = t_fusion.knn_indices(classified[:, :3], query, k)
    assert np.array_equal(idx, j_fusion.knn_indices(classified[:, :3],
                                                    query, k))
    got = t_fusion.fuse_labels(classified, query, 0.5, any_wood, chunk=128,
                               indices=idx, device="cpu")
    want = j_fusion.fuse_labels(classified, query, 0.5, any_wood, chunk=128,
                                indices=idx)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])


def test_collect_predictions_keeps_columns_and_drops_pleaf():
    rng = np.random.default_rng(1)
    table = {"x": rng.normal(size=50), "y": rng.normal(size=50),
             "z": rng.normal(size=50), "label": np.ones(50),
             "pleaf": np.ones(50), "n_z": np.zeros(50)}
    classified = np.concatenate(
        [rng.normal(size=(80, 3)), np.zeros((80, 1)),
         rng.uniform(size=(80, 1))], axis=1)
    out = t_fusion.Fusion(0.5, 1.0, device="cpu").collect_predictions(
        classified, table)
    assert list(out) == ["x", "y", "z", "label", "n_z", "pwood"]
    assert "pleaf" in table and out["x"] is table["x"]
