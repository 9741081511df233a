"""The port's host tiling (pointstowood_tpu_torch.data.tiling) against the
JAX package's, on the CPU: for the same cloud and seed the tiles (points,
grid_size, cell_id, indices) and the ``n_z`` column are bit-identical,
through both subsample branches (reflectance-weighted without
replacement, and uniform with replacement when reflectance is all
zeros), and so are the packed cell ids, NaN rows included."""

import numpy as np
import pandas as pd
import pytest

from pointstowood_tpu.config import TilingConfig as JTilingConfig
from pointstowood_tpu.data import tiling as j_tiling
from pointstowood_tpu.io.loader import canonicalize_columns as j_canon
from pointstowood_tpu.ops import normalization as j_norm
from pointstowood_tpu_torch.config import TilingConfig as TTilingConfig
from pointstowood_tpu_torch.data import tiling as t_tiling
from pointstowood_tpu_torch.io.loader import canonicalize_columns as t_canon
from pointstowood_tpu_torch.ops import normalization as t_norm


def _cloud(n=6000, seed=0, zero_refl=False):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n // 3)
    r = rng.uniform(0, 0.2, n // 3)
    trunk = np.stack([3 + r * np.cos(theta), 3 + r * np.sin(theta),
                      rng.uniform(0, 5, n // 3)], 1)
    m = n - n // 3
    crown = np.stack([3 + rng.normal(0, 1.2, m), 3 + rng.normal(0, 1.2, m),
                      4 + rng.normal(0, 0.8, m)], 1)
    xyz = np.concatenate([trunk, crown])
    refl = np.zeros(n) if zero_refl else rng.normal(size=n)
    return {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "scalar_intensity": refl}


# max_pts 700 overflows the trunk's and the crown's cells at both scales
_KW = dict(grid_size=(2.0, 4.0), min_pts=64, max_pts=700)


@pytest.fixture(scope="module", params=["weighted", "with_replacement"])
def tiled(request):
    cloud = _cloud(zero_refl=request.param == "with_replacement")
    jdf, _, _ = j_canon(pd.DataFrame(cloud), mode="predict")
    j_tiles = j_tiling.preprocess_cloud(jdf, JTilingConfig(**_KW), seed=7)
    tpc, _, _ = t_canon(dict(cloud), mode="predict")
    t_tiles = t_tiling.preprocess_cloud(tpc, TTilingConfig(**_KW), seed=7)
    return jdf, j_tiles, tpc, t_tiles


def test_tiles_are_bit_identical(tiled):
    _, j_tiles, _, t_tiles = tiled
    assert len(t_tiles) == len(j_tiles) > 4
    assert any(len(t) == _KW["max_pts"] for t in t_tiles)
    for a, b in zip(t_tiles, j_tiles):
        assert a.grid_size == b.grid_size
        assert a.cell_id == b.cell_id
        assert a.points.dtype == b.points.dtype == np.float32
        assert np.array_equal(a.points, b.points)
        assert np.array_equal(a.indices, b.indices)


def test_n_z_is_bit_identical(tiled):
    jdf, _, tpc, _ = tiled
    assert list(tpc) == list(jdf.columns)
    assert tpc["n_z"].dtype == jdf["n_z"].to_numpy().dtype
    assert np.array_equal(tpc["n_z"], jdf["n_z"].to_numpy())


def test_with_replacement_branch_draws_duplicates(tiled):
    jdf, _, _, t_tiles = tiled
    zero = bool((jdf["reflectance"] == 0).all())
    dup = any(np.unique(t.indices).size < t.indices.size for t in t_tiles)
    assert dup == zero


def test_normalizations_are_bit_identical():
    rng = np.random.default_rng(2)
    refl = rng.normal(size=5000).astype(np.float32)
    refl[::7] = refl[3]  # ties break by input order
    assert np.array_equal(t_norm.quantile_normalize_np(refl),
                          j_norm.quantile_normalize_np(refl))
    xyz = rng.uniform(0, 30, (5000, 3))
    assert np.array_equal(t_norm.ground_normalize_np(xyz, 5.0),
                          j_norm.ground_normalize_np(xyz, 5.0))


@pytest.mark.parametrize("sizes", [(2.0, 4.0), (2.0, 3.0), (0.5, 2.0, 8.0)])
def test_cell_ids_multi_matches_with_nan_rows(sizes):
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-7, 13, (3000, 3)).astype(np.float32)
    xyz[5] = np.nan
    xyz[17, 2] = np.inf
    got = t_tiling.cell_ids_multi(xyz, sizes)
    assert np.array_equal(got, j_tiling.cell_ids_multi(xyz, sizes))
    for si, s in enumerate(sizes):
        assert np.array_equal(got[:, si], j_tiling.cell_ids_for(xyz, s))
        assert np.array_equal(got[:, si], t_tiling.cell_ids_for(xyz, s))
    assert got[5, 0] == t_tiling.NAN_CELL == j_tiling.NAN_CELL
    allnan = np.full((4, 3), np.nan, np.float32)
    assert np.array_equal(t_tiling.cell_ids_multi(allnan, sizes),
                          j_tiling.cell_ids_multi(allnan, sizes))


def test_vxdir_tiles_reload_as_in_the_jax_package(tmp_path):
    cloud = _cloud(n=2000, seed=1)
    tpc, _, _ = t_canon(dict(cloud), mode="predict")
    tiles = t_tiling.preprocess_cloud(tpc, TTilingConfig(**_KW),
                                      vxdir=str(tmp_path))
    got = t_tiling.load_tiles(str(tmp_path))
    want = j_tiling.load_tiles(str(tmp_path))
    assert len(got) == len(want) == len(tiles)
    for a, b, c in zip(got, want, tiles):
        assert (a.grid_size, a.cell_id) == (b.grid_size, b.cell_id) \
            == (c.grid_size, c.cell_id)
        assert np.array_equal(a.points, b.points)
        assert np.array_equal(a.indices, c.indices)
