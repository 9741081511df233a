"""Whole-network parity of the PyTorch port (pointstowood_tpu_torch) with
the JAX package's flax ``Net`` and ``run_inference``, on the CPU.

One set of seeded numpy weights in the flax layout drives both packages;
the port receives it through ``state_dict_from_flax``.

* fp32 + exact kNN + "last" voxel representatives (the setup of
  test_full_net_parity.py): sigmoid probabilities within 1e-4 of flax's.
* fast config (B=2, N=2048, C=8, fp32, "hash" voxels; SA1 takes the
  transpose route): the port's selection is exact where the JAX kernels
  are approximate, so the bars are mean |delta p| <= 0.01 and label
  agreement >= 99% over points whose JAX probability lies outside
  0.5 +- 0.02.
* ``run_inference`` on synthetic tiles: identical xyz rows in identical
  order, with the fast config's bars.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pointstowood_tpu import config as j_config
from pointstowood_tpu.data.tiling import Tile as JTile
from pointstowood_tpu.model import Net as JNet
from pointstowood_tpu.predict import predicter as j_predicter
from pointstowood_tpu_torch import config as t_config
from pointstowood_tpu_torch.data.tiling import Tile as TTile
from pointstowood_tpu_torch.model import Net as TNet
from pointstowood_tpu_torch.predict import predicter as t_predicter
from pointstowood_tpu_torch.utils.checkpoint_convert import (
    build_key_map,
    state_dict_from_flax,
)

C = 8


def _flax_variables(tnet, seed):
    """Seeded numpy weights in the flax Net's variable layout, shaped from
    the port's modules: N(0, 0.2^2) values, running variances in
    [0.5, 2]."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in tnet.state_dict().items()}
    params, stats = {}, {}

    def put(tree, path, **leaves):
        node = tree
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node.update(leaves)

    def normal(shape):
        return (rng.normal(size=shape) * 0.2).astype(np.float32)

    for tpath, (kind, fpath) in build_key_map().items():
        w = shapes[f"{tpath}.weight"]
        if kind in ("linear", "conv1d"):
            put(params, fpath, kernel=normal((w[1], w[0])), bias=normal(w[0]))
        elif kind == "depthwise":
            put(params, fpath, dw_scale=normal(w[0]), dw_bias=normal(w[0]))
        else:
            put(params, fpath, scale=normal(w), bias=normal(w))
            put(stats, fpath, mean=normal(w),
                var=rng.uniform(0.5, 2.0, w).astype(np.float32))
    return {"params": params, "batch_stats": stats}


def _port(tnet, variables):
    tnet.load_state_dict(state_dict_from_flax(variables), strict=True)
    return tnet.eval()


@functools.partial(jax.jit, static_argnums=0)
def _jax_probs(net, variables, pos, refl, mask, sf):
    return jax.nn.sigmoid(net.apply(variables, pos, refl, mask, sf,
                                    training=False))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------- fp32 + exact (parity path)


def _sparse_cloud(seed, n=512):
    """test_full_net_parity.py's tile: 0.6 m extent, ~5 points per SA1
    radius ball."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 0.6, size=(n, 3)).astype(np.float32)
    xyz -= xyz.mean(axis=0)
    refl = rng.normal(size=n).astype(np.float32)
    sf = np.float32(np.linalg.norm(xyz, axis=1).max())
    return xyz[None], refl[None], np.ones((1, n), bool), np.array([sf])


@pytest.mark.parametrize("seed", [3, 17, 141190])
def test_exact_net_matches_flax(seed):
    kw = dict(channels=C, k=32, knn_method="exact", voxel_priority="last",
              stage_fractions=(1.0, 1.0, 1.0))
    tnet = TNet(**kw)
    variables = _flax_variables(tnet, seed)
    _port(tnet, variables)
    inputs = _sparse_cloud(seed)
    ref = np.asarray(_jax_probs(JNet(**kw, dtype=jnp.float32), variables,
                                *inputs))
    got = t_predicter.forward_probs(tnet, *_t(*inputs)).numpy()
    assert np.abs(got - ref).max() < 1e-4


def test_port_loads_reference_state_dict_and_matches_oracle():
    """A reference-layout state_dict (tests/reference_oracle.OracleNet, the
    reference Net rebuilt in plain torch) loads into the port with
    load_state_dict, and the port's fp32 exact forward matches the
    oracle's probabilities within 1e-4."""
    from reference_oracle import OracleNet

    seed = 3
    om = OracleNet(C=C, k=32).eval()
    grng = np.random.default_rng(seed + 1000)
    sd = om.state_dict()
    for key, v in sd.items():
        if key.endswith("running_var"):
            sd[key] = torch.tensor(
                grng.uniform(0.5, 2.0, size=v.shape).astype(np.float32))
        elif not key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(
                (grng.normal(size=v.shape) * 0.2).astype(np.float32))
    om.load_state_dict(sd)
    tnet = TNet(channels=C, k=32, knn_method="exact", voxel_priority="last",
                stage_fractions=(1.0, 1.0, 1.0)).eval()
    tnet.load_state_dict(om.state_dict(), strict=True)
    pos, refl, mask, sf = _t(*_sparse_cloud(seed))
    with torch.no_grad():
        ref = torch.sigmoid(om(pos[0], refl[0], sf[0])).numpy()
    got = t_predicter.forward_probs(tnet, pos, refl, mask, sf)[0].numpy()
    assert np.abs(got - ref).max() < 1e-4


# --------------------------------------------------------------- fast path


def _tree_tile(rng, n, extent=1.6):
    """A small trunk + crown tree, float32 [x, y, z, reflectance]."""
    n_trunk = n // 3
    theta = rng.uniform(0, 2 * np.pi, n_trunk)
    r = rng.uniform(0, 0.06, n_trunk)
    trunk = np.stack([r * np.cos(theta), r * np.sin(theta),
                      rng.uniform(0, extent, n_trunk)], 1)
    crown = rng.normal(0, [0.3, 0.3, 0.2], (n - n_trunk, 3))
    crown[:, 2] += 0.75 * extent
    xyz = np.clip(np.concatenate([trunk, crown]), -extent / 2, extent)
    refl = np.concatenate([rng.normal(2, 0.3, n_trunk),
                           rng.normal(-1, 0.5, n - n_trunk)])
    pts = np.concatenate([xyz, refl[:, None]], 1).astype(np.float32)
    return pts[rng.permutation(n)]


_FAST = dict(channels=C, k=32, knn_method="fast", voxel_priority="hash")


def _fast_bars(p_port, p_jax):
    mean_dp = float(np.abs(p_port - p_jax).mean())
    sure = np.abs(p_jax - 0.5) > 0.02
    agree = float(((p_port >= 0.5) == (p_jax >= 0.5))[sure].mean())
    assert mean_dp <= 0.01, mean_dp
    assert agree >= 0.99, agree
    return mean_dp, agree


def test_fast_net_matches_jax_fast():
    """B=2 tiles of 2048 and 1900 points. Measured on the CPU: mean
    |delta p| 1.6e-5, max 8.8e-4, label agreement 1.0. With these random
    weights every probability lies in [0.408, 0.415], so the label bar
    sees one class; the probability bar carries the check."""
    from pointstowood_tpu_torch.data.dataset import pad_tiles

    rng = np.random.default_rng(23)
    batch = pad_tiles([_tree_tile(rng, 2048), _tree_tile(rng, 1900)], 2048)
    inputs = (batch.pos, batch.reflectance, batch.mask, batch.sf)
    tnet = TNet(**_FAST)
    assert tnet.stage_routes(2048) == ["transpose", "gather", "gather"]
    variables = _flax_variables(tnet, 5)
    _port(tnet, variables)
    jnet = JNet(**_FAST, transpose_knn=True, dtype=jnp.float32)
    ref = np.asarray(j_predicter._forward(jnet, variables, *inputs))
    got = t_predicter.forward_probs(tnet, *_t(*inputs)).numpy()
    m = batch.mask
    _fast_bars(got[m], ref[m])


def test_run_inference_matches_jax():
    """Five tiles of 1500-2048 points, batch size 2: three padded
    (2, 2048) batches, the last with an all-padding row. Measured on the
    CPU: mean |delta p| 2.8e-6, max 4.3e-4, label agreement 1.0."""
    rng = np.random.default_rng(29)
    pts = [_tree_tile(rng, n) + np.float32([10 * i, 5, 0, 0])
           for i, n in enumerate((2048, 1500, 1800, 2000, 1650))]
    tiling = dict(grid_size=(4.0,), min_pts=64, max_pts=2048)
    tnet = TNet(**_FAST)
    variables = _flax_variables(tnet, 6)
    _port(tnet, variables)
    jnet = JNet(**_FAST, transpose_knn=True, dtype=jnp.float32)
    ref = j_predicter.run_inference(
        [JTile(points=p, grid_size=4.0) for p in pts], variables, jnet,
        j_config.PredictConfig(batch_size=2), j_config.TilingConfig(**tiling))
    got = t_predicter.run_inference(
        [TTile(points=p, grid_size=4.0) for p in pts], tnet,
        t_config.PredictConfig(batch_size=2), t_config.TilingConfig(**tiling),
        device="cpu")
    assert got.shape == ref.shape == (sum(len(p) for p in pts), 5)
    np.testing.assert_array_equal(got[:, :3], ref[:, :3])
    np.testing.assert_array_equal(got[:, 3], (got[:, 4] >= 0.5))
    _fast_bars(got[:, 4], ref[:, 4])


@pytest.mark.parametrize("n,method,transpose,routes", [
    (16384, "fast", True, ["transpose", "transpose", "fused"]),
    (6144, "fast", True, ["transpose", "transpose", "gather"]),
    (2048, "fast", True, ["transpose", "gather", "gather"]),
    (16384, "fast", False, ["gather", "gather", "fused"]),
    (16384, "exact", True, ["gather", "gather", "gather"]),
])
def test_stage_routes_follow_the_jax_rule(n, method, transpose, routes):
    """Routes of the JAX Net's rule (network.py: want the transpose where
    the FP stage gathers or has > 2048 sources; take it where
    transpose_supported admits the SA shape; fused where
    uses_fused_kernel holds), worked out by hand at C=32."""
    net = TNet(channels=32, knn_method=method, transpose_knn=transpose)
    assert net.stage_routes(n) == routes
