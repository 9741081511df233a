"""Parity of the PyTorch port's layers (pointstowood_tpu_torch.model) with
the flax modules of the JAX package, on the CPU in fp32.

The flax variables are seeded numpy values in the flax layout; they reach
the port through ``state_dict_from_flax`` (the path real weights take) and
``load_state_dict(strict=True)``. Eval mode: BatchNorm uses its running
statistics. Tolerance: atol 1e-5 (fp32, different summation order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pointstowood_tpu.model import layers as j_layers
from pointstowood_tpu.model.pointconv import PointConv as JPointConv
from pointstowood_tpu_torch.model import layers as t_layers
from pointstowood_tpu_torch.model.network import Net as TNet
from pointstowood_tpu_torch.model.pointconv import PointConv as TPointConv
from pointstowood_tpu_torch.model.pointconv import gather_rows
from pointstowood_tpu_torch.utils.checkpoint_convert import (
    build_key_map,
    state_dict_from_flax,
)


def _randomize(tree, rng, name=""):
    """Seeded numpy values of a flax variable tree's shapes: running
    variances in [0.5, 2], everything else N(0, 0.3^2)."""
    if hasattr(tree, "items"):
        return {k: _randomize(v, rng, k) for k, v in tree.items()}
    if name == "var":
        return rng.uniform(0.5, 2.0, tree.shape).astype(np.float32)
    return (rng.normal(size=tree.shape) * 0.3).astype(np.float32)


def _carry(flax_vars, flax_path, module, prefix):
    """Load flax variables of the module at ``flax_path`` of the Net tree
    into the port's ``module``, whose keys sit under ``prefix`` in the
    Net's state_dict."""
    tree = {}
    for col in ("params", "batch_stats"):
        node = tree.setdefault(col, {})
        parts = flax_path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        if col in flax_vars:
            node[parts[-1]] = flax_vars[col]
    sd = {k[len(prefix):]: v for k, v in state_dict_from_flax(tree).items()
          if k.startswith(prefix)}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _init(module, rng, *args, **kwargs):
    v = module.init(jax.random.key(0), *args, **kwargs)
    return _randomize(jax.tree_util.tree_map(np.asarray, dict(v)), rng)


def test_masked_batchnorm_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 20, 16)).astype(np.float32)
    jm = j_layers.MaskedBatchNorm(16)
    v = _init(jm, rng, x, use_running_average=True)
    ref = np.asarray(jm.apply(v, x, use_running_average=True))
    tm = _carry(v, "norm", t_layers.MaskedBatchNorm(16), "norm.")
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("widths", [(12, 24, 16), (3, 8)])
def test_ref_mlp_matches_flax(widths):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 30, widths[0])).astype(np.float32)
    jm = j_layers.RefMLP(widths)
    v = _init(jm, rng, x, use_running_average=True)
    ref = np.asarray(jm.apply(v, x, use_running_average=True))
    tm = _carry(v, "fp3_module", t_layers.RefMLP(widths), "fp3_module.NN.")
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_inverted_residual_block_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 25, 16)).astype(np.float32)
    jm = j_layers.InvertedResidualBlock(16)
    v = _init(jm, rng, x, use_running_average=True)
    ref = np.asarray(jm.apply(v, x, use_running_average=True))
    tm = _carry(v, "sa1_module/residual_block",
                t_layers.InvertedResidualBlock(16),
                "sa1_module.residual_block.")
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("with_radius", [False, True])
def test_pointconv_matches_flax(with_radius):
    """Gathered features + geometry, the radius cap (SA1), the masked max
    and zeros at centres without a valid neighbour."""
    rng = np.random.default_rng(3)
    b, n, s, k, c = 2, 64, 16, 8, 6
    channels = (c + 4, 12, 16)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    pos4 = np.concatenate([rng.uniform(-1, 1, (b, n, 3)),
                           rng.normal(size=(b, n, 1))], -1).astype(np.float32)
    center_idx = np.stack([rng.permutation(n)[:s] for _ in range(b)])
    center_idx = center_idx.astype(np.int32)
    nbr_idx = rng.integers(0, n, (b, s, k)).astype(np.int32)
    nbr_idx[..., 0] = center_idx  # every centre its own neighbour
    nbr_valid = rng.random((b, s, k)) > 0.3
    nbr_valid[0, 3] = False  # a centre with no valid neighbour
    center_valid = np.ones((b, s), bool)
    center_valid[1, -2:] = False
    radius = (np.full((b, 1, 1), 0.6, np.float32) if with_radius else None)
    args = (x, pos4, center_idx, nbr_idx, nbr_valid, center_valid)
    jm = JPointConv(channels)
    v = _init(jm, rng, *args, radius=radius, use_running_average=True)
    ref = np.asarray(jm.apply(v, *args, radius=radius,
                              use_running_average=True))
    tm = _carry(v, "sa1_module/conv", TPointConv(channels),
                "sa1_module.conv.")
    t_args = [torch.from_numpy(a) for a in args]
    t_args[2], t_args[3] = t_args[2].long(), t_args[3].long()
    with torch.no_grad():
        got = tm(*t_args, radius=None if radius is None
                 else torch.from_numpy(radius)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert (got[0, 3] == 0).all() and (got[1, -2:] == 0).all()


def test_gather_rows_matches_take_along_axis():
    rng = np.random.default_rng(4)
    arr = rng.normal(size=(3, 10, 5)).astype(np.float32)
    idx = rng.integers(0, 10, (3, 4, 2))
    got = gather_rows(torch.from_numpy(arr), torch.from_numpy(idx)).numpy()
    ref = np.stack([arr[i][idx[i]] for i in range(3)])
    np.testing.assert_array_equal(got, ref)


def test_state_dict_keys_match_reference():
    """The port's Net has the reference Net's state_dict keys and shapes
    (the reference layout, rebuilt in tests/reference_oracle.py), and
    every key is reached by the converter's key map."""
    from reference_oracle import OracleNet

    for c in (8, 32):
        ours = TNet(channels=c).state_dict()
        ref = OracleNet(C=c).state_dict()
        assert set(ours) == set(ref)
        assert all(tuple(ours[k].shape) == tuple(ref[k].shape) for k in ref)
    covered = set()
    for tpath, (kind, _) in build_key_map().items():
        leaves = ("weight", "bias")
        if kind == "bn":
            leaves += ("running_mean", "running_var", "num_batches_tracked")
        covered |= {f"{tpath}.{leaf}" for leaf in leaves}
    assert covered == set(TNet(channels=8).state_dict())


def test_reflectance_gate_is_one():
    g = t_layers.ReflectanceGate()
    r = torch.randn(2, 7)
    assert torch.equal(g(r), torch.ones_like(r))


def test_dense_casts_like_flax_bf16():
    """bf16 compute: input, weight and bias cast to bf16, bias added after
    the product, as flax Dense(dtype=bfloat16) does."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 6, 12)).astype(np.float32)
    w = rng.normal(size=(12, 9)).astype(np.float32)
    bias = rng.normal(size=(9,)).astype(np.float32)
    jd = jax.numpy.asarray
    ref = np.asarray(
        (jnp.matmul(jd(x).astype(jnp.bfloat16), jd(w).astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32).astype(jnp.bfloat16)
         + jd(bias).astype(jnp.bfloat16)).astype(jnp.float32))
    got = t_layers.dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                         torch.from_numpy(bias), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-2,
                               atol=1e-2)
