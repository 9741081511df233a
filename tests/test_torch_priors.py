"""The port's geometric priors (pointstowood_tpu_torch.tools.priors, torch)
against the JAX tool (pointstowood_tpu.tools.priors, jitted JAX) on the
CPU: the closed-form eigenvalues against LAPACK at
tests/test_priors_dtm.py's bar, the priors within 1e-4 of JAX's on its
line, plane and blob clouds, and a cloud whose size is not a multiple of
the chunk.

On the line the prior is 1 - e2/e1 with e2 ~ 1e-8 of e1 ~ 5e-4: the
angle's cosine lies within an ulp or two of 1, where arccos turns one
ulp into ~1e-4 of the prior, so 1e-4 holds only because the port rounds
every step up to that cosine as the JAX tool's CPU code does (at k = 16,
the JAX test's k, bit for bit)."""

import numpy as np
import pytest
import torch

from pointstowood_tpu.tools import priors as j_priors
from pointstowood_tpu_torch.predict.fusion import knn_indices
from pointstowood_tpu_torch.tools import priors

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _clouds(rng, n=200):
    """tests/test_priors_dtm.py's three clouds, drawn in its order."""
    line = np.stack([np.linspace(0, 1, n), np.zeros(n), np.zeros(n)], 1)
    line += rng.normal(0, 1e-4, line.shape)
    plane = np.stack(
        [rng.uniform(0, 1, n), rng.uniform(0, 1, n), np.zeros(n)], 1)
    plane += rng.normal(0, 1e-4, plane.shape)
    blob = rng.normal(0, 0.3, size=(n, 3))
    return {"line": line, "plane": plane, "blob": blob}


@pytest.mark.parametrize("seed", [0, 1, 141190])
def test_eigvals_match_lapack(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(50, 3, 3))
    sym = (a + a.transpose(0, 2, 1)) / 2
    ours = priors._eigvals_sym3x3(
        torch.tensor(sym, dtype=torch.float32)).numpy()
    ref = np.linalg.eigvalsh(sym)[:, ::-1]  # descending
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("name", ["line", "plane", "blob"])
def test_priors_match_jax(name, rng):
    cloud = _clouds(rng)[name]
    got = priors.geometric_priors(cloud, k=16, device="cpu")
    want = j_priors.geometric_priors(cloud, k=16)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["plane", "blob"])
def test_priors_match_jax_at_the_default_k(name, rng):
    cloud = _clouds(rng)[name]
    np.testing.assert_allclose(
        priors.geometric_priors(cloud, device="cpu"),
        j_priors.geometric_priors(cloud), rtol=0, atol=TOL)


def test_priors_order_line_plane_blob(rng):
    """tests/test_priors_dtm.py's ordering, on the port."""
    pr = {k: priors.geometric_priors(c, k=16, device="cpu")
          for k, c in _clouds(rng).items()}
    assert pr["line"].mean() > 0.95
    assert pr["line"].mean() > pr["plane"].mean() > pr["blob"].mean()
    assert all(np.isfinite(p).all() for p in pr.values())
    assert 0.0 <= pr["blob"].min() and pr["line"].max() <= 1.0 + 1e-5


def test_chunks_not_dividing_the_cloud(rng):
    """203 points in chunks of 64: the JAX tool pads its last chunk with
    zeros and drops those rows; the port computes each row alone, so any
    chunking gives the same bits, and the JAX result within 1e-4."""
    cloud = np.concatenate([_clouds(rng)["blob"],
                            rng.normal(0, 0.1, (3, 3))])
    idx = knn_indices(cloud, cloud, 16)
    whole = priors.geometric_priors(cloud, k=16, indices=idx, device="cpu")
    parts = priors.geometric_priors(cloud, k=16, chunk=64, indices=idx,
                                    device="cpu")
    assert np.array_equal(whole, parts)
    want = j_priors.geometric_priors(cloud, k=16, chunk=64, indices=idx)
    np.testing.assert_allclose(parts, want, rtol=0, atol=TOL)


def test_priors_cli_adds_the_column(tmp_path, monkeypatch):
    from pointstowood_tpu_torch.io import read_ply, write_ply

    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(100, 3))
    write_ply(str(tmp_path / "c.ply"), {"x": xyz[:, 0], "y": xyz[:, 1],
                                        "z": xyz[:, 2], "label": np.ones(100)})
    priors.main([str(tmp_path / "c.ply"), "--k", "8"], device="cpu")
    out = read_ply(str(tmp_path / "c_prior.ply"))
    assert list(out) == ["x", "y", "z", "label", "prior"]
    assert np.array_equal(out["prior"].astype(np.float32),
                          priors.geometric_priors(xyz, k=8, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        priors.main([str(tmp_path / "c.ply")])
