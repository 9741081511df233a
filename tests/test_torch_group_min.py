"""The two-stage fast kNN of the port (``ops/knn_kernels`` ``group_min``,
``member_index``, ``fast_route``; ``ops/knn`` ``knn_masked(method="fast")``)
against the JAX package on the same seeded numpy inputs, on the CPU. The
JAX ``group_min`` runs its Pallas kernel through the interpreter, as the
JAX package's own tests run it; the port runs the kernel's plain version.

Tolerances:

* group minima: the same finite pattern (all-masked groups +inf in both);
  the port's minimum is the true d2 and JAX's the bf16x3 selection value
  ``||s||^2 - 2 q.s`` (the lo*lo product term dropped, 2^-16 relative per
  product) with the slot in its 4 low mantissa bits (<= 15 ulp), so the
  port's d2 - ||q||^2 agrees with it within 2^-14 (||q||^2 + ||s||^2) of
  the winning source s. Measured: <= 2e-5 of that scale;
* winning members: the same source row wherever a group's two best
  members differ by more than 1e-5 relative to that scale (closer pairs
  are ties within the bf16x3 value's error);
* ``member_index``: equal;
* the whole fast kNN at N = 24576 (three blocks of 8192) and 32768 (two
  of 16384), Q = 256, k = 32, a masked stretch of sources: mean per-row
  index-set agreement >= 0.99 (JAX's ``approx_min_k`` is exact on the CPU,
  so the sets differ only at near-ties), d2 within
  1e-6 (||q||^2 + ||s||^2) where the indices agree. Measured agreement
  0.9999-1.0; both methods' recall against cKDTree is printed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from scipy.spatial import cKDTree

from pointstowood_tpu.ops import interpolate as j_interp
from pointstowood_tpu.ops import knn as j_knn
from pointstowood_tpu.ops import pallas_knn as j_pknn
from pointstowood_tpu_torch.model import Net
from pointstowood_tpu_torch.ops import knn as t_knn
from pointstowood_tpu_torch.ops import knn_kernels as t_kkern

SIZES = [4096, 24576, 32768]  # one block; three of 8192; two of 16384


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test processes share the host's cores; a full team of
    intra-op threads per process makes each wait for the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(n, n_q, seed):
    """Normal queries and sources; a stretch of masked sources, and every
    member of groups 0-4 of the first block masked (all-masked groups)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n_q, 3)).astype(np.float32)
    s = rng.normal(size=(n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[n // 3:n // 3 + 700] = False
    g = j_pknn.supported(n, 32)
    npg = t_kkern.n_block(n) // g
    for a in range(g):
        mask[a * npg:a * npg + 5] = False
    return q, s, mask, g


@pytest.mark.parametrize("n", SIZES)
def test_group_min_plain_matches_jax(n):
    q, s, mask, g = _inputs(n, 128 if n > 4096 else 256, n)
    pen = ((s * s).sum(1) + np.where(mask, 0.0, np.inf)).astype(np.float32)
    packed = np.asarray(j_pknn.group_min(jnp.asarray(q), jnp.asarray(s),
                                         jnp.asarray(pen), g))
    j_slot = np.asarray(j_pknn.unpack_slot(jnp.asarray(packed)))
    t_min, t_slot = t_kkern.group_min(torch.from_numpy(q)[None],
                                      torch.from_numpy(s)[None],
                                      torch.from_numpy(mask)[None], g)
    t_min, t_slot = t_min[0].numpy(), t_slot[0].numpy()
    assert t_min.shape == packed.shape == (len(q), n // g)
    assert t_slot.dtype == np.uint8
    fin = np.isfinite(t_min)
    np.testing.assert_array_equal(fin, np.isfinite(packed))
    assert not fin[:, :5].any()  # the all-masked groups
    gidx = np.broadcast_to(np.arange(n // g), t_min.shape)
    t_rows = t_kkern.member_index(torch.from_numpy(gidx.copy()),
                                  torch.from_numpy(t_slot), n, g).numpy()
    j_rows = np.asarray(j_pknn.member_index(jnp.asarray(gidx),
                                            jnp.asarray(j_slot), n, g))
    q2 = (q * q).sum(1)[:, None]
    s2 = (s * s).sum(1)[t_rows]
    err = np.abs((t_min - q2)[fin] - packed[fin])
    scale = (q2 + s2)[fin]
    print(f"n={n}: max |d| / (|q|^2 + |s|^2) = {(err / scale).max():.3g}")
    assert (err <= 2.0 ** -14 * scale).all()

    # the port's slot is the first strict minimum of its own d2; outside
    # near-ties (relative to the scale of JAX's values) the JAX kernel
    # picks the same member
    d = ((q[:, None, :] - s[None]) ** 2).sum(-1)
    d = np.where(mask[None], d, np.inf)
    nb = t_kkern.n_block(n)
    d = d.reshape(len(q), n // nb, g, nb // g)
    best = np.argsort(d, axis=2, kind="stable")[:, :, :2]
    two = np.take_along_axis(d, best, axis=2)
    s2_cols = (s * s).sum(1).reshape(n // nb, g, nb // g)
    s2_two = np.take_along_axis(np.broadcast_to(s2_cols, d.shape), best,
                                axis=2).max(axis=2)
    with np.errstate(invalid="ignore"):  # inf - inf: all-masked groups
        gap = (two[:, :, 1] - two[:, :, 0]) / (q2[:, :, None] + s2_two)
    clear = (gap > 1e-5).reshape(len(q), n // g) & fin
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(t_rows[clear], j_rows[clear])
    # the winning member holds the minimum
    rows_d = np.take_along_axis(d.reshape(len(q), n), t_rows, axis=1)
    np.testing.assert_allclose(rows_d[fin], t_min[fin], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_member_index_matches_jax(n):
    g = j_pknn.supported(n, 32)
    rng = np.random.default_rng(n + 1)
    gidx = rng.integers(0, n // g, (64, 32))
    slot = rng.integers(0, g, (64, 32))
    want = np.asarray(j_pknn.member_index(jnp.asarray(gidx),
                                          jnp.asarray(slot), n, g))
    got = t_kkern.member_index(torch.from_numpy(gidx),
                               torch.from_numpy(slot), n, g)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < n


def _recall(idx, valid, ref):
    return float(np.mean([len(set(i[v]) & set(r)) / len(r)
                          for i, v, r in zip(idx, valid, ref)]))


@pytest.mark.parametrize("n", [24576, 32768])
def test_two_stage_fast_knn_matches_jax(n):
    q, s, mask, _ = _inputs(n, 256, 7 * n)
    k = 32
    assert t_kkern.fast_route(n, k) == "two_stage"
    j_idx, j_d2, j_valid = (np.asarray(a) for a in j_knn.knn_masked(
        jnp.asarray(q), jnp.asarray(s), k, source_mask=jnp.asarray(mask),
        method="fast"))
    t_idx, t_d2, t_valid = (a[0].numpy() for a in t_knn.knn_masked(
        torch.from_numpy(q)[None], torch.from_numpy(s)[None], k,
        source_mask=torch.from_numpy(mask)[None], method="fast"))
    assert t_valid.all() and j_valid.all()
    agree = _recall(t_idx, t_valid, j_idx)
    keep = np.flatnonzero(mask)
    _, ref = cKDTree(s[keep]).query(q, k=k)
    ref = keep[ref]
    print(f"n={n}: index-set agreement {agree:.5f}; recall vs cKDTree: "
          f"port {_recall(t_idx, t_valid, ref):.5f}, "
          f"jax {_recall(j_idx, j_valid, ref):.5f}")
    assert agree >= 0.99
    # ascending, unmasked, and the exact difference-form d2 of each row
    assert (np.diff(t_d2, axis=1) >= 0).all()
    assert mask[t_idx].all()
    dd = torch.from_numpy(q)[:, None, :] - torch.from_numpy(s[t_idx])
    sq = dd * dd
    np.testing.assert_array_equal(
        t_d2, ((sq[..., 0] + sq[..., 1]) + sq[..., 2]).numpy())
    for r in range(len(q)):
        common, ti, ji = np.intersect1d(t_idx[r], j_idx[r],
                                        return_indices=True)
        scale = (q[r] ** 2).sum() + (s[common] ** 2).sum(1)
        assert (np.abs(t_d2[r, ti] - j_d2[r, ji]) <= 1e-6 * scale).all()


@pytest.mark.parametrize("n", [2048, 4096, 9216, 16384, 24576, 32768])
@pytest.mark.parametrize("k", [2, 32])
def test_fast_route_matches_jax_gates(n, k):
    """The JAX _fast_knn's order of gates (knn.py:135-172)."""
    if k == 2 and j_pknn.top2_supported(n):
        want = "top2"
    elif j_pknn.topk_supported(n, k):
        want = "topk"
    elif j_pknn.supported(n, k):
        want = "two_stage"
    else:
        want = "approx"
    assert t_kkern.fast_route(n, k) == want


@pytest.mark.parametrize("n", [24576, 32768])
def test_stage_routes_take_the_gather_route_at_sa1(n):
    """At tiles past 16384 points the JAX Net's SA1 cannot take its
    transpose kernel and searches by gather (the two-stage kNN), SA2/SA3
    take the transpose; the port's routes are the JAX Net's rule
    (network.py:260-292) evaluated with the JAX package's own gates."""
    net = Net(channels=8)
    caps = net.capacities(n)
    src = [n] + caps[:-1]
    want = []
    for i in range(3):
        gather = not j_interp.uses_fused_kernel(src[i], caps[i], 8 * 16, 2,
                                                "fast", 2048)
        want_t = gather or caps[i] > 2048
        if want_t and j_pknn.transpose_supported(caps[i], src[i], 32):
            want.append("transpose")
        else:
            want.append("gather" if gather else "fused")
    assert net.stage_routes(n) == want
    assert want[0] == "gather"
    assert t_kkern.fast_route(src[0], 32) == "two_stage"


def test_group_min_argument_checks_and_no_plain_off_cpu():
    r = torch.zeros((1, 8, 3))
    c = torch.zeros((1, 2048, 3))
    m = torch.ones((1, 2048), dtype=torch.bool)
    with pytest.raises(ValueError, match="g=3"):
        t_kkern.group_min(r, c, m, 3)
    with pytest.raises(ValueError):
        t_kkern.group_min(r, c[:, :1000], m[:, :1000], 8)

    def meta(t):
        return torch.zeros(t.shape, dtype=t.dtype, device="meta")

    with pytest.raises(RuntimeError, match="no kernel"):
        t_kkern.group_min(meta(r), meta(c), meta(m), 8)
