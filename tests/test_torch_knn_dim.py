"""The D-dimensional selection of the PyTorch port (``knn_topk_dim``'s plain
version, ``select_plain_dim``), on the CPU, without JAX.

* At D = 3 it is ``select_plain`` bit for bit (``pair_d2_dim`` is
  ``pair_d2``'s float there), ties, NaN rows and masks included.
* At D = 71 and 135 (``ATSearchKNN``'s SA2 and SA3 widths at C = 8) its
  sets equal the port's exact route (``knn_masked(method="exact")``, the
  expansion form) except at near-ties: a pair whose two d2 differ by less
  than 1e-6 of the row's k-th d2.
* Its contract: ties to the lower column, a NaN distance as +inf, masked
  columns never selected, empty slots (+inf, 0).
* Past k = 64 the kernel runs passes of K = 64 above the last key of the
  pass before: ``select_plain_dim_above`` chained so equals
  ``select_plain_dim`` at k = 128 bit for bit.
* ``knn_masked(method="fast")`` takes ``knn_topk_dim`` for D != 3 at
  every shape, and keeps its 3-dim routes.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pointstowood_tpu_torch.ops import knn as t_knn
from pointstowood_tpu_torch.ops import knn_kernels as kk


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test processes share the host's cores (see
    test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _points(seed, b, n_rows, n_cols, d, dup=False):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(b, n_rows, d)).astype(np.float32)
    cols = rng.normal(size=(b, n_cols, d)).astype(np.float32)
    if dup:
        # exact ties: every column twice, a row on a column
        cols[:, n_cols // 2:] = cols[:, :n_cols - n_cols // 2]
        rows[:, 0] = cols[:, 3]
    mask = rng.random((b, n_cols)) < 0.8
    return torch.from_numpy(rows), torch.from_numpy(cols), \
        torch.from_numpy(mask)


def test_pair_d2_dim_is_a_left_to_right_sum():
    """acc = diff_0^2, then acc + diff_d^2 in ascending d, each rounded to
    fp32 (numpy float32 does the same sum here)."""
    r, c, _ = _points(0, 2, 5, 7, 13)
    got = kk.pair_d2_dim(r, c).numpy()
    diff = r.numpy()[:, :, None, :] - c.numpy()[:, None, :, :]
    want = diff[..., 0] * diff[..., 0]
    for a in range(1, 13):
        want = (want + diff[..., a] * diff[..., a]).astype(np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 8, 32, 40])
def test_select_plain_dim_is_select_plain_at_d3(k):
    r, c, m = _points(1, 2, 33, 100, 3, dup=True)
    r[1, 5] = math.nan
    m[1] = False if k == 40 else m[1]
    d_a, i_a = kk.select_plain_dim(r, c, m, k)
    d_b, i_b = kk.select_plain(r, c, m, k)
    assert torch.equal(d_a, d_b) and torch.equal(i_a, i_b)
    torch.testing.assert_close(kk.pair_d2_dim(r, c), kk.pair_d2(r, c),
                               rtol=0, atol=0, equal_nan=True)


def _near_tie_equal(idx_a, idx_b, d2_rows, valid, k, rel=1e-6):
    """Per row: the two index sets are equal, or every index in one and
    not the other has a d2 within rel * (k-th d2) of the k-th d2
    (d2_rows: (R, C) float64 distances)."""
    for q in range(idx_a.shape[0]):
        a = set(idx_a[q][valid[q]].tolist())
        b = set(idx_b[q][valid[q]].tolist())
        if a == b:
            continue
        kth = np.sort(d2_rows[q])[min(k, d2_rows.shape[1]) - 1]
        for j in a ^ b:
            assert abs(d2_rows[q, j] - kth) <= rel * kth, (q, j)


@pytest.mark.parametrize("d", [71, 135])
def test_select_plain_dim_matches_the_exact_route(d):
    """The C = 8 embedding widths of SA2 (3 + 2 * 18 + 32) and SA3
    (3 + 2 * 34 + 64), k = 32, standardised coordinates as ATSearchKNN
    makes them."""
    k = 32
    r, c, m = _points(2 + d, 2, 48, 300, d)
    d2, idx = kk.select_plain_dim(r, c, m, k)
    e_idx, e_d2, e_valid = t_knn.knn_masked(r, c, k, source_mask=m,
                                            method="exact")
    valid = torch.isfinite(d2)
    assert torch.equal(valid, e_valid)
    # the selected distances agree within the expansion form's rounding
    np.testing.assert_allclose(d2.numpy(), e_d2.numpy(), rtol=2e-5,
                               atol=1e-4)
    r64, c64 = r.double().numpy(), c.double().numpy()
    for bi in range(2):
        d2_rows = ((r64[bi][:, None] - c64[bi][None]) ** 2).sum(-1)
        d2_rows[:, ~m[bi].numpy()] = np.inf
        _near_tie_equal(idx[bi].numpy(), e_idx[bi].numpy(), d2_rows,
                        valid[bi].numpy(), k)


def test_select_plain_dim_contract():
    """Masked columns never selected, a NaN row gives only empty slots,
    fewer valid columns than k leave (+inf, 0) slots, a NaN column
    coordinate is never selected, and equal distances go to the lower
    column."""
    r, c, m = _points(3, 2, 6, 40, 9, dup=True)
    r[0, 2] = math.nan
    c[1, 7, 4] = math.nan
    m[1, 20:] = False
    d2, idx = kk.select_plain_dim(r, c, m, 30)
    assert torch.isinf(d2[0, 2]).all() and (idx[0, 2] == 0).all()
    assert not bool((idx[1] == 7).any())
    live = torch.isfinite(d2)
    for bi in range(2):
        assert bool(m[bi][idx[bi].long()][live[bi]].all())
    assert (idx[~live] == 0).all()
    assert int(live[1, 0].sum()) == int(m[1].sum()) - int(m[1, 7])
    # ties: duplicated columns j and j + 20 have equal d2; the lower
    # comes first
    d = d2[0, 0].numpy()
    i = idx[0, 0].numpy()
    for s in range(len(d) - 1):
        if d[s] == d[s + 1] and np.isfinite(d[s]):
            assert i[s] < i[s + 1]


def test_dim_passes_past_64_join_into_the_top_128():
    """Pass 2 selects the 64 nearest keys above pass 1's key in slot 63,
    as ptw_knn_topk_dim's second launch does; joined they are the top
    128, across exact ties at the passes' boundary."""
    r, c, m = _points(4, 2, 9, 300, 23, dup=True)
    assert kk.topk_plan(128) == (64, 2)
    d1, i1 = kk.select_plain_dim(r, c, m, 64)
    d2, i2 = kk.select_plain_dim_above(r, c, m, 64, d1[..., -1], i1[..., -1])
    d_all, i_all = kk.select_plain_dim(r, c, m, 128)
    assert torch.equal(torch.cat([d1, d2], -1), d_all)
    assert torch.equal(torch.cat([i1, i2], -1), i_all)
    # a floor at the empty slot gives an empty pass
    d3, i3 = kk.select_plain_dim_above(
        r, c, m, 64, torch.full_like(d1[..., -1], math.inf),
        torch.zeros_like(i1[..., -1]))
    assert torch.isinf(d3).all() and (i3 == 0).all()


@pytest.mark.parametrize("d,n", [(7, 300), (7, 4096), (3, 300)])
def test_knn_masked_fast_routes_by_dimension(d, n, monkeypatch):
    """D != 3: knn_topk_dim at every shape (here 300 columns, no JAX
    kernel's gate; and 4096, which the 3-dim routes send to the in-kernel
    top-k); D = 3 keeps the 3-dim routes."""
    calls = []
    for name in ("knn_topk_dim", "knn_topk", "knn_top2", "group_min"):
        fn = getattr(t_knn, name)
        monkeypatch.setattr(
            t_knn, name,
            lambda *a, _fn=fn, _name=name, **kw: calls.append(_name)
            or _fn(*a, **kw))
    r, c, m = _points(5, 1, 17, n, d)
    qm = torch.ones((1, 17), dtype=torch.bool)
    qm[0, 3] = False
    idx, d2, valid = t_knn.knn_masked(r, c, 16, qm, m, method="fast")
    assert calls == (["knn_topk_dim"] if d != 3 else ["knn_topk"])
    want_d, want_i = kk.select_plain_dim(r, c, m, 16)
    want_v = torch.isfinite(want_d) & qm[..., None]
    assert torch.equal(valid, want_v)
    assert torch.equal(idx, torch.where(want_v, want_i.long(), 0))
    assert torch.equal(d2, torch.where(want_v, want_d, math.inf))


def test_knn_topk_dim_checks_its_inputs():
    r, c, m = _points(6, 1, 4, 10, 5)
    with pytest.raises(ValueError):
        kk.knn_topk_dim(r, c[..., :4], m, 2)
    with pytest.raises(TypeError):
        kk.knn_topk_dim(r.double(), c.double(), m, 2)
    d2, idx = kk.knn_topk_dim(r, c, m, 3)
    assert d2.shape == idx.shape == (1, 4, 3) and idx.dtype == torch.int32
