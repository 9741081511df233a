"""The contract of the port's exact selections, held on their plain
versions (``ops/knn_kernels.select_plain`` for ``knn_topk``/``knn_top2``,
``ops/fusion_kernels.pair_select_plain`` for ``pair_select``; the wrappers
run them for CPU tensors), which the
CUDA kernels of ``csrc/select.cuh`` must equal bit for bit on the card
(``chip_smoke.py`` holds them so, on these cases among others):

* ties go to the lower column (union) index, whatever order the columns
  arrive in: duplicated points, and columns in descending-distance order
  (the order in which every column beats the current k-th);
* a NaN distance counts as +inf: a NaN query row comes back as (+inf, 0)
  in every slot, and a column with a NaN coordinate is never selected;
* slots without a source hold (+inf, 0): masked columns, ``n_cols`` < k,
  a union shorter than k, empty fine or coarse regions, dead queries.

Expected values are written out by hand or computed with numpy's
lexicographic sort over (d2, index), d2 in float32 difference form.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pointstowood_tpu_torch.ops import build
from pointstowood_tpu_torch.ops.fusion_kernels import pair_select
from pointstowood_tpu_torch.ops.knn_kernels import knn_top2, knn_topk

TOPK = [8, 16, 32]
PAIR_K = [32, 64]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test processes share the host's cores; a full team of
    intra-op threads per process makes each wait for the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _d2(q, c):
    """float32 ((dx*dx + dy*dy) + dz*dz), q (R, 3) x c (C, 3) -> (R, C)."""
    diff = q[:, None, :].astype(np.float32) - c[None, :, :].astype(np.float32)
    sq = diff * diff
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _lex_topk(d, k):
    """(d2, idx) of the k smallest keys per row by (d2, index), NaN as
    +inf; non-finite slots (+inf, 0)."""
    d = np.where(np.isnan(d), np.inf, d).astype(np.float32)
    n = d.shape[1]
    out_d = np.full((d.shape[0], k), np.inf, np.float32)
    out_i = np.zeros((d.shape[0], k), np.int32)
    for r in range(d.shape[0]):
        order = np.lexsort((np.arange(n), d[r]))[:k]
        out_d[r, :len(order)] = d[r, order]
        out_i[r, :len(order)] = np.where(np.isfinite(d[r, order]), order, 0)
    return out_d, out_i


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- select_plain (knn_topk, knn_top2)


@pytest.mark.parametrize("k", TOPK)
def test_topk_duplicated_columns_tie_to_the_lower_index(k):
    rng = np.random.default_rng(k)
    base = rng.normal(size=(5, 3)).astype(np.float32)
    cols = np.repeat(base, 20, axis=0)[rng.permutation(100)]  # 5 points x 20
    mask = np.ones(100, bool)
    mask[::7] = False
    rows = base[[0, 3]] + np.float32(0.01)
    d, i = knn_topk(_t(rows)[None], _t(cols)[None], _t(mask)[None], k)
    dm = np.where(mask, _d2(rows, cols), np.inf)
    want_d, want_i = _lex_topk(dm, k)
    np.testing.assert_array_equal(d[0].numpy(), want_d)
    np.testing.assert_array_equal(i[0].numpy(), want_i)
    # within one run of equal distances the indices ascend
    for r in range(2):
        dd, ii = d[0, r].numpy(), i[0, r].numpy()
        same = dd[1:] == dd[:-1]
        assert same.any() and (ii[1:][same] > ii[:-1][same]).all()


@pytest.mark.parametrize("k", TOPK)
def test_topk_descending_distance_order(k):
    n = 3 * k + 5
    x = np.arange(n, 0, -1, dtype=np.float32)  # column c at distance n - c
    cols = np.stack([x, np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    rows = np.zeros((1, 3), np.float32)
    d, i = knn_topk(_t(rows)[None], _t(cols)[None],
                    torch.ones((1, n), dtype=torch.bool), k)
    np.testing.assert_array_equal(i[0, 0].numpy(), np.arange(n - 1, n - 1 - k,
                                                              -1))
    np.testing.assert_array_equal(d[0, 0].numpy(),
                                  np.arange(1, k + 1, dtype=np.float32) ** 2)


@pytest.mark.parametrize("k", TOPK)
def test_topk_grid_ties_match_the_lexicographic_order(k):
    # integer coordinates: many exact distance ties, in shuffled order
    rng = np.random.default_rng(100 + k)
    cols = rng.integers(-3, 4, size=(2, 300, 3)).astype(np.float32)
    rows = rng.integers(-3, 4, size=(2, 33, 3)).astype(np.float32)
    mask = rng.random((2, 300)) < 0.9
    d, i = knn_topk(_t(rows), _t(cols), _t(mask), k)
    for b in range(2):
        dm = np.where(mask[b], _d2(rows[b], cols[b]), np.inf)
        want_d, want_i = _lex_topk(dm, k)
        np.testing.assert_array_equal(d[b].numpy(), want_d)
        np.testing.assert_array_equal(i[b].numpy(), want_i)


@pytest.mark.parametrize("k", TOPK)
def test_topk_nan_rows_and_columns(k):
    rng = np.random.default_rng(200 + k)
    cols = rng.normal(size=(1, 2 * k, 3)).astype(np.float32)
    cols[0, 1, 2] = np.nan  # never selected
    rows = rng.normal(size=(1, 4, 3)).astype(np.float32)
    rows[0, 2, 0] = np.nan  # every slot (+inf, 0)
    d, i = knn_topk(_t(rows), _t(cols), torch.ones((1, 2 * k), dtype=bool),
                    k)
    assert torch.isinf(d[0, 2]).all() and (i[0, 2] == 0).all()
    live = [0, 1, 3]
    assert not (i[0, live] == 1).any()
    want_d, want_i = _lex_topk(_d2(rows[0, live], cols[0]), k)
    np.testing.assert_array_equal(d[0, live].numpy(), want_d)
    np.testing.assert_array_equal(i[0, live].numpy(), want_i)
    # one NaN column leaves 2k - 1: the last slot of a live row is filled
    assert torch.isfinite(d[0, live, -1]).all()


@pytest.mark.parametrize("k", TOPK)
def test_topk_short_and_masked_columns_fill_inf_zero(k):
    rng = np.random.default_rng(300 + k)
    rows = rng.normal(size=(2, 1, 3)).astype(np.float32)
    cols = rng.normal(size=(2, k - 3, 3)).astype(np.float32)
    mask = np.ones((2, k - 3), bool)
    mask[1] = False  # a fully masked batch
    d, i = knn_topk(_t(rows), _t(cols), _t(mask), k)
    assert torch.isfinite(d[0, 0, :k - 3]).all()
    assert torch.isinf(d[0, 0, k - 3:]).all() and (i[0, 0, k - 3:] == 0).all()
    assert torch.isinf(d[1]).all() and (i[1] == 0).all()


def test_top2_ties_and_nan():
    cols = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float32)
    rows = np.array([[0, 0, 0], [np.nan, 0, 0]], np.float32)
    d, i = knn_top2(_t(rows)[None], _t(cols)[None],
                    torch.ones((1, 4), dtype=torch.bool))
    assert i[0, 0].tolist() == [0, 1] and d[0, 0].tolist() == [1.0, 1.0]
    assert torch.isinf(d[0, 1]).all() and i[0, 1].tolist() == [0, 0]


# ---- pair_select_plain


def _pair_case(k, seed):
    """Four entries over one flat source array: entry 0 a fine and a
    coarse region that share duplicated points (fine copies win the
    ties), its query 5 NaN and its last two queries dead; entry 1 an empty
    fine region and q_len = Q; entry 2 an empty coarse region, a union
    shorter than k; entry 3 q_len 0."""
    rng = np.random.default_rng(seed)
    n_q = 8
    fine = rng.integers(-2, 3, size=(3 * k, 3)).astype(np.float32)
    coarse = np.concatenate([fine[::-1][:k], rng.normal(size=(k, 3))])
    src = np.concatenate([fine, coarse]).astype(np.float32)
    pay = rng.integers(0, 1024, size=len(src)).astype(np.int32)
    regions = np.array([[0, 3 * k, 3 * k, 2 * k],
                        [0, 0, 3 * k, 2 * k],
                        [5, k // 2, 0, 0],
                        [0, 3 * k, 3 * k, 2 * k]], np.int32)
    queries = rng.integers(-2, 3, size=(4, n_q, 3)).astype(np.float32)
    queries[0, 5] = np.nan
    q_len = np.array([6, n_q, 3, 0], np.int32)
    return queries, q_len, src, pay, regions


def _pair_want(queries, q_len, src, pay, regions, k):
    n_e, n_q, _ = queries.shape
    out_d = np.full((n_e, n_q, k), np.inf, np.float32)
    out_p = np.zeros((n_e, n_q, k), np.int32)
    for e in range(n_e):
        of, lf, oc, lc = regions[e]
        rows = np.concatenate([np.arange(of, of + lf), np.arange(oc, oc + lc)])
        if not q_len[e] or not len(rows):
            continue
        d, u = _lex_topk(_d2(queries[e, :q_len[e]], src[rows]), k)
        out_d[e, :q_len[e]] = d
        out_p[e, :q_len[e]] = np.where(np.isfinite(d), pay[rows][u], 0)
    return out_d, out_p


@pytest.mark.parametrize("k", PAIR_K)
def test_pair_select_plain_ties_regions_and_nan(k):
    case = _pair_case(k, k)
    d, p = pair_select(*(_t(a) for a in case), k)
    want_d, want_p = _pair_want(*case, k)
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(p.numpy(), want_p)
    assert torch.isinf(d[0, 5]).all() and (p[0, 5] == 0).all()  # NaN query
    assert torch.isinf(d[0, 6:]).all()                            # dead
    assert torch.isfinite(d[1]).all()                             # q_len = Q
    short = k // 2                                                # union < k
    assert torch.isfinite(d[2, :3, :short]).all()
    assert torch.isinf(d[2, :, short:]).all() and (p[2, :, short:] == 0).all()
    assert torch.isinf(d[3]).all() and (p[3] == 0).all()         # q_len 0


@pytest.mark.parametrize("k", PAIR_K)
def test_pair_select_plain_duplicates_take_the_fine_copy(k):
    # every coarse point duplicates a fine point with another payload:
    # each tie goes to the fine copy (the lower union index)
    fine = np.array([[0, 0, 0], [1, 0, 0], [0, 2, 0]], np.float32)
    src = np.concatenate([fine[::-1], fine]).astype(np.float32)
    pay = np.array([1, 2, 3, 10, 20, 30], np.int32)  # fine rows 3-5
    regions = np.array([[3, 3, 0, 3]], np.int32)
    queries = np.zeros((1, 1, 3), np.float32)
    d, p = pair_select(_t(queries), _t(np.array([1], np.int32)), _t(src),
                       _t(pay), _t(regions), k)
    assert p[0, 0, :6].tolist() == [10, 3, 20, 2, 30, 1]
    assert d[0, 0, :6].tolist() == [0, 0, 1, 1, 4, 4]
    assert torch.isinf(d[0, 0, 6:]).all() and (p[0, 0, 6:] == 0).all()


@pytest.mark.parametrize("k", PAIR_K)
def test_pair_select_plain_descending_union(k):
    n = 2 * k + 3
    x = np.arange(n, 0, -1, dtype=np.float32)
    src = np.stack([x, np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    pay = np.arange(n, dtype=np.int32)
    half = n // 2
    regions = np.array([[0, half, half, n - half]], np.int32)
    d, p = pair_select(_t(np.zeros((1, 2, 3), np.float32)),
                       _t(np.array([2], np.int32)), _t(src), _t(pay),
                       _t(regions), k)
    np.testing.assert_array_equal(p[0, 0].numpy(), np.arange(n - 1,
                                                             n - 1 - k, -1))
    assert torch.equal(d[0, 0], d[0, 1]) and torch.equal(p[0, 0], p[0, 1])


# ---- the build


def test_header_edit_rebuilds_both_libraries(tmp_path, monkeypatch):
    """knn.cu and fusion.cu include select.cuh: an edit of the header
    must change both libraries' hashed names, so neither is served from a
    stale build."""
    for path in build.CSRC.glob("*.cu*"):
        shutil.copy(path, tmp_path / path.name)
    assert (tmp_path / "select.cuh").exists()
    for name in ("knn", "fusion"):
        assert '#include "select.cuh"' in (tmp_path / f"{name}.cu").read_text()
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build._target(n).name for n in build.SOURCES}
    head = tmp_path / "select.cuh"
    head.write_text(head.read_text() + "\n// edited\n")
    after = {n: build._target(n).name for n in build.SOURCES}
    assert before["knn"] != after["knn"]
    assert before["fusion"] != after["fusion"]


def test_library_from_another_source_dir(tmp_path):
    """An earlier tree's knn.cu (no header) builds under its own hashed
    name beside the port's libraries, and the port's own name does not
    move."""
    own = build._target("knn")
    (tmp_path / "knn.cu").write_text("// an earlier knn.cu\n")
    other = build._target("knn", tmp_path)
    assert other.parent == own.parent == build.BUILD_DIR
    assert other.name != own.name and other.name.startswith("libknn-")
    assert build._target("knn") == own
