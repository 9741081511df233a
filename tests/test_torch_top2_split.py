"""The host-side decisions and algorithms behind the port's redesigned
selection kernels, on the CPU (the CUDA kernels themselves run only on
the card, where ``chip_smoke.py`` holds them bit for bit against these
plain versions):

* ``knn_topk``'s instance choice (``topk_instance``): every k that
  ``fast_route`` sends to the in-kernel top-k, up to 64, has an instance
  of at least k; a larger k runs in ceil(k / 64) passes of K = 64
  (``topk_plan``), each the 64 smallest keys above the last key of the
  pass before (``select_plain_above``), emulated here and equal to
  ``select_plain(k)`` bit for bit;
* ``knn_top2``'s split-column design, emulated here with numpy: L lanes
  each keep the top-2 of the columns c = lane (mod L) in ascending index
  order; after every column tile but the last the group's pair is shared
  (lane 0 keeps it, the others its second distance under the index
  0xffffffff), and at the end merged by the (d2 bits, index) key over a
  shuffle butterfly; it equals ``select_plain(..., 2)`` bit for bit;
* the host's lane count (``top2_lanes``) is one the kernel is built for,
  and at the canonical shapes the one the card timed fastest;
* ``group_min_plain`` on all-masked groups and non-finite rows, the cases
  that ``group_min``'s masked members as +inf coordinates must keep (and
  why a non-finite row needs the kernel's masked loop);
* ``select_plain`` at k = 64 and 128 against the JAX package's exact kNN.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from pointstowood_tpu.ops import knn as j_knn
from pointstowood_tpu_torch.ops import knn_kernels as kk

CANONICAL_TOP2 = [(8, 16384, 8192), (8, 8192, 4096), (8, 4096, 2048)]
ADVERSARIAL_TOP2 = [(2, n_rows, n_cols) for n_rows in (1, 33)
                    for n_cols in (2560, 3000, 5, 2085)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test processes share the host's cores; a full team of
    intra-op threads per process makes each wait for the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- knn_topk: the instance that serves k --------------------------------


def test_topk_instance_covers_every_routed_k():
    routed = {k for n in (2048, 4096, 8192, 16384) for k in range(1, 65)
              if kk.fast_route(n, k) == "topk"}
    assert {48, 64} <= routed  # Net(k=48), Net(k=64) at the canonical N
    for k in range(1, 65):
        inst = kk.topk_instance(k)
        assert inst >= k and inst in kk._TOPK_INSTANCES
    assert kk.topk_instance(33) == kk.topk_instance(64) == 64


PAST_64 = [65, 128, 512]


@pytest.mark.parametrize("k", PAST_64)
def test_topk_plan_past_64_is_passes_of_the_k64_instance(k):
    assert kk.topk_plan(k) == (64, -(-k // 64))
    assert kk.topk_instance(k) == 64
    # every k the topk route admits (up to 2 x fold = 512) has a plan
    assert kk.fast_route(16384, k) == "topk"
    assert kk.topk_plan(64) == (64, 1) and kk.topk_plan(2) == (2, 1)


def _floor_passes(rows, cols, mask, k):
    """knn_topk's passes past 64 on the plain versions: pass 0 is the
    K = 64 selection, pass r the 64 smallest keys above slot 63 of pass
    r - 1; joined and cut to k."""
    inst, passes = kk.topk_plan(k)
    d, i = kk.select_plain(rows, cols, mask, inst)
    ds, idxs = [d], [i]
    for _ in range(1, passes):
        d, i = kk.select_plain_above(rows, cols, mask, inst, d[..., -1],
                                     i[..., -1])
        ds.append(d)
        idxs.append(i)
    return torch.cat(ds, -1)[..., :k], torch.cat(idxs, -1)[..., :k]


def _pass_cases():
    """Ties across the 63/64 (and 127/128) pass boundary: 3 copies of each
    point at distinct distances from the row, so slots 63-65 hold copies
    of one point; a short row (fewer valid columns than k, the rest
    masked); a NaN row; a fully masked batch."""
    rng = np.random.default_rng(64)
    radii = np.sort(rng.uniform(1, 9, 250))
    dirs = rng.normal(size=(250, 3))
    pts = radii[:, None] * dirs / np.linalg.norm(dirs, axis=1,
                                                  keepdims=True)
    cols = np.repeat(pts, 3, axis=0)[rng.permutation(750)].astype(
        np.float32)
    rows = np.zeros((2, 4, 3), np.float32)
    rows[:, 1:] = rng.normal(size=(2, 3, 3)) * 0.05
    rows[0, 2, 0] = np.nan
    mask = np.ones((2, 750), bool)
    mask[0, rng.permutation(750)[:600]] = False  # 150 valid columns
    mask[1] = False
    mask[1, :3] = True  # a short batch
    return rows, np.stack([cols, cols]), mask


@pytest.mark.parametrize("k", PAST_64)
def test_floor_passes_equal_select_plain(k):
    rows, cols, mask = (torch.from_numpy(a) for a in _pass_cases())
    d_s, i_s = _floor_passes(rows, cols, mask, k)
    d_p, i_p = kk.select_plain(rows, cols, mask, k)
    np.testing.assert_array_equal(d_s.numpy().view(np.uint32),
                                  d_p.numpy().view(np.uint32))
    np.testing.assert_array_equal(i_s.numpy(), i_p.numpy())
    # the row at the origin ties across the pass boundary
    full = kk.select_plain(rows, cols, torch.ones_like(mask), 130)[0]
    assert full[1, 0, 63] == full[1, 0, 64]
    d_f, i_f = _floor_passes(rows, cols, torch.ones_like(mask), k)
    assert torch.equal(d_f, kk.select_plain(rows, cols,
                                            torch.ones_like(mask), k)[0])
    # the NaN row, the short rows' tails and passes past them are empty
    assert torch.isinf(d_s[0, 2]).all() and not i_s[0, 2].any()
    assert torch.isinf(d_s[0, :, 150:]).all()
    assert torch.isinf(d_s[1, :, 3:]).all() and not i_s[1, :, 3:].any()


# --- knn_top2: the split-column design ------------------------------------


def _keys(d, i):
    """(d2 bits << 32) | index as an unsigned 32-bit int, as select.cuh's
    make_key (index -1 is 0xffffffff)."""
    bits = np.ascontiguousarray(d, np.float32).view(np.uint32)
    return ((bits.astype(np.uint64) << np.uint64(32))
            | (i.astype(np.int64) & 0xFFFFFFFF).astype(np.uint64))


def _unkey(k):
    return ((k >> np.uint64(32)).astype(np.uint32).view(np.float32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
            .astype(np.int64))


def _group_top2(d0, i0, d1, i1):
    """The butterfly of __shfl_xor_sync strides L/2 .. 1 over the lanes
    (last axis): of (a0, a1) and (b0, b1) the two smallest keys are
    min(a0, b0) and min(max(a0, b0), min(a1, b1)); every lane ends with
    the group's pair."""
    lanes = d0.shape[-1]
    k0, k1 = _keys(d0, i0), _keys(d1, i1)
    s = lanes // 2
    while s:
        partner = np.arange(lanes) ^ s
        o0, o1 = k0[..., partner], k1[..., partner]
        k0, k1 = np.minimum(k0, o0), np.minimum(np.maximum(k0, o0),
                                                np.minimum(k1, o1))
        s //= 2
    return k0, k1


def _split_top2(rows, cols, mask, lanes, tile):
    """The kernel's algorithm in numpy: a masked column is NaN
    coordinates; in each tile of ``tile`` columns lane l inserts the
    columns c = l (mod L) in ascending order into its pair (d < d1, then
    d < d0: equal distances stay ahead); after every tile but the last
    the group shares its pair: lane 0 keeps it, the others keep its
    second distance in both slots under the index -1 (key index
    0xffffffff, above every real key of that distance); after the last
    tile the group's pair is the result."""
    cols = np.where(mask[..., None], cols, np.nan).astype(np.float32)
    d = kk.pair_d2(torch.from_numpy(rows), torch.from_numpy(cols)).numpy()
    b, n_rows, n_cols = d.shape
    d0 = np.full((b, n_rows, lanes), np.inf, np.float32)
    d1 = d0.copy()
    i0 = np.zeros((b, n_rows, lanes), np.int64)
    i1 = i0.copy()
    for base in range(0, n_cols, tile):
        for lane in range(lanes):
            for c in range(base + lane, min(base + tile, n_cols), lanes):
                dc = d[..., c]
                with np.errstate(invalid="ignore"):
                    lt0, lt1 = dc < d0[..., lane], dc < d1[..., lane]
                d1[..., lane] = np.where(lt0, d0[..., lane],
                                         np.where(lt1, dc, d1[..., lane]))
                i1[..., lane] = np.where(lt0, i0[..., lane],
                                         np.where(lt1, c, i1[..., lane]))
                d0[..., lane] = np.where(lt0, dc, d0[..., lane])
                i0[..., lane] = np.where(lt0, c, i0[..., lane])
        if base + tile < n_cols:  # share
            k0, k1 = _group_top2(d0, i0, d1, i1)
            (g0, j0), (g1, j1) = _unkey(k0), _unkey(k1)
            lead = np.arange(lanes) == 0
            d1, i1 = g1, np.where(lead, j1, -1)
            d0, i0 = np.where(lead, g0, g1), np.where(lead, j0, -1)
    k0, k1 = _group_top2(d0, i0, d1, i1)
    (g0, j0), (g1, j1) = _unkey(k0[..., 0]), _unkey(k1[..., 0])
    return np.stack([g0, g1], -1), np.stack([j0, j1], -1).astype(np.int32)


def _top2_cases():
    rng = np.random.default_rng(7)
    base = rng.integers(-2, 3, size=(12, 3)).astype(np.float32)
    dup = np.repeat(base, 9, axis=0)[rng.permutation(108)]
    rows = rng.integers(-2, 3, size=(2, 17, 3)).astype(np.float32)
    cases = {"ties": (rows, np.stack([dup, dup]), np.ones((2, 108), bool))}
    r = rng.normal(size=(2, 9, 3)).astype(np.float32)
    r[0, 4, 1] = np.nan
    c = rng.normal(size=(2, 70, 3)).astype(np.float32)
    m = rng.random((2, 70)) > 0.3
    m[1] = False
    cases["NaN row, masks, a masked batch"] = (r, c, m)
    desc = np.stack([np.linspace(9, 1, 45), np.zeros(45), np.zeros(45)],
                    1).astype(np.float32)
    cases["descending distances"] = (np.zeros((1, 3, 3), np.float32),
                                     desc[None], np.ones((1, 45), bool))
    for n in (1, 3):
        cases[f"{n} columns"] = (r, c[:, :n], np.ones((2, n), bool))
    cases["zero rows"] = (r[:, :0], c, m)
    return cases


# 512: csrc/knn.cu kTop2Tile (one tile at these sizes); 32 shares the
# group's pair after every 32 columns
@pytest.mark.parametrize("tile", [32, 512])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(_top2_cases()))
def test_split_top2_equals_select_plain(lanes, case, tile):
    rows, cols, mask = _top2_cases()[case]
    d_s, i_s = _split_top2(rows, cols, mask, lanes, tile)
    d_p, i_p = kk.select_plain(*(torch.from_numpy(a)
                                 for a in (rows, cols, mask)), 2)
    np.testing.assert_array_equal(d_s.view(np.uint32),
                                  d_p.numpy().view(np.uint32))
    np.testing.assert_array_equal(i_s, i_p.numpy())


@pytest.mark.parametrize("shape", ADVERSARIAL_TOP2)
def test_top2_lanes_is_a_built_lane_count(shape):
    b, n_rows, _ = shape
    lanes = kk.top2_lanes(b, n_rows)
    assert lanes in kk.TOP2_LANES and 32 % lanes == 0
    assert lanes == kk.TOP2_LANES[-1]  # too few rows for one wave


# by rows: the lane counts that ``chip_smoke.py`` phase ``top2_lanes``
# timed fastest, or within 0.1% of it, on the H100 at SA1T / SA2T / FP3:
# about one wave of 32 resident warps on each of its 132 SMs
MEASURED_LANES = {16384: 2, 8192: 4, 4096: 8}


@pytest.mark.parametrize("shape", CANONICAL_TOP2)
def test_top2_lanes_fill_the_card_at_the_canonical_shapes(shape):
    b, n_rows, _ = shape
    assert kk.top2_lanes(b, n_rows) == MEASURED_LANES[n_rows]


# --- group_min_plain: the cases the kernel's mask handling must keep -------


def _group_min_case():
    rng = np.random.default_rng(3)
    g, n_cols = 2, 256  # one block of 256 columns: npg = 128
    rows = rng.normal(size=(1, 6, 3)).astype(np.float32)
    rows[0, 2, 0] = np.nan
    rows[0, 3, 1] = np.inf
    rows[0, 4, 2] = -np.inf
    cols = rng.normal(size=(1, n_cols, 3)).astype(np.float32)
    mask = rng.random((1, n_cols)) > 0.4
    mask[0, [5, 128 + 5]] = False  # group 5: both members masked
    mask[0, 7], mask[0, 128 + 7] = False, True  # group 7: slot 0 masked
    return rows, cols, mask, g


def _scan(d):
    """Strict '<' scan over the slots: (min, first slot holding it)."""
    m, slot = d[..., 0].copy(), np.zeros(d.shape[:-1], np.uint8)
    for a in range(1, d.shape[-1]):
        with np.errstate(invalid="ignore"):
            upd = d[..., a] < m
        m, slot = np.where(upd, d[..., a], m), np.where(upd, a, slot)
    return m, slot


def test_group_min_plain_all_masked_groups_and_non_finite_rows():
    rows, cols, mask, g = _group_min_case()
    m, s = kk.group_min_plain(*(torch.from_numpy(a)
                                for a in (rows, cols, mask)), g)
    m, s = m.numpy()[0], s.numpy()[0]
    assert np.isinf(m[:, 5]).all() and (s[:, 5] == 0).all()
    # member distances by hand, masked ones +inf, then the strict scan
    with np.errstate(invalid="ignore"):
        diff = rows[0][:, None, :] - cols[0][None, :, :]
        sq = diff * diff
        d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    d = np.where(mask[0], d, np.inf).reshape(6, g, 128).transpose(0, 2, 1)
    m_ref, s_ref = _scan(d)
    np.testing.assert_array_equal(m.view(np.uint32),
                                  m_ref.astype(np.float32).view(np.uint32))
    np.testing.assert_array_equal(s, s_ref)
    # the NaN row: live members NaN, masked ones +inf; slot 0 masked in
    # group 7 keeps +inf there, which no NaN replaces
    assert np.isnan(m[2]).any() and m[2, 7] == np.inf and s[2, 7] == 0
    # +inf / -inf rows: every distance +inf, slot 0
    assert np.isinf(m[3:5]).all() and (s[3:5] == 0).all()


def test_group_min_masked_members_as_inf_coordinates():
    """The kernel's fast loop loads a masked member as +inf coordinates
    and drops the mask: equal to ``group_min_plain`` bit for bit on every
    finite row, and not on a NaN or +inf row (NaN - inf, inf - inf are NaN
    where the plain version has +inf), which therefore take the loop that
    keeps the mask, as every non-finite row does."""
    rows, cols, mask, g = _group_min_case()
    inf_cols = np.where(mask[..., None], cols, np.inf).astype(np.float32)
    ones = np.ones_like(mask)
    m_p, s_p = kk.group_min_plain(*(torch.from_numpy(a)
                                    for a in (rows, cols, mask)), g)
    m_f, s_f = kk.group_min_plain(*(torch.from_numpy(a)
                                    for a in (rows, inf_cols, ones)), g)
    finite = np.isfinite(rows[0]).all(-1)
    np.testing.assert_array_equal(m_f.numpy()[0, finite].view(np.uint32),
                                  m_p.numpy()[0, finite].view(np.uint32))
    np.testing.assert_array_equal(s_f.numpy()[0, finite],
                                  s_p.numpy()[0, finite])
    for r in (2, 3):  # the NaN row and the +inf row
        assert not np.array_equal(m_f.numpy()[0, r], m_p.numpy()[0, r],
                                  equal_nan=True)


# --- select_plain at k = 64 and 128 against the JAX exact kNN ---------------


def test_select_plain_k64_matches_jax_exact_knn():
    rng = np.random.default_rng(11)
    q = rng.normal(size=(40, 3)).astype(np.float32)
    s = (rng.normal(size=(500, 3)) * 2).astype(np.float32)
    smask = rng.random(500) > 0.2
    j_idx, j_d = j_knn._exact_knn(jnp.asarray(q), jnp.asarray(s),
                                  jnp.asarray(smask), 64, 128)
    d_p, i_p = kk.select_plain(*(torch.from_numpy(a[None])
                                 for a in (q, s, smask)), 64)
    j_idx, i_p = np.asarray(j_idx), i_p.numpy()[0]
    d = np.sort(d_p.numpy()[0], axis=1)
    # where the 64th and 65th distances are distinct, both sets agree
    sep = np.sort(np.where(smask, ((q[:, None] - s[None]) ** 2).sum(-1),
                           np.inf), axis=1)
    distinct = (sep[:, 64] - sep[:, 63]) > 1e-4 * (1 + sep[:, 63])
    assert distinct.sum() >= 30
    for r in np.flatnonzero(distinct):
        assert set(j_idx[r].tolist()) == set(i_p[r].tolist())
    np.testing.assert_allclose(d, np.asarray(j_d), rtol=1e-5, atol=1e-5)


def test_select_plain_k128_matches_jax_exact_knn():
    rng = np.random.default_rng(128)
    q = rng.normal(size=(40, 3)).astype(np.float32)
    s = (rng.normal(size=(600, 3)) * 2).astype(np.float32)
    smask = rng.random(600) > 0.2
    j_idx, j_d = j_knn._exact_knn(jnp.asarray(q), jnp.asarray(s),
                                  jnp.asarray(smask), 128, 256)
    d_p, i_p = kk.select_plain(*(torch.from_numpy(a[None])
                                 for a in (q, s, smask)), 128)
    j_idx, i_p = np.asarray(j_idx), i_p.numpy()[0]
    sep = np.sort(np.where(smask, ((q[:, None] - s[None]) ** 2).sum(-1),
                           np.inf), axis=1)
    distinct = (sep[:, 128] - sep[:, 127]) > 1e-4 * (1 + sep[:, 127])
    assert distinct.sum() >= 30
    for r in np.flatnonzero(distinct):
        assert set(j_idx[r].tolist()) == set(i_p[r].tolist())
    np.testing.assert_allclose(np.sort(d_p.numpy()[0], axis=1),
                               np.asarray(j_d), rtol=1e-5, atol=1e-5)
