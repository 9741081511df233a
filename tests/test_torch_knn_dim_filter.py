"""The certificate of ``knn_topk_dim``'s tensor-core filter, held on its
plain arithmetic (``knn_kernels.filter_plain``), on the CPU, without JAX.

The kernel (csrc/knn_dim.cu) bounds each pair's ``pair_d2_dim`` p from
above by U and from below by L, out of TF32 products summed in an
unspecified order, takes tau, an upper bound on each row's K-th smallest
p, from U, and rescores exactly only the columns with !(L > tau). The
plain version rounds to TF32 on the fp32 bits, sums the products (and the
squared norms) in fp32 in shuffled orders, and forms U and L with the
kernel's formula and directed roundings. On every case of
``chip_smoke.filter_cases`` at 8 rows and 2048 columns (D = 263 and 519:
a standardised embedding, an offset of 1e4, magnitudes of 1e19-1e20,
subnormal coordinates, exact duplicates tied at the k-th place, NaN and
masked columns; 16 tiles, so that the sweep lists columns under its
running threshold as well as on its last visits):

1. (1 + g) U >= p >= (1 - g) L wherever a bound is not NaN
   (``filter_p_bounds``; the kernel keeps U and L without the factors),
   and a pair whose p is NaN or +inf never counts toward tau (its U is
   NaN or +inf);
2. every column of ``select_plain_dim``'s top-k survives, and the
   kernel's single sweep (``filter_candidates_plain``: a running
   threshold after 8 priming tiles) lists every survivor;
3. the selection over the survivors is ``select_plain_dim``'s, bit for
   bit.

The card's kernel is held to ``select_plain_dim`` on the same cases by
``chip_smoke.py`` (phase ``attention``).
"""

import math
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke
from pointstowood_tpu_torch.ops import knn_kernels as kk

CASES = chip_smoke.filter_cases(20261017, n_rows=8, n_cols=(2048,))
FLT_MAX = float(np.finfo(np.float32).max)
NAMES = [c[0] for c in CASES]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test processes share the host's cores (see
    test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(name):
    _, r, c, m, k = CASES[NAMES.index(name)]
    return torch.from_numpy(r), torch.from_numpy(c), torch.from_numpy(m), k


def _select_rows(r, c, keep, k):
    """``select_plain_dim`` with a column mask of each row's own."""
    outs = [kk.select_plain_dim(r[:, i:i + 1], c, keep[:, i], k)
            for i in range(r.shape[1])]
    return (torch.cat([o[0] for o in outs], 1),
            torch.cat([o[1] for o in outs], 1))


@pytest.mark.parametrize("name", NAMES[:-1])
def test_certificate(name):
    r, c, m, k = _case(name)
    u, lo, tau, surv = kk.filter_plain(r, c, m, k, seed=NAMES.index(name))
    p = kk.pair_d2_dim(r, c)
    real = ~torch.isnan(p)
    up, down = kk.filter_p_bounds(u, lo, r.shape[-1])
    assert bool(((up >= p) | torch.isnan(up) | ~real).all())
    assert bool(((down <= p) | torch.isnan(down) | ~real).all())
    never = torch.isnan(p) | (p == math.inf)
    assert bool((torch.isnan(u) | (u == math.inf))[never].all())
    if name.startswith("standardised"):
        assert bool(torch.isfinite(u).all() and torch.isfinite(lo).all())
        # the window is narrow: far fewer survivors than columns
        assert float(surv.sum(-1).float().mean()) < 0.5 * c.shape[1]
    # tau bounds each row's k-th smallest p
    d_p, i_p = kk.select_plain_dim(r, c, m, k)
    tau_p = kk.filter_p_bounds(tau, tau, r.shape[-1])[0]
    assert bool((d_p[..., -1] <= tau_p).all())
    # every selected column survives, and only valid columns survive
    hit = torch.isfinite(d_p)
    assert bool(torch.gather(surv, 2, i_p.long())[hit].all())
    assert not bool((surv & ~m[:, None, :]).any())
    d_s, i_s = _select_rows(r, c, surv, k)
    assert torch.equal(d_s, d_p) and torch.equal(i_s, i_p)
    # the single sweep lists every survivor
    listed = kk.filter_candidates_plain(u, lo, m, k, r.shape[-1])
    assert not bool((surv & ~listed).any())
    assert not bool((listed & ~m[:, None, :]).any())


def test_more_duplicates_than_candidates_overflow():
    """The case built to overflow the candidate list: row 0 of each batch
    keeps more than DIM_CANDIDATES survivors (the kernel's exhaustive
    rows), the others fewer; the selection over survivors stays exact."""
    name = NAMES[-1]
    r, c, m, k = _case(name)
    _, _, _, surv = kk.filter_plain(r, c, m, k)
    counts = surv.sum(-1)
    assert bool((counts[:, 0] > kk.DIM_CANDIDATES).all())
    assert bool((counts[:, 1:] <= kk.DIM_CANDIDATES).all())
    d_k, i_k, stats = kk.knn_topk_dim_survivors(r, c, m, k)
    assert stats["over_capacity"] == 2 and stats["rows"] == 16
    assert stats["candidates_max"] >= int(counts.max())
    assert stats["max"] == int(counts[:, 1:].max())
    d_s, i_s = _select_rows(r, c, surv, k)
    d_p, i_p = kk.select_plain_dim(r, c, m, k)
    assert torch.equal(d_s, d_p) and torch.equal(i_s, i_p)
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)


@pytest.mark.parametrize("k", [2, 8, 16, 48, 64])
def test_certificate_at_every_instance(k):
    """tau at K = 2-64 (KL = 1, 2, 4, 8, 8 a lane) still holds the top-k,
    also at k = 48 (the K = 64 instance keeps 48 slots)."""
    r, c, m, _ = _case("duplicates tied at the k-th place D=263 C=2048")
    u, lo, tau, surv = kk.filter_plain(r, c, m, k)
    d_p, i_p = kk.select_plain_dim(r, c, m, k)
    assert bool((d_p[..., -1] <= kk.filter_p_bounds(tau, tau, 263)[0]).all())
    assert not bool((surv & ~kk.filter_candidates_plain(
        u, lo, m, k, 263)).any())
    d_s, i_s = _select_rows(r, c, surv, k)
    assert torch.equal(d_s, d_p) and torch.equal(i_s, i_p)


def test_tau_is_the_kth_of_the_lane_groups_lists():
    """Column c lies on lane group (c % 128 // 64, c % 8 // 2); with U = c
    at K = 32 each group keeps its 8 smallest, and tau is the 32nd
    smallest of the 64 kept; a masked column or a NaN / negative U never
    counts; fewer than K kept finite values give +inf."""
    n = 256
    u = torch.arange(n, dtype=torch.float32).view(1, 1, n)
    m = torch.ones(1, n, dtype=torch.bool)
    groups = (torch.arange(n) % 128 // 64) * 4 + torch.arange(n) % 8 // 2

    def want(valid, k=32):
        kept = []
        for g_ in range(8):
            cols = [c for c in range(n) if groups[c] == g_ and valid[c]]
            kept += cols[:8]
        return sorted(kept)[k - 1]
    assert float(kk.filter_tau_plain(u, m, 32)) == want([True] * n)
    # at K = 64 the 64 kept are all there is: tau is the largest
    assert float(kk.filter_tau_plain(u, m, 64)) == want([True] * n, 64)
    assert want([True] * n, 64) == 95
    m2 = m.clone()
    m2[0, 5] = False
    u2 = u.clone()
    u2[0, 0, 0] = math.nan
    u2[0, 0, 1] = -1.0
    valid = [c not in (0, 1, 5) for c in range(n)]
    assert float(kk.filter_tau_plain(u2, m2, 32)) == want(valid)
    assert float(kk.filter_tau_plain(u[..., :20], m[:, :20], 32)) == math.inf


def test_tf32_round_is_cvt_rna():
    """Round to nearest at the 13 dropped bits, ties away from zero, a
    carry into the exponent (up to +-inf), non-finite values kept."""
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -12, 1 + 2 ** -12,
                      -(1 + 2 ** -11), 2 - 2 ** -23, FLT_MAX, -FLT_MAX,
                      1e-40, math.inf, -math.inf], dtype=torch.float32)
    got = kk.tf32_round(x).tolist()
    assert got[:8] == [1.0, 1 + 2 ** -10, 1 + 2 ** -10, 1.0,
                       -(1 + 2 ** -10), 2.0, math.inf, -math.inf]
    assert got[8] == float(np.float32(1e-40)
                           .view(np.uint32).__add__(0x1000)
                           .__and__(0xFFFFE000).view(np.float32))
    assert got[9:] == [math.inf, -math.inf]
    assert math.isnan(float(kk.tf32_round(torch.tensor([math.nan]))))
    bits = kk.tf32_round(torch.randn(1000)).view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())


def test_directed_roundings_bracket_the_exact_value():
    """_add / _mul / _fma / _div_up / _sqrt_up round the exact result up
    or down to the adjacent fp32 (checked with fractions), across
    magnitudes from subnormal to near overflow."""
    rng = np.random.default_rng(5)
    a = (rng.normal(size=300) * 10.0 ** rng.integers(-44, 38, 300))
    b = (rng.normal(size=300) * 10.0 ** rng.integers(-44, 38, 300))
    a = torch.from_numpy(a.astype(np.float32))
    b = torch.from_numpy(b.astype(np.float32))
    up = torch.tensor(math.inf)
    down = torch.tensor(-math.inf)

    def brackets(got_up, got_dn, exact):
        for gu, gd, ex in zip(got_up.tolist(), got_dn.tolist(), exact):
            if math.isinf(gu) or math.isinf(gd):
                continue
            assert Fraction(gd) <= ex <= Fraction(gu)
            assert gu == gd or float(torch.nextafter(
                torch.tensor(gd), up)) == gu
    fa = [Fraction(v) for v in a.tolist()]
    fb = [Fraction(v) for v in b.tolist()]
    brackets(kk._add(a, b, True), kk._add(a, b, False),
             [x + y for x, y in zip(fa, fb)])
    brackets(kk._mul(a, b, True), kk._mul(a, b, False),
             [x * y for x, y in zip(fa, fb)])
    brackets(kk._fma(kk._f32(-2.0), a, b, True),
             kk._fma(kk._f32(-2.0), a, b, False),
             [-2 * x + y for x, y in zip(fa, fb)])
    pos = b.abs() + 1e-30
    q = kk._div_up(a, pos)
    for v, x, y in zip(q.tolist(), a.tolist(), pos.tolist()):
        if math.isinf(v):
            continue
        assert Fraction(v) >= Fraction(x) / Fraction(y)
        below = float(torch.nextafter(torch.tensor(v), down))
        assert math.isinf(below) or Fraction(below) < Fraction(x) / Fraction(y)
    s = kk._sqrt_up(a.abs())
    for v, x in zip(s.tolist(), a.abs().tolist()):
        assert Fraction(v) ** 2 >= Fraction(x)
        below = float(torch.nextafter(torch.tensor(v), down))
        assert below < 0 or Fraction(below) ** 2 < Fraction(x)


@pytest.mark.parametrize("k", [32, 64])
def test_single_sweep_lists_every_survivor(k):
    """2048 columns (16 tiles: 8 priming, 8 listed under a running
    threshold, then the 8 primed again): every survivor is listed, and the
    lists stay well inside DIM_CANDIDATES on a standardised embedding."""
    rng = np.random.default_rng(k)
    c = rng.normal(size=(1, 2048, 263)).astype(np.float32)
    r = (c[:, rng.choice(2048, 8, replace=False)]
         + 0.5 * rng.normal(size=(1, 8, 263))).astype(np.float32)
    r, c = torch.from_numpy(r), torch.from_numpy(c)
    m = torch.from_numpy(rng.random((1, 2048)) < 0.9)
    u, lo, _, surv = kk.filter_plain(r, c, m, k)
    listed = kk.filter_candidates_plain(u, lo, m, k, 263)
    assert not bool((surv & ~listed).any())
    assert bool((listed.sum(-1) < kk.DIM_CANDIDATES // 2).all())
    assert bool((listed.sum(-1) > surv.sum(-1)).any())
