"""The interpolation backward of the port as a source-major gather
(``ops/interp_kernels``: ``blend_bwd_lists_plain``,
``blend_bwd_gather_plain``, ``blend_bwd_plain``), on the CPU. On the card
``interp_blend_bwd`` (csrc/interp.cu) must equal ``blend_bwd_plain`` bit
for bit; ``chip_smoke.py`` holds it so. Here:

* the inverse lists (CSR by source) against a numpy reference: entry ids
  e = t * k + i in ascending order with their weights and their targets'
  den, masked targets and empty (+inf) slots absent whatever their idx
  holds, a source named by every target, sources named by none;
* ``blend_bwd_plain`` is the same tensor on two runs, and within fp32
  reordering of the earlier ``index_add_`` order (all of slot 0, then
  slot 1, ...);
* against the JAX package on the same seeded numpy inputs: the fused
  custom VJP of ``fp_interpolate_fast`` at an FP3-like shape (relative
  L1 < 0.03, the bar of ``tests/test_torch_interp_grad.py``: JAX rounds W
  and d_y / den to bf16) and the gather-path VJP with FP2/FP1-like
  transpose neighbours (relative L1 <= 1e-5);
* ``knn_interpolate_batched(k=16)``, forward and gradient, against the JAX
  function at k = 16 (past the forward kernel's register instance).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pointstowood_tpu.ops import pallas_interp
from pointstowood_tpu.ops.interpolate import (
    knn_interpolate_batched as j_interpolate,
)
from pointstowood_tpu_torch.ops import knn_kernels as kk
from pointstowood_tpu_torch.ops.interp_kernels import (
    blend_bwd_gather_plain,
    blend_bwd_lists,
    blend_bwd_lists_plain,
    blend_bwd_plain,
    interp_blend_bwd,
)
from pointstowood_tpu_torch.ops.interpolate import (
    knn_interpolate_batched as t_interpolate,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test processes share the host's cores; a full team of
    intra-op threads per process makes each wait for the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel_l1(a, b):
    return float(np.abs(a - b).sum() / np.abs(b).sum())


def _case(name, seed=0):
    """(d_y (B, T, C) f32, idx (B, T, k) int, d2 (B, T, k) f32, tmask
    (B, T), n_src) from numpy: empty slots (+inf) and masked targets hold
    nonzero garbage indices; a hub source every target names; sources
    named by none; an all-masked batch; S not a power of two."""
    rng = np.random.default_rng(seed)
    k = {"k1": 1, "k3": 3, "hub k2": 2, "k16": 16}[name]
    b, t, s, c = 3, 45, 37, 8
    idx = rng.integers(0, s - 5, (b, t, k))  # sources s-5.. named by none
    d2 = rng.uniform(0.01, 2.0, (b, t, k)).astype(np.float32)
    empty = rng.random((b, t, k)) < 0.25
    d2[empty] = np.inf
    idx[empty] = rng.integers(1, s, int(empty.sum()))  # garbage
    d2[0, 3, 0] = 0.0  # a coincident source: w = 1e16
    tmask = rng.random((b, t)) > 0.2
    tmask[2] = False  # an all-masked batch
    idx[~tmask] = rng.integers(1, s, (int((~tmask).sum()), k))
    if name == "hub k2":
        idx[:, :, 0] = 7
        d2[:, :, 0] = rng.uniform(0.01, 2.0, (b, t))
    d_y = rng.normal(size=(b, t, c)).astype(np.float32)
    return d_y, idx, d2, tmask, s


CASES = ["k1", "k3", "hub k2", "k16"]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("name", CASES)
def test_lists_plain_match_a_numpy_reference(name):
    _, idx, d2, tmask, s = _case(name)
    b, t, k = idx.shape
    offsets, entries, weights, dens = blend_bwd_lists_plain(
        *_t(idx, d2, tmask), s)
    # den: slot-order sum of the weights, empty slots 0, clamped
    w = 1.0 / np.maximum(d2, np.float32(1e-16))
    ref_den = np.zeros((b, t), np.float32)
    for i in range(k):
        ref_den = ref_den + w[..., i]
    ref_den = np.maximum(ref_den, np.float32(1e-16))
    lists = [[] for _ in range(b * s)]
    for bb in range(b):
        for tt in range(t):
            for i in range(k):
                if tmask[bb, tt] and np.isfinite(d2[bb, tt, i]):
                    lists[bb * s + idx[bb, tt, i]].append(
                        (tt * k + i, w[bb, tt, i], ref_den[bb, tt]))
    ref_off = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    ref = np.array([e for x in lists for e in x]).reshape(-1, 3)
    assert offsets.dtype == entries.dtype == torch.int32
    np.testing.assert_array_equal(offsets.numpy(), ref_off)
    np.testing.assert_array_equal(entries.numpy(), ref[:, 0].astype(int))
    np.testing.assert_array_equal(weights.numpy(),
                                  ref[:, 1].astype(np.float32))
    np.testing.assert_array_equal(dens.numpy(), ref[:, 2].astype(np.float32))
    # ascending inside each list; masked batch and unnamed sources empty
    for cell in range(b * s):
        seg = entries.numpy()[ref_off[cell]:ref_off[cell + 1]]
        assert (np.diff(seg) > 0).all()
    assert (offsets.numpy()[2 * s:] == offsets.numpy()[2 * s]).all()
    for bb in range(2):
        assert ref_off[bb * s + s - 5] == ref_off[bb * s + s]
    # the CPU wrapper is the plain version
    for got, want in zip(blend_bwd_lists(*_t(idx, d2, tmask), s),
                         (offsets, entries, weights, dens)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", CASES)
def test_blend_bwd_plain_is_the_same_on_every_run(name, dtype):
    d_y, idx, d2, tmask, s = _case(name, seed=1)
    args = (torch.from_numpy(d_y).to(dtype), *_t(idx, d2, tmask), s)
    first = blend_bwd_plain(*args)
    assert first.dtype == dtype and first.shape == (3, s, 8)
    assert torch.equal(first, blend_bwd_plain(*args))
    assert torch.equal(first, interp_blend_bwd(*args))
    # unnamed sources and the masked batch get exact zeros
    assert not first[:, s - 5:].any() and not first[2].any()


def _index_add_order(d_y, idx, d2, tmask, s):
    """The earlier plain version: slot by slot, each an index_add_ over
    the targets; returns (sum, sum of |terms|) per source row."""
    b, _, c = d_y.shape
    w = torch.reciprocal(torch.clamp(d2, min=1e-16))
    den = torch.zeros(d2.shape[:2])
    for i in range(d2.shape[-1]):
        den = den + w[..., i]
    g = torch.where(tmask[..., None],
                    d_y / torch.clamp(den, min=1e-16)[..., None], 0.0)
    acc = torch.zeros((b * s, c))
    mag = torch.zeros((b * s, c))
    offs = torch.arange(b)[:, None] * s
    for i in range(d2.shape[-1]):
        wi = w[..., i, None]
        term = torch.where(wi > 0, wi * g, 0.0).reshape(-1, c)
        flat = (idx[..., i] + offs).reshape(-1)
        acc.index_add_(0, flat, term)
        mag.index_add_(0, flat, term.abs())
    return acc.view(b, s, c), mag.view(b, s, c)


@pytest.mark.parametrize("name", CASES)
def test_blend_bwd_plain_is_index_add_up_to_fp32_reordering(name):
    d_y, idx, d2, tmask, s = _case(name, seed=2)
    args = (*_t(d_y, idx, d2, tmask), s)
    new = blend_bwd_plain(*args)
    old, mag = _index_add_order(*args)
    n_max = int(np.bincount((idx + np.arange(3)[:, None, None] * s)
                            .reshape(-1)).max())
    # each reordered sum of n terms moves by at most ~n ulps of sum |terms|
    tol = n_max * 2.0 ** -23 * mag
    assert bool(((new - old).abs() <= tol).all())


def test_gather_plain_takes_the_lists_order():
    """The gather sums in the order its lists give: reversing every list
    changes some bits, and sorting the reversed lists back restores the
    result exactly."""
    d_y, idx, d2, tmask, s = _case("hub k2", seed=3)
    d_y_t, idx_t, d2_t, tmask_t = _t(d_y, idx, d2, tmask)
    lists = blend_bwd_lists_plain(idx_t, d2_t, tmask_t, s)
    ref = blend_bwd_gather_plain(d_y_t, *lists, s, 2)
    o = lists[0].long()
    perm = torch.cat([torch.arange(o[c], o[c + 1]).flip(0)
                      for c in range(len(o) - 1)])
    out = blend_bwd_gather_plain(d_y_t, lists[0],
                                 *(a[perm] for a in lists[1:]), s, 2)
    assert not torch.equal(out, ref)  # the hub's long sum moved
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def _top2(rows, cols, mask):
    d, i = kk.select_plain(*_t(rows, cols, mask), 2)
    return d, i


def test_blend_bwd_plain_matches_jax_fused_vjp_at_fp3():
    rng = np.random.default_rng(141190)
    b, s, t, c = 1, 2048, 256, 128
    assert pallas_interp.fused_supported(t, s, c)
    x = rng.normal(size=(b, s, c)).astype(np.float32)
    pos = rng.uniform(-1, 1, (b, s, 3)).astype(np.float32)
    tpos = rng.uniform(-1, 1, (b, t, 3)).astype(np.float32)
    smask = np.ones((b, s), bool)
    smask[:, -64:] = False
    ct = rng.normal(size=(b, t, c)).astype(np.float32)
    ctj = jnp.asarray(ct)
    g_jax = np.asarray(jax.grad(lambda x, p, q, m: jnp.sum(
        pallas_interp.fp_interpolate_fast(x, p, q, m) * ctj))(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(tpos),
        jnp.asarray(smask)))
    d2, idx = _top2(tpos, pos, smask)
    got = blend_bwd_plain(torch.from_numpy(ct), idx, d2,
                          torch.ones((b, t), dtype=torch.bool), s).numpy()
    assert _rel_l1(got, g_jax) < 0.03


@pytest.mark.parametrize("level", ["FP2", "FP1"])
def test_blend_bwd_plain_matches_jax_gather_vjp_on_transpose_neighbours(
        level):
    """FP2/FP1: the targets are a level's points, the sources its centres
    (a subset, so every centre is its own nearest source at d2 = 0), and
    the neighbours the exact top-2 of each point among the centres, the
    SA stage's transpose top-2."""
    rng = np.random.default_rng({"FP2": 5, "FP1": 6}[level])
    b, n, c = 2, {"FP2": 96, "FP1": 160}[level], 24
    pts = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    pmask = np.ones((b, n), bool)
    pmask[1, -11:] = False
    cidx = np.stack([np.sort(rng.choice(n - 11, n // 2, replace=False))
                     for _ in range(b)])
    cpos = np.take_along_axis(pts, cidx[..., None], 1)
    cmask = np.ones((b, n // 2), bool)
    cmask[0, -3:] = False
    x = rng.normal(size=(b, n // 2, c)).astype(np.float32)
    ct = rng.normal(size=(b, n, c)).astype(np.float32)
    d2, idx = _top2(pts, cpos, cmask)
    valid = np.isfinite(d2.numpy()) & pmask[..., None]
    j_idx = jnp.asarray(np.where(valid, idx.numpy(), 0).astype(np.int32))
    ctj = jnp.asarray(np.where(pmask[..., None], ct, 0))
    g_jax = np.asarray(jax.grad(lambda x: jnp.sum(j_interpolate(
        x, jnp.asarray(cpos), jnp.asarray(pts), k=2,
        source_mask=jnp.asarray(cmask), target_mask=jnp.asarray(pmask),
        precomputed=(j_idx, jnp.asarray(valid))) * ctj))(jnp.asarray(x)))
    got = blend_bwd_plain(torch.from_numpy(ct), idx, d2,
                          torch.from_numpy(pmask), n // 2).numpy()
    assert _rel_l1(got, g_jax) <= 1e-5


def test_knn_interpolate_k16_forward_and_gradient_match_jax():
    rng = np.random.default_rng(16)
    b, s, t, c = 2, 200, 64, 16
    x = rng.normal(size=(b, s, c)).astype(np.float32)
    pos = rng.uniform(-1, 1, (b, s, 3)).astype(np.float32)
    tpos = rng.uniform(-1, 1, (b, t, 3)).astype(np.float32)
    smask = rng.random((b, s)) > 0.1
    tmask = np.ones((b, t), bool)
    tmask[1, -9:] = False
    ct = rng.normal(size=(b, t, c)).astype(np.float32)
    ctj = jnp.asarray(np.where(tmask[..., None], ct, 0))

    def j_fwd(x):
        return j_interpolate(x, jnp.asarray(pos), jnp.asarray(tpos), k=16,
                             source_mask=jnp.asarray(smask),
                             target_mask=jnp.asarray(tmask), method="exact")

    y_jax = np.where(tmask[..., None], np.asarray(j_fwd(jnp.asarray(x))), 0)
    g_jax = np.asarray(jax.grad(lambda x: jnp.sum(j_fwd(x) * ctj))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    y = t_interpolate(xt, *_t(pos, tpos), k=16,
                      source_mask=torch.from_numpy(smask),
                      target_mask=torch.from_numpy(tmask), method="exact")
    (y * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), y_jax, rtol=1e-5,
                               atol=1e-5)
    assert _rel_l1(xt.grad.numpy(), g_jax) <= 1e-5
