"""Gradient of the port's interpolation (``ops/interp_kernels``
``InterpBlend``, the port of the custom VJP of the JAX package's
``fp_interpolate_fast``), on the CPU.

* The fused route's gradient at the JAX test's shape (b=2, S=2048, T=512,
  C=128; tests/test_ops.py ``test_fused_fp_interpolate_matches_exact``)
  against JAX's ``fp_interpolate_fast`` VJP under the Pallas interpreter
  (relative L1 < 0.03: JAX rounds W and d_y/den to bf16, and its threshold
  admits ties and 3rd-nearest sources) and against JAX's exact gather-path
  gradient (relative L1 <= 1e-5). Measured: 0.0043 and 2.1e-8.
* ``blend_bwd_plain`` (the backward kernel's plain version) equals
  autograd through ``blend_plain`` to fp32 rounding (the order of the sums
  into one source row differs), with padded targets and empty slots.
* On the CPU, ``interp_blend`` returns a tensor whose ``grad_fn`` is the
  ``InterpBlend`` Function: the path CUDA tensors take too.
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
from pointstowood_tpu_torch.ops.interp_kernels import (
    blend_bwd_plain,
    blend_plain,
    interp_blend,
    interp_blend_bwd,
)
from pointstowood_tpu_torch.ops.interpolate import (
    knn_interpolate_batched as t_interpolate,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes on the host's cores at once.
    These tests run thousands of small CPU ops, and a full team of
    intra-op threads per process makes each of them wait for cores the
    other processes hold (measured under such load: 200.6 s for
    ``test_semantic_training_on_cpu`` with 8 threads, 6.4 s with 2)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel_l1(a, b):
    return float(np.abs(a - b).sum() / np.abs(b).sum())


@pytest.fixture(scope="module")
def fused_case():
    rng = np.random.default_rng(141190)
    b, s, t, c = 2, 2048, 512, 128
    assert pallas_interp.fused_supported(t, s, c)
    x = rng.normal(size=(b, s, c)).astype(np.float32)
    pos = rng.uniform(-1, 1, (b, s, 3)).astype(np.float32)
    tpos = rng.uniform(-1, 1, (b, t, 3)).astype(np.float32)
    smask = np.ones((b, s), bool)
    smask[:, -64:] = False
    ct = rng.normal(size=(b, t, c)).astype(np.float32)
    return x, pos, tpos, smask, ct


def _port_grad(x, pos, tpos, smask, ct):
    xt = torch.from_numpy(x).requires_grad_()
    y = t_interpolate(xt, torch.from_numpy(pos), torch.from_numpy(tpos), k=2,
                      source_mask=torch.from_numpy(smask), fused=True)
    (y * torch.from_numpy(ct)).sum().backward()
    return xt.grad.numpy()


def test_fused_route_gradient_matches_jax_fused_vjp(fused_case):
    x, pos, tpos, smask, ct = fused_case
    ctj = jnp.asarray(ct)
    g_jax = np.asarray(jax.grad(lambda x, p, q, m: jnp.sum(
        pallas_interp.fp_interpolate_fast(x, p, q, m) * ctj))(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(tpos),
        jnp.asarray(smask)))
    assert _rel_l1(_port_grad(*fused_case), g_jax) < 0.03


def test_fused_route_gradient_matches_jax_exact_gradient(fused_case):
    x, pos, tpos, smask, ct = fused_case
    ctj = jnp.asarray(ct)
    g_exact = np.asarray(jax.grad(lambda x, p, q, m: jnp.sum(j_interpolate(
        x, p, q, k=2, source_mask=m, method="exact") * ctj))(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(tpos),
        jnp.asarray(smask)))
    assert _rel_l1(_port_grad(*fused_case), g_exact) <= 1e-5


def _blend_inputs(seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    b, s, t, c, k = 2, 40, 64, 16, 2
    x = torch.randn((b, s, c), generator=g).to(dtype)
    idx = torch.randint(0, s, (b, t, k), generator=g)
    d2 = torch.rand((b, t, k), generator=g)
    d2[0, ::5, 1] = float("inf")        # empty slots
    d2[1, 7] = float("inf")             # a target with no neighbour
    d2[1, 9, 0] = 0.0                   # a coincident source (w = 1e16)
    tmask = torch.rand((b, t), generator=g) > 0.2
    d_y = torch.randn((b, t, c), generator=g).to(dtype)
    return x, idx, d2, tmask, d_y


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_backward_equals_autograd_through_plain_forward(seed):
    x, idx, d2, tmask, d_y = _blend_inputs(seed)
    xr = x.clone().requires_grad_()
    blend_plain(xr, idx, d2, tmask).backward(d_y)
    got = blend_bwd_plain(d_y, idx, d2, tmask, x.shape[1])
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, xr.grad, rtol=1e-6, atol=1e-6)
    # the CPU wrapper is the plain version
    assert torch.equal(interp_blend_bwd(d_y, idx, d2, tmask, x.shape[1]),
                       got)


def test_plain_backward_bf16_accumulates_in_fp32():
    """bf16 d_y: the sum is taken in fp32 and cast once (as JAX returns
    d_feat.astype(d_y.dtype)), so it equals the fp32 result rounded."""
    x, idx, d2, tmask, d_y = _blend_inputs(2, torch.bfloat16)
    got = blend_bwd_plain(d_y, idx, d2, tmask, x.shape[1])
    ref = blend_bwd_plain(d_y.float(), idx, d2, tmask, x.shape[1])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.to(torch.bfloat16))


def test_interp_blend_grad_fn_is_the_function_on_cpu():
    x, idx, d2, tmask, d_y = _blend_inputs(3)
    xr = x.clone().requires_grad_()
    y = interp_blend(xr, idx, d2, tmask)
    assert type(y.grad_fn).__name__ == "InterpBlendBackward"
    assert torch.equal(y.detach(), blend_plain(x, idx, d2, tmask))
    y.backward(d_y)
    assert torch.equal(xr.grad,
                       blend_bwd_plain(d_y, idx, d2, tmask, x.shape[1]))
    # neighbour arrays get no gradient; a frozen x builds no graph
    assert interp_blend(x, idx, d2, tmask).grad_fn is None
