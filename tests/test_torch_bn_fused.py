"""The training BatchNorm's fused passes (``ops/batchnorm_kernels.py``,
kernels in csrc/batchnorm.cu) on the CPU, through their plain PyTorch
transcription (no JAX):

* dispatch: CPU tensors and data groups take ``layers._BatchStatsNorm``;
  the fused Function takes the rest; the tracer's ``bn.fused_elems`` and
  ``bn.plain_elems`` add x's elements by path while tracing is on, and
  nothing while it is off;
* the transcription (its float64 sums, the rearranged backward sums)
  against ``_BatchStatsNorm`` and against float64 autograd of the plain
  expressions, in fp32 and bf16, at vector and scalar layouts;
* masked rows holding ±inf, and n = 0;
* a Net training forward and backward with the fused path against the
  plain one;
* the C entry points' argument counts against ``build._SIGNATURES``.

The kernels themselves run on the card only: ``chip_smoke.py --only
batchnorm`` holds them against these plain versions there."""

import math
import re
import types

import pytest
import torch

from pointstowood_tpu_torch.config import ModelConfig
from pointstowood_tpu_torch.model import layers
from pointstowood_tpu_torch.model.layers import MaskedBatchNorm
from pointstowood_tpu_torch.ops import batchnorm_kernels as bk
from pointstowood_tpu_torch.ops import build
from pointstowood_tpu_torch.parallel.mesh import DataGroup
from pointstowood_tpu_torch.predict.predicter import build_net
from pointstowood_tpu_torch.train.loss import poly1_focal_loss
from pointstowood_tpu_torch.utils import trace

EPS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test processes share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """The dispatch as on the card: every tensor without a data group
    takes the fused Function (here its plain transcription)."""
    monkeypatch.setattr(layers, "fused_path", lambda x, group: group is None)


def _inputs(lead, c, seed, dtype=torch.float32, valid=0.7):
    g = torch.Generator().manual_seed(seed)
    off = torch.randn(c, generator=g) * 2
    scale = torch.rand(c, generator=g) * 3 + 0.1
    x = (torch.randn(lead + (c,), generator=g) * scale + off).to(dtype)
    mask = torch.rand(lead, generator=g) < valid
    gy = (torch.randn(lead + (c,), generator=g) * 1e-2).to(dtype)
    w = torch.randn(c, generator=g) * 0.5 + 1
    b = torch.randn(c, generator=g) * 0.1
    return x, mask, gy, w, b


def _run(fn, x, m, gy, w, b):
    """(y, mean, var, n, g_x, g_weight, g_bias) of one forward and
    backward."""
    xr = x.clone().requires_grad_()
    wr, br = w.clone().requires_grad_(), b.clone().requires_grad_()
    y, mean, var, n = fn(xr, m, wr, br)
    grads = torch.autograd.grad(y, (xr, wr, br), gy.to(y.dtype))
    return (y.detach(), mean, var, n) + grads


def _fused(x, m, w, b):
    return bk.batch_norm_train(x, m, w, b, EPS)


def _plain(x, m, w, b):
    y, mean, var, n = layers._BatchStatsNorm.apply(
        x.float(), m, w, b, EPS, None, torch.float32)
    return (y.to(x.dtype), mean, var, n)


def _float64(x, m, w, b):
    """The plain expressions in float64."""
    x64 = x.double()
    dims = tuple(range(x.dim() - 1))
    n = torch.clamp(m.sum(dtype=torch.float64), min=1.0)
    mean = torch.where(m, x64, 0.0).sum(dims) / n
    d = x64 - mean
    var = torch.where(m, d * d, 0.0).sum(dims) / n
    y = d * torch.rsqrt(var + EPS) * w.double() + b.double()
    return y, mean, var, n


# (leading dims, C): C % 8 == 0 takes 8 channels a thread on the card,
# else one
SHAPES = [((2, 30000), 16), ((4, 37, 5), 24), ((3, 50, 8), 3),
          ((5, 70), 4), ((2, 16, 4), 512), ((64,), 264)]


@pytest.mark.parametrize("lead,c", SHAPES)
def test_transcription_matches_plain_and_float64(lead, c):
    x, mask, gy, w, b = _inputs(lead, c, seed=c)
    m = mask[..., None]
    got = _run(_fused, x, m, gy, w, b)
    plain = _run(_plain, x, m, gy, w, b)
    ref = _run(_float64, x.double(), m, gy.double(), w.double(),
               b.double())
    names = ("y", "mean", "var", "n", "g_x", "g_weight", "g_bias")
    for name, g, p, r in zip(names, got, plain, ref):
        assert g.dtype == p.dtype and g.shape == p.shape, name
        r = r.detach()
        scale = float(r.abs().max()) or 1.0
        # the sums' order alone differs: as close to float64 as the plain
        # version is, to a few float32 ulps of the largest value
        err_g = float((g.double() - r).abs().max()) / scale
        err_p = float((p.double() - r).abs().max()) / scale
        assert err_g <= max(2 * err_p, 8 * 2.0 ** -24), (name, err_g, err_p)
    assert float(got[3]) == float(mask.sum())


@pytest.mark.parametrize("lead,c", [((4, 37, 5), 24), ((3, 50, 8), 3)])
def test_bf16_in_bf16_out_within_a_rounding_of_plain(lead, c):
    """x in bf16: y and g_x in bf16, within one bf16 rounding of the
    plain version's (which computes in fp32 from x.float() and casts)."""
    x, mask, gy, w, b = _inputs(lead, c, seed=1, dtype=torch.bfloat16)
    m = mask[..., None]
    got = _run(_fused, x, m, gy, w, b)
    plain = _run(_plain, x, m, gy, w, b)
    for i in (0, 4):
        assert got[i].dtype == torch.bfloat16
        torch.testing.assert_close(got[i].float(), plain[i].float(),
                                   rtol=2 ** -7, atol=1e-6)
    for i in (1, 2, 5, 6):
        torch.testing.assert_close(got[i], plain[i], rtol=1e-5, atol=1e-7)


def test_elementwise_steps_are_the_plain_expressions():
    """Fed the same (C,) vectors, the apply and gradient passes are the
    plain code's expressions: the Function's y and g_x equal
    ``elementwise_plain`` on its own statistics bit for bit."""
    x, mask, gy, w, b = _inputs((6, 40, 4), 16, seed=5)
    x2, m1, gy2 = x.view(-1, 16), mask.reshape(-1), gy.view(-1, 16)
    mean, var, n, r = bk.batch_stats(x2, m1, EPS)
    y = bk.elementwise_plain(bk.APPLY, x2, m1, None, mean, r, w, b)
    want = ((x2 - mean) * r * w + b)
    assert torch.equal(y, want)
    g_w, g_b, g_s2, g_mean = bk.grad_sums(x2, m1, gy2, mean, r, w, n)
    gx = bk.elementwise_plain(bk.GRAD_INPUT, x2, m1, gy2, mean, r, w, g_s2,
                              g_mean / n)
    v = m1[:, None]
    d = x2 - mean
    g_d = gy2 * w * r + torch.where(v, 2.0 * d * g_s2, 0.0)
    assert torch.equal(gx, g_d + torch.where(v, g_mean / n, 0.0))
    # the rearranged g_mean: -Σ g_d summed by its two parts
    torch.testing.assert_close(g_mean, -g_d.sum(0), rtol=1e-5, atol=1e-6)
    got = _run(_fused, x, mask[..., None], gy, w, b)
    assert torch.equal(got[0].view(-1, 16), y)
    assert torch.equal(got[4].view(-1, 16), gx)


def test_masked_rows_holding_inf():
    """±inf on masked rows moves no statistic (bit for bit against the
    same rows holding zeros) and no y on a valid row; the backward's
    non-finite pattern is the plain code's."""
    x, mask, gy, w, b = _inputs((4, 50, 6), 16, seed=9)
    alt = torch.arange(x.numel()).view(x.shape) % 2 == 0
    bad = torch.where(mask[..., None], x,
                      torch.where(alt, math.inf, -math.inf))
    zero = torch.where(mask[..., None], x, 0.0)
    m = mask[..., None]
    got, base = _run(_fused, bad, m, gy, w, b), _run(_fused, zero, m, gy, w, b)
    for i in (1, 2, 3):
        assert torch.equal(got[i], base[i])
    assert torch.equal(got[0][mask], base[0][mask])
    plain = _run(_plain, bad, m, gy, w, b)
    for i in (4, 5, 6):
        assert torch.equal(torch.isnan(got[i]), torch.isnan(plain[i]))
        assert torch.equal(torch.isinf(got[i]), torch.isinf(plain[i]))
    torch.testing.assert_close(got[4][~mask], plain[4][~mask])


def test_no_valid_row():
    """n = 0: mean 0, var 0, n 1, as the plain code; finite gradients."""
    x, mask, gy, w, b = _inputs((3, 20), 8, seed=4)
    m = torch.zeros_like(mask)[..., None]
    got, plain = _run(_fused, x, m, gy, w, b), _run(_plain, x, m, gy, w, b)
    assert float(got[3]) == 1.0
    assert not got[1].any() and not got[2].any()
    for g, p in zip(got, plain):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, p, rtol=1e-6, atol=1e-7)


def test_empty_batch():
    x, mask, gy, w, b = _inputs((0, 5), 8, seed=4)
    got = _run(_fused, x, mask[..., None], gy, w, b)
    assert got[0].shape == (0, 5, 8) and float(got[3]) == 1.0
    assert not got[5].any() and not got[6].any()


def test_fused_path_predicate():
    cuda = types.SimpleNamespace(is_cuda=True)
    group = DataGroup(0, 1, None)
    assert layers.fused_path(cuda, None)
    assert not layers.fused_path(cuda, group)
    assert not layers.fused_path(torch.zeros(2, 3), None)


def _module_counts(mod, x, mask):
    trace.reset()
    with trace.session():
        y = mod(x, mask, use_running_average=False)
    counts = trace.collected()["counters"]
    trace.reset()
    return y, counts


def test_dispatch_and_counters(fused_on_cpu):
    """Without a group the fused Function runs (its counter grows by x's
    elements); under a data group the plain one (float64 sums); running
    statistics updated either way; tracing off counts nothing."""
    x, mask, _, _, _ = _inputs((3, 40, 4), 16, seed=3)
    fused, grouped = MaskedBatchNorm(16), MaskedBatchNorm(16)
    grouped.data_group = DataGroup(0, 1, None)
    y_f, c_f = _module_counts(fused, x, mask)
    y_g, c_g = _module_counts(grouped, x, mask)
    assert c_f == {"bn.fused_elems": x.numel()}
    assert c_g == {"bn.plain_elems": x.numel()}
    torch.testing.assert_close(y_f, y_g, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fused.running_mean, grouped.running_mean)
    torch.testing.assert_close(fused.running_var, grouped.running_var)
    trace.reset()
    fused(x, mask, use_running_average=False)
    assert trace.collected()["counters"] == {}


def test_cpu_tensors_take_the_plain_function(monkeypatch):
    """Unpatched, a CPU tensor runs ``_BatchStatsNorm`` and counts as
    plain; the eval branch counts nothing."""
    seen = []
    real = layers._BatchStatsNorm.apply
    monkeypatch.setattr(layers._BatchStatsNorm, "apply",
                        lambda *a: seen.append(a[-1]) or real(*a))
    x, mask, _, _, _ = _inputs((2, 30), 8, seed=6, dtype=torch.bfloat16)
    mod = MaskedBatchNorm(8)
    y, counts = _module_counts(mod, x, mask)
    assert seen == [torch.float32] and y.dtype == torch.bfloat16
    assert counts == {"bn.plain_elems": x.numel()}
    trace.reset()
    with trace.session():
        mod(x, mask, use_running_average=True)
    assert trace.collected()["counters"] == {}
    trace.reset()
    assert bk.batch_norm_train.launches == 0


def _forward_backward(net, seed):
    """Logits, loss and gradients of one training forward (random 50%
    centres from ``seed``) of a batch of two tiles, one of them padded."""
    g = torch.Generator().manual_seed(seed)
    n = 256
    pos = torch.randn(2, n, 3, generator=g)
    refl = torch.randn(2, n, generator=g)
    mask = torch.arange(n)[None] < torch.tensor([[n], [200]])
    sf = pos.norm(dim=-1).amax(1)
    labels = (torch.rand(2, n, generator=g) > 0.5).float()
    net.zero_grad()
    logits = net(pos, refl, mask, sf, training=True, generator=g)
    loss = poly1_focal_loss(logits, labels, label_smoothing=0.1,
                            mask=mask)[0]
    loss.backward()
    grads = {k: p.grad.clone() for k, p in net.named_parameters()
             if p.grad is not None}
    return logits.detach(), float(loss.detach()), grads


def _rel_l1(a, b):
    return float((a - b).abs().sum()) / (float(b.abs().sum()) or 1.0)


def test_net_training_forward_fused_against_plain(monkeypatch):
    """A float32 Net training forward and backward with every
    batch-statistic BatchNorm fused, against the plain ones: the loss to
    float32 rounding carried through the network, the logits close, and
    only the fused counter counting. Every parameter's gradient is held
    to the plain step with float64 sums: the ~45 BatchNorms amplify
    float32 rounding on the way back to the encoder (the plain float32
    step is ~2.5% relative L1 from it over the whole gradient), so the
    fused step may be no further from it than a few times the plain
    float32 step is, per tensor and over the whole gradient."""
    torch.manual_seed(0)
    net = build_net(ModelConfig(channels=8, compute_dtype="float32"),
                    device="cpu")
    start = {k: v.clone() for k, v in net.state_dict().items()}
    logits_p, loss_p, grads_p = _forward_backward(net, 1)
    real = layers._BatchStatsNorm.apply
    with monkeypatch.context() as mp:
        mp.setattr(layers._BatchStatsNorm, "apply",
                   lambda *a: real(*a[:-1], torch.float64))
        net.load_state_dict(start)
        _, _, grads_64 = _forward_backward(net, 1)
    net.load_state_dict(start)
    monkeypatch.setattr(layers, "fused_path", lambda x, group: group is None)
    trace.reset()
    with trace.session():
        logits_f, loss_f, grads = _forward_backward(net, 1)
    counts = trace.collected()["counters"]
    trace.reset()
    assert counts.get("bn.fused_elems", 0) > 0
    assert "bn.plain_elems" not in counts
    assert loss_f == pytest.approx(loss_p, rel=1e-5)
    torch.testing.assert_close(logits_f, logits_p, rtol=0, atol=2e-3)
    assert set(grads) == set(grads_p) == set(grads_64)
    total = {"fused": 0.0, "plain": 0.0, "ref": 0.0}
    for k, g in grads.items():
        assert torch.isfinite(g).all(), k
        err_f, err_p = _rel_l1(g, grads_64[k]), _rel_l1(grads_p[k],
                                                        grads_64[k])
        assert err_f <= max(4 * err_p, 1e-5), (k, err_f, err_p)
        total["fused"] += float((g - grads_64[k]).abs().sum())
        total["plain"] += float((grads_p[k] - grads_64[k]).abs().sum())
        total["ref"] += float(grads_64[k].abs().sum())
    assert total["fused"] <= 2 * total["plain"], total
    assert total["plain"] <= 0.1 * total["ref"], total


def test_entry_points_match_their_signatures():
    """Every ``ptw_*`` entry point of each CUDA source takes as many
    arguments as its ctypes signature declares."""
    for name in build.SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        found = dict(re.findall(r"\nint (ptw_\w+)\(([^)]*)\)", src))
        assert set(found) == set(build._SIGNATURES[name]), name
        for fn, args in found.items():
            assert len(args.split(",")) == len(build._SIGNATURES[name][fn]), fn
