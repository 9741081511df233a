"""The training path of the PyTorch port against the JAX package, on the
CPU (channels 8, N <= 512, inputs from numpy seeds).

* Training-mode layers (masked batch-stat ``MaskedBatchNorm``, a local-MLP
  ``RefMLP`` over (B, S, k, C) edges with a neighbour mask, an
  ``InvertedResidualBlock``) against the flax modules, with padded masks
  and garbage in the padding: outputs, input and parameter gradients
  within rtol 1e-4 / atol 1e-6 (atol in units of the module's largest
  gradient, which reaches ~40 in these cases), new running statistics
  within 1e-5.
* One train step (fp32, exact kNN, centres from one numpy-scored rule
  monkeypatched into both packages' ``network.random_sample``) against the
  flax train step (``trainer.make_train_step``). The network has ~45
  batch-statistic BatchNorms and masked maxima, so fp32 rounding is
  amplified on the way back to the encoder: the reference disagrees with
  *itself* by ~5e-5 on the loss and up to ~6% (relative L1) on encoder
  gradients when only the order of the two batch samples is swapped
  (measured in this test's setup). The port is held to that measured
  noise floor: loss and gradients no further from flax than flax's own
  swapped-batch run, running statistics within 1e-5 relative, post-step
  parameters (the JAX trainer's ``make_optimizer`` applied to the flax
  step's gradients, as ``make_train_step`` applies it) within 0.1 lr
  wherever the two gradients agree in sign and are >> eps (Adam's first
  step is +-lr there, so a sign flip of a noise-level gradient is the
  only gap, and those are counted).
* A non-finite step changes nothing, the BatchNorm statistics its forward
  had updated included.
* The ReflectanceGate's gradient-free parameters are decayed by AdamW as
  optax decays them.
* ``poly1_focal_loss`` (values and gradients), the metrics, the schedules
  and ``augment_tile`` (bit-identical) against JAX; ``random_sample``'s
  invariants.
* ``semantic_training`` and ``cli.train.main`` on the CPU on
  tests/test_train_loop.py's toy tree: ``.pth`` and history written, and
  the ``.pth`` serves through the port's predict path.
"""

import os
from typing import Any, NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from pointstowood_tpu import config as j_config
from pointstowood_tpu.model import Net as JNet
from pointstowood_tpu.model import layers as j_layers
from pointstowood_tpu.model import network as j_network
from pointstowood_tpu.ops import sampling as j_sampling
from pointstowood_tpu.train import augmentation as j_aug
from pointstowood_tpu.train import loss as j_loss
from pointstowood_tpu.train import metrics as j_metrics
from pointstowood_tpu.train import schedule as j_schedule
from pointstowood_tpu.train import trainer as j_trainer
from chip_smoke import seeded_flax_variables
from pointstowood_tpu_torch import config as t_config
from pointstowood_tpu_torch.model import Net as TNet
from pointstowood_tpu_torch.model import layers as t_layers
from pointstowood_tpu_torch.model import network as t_network
from pointstowood_tpu_torch.ops import sampling as t_sampling
from pointstowood_tpu_torch.train import augmentation as t_aug
from pointstowood_tpu_torch.train import loss as t_loss
from pointstowood_tpu_torch.train import metrics as t_metrics
from pointstowood_tpu_torch.train import schedule as t_schedule
from pointstowood_tpu_torch.train import trainer as t_trainer
from pointstowood_tpu_torch.utils import trace
from pointstowood_tpu_torch.utils.checkpoint_convert import (
    state_dict_from_flax,
)

C = 8
LR = 1e-3


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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_l1(a, b):
    den = float(b.abs().sum())
    return float((a - b).abs().sum()) / den if den else float(a.abs().sum())


# ------------------------------------------------- training-mode layers


def _nest(path, leaf):
    out = leaf
    for part in reversed(path.split("/")):
        out = {part: out}
    return out


@pytest.mark.parametrize("which", ["norm", "sa2_module/conv/local_nn",
                                   "sa1_module/residual_block"])
def test_training_mode_layer_matches_flax(which):
    """Batch statistics over the valid elements only (the padding holds
    1e30 garbage), the biased variance normalising, the running update
    with momentum 0.1 and the unbiased variance, and the gradients."""
    rng = np.random.default_rng(17)
    tnet = TNet(channels=C)
    tmod = tnet.get_submodule(which.replace("/", "."))
    if which == "norm":
        jmod, width = j_layers.MaskedBatchNorm(16 * C), 16 * C
        shape, mshape = (2, 96, width), (2, 96)
    elif which.endswith("local_nn"):
        jmod, width = j_layers.RefMLP((4 * C + 4, 6 * C, 8 * C)), 4 * C + 4
        shape, mshape = (2, 24, 32, width), (2, 24, 32)
    else:
        jmod, width = j_layers.InvertedResidualBlock(4 * C), 4 * C
        shape, mshape = (2, 64, width), (2, 64)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    mask = rng.random(mshape) < 0.75
    mask[1, -5:] = False
    x[~mask] = 1e30
    ct = rng.normal(size=shape[:-1] + (
        width if which == "norm" else (8 * C if "local" in which else width),
    )).astype(np.float32)
    jm = jnp.asarray(mask)
    variables = jax.jit(lambda: jmod.init(jax.random.PRNGKey(3),
                                          jnp.zeros(shape), mask=jm))()
    # non-trivial scale/bias and running statistics
    variables = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.normal(size=a.shape) * 0.1,
                                  jnp.float32), variables)

    def loss(params, x):
        y, mut = jmod.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            x, mask=jm, use_running_average=False,
                            mutable=["batch_stats"])
        return jnp.sum(jnp.where(jm[..., None], y, 0.0) * ct), (mut, y)

    (_, (mut, y_ref)), (g_p, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"],
                                             jnp.asarray(x))

    prefix = which.replace("/", ".") + "."
    full = {c: _nest(which, variables[c]) for c in variables}
    sd = {k[len(prefix):]: v for k, v in state_dict_from_flax(full).items()
          if k.startswith(prefix)}
    tmod.load_state_dict(sd, strict=False)
    xt = torch.from_numpy(x).requires_grad_()
    mt = torch.from_numpy(mask)
    y = tmod(xt, mt, False)
    (torch.where(mt[..., None], y, 0.0) * torch.from_numpy(ct)).sum().backward()

    y_ref = torch.from_numpy(np.array(y_ref))
    torch.testing.assert_close(y.detach()[mt], y_ref[mt], rtol=1e-4,
                               atol=1e-5)
    g_sd = {k[len(prefix):]: v for k, v in state_dict_from_flax(
        {"params": _nest(which, _np_tree(g_p))}).items()
        if k.startswith(prefix)}
    scale = max(float(v.abs().max()) for v in g_sd.values())
    for name, p in tmod.named_parameters():
        torch.testing.assert_close(p.grad, g_sd[name], rtol=1e-4,
                                   atol=1e-6 * scale, msg=name)
    gx = torch.from_numpy(np.array(g_x))
    torch.testing.assert_close(torch.where(mt[..., None], xt.grad, 0.0),
                               torch.where(mt[..., None], gx, 0.0),
                               rtol=1e-4, atol=1e-6 * scale)
    stats = {k[len(prefix):]: v for k, v in state_dict_from_flax(
        {"params": full["params"],
         "batch_stats": _nest(which, _np_tree(mut["batch_stats"]))}).items()
        if k.startswith(prefix) and "running" in k}
    for name, b in tmod.named_buffers():
        if "running" in name:
            torch.testing.assert_close(b, stats[name], rtol=1e-5, atol=1e-5,
                                       msg=name)


# ------------------------------------------------------- one train step


def _scores(n):
    return np.random.default_rng(1000 + n).random(n).astype(np.float32)


def _jax_rule(rng, mask, capacity, fraction=0.5):
    """The centre rule both packages get: the first floor(n_valid / 2)
    valid points by a fixed numpy score."""
    n = mask.shape[0]
    n_take = jnp.minimum((jnp.sum(mask) * fraction).astype(jnp.int32),
                         capacity)
    order = jnp.argsort(jnp.where(mask, jnp.asarray(_scores(n)), jnp.inf))
    select = jnp.zeros(n, bool).at[order].set(jnp.arange(n) < n_take)
    return j_sampling.compact_indices(select, capacity)


def _port_rule(mask, capacity, generator, fraction=0.5, group=None):
    """``_jax_rule`` for the port's ``random_sample`` signature; a row's
    centres depend on that row alone, so a data group changes nothing."""
    n = mask.shape[1]
    n_take = torch.clamp((mask.sum(-1) * fraction).long(), max=capacity)
    score = torch.where(mask, torch.from_numpy(_scores(n)), torch.inf)
    order = torch.argsort(score, dim=-1, stable=True)
    select = torch.zeros_like(mask).scatter(
        1, order, torch.arange(n) < n_take[:, None])
    return t_sampling.compact_indices(select, capacity)


class _Recorded(NamedTuple):
    grads: Any


def _recorder():
    """An optax transformation that applies no update and keeps the
    gradients it was given in its state: the flax train step's new
    optimizer state then holds its gradients."""

    def init(params):
        return _Recorded(jax.tree_util.tree_map(jnp.zeros_like, params))

    def update(updates, state, params=None):
        return (jax.tree_util.tree_map(jnp.zeros_like, updates),
                _Recorded(updates))

    return optax.GradientTransformation(init, update)


def _flax_update(cfg, grads, params, lr):
    """The update the flax train step applies to ``grads``: the JAX
    trainer's own optimizer (clip by global norm, AdamW) with lr
    injected, over the parameters raveled into one vector (the global
    norm of that vector is the tree's; AdamW is elementwise)."""
    from jax.flatten_util import ravel_pytree

    flat_p, unravel = ravel_pytree(params)
    flat_g, _ = ravel_pytree(grads)
    tx = j_trainer.make_optimizer(cfg)
    state = tuple(
        s._replace(hyperparams={**s.hyperparams, "learning_rate": lr})
        if hasattr(s, "hyperparams") else s for s in tx.init(flat_p))
    updates, _ = jax.jit(tx.update)(flat_g, state, flat_p)
    return unravel(optax.apply_updates(flat_p, updates))


def _step_inputs(seed=5, b=2, n=512):
    """test_full_net_parity.py's sparse 0.6 m tiles; the second sample is
    padded from 0.8 n on."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 0.6, (b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[-1, int(n * 0.8):] = False
    xyz -= xyz.mean(1, keepdims=True)
    xyz[~mask] = 0.0
    refl = rng.normal(size=(b, n)).astype(np.float32)
    sf = np.linalg.norm(xyz, axis=-1).max(1).astype(np.float32)
    labels = (rng.random((b, n)) < 0.3).astype(np.float32)
    return xyz, refl, mask, sf, labels


_STEP_NET = dict(channels=C, k=32, knn_method="exact",
                 voxel_priority="last")


@pytest.fixture(scope="module")
def flax_step():
    """The flax train step with a recording optimizer, on the batch and on
    the same batch with its two samples swapped (one compile), and the
    update the JAX trainer applies to its gradients."""
    inputs = _step_inputs()
    swapped = [np.ascontiguousarray(a[::-1]) for a in inputs]
    variables = seeded_flax_variables(TNet(**_STEP_NET), 7)
    jcfg = j_config.TrainConfig(learning_rate=LR)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_network, "random_sample", _jax_rule)
        rec = optax.chain(_recorder())
        state0 = jax.jit(rec.init)(params)
        step = j_trainer.make_train_step(
            JNet(**_STEP_NET, dtype=jnp.float32), rec, jcfg)
        out = step(params, stats, state0, *map(jnp.asarray, inputs),
                   jnp.float32(LR), jax.random.PRNGKey(0))
        out_sw = step(params, stats, state0, *map(jnp.asarray, swapped),
                      jnp.float32(LR), jax.random.PRNGKey(0))
    assert bool(out[5]) and bool(out_sw[5])
    return {"inputs": inputs, "variables": variables, "params": params,
            "out": out, "out_sw": out_sw,
            "new_params": _flax_update(jcfg, out[2][0].grads, params, LR)}


def _step_case(flax_step, fused: bool):
    """One port train step from the flax step's state and batch (every
    batch-statistic BatchNorm on ``ops.batchnorm_kernels``' passes where
    ``fused``, as on the card), beside the flax step's results."""
    inputs, variables = flax_step["inputs"], flax_step["variables"]
    out, out_sw = flax_step["out"], flax_step["out_sw"]
    params = flax_step["params"]
    tnet = TNet(**_STEP_NET)
    tnet.load_state_dict(state_dict_from_flax(variables))
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    tcfg = t_config.TrainConfig(learning_rate=LR)
    raw = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_network, "random_sample", _port_rule)
        if fused:
            mp.setattr(t_layers, "fused_path", lambda x, group: group is None)
        # the port: one train step, its gradients recorded before clipping
        clip = t_trainer.clip_by_global_norm_

        def recording_clip(grads, max_norm):
            raw["grads"] = [g.clone() for g in grads]
            return clip(grads, max_norm)

        mp.setattr(t_trainer, "clip_by_global_norm_", recording_clip)
        opt = t_trainer.make_optimizer(tnet, tcfg)
        t_step = t_trainer.make_train_step(tnet, opt, tcfg)
        trace.reset()
        with trace.session():
            loss_t, counts_t, finite_t = t_step(
                *map(torch.from_numpy, inputs), LR, torch.Generator())
        bn_counts = {k: v for k, v in trace.collected()["counters"].items()
                     if k.startswith("bn.")}
        trace.reset()
    names = [n for n, _ in tnet.named_parameters()]

    def sd(params=None, batch_stats=None):
        return state_dict_from_flax({"params": _np_tree(params),
                                     **({"batch_stats": _np_tree(batch_stats)}
                                        if batch_stats is not None else {})})

    return {
        "loss": (float(loss_t), float(out[3]), float(out_sw[3])),
        "counts": (counts_t.numpy(), np.asarray(out[4])),
        "finite": finite_t,
        "grads": (dict(zip(names, raw["grads"])), sd(out[2][0].grads),
                  sd(out_sw[2][0].grads)),
        "stats": (tnet.state_dict(), sd(params, out[1]),
                  sd(params, out_sw[1])),
        "params": (tnet.state_dict(), sd(flax_step["new_params"])),
        "before": before,
        "bn_counts": bn_counts,
    }


@pytest.fixture(scope="module")
def step_case(flax_step):
    return _step_case(flax_step, fused=False)


def _boundary_points(flax_step):
    """Valid points whose logit lies within float32 noise of 0: the
    port's training forward from the step's state, its BatchNorms' sums
    in float32 and in float64; the noise is the largest gap between the
    two logits, and a point whose float32 logit is no larger in magnitude
    may fall on either side by the sums' order alone."""
    inputs, variables = flax_step["inputs"], flax_step["variables"]
    real = t_layers._BatchStatsNorm.apply
    logits = []
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(t_network, "random_sample", _port_rule)
        for sums in (torch.float32, torch.float64):
            mp.setattr(t_layers._BatchStatsNorm, "apply",
                       lambda *a, sums=sums: real(*a[:-1], sums))
            tnet = TNet(**_STEP_NET)
            tnet.load_state_dict(state_dict_from_flax(variables))
            args = [torch.from_numpy(a) for a in inputs[:4]]
            logits.append(tnet(*args, training=True,
                               generator=torch.Generator()).float())
    mask = torch.from_numpy(inputs[2])
    noise = float((logits[0] - logits[1])[mask].abs().max())
    return int((logits[0][mask].abs() <= noise).sum())


@pytest.fixture(scope="module")
def fused_step_case(flax_step):
    return {**_step_case(flax_step, fused=True),
            "boundary_points": _boundary_points(flax_step)}


def test_train_step_loss_matches_flax(step_case):
    port, ref, ref_sw = step_case["loss"]
    assert step_case["finite"]
    noise = abs(ref_sw - ref) / abs(ref)
    assert abs(port - ref) / abs(ref) <= max(1e-5, noise)
    np.testing.assert_array_equal(*step_case["counts"])


def test_train_step_gradients_match_flax(step_case):
    """Every parameter's gradient (the ReflectanceGate's: exactly zero on
    both sides), held to the reference's swapped-batch noise floor: per
    tensor and over the whole gradient, relative L1 no larger than flax's
    own; the head (conv2, behind the last BatchNorm) within rtol 1e-4."""
    port, ref, ref_sw = step_case["grads"]
    assert set(port) == set(ref)
    total = {"port": 0.0, "ref_sw": 0.0, "ref": 0.0}
    floor = max(_rel_l1(ref_sw[k], ref[k]) for k in ref
                if float(ref[k].abs().max()) > 0)
    for k, g in port.items():
        if "reflectanceyesno" in k:
            assert float(ref[k].abs().max()) == 0.0
            assert float(g.abs().max()) == 0.0
            continue
        assert _rel_l1(g, ref[k]) <= max(floor, 1e-4), k
        total["port"] += float((g - ref[k]).abs().sum())
        total["ref_sw"] += float((ref_sw[k] - ref[k]).abs().sum())
        total["ref"] += float(ref[k].abs().sum())
    assert total["port"] <= total["ref_sw"]
    scale = max(float(v.abs().max()) for v in ref.values())
    for k in ("conv2.weight", "conv2.bias"):
        torch.testing.assert_close(port[k], ref[k], rtol=1e-4,
                                   atol=1e-6 * scale, msg=k)


def test_train_step_running_stats_match_flax(step_case):
    port, ref, ref_sw = step_case["stats"]
    for k, v in ref.items():
        if "running" not in k:
            continue
        noise = float(((ref_sw[k] - v).abs() / (v.abs() + 1)).max())
        err = float(((port[k] - v).abs() / (v.abs() + 1)).max())
        assert err <= max(1e-5, noise), (k, err, noise)


def test_train_step_params_match_flax(step_case):
    """Adam's first step moves a parameter by ~lr * g / (|g| + eps) (plus
    the decay): within 0.1 lr of flax's wherever the two gradients agree
    in sign and both clipped gradients are >= 100 eps, within 2.1 lr
    everywhere, and sign flips are rare."""
    port_sd, ref = step_case["params"]
    g_port, g_ref, _ = step_case["grads"]

    def clipped(grads):
        norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
        return {k: g * min(1.0, 1.0 / norm) for k, g in grads.items()}

    c_port, c_ref = clipped(g_port), clipped(g_ref)
    flips = total = 0
    for k, v in ref.items():
        agree = torch.sign(g_port[k]) == torch.sign(g_ref[k])
        live = agree & (c_ref[k].abs() >= 1e-6) & (c_port[k].abs() >= 1e-6)
        diff = (port_sd[k] - v).abs()
        assert float(torch.where(live, diff, 0.0).max()) <= 0.1 * LR, k
        assert float(diff.max()) <= 2.1 * LR, k
        flips += int((~agree).sum())
        total += agree.numel()
    assert flips / total < 0.01, flips / total


def test_reflectance_gate_params_are_decayed(step_case):
    """JAX gives the gate's fc parameters zero gradients and optax still
    decays them; torch leaves their grad None, and the port's step decays
    them all the same: p <- p (1 - lr wd)."""
    port_sd, ref = step_case["params"]
    before = step_case["before"]
    keys = [k for k in ref if "reflectanceyesno" in k]
    assert len(keys) == 3 * 3 * 2
    for k in keys:
        want = before[k] * (1 - LR * 1e-2)
        torch.testing.assert_close(port_sd[k], want, rtol=2e-7, atol=0)
        torch.testing.assert_close(ref[k], want, rtol=2e-7, atol=0)
        assert not torch.equal(port_sd[k], before[k])


def _fused_loss_matches_flax(case):
    """``test_train_step_loss_matches_flax``'s loss check; the (tp, fp,
    tn, fn) counts equal flax's but for points within float32 noise of
    the decision boundary (``boundary_points``), each of which moves two
    counts by one."""
    port, ref, ref_sw = case["loss"]
    assert case["finite"]
    noise = abs(ref_sw - ref) / abs(ref)
    assert abs(port - ref) / abs(ref) <= max(1e-5, noise)
    got, want = case["counts"]
    assert got.sum() == want.sum()
    assert np.abs(got - want).sum() <= 2 * case["boundary_points"], (
        got, want, case["boundary_points"])


@pytest.mark.parametrize("check", [
    _fused_loss_matches_flax, test_train_step_gradients_match_flax,
    test_train_step_running_stats_match_flax,
    test_train_step_params_match_flax, test_reflectance_gate_params_are_decayed,
], ids=["loss", "gradients", "running_stats", "params", "gate_decay"])
def test_fused_batchnorm_step_matches_flax(fused_step_case, check):
    """The same step with every batch-statistic BatchNorm on the fused
    Function's passes (``ops.batchnorm_kernels``, their plain
    transcription on the CPU), held to the flax step by each check above
    at its own tolerance. The counts alone are held to flax's up to the
    points that float32 rounding may put on either side of the decision
    boundary: the fused passes sum in another order, and in this batch
    one valid point's logit is -6.6e-7 with the plain float32 sums and
    +1.1e-5 with float64 sums."""
    assert set(fused_step_case["bn_counts"]) == {"bn.fused_elems"}
    check(fused_step_case)


def test_non_finite_step_is_skipped_and_restores_batch_stats(monkeypatch):
    """The finite guard: a step whose loss or gradients are not finite
    changes no parameter, no optimizer state and no BatchNorm statistic,
    although its forward had updated the statistics."""
    tnet = TNet(channels=C, knn_method="exact")
    tnet.load_state_dict(state_dict_from_flax(seeded_flax_variables(tnet, 3)))
    cfg = t_config.TrainConfig(learning_rate=LR)
    opt = t_trainer.make_optimizer(tnet, cfg)
    step = t_trainer.make_train_step(tnet, opt, cfg)
    inputs = [torch.from_numpy(a) for a in _step_inputs(n=256)]
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    loss_fn = t_trainer.poly1_focal_loss
    moved = {}

    def nan_loss(*a, **k):
        # runs after the forward: record that it moved the statistics
        moved.update({k: v.clone() for k, v in tnet.state_dict().items()
                      if "running" in k})
        return loss_fn(*a, **k)[0] * float("nan"), 2.0

    monkeypatch.setattr(t_trainer, "poly1_focal_loss", nan_loss)
    _, _, finite = step(*inputs, LR, torch.Generator().manual_seed(0))
    assert not finite
    assert any(not torch.equal(moved[k], before[k]) for k in moved)
    for k, v in tnet.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not opt.state
    monkeypatch.undo()
    _, _, finite = step(*inputs, LR, torch.Generator().manual_seed(0))
    assert finite and opt.state


# ------------------------------------------------------------ small pieces


def test_poly1_focal_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(4, 300)) * 6).astype(np.float32)
    logits[0, :4] = [1e4, -1e4, 10.0, -10.0]
    labels = (rng.random((4, 300)) < 0.4).astype(np.float32)
    mask = rng.random((4, 300)) < 0.8
    for kw in (dict(label_smoothing=0.1, mask=mask),
               dict(label_smoothing=None, alpha=0.25, reduction="sum")):
        jkw = {k: (jnp.asarray(v) if k == "mask" else v)
               for k, v in kw.items()}
        tkw = {k: (torch.from_numpy(v) if k == "mask" else v)
               for k, v in kw.items()}
        ref, g_ref = jax.jit(jax.value_and_grad(
            lambda lo, la: j_loss.poly1_focal_loss(lo, la, **jkw)[0]))(
            jnp.asarray(logits), jnp.asarray(labels))
        lt = torch.from_numpy(logits).requires_grad_()
        got, gamma = t_loss.poly1_focal_loss(lt, torch.from_numpy(labels),
                                             **tkw)
        got.backward()
        assert gamma == 2.0
        np.testing.assert_allclose(float(got.detach()), float(ref),
                                   rtol=1e-6)
        np.testing.assert_allclose(lt.grad.numpy(), np.asarray(g_ref),
                                   rtol=1e-5, atol=1e-9)


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    for p_wood in (0.0, 0.3, 1.0):
        preds = (rng.random((2, 200)) < 0.5).astype(np.float32)
        labels = (rng.random((2, 200)) < p_wood).astype(np.float32)
        mask = rng.random((2, 200)) < 0.9
        ref = np.asarray(j_metrics.binary_counts(
            jnp.asarray(preds), jnp.asarray(labels), jnp.asarray(mask)))
        got = t_metrics.binary_counts(torch.from_numpy(preds),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), ref)
        assert t_metrics.batch_metrics(got) == j_metrics.batch_metrics(ref)


def test_schedules_match_jax():
    for total in (1, 2, 7, 40, 200):
        for step in range(total + 2):
            assert t_schedule.onecycle_cos_lr(
                step, max_lr=1e-4, total_steps=total) == \
                j_schedule.onecycle_cos_lr(step, max_lr=1e-4,
                                           total_steps=total)
    for step in range(-1, 40):
        kw = dict(first_cycle_steps=8, max_lr=1e-6, min_lr=1e-8,
                  warmup_steps=5, gamma=0.5)
        assert t_schedule.cosine_warmup_restarts_lr(step, **kw) == \
            j_schedule.cosine_warmup_restarts_lr(step, **kw)
    for cfg in (dict(), dict(tune=True, num_epochs=30)):
        jc, tc = j_config.TrainConfig(**cfg), t_config.TrainConfig(**cfg)
        assert [t_trainer.epoch_lr(tc, e) for e in range(tc.num_epochs)] \
            == [j_trainer.epoch_lr(jc, e) for e in range(jc.num_epochs)]


def test_train_config_matches_jax():
    import dataclasses

    assert dataclasses.asdict(t_config.TrainConfig()) == \
        dataclasses.asdict(j_config.TrainConfig())


def test_augment_tile_is_bit_identical():
    pts = np.random.default_rng(8).normal(size=(500, 5)).astype(np.float32)
    for mode in ("train", "test"):
        r_j, r_t = np.random.default_rng(21), np.random.default_rng(21)
        for _ in range(40):
            np.testing.assert_array_equal(
                t_aug.augment_tile(pts, r_t, mode=mode),
                j_aug.augment_tile(pts, r_j, mode=mode))
        assert r_j.random() == r_t.random()


def test_random_sample_invariants():
    g = torch.Generator().manual_seed(0)
    n, cap = 300, 150
    mask = torch.zeros((4, n), dtype=torch.bool)
    mask[0] = True
    mask[1, :123] = True
    mask[2, ::7] = True
    # row 3: empty (a padding tile)
    for _ in range(3):
        idx, valid = t_sampling.random_sample(mask, cap, g)
        assert idx.shape == valid.shape == (4, cap)
        for row in range(4):
            n_valid = int(mask[row].sum())
            chosen = idx[row][valid[row]]
            assert int(valid[row].sum()) == n_valid // 2
            assert bool(valid[row, :n_valid // 2].all())  # compacted
            assert bool(mask[row, chosen].all())           # valid points
            assert bool((chosen[1:] > chosen[:-1]).all())  # unique, sorted
            assert bool((idx[row][~valid[row]] == 0).all())
    # another generator state draws another subset
    a, _ = t_sampling.random_sample(mask, cap, torch.Generator().manual_seed(1))
    b, _ = t_sampling.random_sample(mask, cap, torch.Generator().manual_seed(2))
    assert not torch.equal(a, b)


def test_random_sample_caps_at_capacity():
    mask = torch.ones((1, 100), dtype=torch.bool)
    idx, valid = t_sampling.random_sample(mask, 20, torch.Generator())
    assert int(valid.sum()) == 20
    assert bool((idx[0, 1:] > idx[0, :-1]).all())


# ------------------------------------------------------- loop and CLI


def _toy_tree(seed=11, n_wood=800, n_leaf=1200):
    """tests/test_train_loop.py's labelled tree, as a column table."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n_wood)
    r = rng.uniform(0, 0.15, n_wood)
    trunk = np.stack([r * np.cos(theta), r * np.sin(theta),
                      rng.uniform(0, 6, n_wood)], axis=1)
    crown = np.stack([rng.normal(0, 1.0, n_leaf), rng.normal(0, 1.0, n_leaf),
                      4.0 + rng.normal(0, 0.8, n_leaf)], axis=1)
    xyz = np.concatenate([trunk, crown])
    refl = np.concatenate([rng.normal(2.0, 0.3, n_wood),
                           rng.normal(-1.0, 0.5, n_leaf)])
    labels = np.concatenate([np.ones(n_wood), np.zeros(n_leaf)])
    return {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "reflectance": refl, "truth": labels}


def _serves(path, tiles, model_cfg, tiling):
    from pointstowood_tpu_torch.predict import predicter
    from pointstowood_tpu_torch.utils.checkpoint import load_checkpoint

    net = load_checkpoint(str(path),
                          predicter.build_net(model_cfg, device="cpu"))
    out = predicter.run_inference(tiles, net,
                                  t_config.PredictConfig(batch_size=2),
                                  tiling, device="cpu")
    assert out.shape == (sum(len(t) for t in tiles), 5)
    assert np.isfinite(out).all()


def test_semantic_training_on_cpu(tmp_path):
    from pointstowood_tpu_torch.data.tiling import preprocess_cloud
    from pointstowood_tpu_torch.io.loader import canonicalize_columns

    pc, _, _ = canonicalize_columns(_toy_tree(), mode="train")
    tiling = t_config.TilingConfig(grid_size=(4.0,), min_pts=32, max_pts=512)
    tiles = preprocess_cloud(pc, tiling, with_labels=True)
    assert len(tiles) >= 2
    cfg = t_config.TrainConfig(num_epochs=3, batch_size=2, learning_rate=1e-3)
    model_cfg = t_config.ModelConfig(channels=C, compute_dtype="float32")
    state, history = t_trainer.semantic_training(
        tiles, cfg, model_cfg, tiling, wdir=str(tmp_path), model_name="m.pth",
        checkpoints=[2], log_fn=lambda s: None, device="cpu")
    hist = np.asarray(history)
    assert hist.shape == (3, 7)
    assert np.isfinite(hist).all()
    assert hist[-1, 2] < hist[0, 2]  # the loss falls on the toy problem
    for f in ("m.pth", "m_history.csv", "ba-m.pth", "f1-m.pth"):
        assert (tmp_path / "model" / f).exists(), f
    assert (tmp_path / "checkpoints" / "epoch_2.pth").exists()
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / "model" / "m_history.csv"), hist)
    assert state.epoch == 3
    _serves(tmp_path / "model" / "m.pth", tiles, model_cfg, tiling)


def test_train_cli_on_cpu(tmp_path):
    from pointstowood_tpu_torch.cli import train as cli
    from pointstowood_tpu_torch.data.tiling import load_tiles
    from pointstowood_tpu_torch.io import write_ply

    os.makedirs(tmp_path / "data" / "train")
    write_ply(str(tmp_path / "data" / "train" / "plot1_train.ply"),
              _toy_tree())
    history = cli.main([
        "--wdir", str(tmp_path), "--preprocess", "--num_epochs", "1",
        "--batch_size", "2", "--min_pts", "32", "--max_pts", "512",
        "--grid_size", "4.0", "--model", "m.pth", "--channels", str(C),
        "--dtype", "float32"], device="cpu")
    assert len(history) == 1 and np.isfinite(history[0]).all()
    assert (tmp_path / "model" / "m.pth").exists()
    assert (tmp_path / "model" / "m_history.csv").exists()
    tiles = load_tiles(str(tmp_path / "data" / "train" / "voxels"))
    assert tiles
    _serves(tmp_path / "model" / "m.pth", tiles,
            t_config.ModelConfig(channels=C, compute_dtype="float32"),
            t_config.TilingConfig(grid_size=(4.0,), min_pts=32, max_pts=512))
