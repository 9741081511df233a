"""The attention variants of the PyTorch port against the JAX package's
``model/attention.py`` and ``Net(attention_knn=..., attention_conv=...)``,
on the CPU (channels 8, N <= 256, inputs from numpy seeds; JAX jitted, its
variables carried across by ``state_dict_from_flax``).

* ``PositionalEncoding``, ``AdaptiveBlending`` and ``AttentivePointConv``
  (batch statistics with their running update, running averages, SA1's
  radius cap, neighbourhoods with no valid slot giving zeros) against the
  flax modules within 1e-5 (``PositionalEncoding`` also against the
  float64 formula, and against JAX's computed in a fresh process).
* ``ATSearchKNN``'s neighbour sets (exact and fast routes) equal JAX's
  exact sets except near-ties: pairs whose d2 in the port's embedding
  lies within 1e-6 of the k-th d2. JAX's own fast route ranks by a
  truncated distance at D > 3 (a finding about the reference, measured
  here); the port's is exact.
* Whole-``Net`` parity of both variants (fp32, exact kNN, N = 256):
  sigmoid probabilities within 1e-4 of flax's (test_full_net_parity.py's
  bar).
* One train step of each variant against the flax ``make_train_step`` at
  ``tests/test_torch_train.py``'s one-step tolerances (the reference's own
  swapped-batch noise); the gradient-free parameters (the ReflectanceGate
  and the ATSearchKNN blending MLPs) get zero gradients on both sides and
  decay by the same factor.
* ``stage_routes`` gives no transpose at levels 1-2 under
  ``attention_knn``; the key map covers the variants' variables as the
  flax modules name and shape them, and they round-trip through
  ``state_dict_from_flax`` / ``flax_from_state_dict`` and a ``.ckpt`` bit
  for bit.
"""

import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from chip_smoke import seeded_flax_variables
from flax_forward import flax_probs
from pointstowood_tpu import config as j_config
from pointstowood_tpu.model import Net as JNet
from pointstowood_tpu.model import attention as j_att
from pointstowood_tpu.model import network as j_network
from pointstowood_tpu.train import trainer as j_trainer
from pointstowood_tpu_torch import config as t_config
from pointstowood_tpu_torch.model import Net as TNet
from pointstowood_tpu_torch.model import attention as t_att
from pointstowood_tpu_torch.model import network as t_network
from pointstowood_tpu_torch.ops.interpolate import uses_fused_kernel
from pointstowood_tpu_torch.predict import predicter as t_predicter
from pointstowood_tpu_torch.train import trainer as t_trainer
from pointstowood_tpu_torch.utils import msgpack
from pointstowood_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from pointstowood_tpu_torch.utils.checkpoint_convert import (
    build_key_map,
    flax_from_state_dict,
    state_dict_from_flax,
)
from test_torch_train import (
    _flax_update,
    _jax_rule,
    _nest,
    _np_tree,
    _port_rule,
    _recorder,
    _rel_l1,
    _step_inputs,
)

C = 8
LR = 1e-3
VARIANTS = {"knn": dict(attention_knn=True), "conv": dict(attention_conv=True)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test processes share the host's cores (see
    test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _perturbed(variables, seed):
    """flax init values plus N(0, 0.1^2) noise on every leaf, so biases,
    norm scales and running statistics are not at their defaults."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=a.shape) * 0.1)
        .astype(np.float32), variables)


def _sub_state(path, variables):
    """The port's state_dict of the module at flax ``path`` (a Net path)
    from that module's own variables."""
    full = {c: _nest(path, variables[c]) for c in variables}
    prefix = path.replace("/", ".") + "."
    return {k[len(prefix):]: v for k, v in state_dict_from_flax(full).items()
            if k.startswith(prefix)}


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------------- modules


def test_band_frequencies_follow_jnp_linspace():
    """The port's bands are jnp.linspace's formula with every operation
    rounded to fp32. XLA's CPU code rounds the quotients i / 63 its own
    way, so JAX's bands (eager and jitted) lie within 2 ulps of them."""
    f = t_att.band_frequencies(10.0, 64)
    i = np.arange(63, dtype=np.float64)
    exact = np.float32(1.0) * (np.float32(1.0) - (i / 63).astype(np.float32))
    assert f.dtype == np.float32 and f[0] == 1.0 and f[-1] == 10.0
    np.testing.assert_allclose(f[:-1], exact + 10 * (i / 63), rtol=2e-7)
    for ref in (jnp.linspace(1.0, 10.0, 64),
                jax.jit(lambda: jnp.linspace(1.0, 10.0, 64))()):
        np.testing.assert_array_max_ulp(f, np.asarray(ref), maxulp=2)


PE_MODELS = (18, 66, 130)

# JAX's PositionalEncoding in a fresh interpreter: in one run of the whole
# suite (six workers, each importing every test file and running others
# before this one), the in-process jitted reference of d_model = 18 lay
# 1.5e-4 from the port at 375 of 1800 elements, though both lie within
# 4e-7 of the float64 formula in a fresh process, and neither moved when
# this file ran after any one of the files that ran before it in that
# worker. A reference computed in its own process sees none of that state.
_PE_REFERENCE = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from pointstowood_tpu.model import attention as j_att
out = {}
for d in map(int, sys.argv[2:]):
    xyz = np.random.default_rng(d).uniform(-3, 3, (2, 50, 3)).astype(
        np.float32)
    mod = j_att.PositionalEncoding(d)
    out[str(d)] = np.asarray(jax.jit(lambda x: mod.apply({}, x))(xyz))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def positional_encoding_refs(tmp_path_factory):
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = str(tmp_path_factory.mktemp("pe") / "refs.npz")
    subprocess.run([sys.executable, "-c", _PE_REFERENCE, path,
                    *map(str, PE_MODELS)], check=True, timeout=300,
                   env=dict(os.environ, JAX_PLATFORMS="cpu",
                            PYTHONPATH=repo))
    with np.load(path) as f:
        return {int(k): f[k] for k in f.files}


@pytest.mark.parametrize("d_model", PE_MODELS)
def test_positional_encoding_matches_jax(d_model, positional_encoding_refs,
                                        record_property):
    """Unscaled tile coordinates up to 3 m: sin/cos of up to 30 rad. The
    port within 1e-5 of JAX's (computed in a fresh process, see
    ``_PE_REFERENCE``) and of the float64 formula; a miss reports each
    side's distance from the formula, the in-process JAX value's too. The
    in-process JAX value's distance is recorded on every run (a junit
    property) and warned about past 1e-5, so that a recurrence of the
    drift names the side that moved."""
    xyz = np.random.default_rng(d_model).uniform(
        -3, 3, (2, 50, 3)).astype(np.float32)
    ref = positional_encoding_refs[d_model]
    got = t_att.PositionalEncoding(d_model)(torch.from_numpy(xyz)).numpy()
    assert got.shape == ref.shape == (2, 50, d_model)
    x_freq = xyz.astype(np.float64)[..., None] * np.linspace(1.0, 10.0, 64)
    oracle = np.stack([np.sin(x_freq), np.cos(x_freq)], -1).reshape(
        2, 50, -1)[..., :d_model]
    mod = j_att.PositionalEncoding(d_model)
    here = np.asarray(jax.jit(lambda x: mod.apply({}, x))(xyz))
    msg = (f"max |delta| against the float64 formula: port "
           f"{np.abs(got - oracle).max():.3g}, JAX (fresh process) "
           f"{np.abs(ref - oracle).max():.3g}, JAX (this process) "
           f"{np.abs(here - oracle).max():.3g}")
    here_err = float(np.abs(here - oracle).max())
    record_property("jax_in_process_max_abs_vs_formula", here_err)
    if here_err > 1e-5:
        warnings.warn(f"PositionalEncoding({d_model}): JAX in this process "
                      f"moved from the float64 formula; {msg}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5, err_msg=msg)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5, err_msg=msg)


def test_adaptive_blending_matches_jax():
    rng = np.random.default_rng(4)
    a = 18
    feats = rng.normal(size=(2, 40, 16 + a)).astype(np.float32)
    pos = rng.normal(size=(2, 40, 3 + a)).astype(np.float32)
    mod = j_att.AdaptiveBlending(a)
    variables = _perturbed(jax.jit(mod.init)(jax.random.key(1), feats, pos),
                           5)
    ref = jax.jit(mod.apply)(variables, feats, pos)
    tmod = t_att.AdaptiveBlending(16 + a, 3 + a, a)
    tmod.load_state_dict(_sub_state("sa2_module/atsearch/blending",
                                    variables), strict=True)
    got = tmod(*_t(feats, pos))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-6)


def _conv_inputs(seed, b=2, n=64, s=24, k=8, c=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    pos4 = rng.normal(size=(b, n, 4)).astype(np.float32)
    cidx = rng.integers(0, n, size=(b, s)).astype(np.int32)
    nidx = rng.integers(0, n, size=(b, s, k)).astype(np.int32)
    nval = rng.random((b, s, k)) < 0.8
    nval[:, -4:] = False  # centres with no valid neighbour
    cval = np.ones((b, s), bool)
    cval[1, 3] = False
    return x, pos4, cidx, nidx, nval, cval


@pytest.mark.parametrize("case", ["batch_stats", "running_average",
                                  "radius"])
def test_attentive_point_conv_matches_jax(case):
    """Outputs within 1e-5 (zeros where a centre has no valid neighbour
    or is itself invalid); with batch statistics also the new running
    statistics of the local MLP's BatchNorm. "radius": SA1's cap of 1.0,
    which also empties some neighbourhoods."""
    c = 16
    inputs = _conv_inputs(7)
    radius = np.ones((2, 1, 1), np.float32) if case == "radius" else None
    ura = case == "running_average"
    mod = j_att.AttentivePointConv(in_channels=c, local_channels=(c, 24, 32))
    variables = _perturbed(jax.jit(mod.init)(jax.random.key(0), *inputs), 8)

    def apply(v, *a):
        return mod.apply(v, *a, radius=radius, use_running_average=ura,
                         mutable=["batch_stats"])

    ref, mut = jax.jit(apply)(variables, *inputs)
    tmod = t_att.AttentivePointConv(c, (c, 24, 32))
    tmod.load_state_dict(_sub_state("sa1_module/conv", variables),
                         strict=True)
    got = tmod(*_t(*inputs), radius=None if radius is None
               else torch.from_numpy(radius), use_running_average=ura)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    assert (ref[:, -4:] == 0).all() and (ref[1, 3] == 0).all()
    assert (got[:, -4:] == 0).all() and (got[1, 3] == 0).all()
    assert np.abs(ref).max() > 0
    stats = _sub_state("sa1_module/conv", {
        "params": variables["params"],
        "batch_stats": _np_tree(mut["batch_stats"])})
    for name, buf in tmod.named_buffers():
        torch.testing.assert_close(buf, stats[name], rtol=1e-5, atol=1e-5,
                                   msg=name)


@pytest.mark.parametrize("method", ["exact", "fast"])
def test_atsearch_sets_match_jax_exact(method, monkeypatch):
    """Unscaled positions in a 4 m tile, a padded second sample, an
    invalid centre; A = 18, C_in = 32 (SA2 at C = 8: D = 71), k = 16. The
    port's sets (both routes: on the CPU "fast" runs knn_topk_dim's plain
    version) equal JAX's exact sets except near-ties in the port's
    embedding."""
    rng = np.random.default_rng(11)
    b, n, s, k, c, a = 2, 200, 40, 16, 32, 18
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    pos4 = np.concatenate([rng.uniform(-2, 2, (b, n, 3)),
                           rng.normal(size=(b, n, 1))], -1).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 150:] = False
    cidx = np.stack([rng.permutation(150)[:s] for _ in range(b)]).astype(
        np.int32)
    cval = np.ones((b, s), bool)
    cval[0, 5] = False
    inputs = (x, pos4, mask, cidx, cval)
    mod = j_att.ATSearchKNN(k=k, attention_dim=a, knn_method="exact")
    variables = _perturbed(jax.jit(mod.init)(jax.random.key(2), *inputs), 3)
    r_idx, r_valid = (np.asarray(v) for v in
                      jax.jit(mod.apply)(variables, *inputs))

    seen = {}
    knn = t_att.knn_masked

    def capture(q, s_, *args, **kw):
        seen["q"], seen["s"] = q.double().numpy(), s_.double().numpy()
        return knn(q, s_, *args, **kw)

    monkeypatch.setattr(t_att, "knn_masked", capture)
    tmod = t_att.ATSearchKNN(k, a, c, knn_method=method)
    tmod.load_state_dict(_sub_state("sa2_module/atsearch", variables),
                         strict=True)
    idx, valid = (v.numpy() for v in tmod(*_t(*inputs)))
    assert seen["s"].shape == (b, n, 3 + 2 * a + c)
    np.testing.assert_array_equal(valid, r_valid)
    ties = 0
    for bi in range(b):
        d2 = ((seen["q"][bi][:, None] - seen["s"][bi][None]) ** 2).sum(-1)
        d2[:, ~mask[bi]] = np.inf
        for q in range(s):
            got = set(idx[bi, q][valid[bi, q]].tolist())
            want = set(r_idx[bi, q][r_valid[bi, q]].tolist())
            if got == want:
                continue
            kth = np.sort(d2[q])[k - 1]
            for j in got ^ want:
                assert abs(d2[q, j] - kth) <= 1e-6 * kth, (bi, q, j)
            ties += 1
    assert ties <= 2


def test_jax_fast_route_ranks_by_four_coordinates_past_three_dims():
    """The finding about the reference that the port does not copy: the
    JAX fast kNN's Pallas kernels read blocks of 4 columns of their
    (Q, D + 1) / (D + 1, N) operands, so at D > 3 they rank by ||s||^2
    over all D minus 2 q.s over the first 4 coordinates. D = 16, N = 2048
    (the in-kernel top-k's gate admits it), Q = 128, k = 8, in Pallas
    interpret mode: the JAX sets hold 0.090 of the exact sets and 0.998 of
    that truncated ranking's. The port's fast route (here knn_topk_dim's
    plain version) returns the exact sets."""
    from pointstowood_tpu.ops.knn import knn_masked as j_knn

    rng = np.random.default_rng(0)
    d, n, q_n, k = 16, 2048, 128, 8
    s = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(q_n, d)).astype(np.float32)
    fast = np.asarray(j_knn(q, s, k, method="fast", with_dist=False)[0])
    exact = np.asarray(j_knn(q, s, k, method="exact")[0])
    trunc = (s * s).sum(1)[None] - 2 * q[:, :4] @ s[:, :4].T
    trunc = np.argsort(trunc, 1, kind="stable")[:, :k]

    def recall(a, b):
        return np.mean([len(set(x) & set(y)) / k for x, y in zip(a, b)])

    assert recall(fast, exact) < 0.2
    assert recall(fast, trunc) > 0.99
    port = t_att.knn_masked(torch.from_numpy(q)[None],
                            torch.from_numpy(s)[None], k,
                            method="fast")[0][0].numpy()
    assert recall(port, exact) == 1.0


# ---------------------------------------------------------- whole Net

_EXACT = dict(channels=C, k=32, knn_method="exact", voxel_priority="last",
              stage_fractions=(1.0, 1.0, 1.0))


def _sparse_cloud(seed, n=256):
    """test_full_net_parity.py's tile: 0.6 m extent."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 0.6, size=(n, 3)).astype(np.float32)
    xyz -= xyz.mean(axis=0)
    refl = rng.normal(size=n).astype(np.float32)
    sf = np.float32(np.linalg.norm(xyz, axis=1).max())
    return xyz[None], refl[None], np.ones((1, n), bool), np.array([sf])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_attention_net_matches_flax(variant):
    flags = VARIANTS[variant]
    tnet = TNet(**_EXACT, **flags)
    variables = seeded_flax_variables(tnet, 13)
    tnet.load_state_dict(state_dict_from_flax(variables), strict=True)
    inputs = _sparse_cloud(13)
    ref = np.asarray(flax_probs(JNet(**_EXACT, **flags, dtype=jnp.float32),
                                variables, *inputs))
    got = t_predicter.forward_probs(tnet.eval(), *_t(*inputs)).numpy()
    assert np.isfinite(got).all() and ref.std() > 1e-3
    assert np.abs(got - ref).max() < 1e-4


def test_stage_routes_take_no_transpose_at_attention_levels():
    """SA1 keeps its radius kNN and its transpose; SA2 and SA3 search with
    ATSearchKNN, so FP2 and FP3 take the fused or the gather route, as
    the JAX FP stages do when their SA stage hands them no transpose."""
    for training in (False, True):
        base = TNet(channels=32).stage_routes(16384, training)
        net = TNet(channels=32, attention_knn=True)
        routes = net.stage_routes(16384, training)
        assert routes[0] == base[0] == "transpose"
        caps = net.capacities(16384)
        bound = 4096 if training else 2048
        for lvl in (1, 2):
            fused = uses_fused_kernel(caps[lvl - 1], caps[lvl], 32 * 16, 2,
                                      "fast", bound)
            assert routes[lvl] == ("fused" if fused else "gather")
        assert "transpose" in base[1:]
        assert TNet(channels=32, attention_conv=True).stage_routes(
            16384, training) == base


# ------------------------------------------------------- one train step


# XLA's fusion pass on the CPU computes the producer of a ``jnp.max`` again
# inside the fusions of its VJP, whose compare against the maximum then
# misses it: the jitted flax step's gradients through the attention conv's
# masked max (over its local MLP's BatchNorm output) lie up to 28% away
# from the eager gradient and the finite differences (6.9 of 25 in
# AttentivePointConv's input gradient). Compiled without that pass, the
# step's gradients are the eager ones (within 1e-5).
_NO_FUSION = {"xla_disable_hlo_passes": "fusion"}


# The bars of tests/test_torch_train.py's one-step tests hold the port to
# the flax step's distance from itself on its batch with the two samples
# swapped, one draw of its rounding noise. Here that floor is the largest
# of three such draws (the swapped batch and two nudged by single ulps),
# and the port may lie up to twice as far: two independent fp32 steps,
# each that far from the exact one, can lie twice as far apart. Measured
# on this harness, one draw is not enough even for the plain Net, whose
# code these variants share: at N = 256 its loss lay 3.4x and its
# gradient 2.0x its swapped-batch distance from flax. The attention
# conv's gradient is ill-conditioned at the fp32 level (flax's LayerNorm
# takes E[x^2] - E[x]^2 of messages that the softmax scaled to near
# zero): the port's own fp32 step lies 13-16% (relative L1) from its
# float64 step on SA1's tensors.
NOISE_FACTOR = 2.0


def _nudged(a, rng):
    """a with each element moved by -1, 0 or +1 ulp at random."""
    step = rng.integers(-1, 2, a.shape)
    up = np.nextafter(a, np.float32(np.inf))
    down = np.nextafter(a, np.float32(-np.inf))
    return np.where(step > 0, up, np.where(step < 0, down, a)).astype(
        np.float32)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def attention_step(request):
    """tests/test_torch_train.py's step_case for one variant (N = 512):
    the flax step on the batch, and on three copies that change it only at
    the rounding level (its noise floor): its samples swapped, and twice
    its coordinates and reflectances each moved by -1, 0 or +1 ulp at
    random; the port's step with its gradients recorded."""
    kw = dict(channels=C, k=32, knn_method="exact", voxel_priority="last",
              **VARIANTS[request.param])
    inputs = _step_inputs()
    swapped = [np.ascontiguousarray(a[::-1]) for a in inputs]
    rng = np.random.default_rng(17)
    nudged = [[_nudged(a, rng) if i in (0, 1) else a
               for i, a in enumerate(inputs)] for _ in range(2)]
    tnet = TNet(**kw)
    variables = seeded_flax_variables(tnet, 7)
    tnet.load_state_dict(state_dict_from_flax(variables))
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    jcfg = j_config.TrainConfig(learning_rate=LR)
    tcfg = t_config.TrainConfig(learning_rate=LR)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    raw = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_network, "random_sample", _jax_rule)
        mp.setattr(t_network, "random_sample", _port_rule)
        rec = optax.chain(_recorder())
        state0 = jax.jit(rec.init)(params)
        step = j_trainer.make_train_step(JNet(**kw, dtype=jnp.float32), rec,
                                         jcfg)
        args = (params, stats, state0, *map(jnp.asarray, inputs),
                jnp.float32(LR), jax.random.PRNGKey(0))
        step = step.lower(*args).compile(compiler_options=_NO_FUSION)
        out = step(*args)
        selfs = [step(params, stats, state0, *map(jnp.asarray, other),
                      jnp.float32(LR), jax.random.PRNGKey(0))
                 for other in (swapped, *nudged)]
        assert bool(out[5]) and all(bool(o[5]) for o in selfs)
        new_params = _flax_update(jcfg, out[2][0].grads, params, LR)
        clip = t_trainer.clip_by_global_norm_

        def recording_clip(grads, max_norm):
            raw["grads"] = [g.clone() for g in grads]
            return clip(grads, max_norm)

        mp.setattr(t_trainer, "clip_by_global_norm_", recording_clip)
        opt = t_trainer.make_optimizer(tnet, tcfg)
        loss_t, _, finite_t = t_trainer.make_train_step(tnet, opt, tcfg)(
            *map(torch.from_numpy, inputs), LR, torch.Generator())
    names = [n for n, _ in tnet.named_parameters()]

    def sd(params=None, batch_stats=None):
        return state_dict_from_flax({"params": _np_tree(params),
                                     **({"batch_stats": _np_tree(batch_stats)}
                                        if batch_stats is not None else {})})

    return {
        "variant": request.param,
        "loss": (float(loss_t), float(out[3]), [float(o[3]) for o in selfs]),
        "finite": finite_t,
        "grads": (dict(zip(names, raw["grads"])), sd(out[2][0].grads),
                  [sd(o[2][0].grads) for o in selfs]),
        "stats": (tnet.state_dict(), sd(params, out[1]),
                  [sd(params, o[1]) for o in selfs]),
        "params": (tnet.state_dict(), sd(new_params)),
        "self_grads": [sd(o[2][0].grads) for o in selfs],
        "before": before,
    }


def _gradient_free(key):
    return "reflectanceyesno" in key or ".atsearch." in key


def test_attention_train_step_loss_matches_flax(attention_step):
    port, ref, selfs = attention_step["loss"]
    assert attention_step["finite"]
    noise = max(abs(r - ref) / abs(ref) for r in selfs)
    assert abs(port - ref) / abs(ref) <= max(1e-5, NOISE_FACTOR * noise)


def test_attention_train_step_gradients_match_flax(attention_step):
    """Per tensor and over the whole gradient (relative L1), within
    NOISE_FACTOR times flax's distance from itself on the swapped and
    nudged batches; the head within rtol 1e-4; the gradient-free
    parameters exactly zero on both sides."""
    port, ref, selfs = attention_step["grads"]
    assert set(port) == set(ref)
    floor = max(_rel_l1(o[k], ref[k]) for o in selfs for k in ref
                if float(ref[k].abs().max()) > 0)
    total = {"port": 0.0, "selfs": [0.0] * len(selfs)}
    for k, g in port.items():
        if _gradient_free(k):
            assert float(ref[k].abs().max()) == 0.0, k
            assert float(g.abs().max()) == 0.0, k
            continue
        assert _rel_l1(g, ref[k]) <= max(NOISE_FACTOR * floor, 1e-4), k
        total["port"] += float((g - ref[k]).abs().sum())
        for i, o in enumerate(selfs):
            total["selfs"][i] += float((o[k] - ref[k]).abs().sum())
    assert total["port"] <= NOISE_FACTOR * max(total["selfs"]), total
    # the head, behind the last BatchNorm: elementwise within rtol 1e-4,
    # or NOISE_FACTOR times flax's own largest elementwise distance
    scale = max(float(v.abs().max()) for v in ref.values())
    for k in ("conv2.weight", "conv2.bias"):
        err = float(((port[k] - ref[k]).abs()
                     / (1e-4 * ref[k].abs() + 1e-6 * scale)).max())
        noise = max(float(((o[k] - ref[k]).abs()
                           / (1e-4 * ref[k].abs() + 1e-6 * scale)).max())
                    for o in selfs)
        assert err <= max(1.0, NOISE_FACTOR * noise), (k, err, noise)
    if attention_step["variant"] == "conv":
        assert float(port["sa1_module.conv.qkv_proj.weight"].abs().max()) > 0


def test_attention_train_step_running_stats_match_flax(attention_step):
    port, ref, selfs = attention_step["stats"]
    for k, v in ref.items():
        if "running" not in k:
            continue
        noise = max(float(((o[k] - v).abs() / (v.abs() + 1)).max())
                    for o in selfs)
        err = float(((port[k] - v).abs() / (v.abs() + 1)).max())
        assert err <= max(1e-5, NOISE_FACTOR * noise), (k, err, noise)


def test_attention_train_step_params_match_flax(attention_step):
    """Adam's first step, as test_train_step_params_match_flax: within
    0.1 lr of flax's where both clipped gradients agree in sign and are
    >= 1e-6, within 2.1 lr everywhere; sign flips no more frequent than
    max(1%, NOISE_FACTOR times flax's own flips against its swapped and
    nudged steps)."""
    port_sd, ref = attention_step["params"]
    g_port, g_ref, _ = attention_step["grads"]

    def clipped(grads):
        norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
        return {k: g * min(1.0, 1.0 / norm) for k, g in grads.items()}

    def flip_rate(grads):
        flips = sum(int((torch.sign(grads[k]) != torch.sign(g_ref[k])).sum())
                    for k in ref)
        return flips / sum(g_ref[k].numel() for k in ref)

    c_port, c_ref = clipped(g_port), clipped(g_ref)
    for k, v in ref.items():
        agree = torch.sign(g_port[k]) == torch.sign(g_ref[k])
        live = agree & (c_ref[k].abs() >= 1e-6) & (c_port[k].abs() >= 1e-6)
        diff = (port_sd[k] - v).abs()
        assert float(torch.where(live, diff, 0.0).max()) <= 0.1 * LR, k
        assert float(diff.max()) <= 2.1 * LR, k
    noise = max(flip_rate(o) for o in attention_step["self_grads"])
    assert flip_rate(g_port) <= max(0.01, NOISE_FACTOR * noise), noise


def test_gradient_free_params_are_decayed_like_flax(attention_step):
    """The gate's and the blending MLPs' parameters (off the autograd
    graph: the blending only chooses indices) get zero gradients, and
    AdamW decays them as optax does: p <- p (1 - lr wd)."""
    port_sd, ref = attention_step["params"]
    before = attention_step["before"]
    keys = [k for k in ref if _gradient_free(k)]
    n_blend = 2 * 4 * 2 if attention_step["variant"] == "knn" else 0
    assert len(keys) == 3 * 3 * 2 + n_blend
    for k in keys:
        want = before[k] * (1 - LR * 1e-2)
        torch.testing.assert_close(port_sd[k], want, rtol=2e-7, atol=0)
        torch.testing.assert_close(ref[k], want, rtol=2e-7, atol=0)
        assert not torch.equal(port_sd[k], before[k])


# ------------------------------------------------------- checkpoints


def test_key_map_matches_the_flax_variables():
    """build_key_map's flax paths and shapes, with both flags, are those of
    the flax Net's own variables (jax.eval_shape of its init); without
    flags it has no attention entry."""
    flags = dict(attention_knn=True, attention_conv=True)
    tnet = TNet(channels=C, **flags)
    ours = seeded_flax_variables(tnet, 1)
    pos, refl, mask, sf = _sparse_cloud(1, n=128)
    shapes = jax.eval_shape(
        functools.partial(JNet(channels=C, **flags).init, training=False),
        {"params": jax.random.key(0)}, pos, refl, mask, sf)
    flat = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    ours_flat = {jax.tree_util.keystr(p): np.shape(v) for p, v in
                 jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert ours_flat == flat
    plain = build_key_map()
    assert not [k for k in plain if "atsearch" in k or "qkv" in k]
    assert set(plain) < set(build_key_map(**flags))


def test_attention_variables_round_trip(tmp_path):
    """flax variables -> state_dict -> flax variables, and a .ckpt written
    and read by the port, bit for bit."""
    flags = dict(attention_knn=True, attention_conv=True)
    tnet = TNet(channels=C, **flags)
    variables = seeded_flax_variables(tnet, 2)
    tnet.load_state_dict(state_dict_from_flax(variables), strict=True)
    back = flax_from_state_dict(tnet.state_dict())
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(back_flat) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back_flat[path], leaf)
    decoded = msgpack.unpackb(msgpack.packb(back))
    for path, leaf in flat:
        node = decoded
        for part in path:
            node = node[part.key]
        np.testing.assert_array_equal(node, leaf)
    save_checkpoint(str(tmp_path / "att.ckpt"), tnet)
    fresh = load_checkpoint(str(tmp_path / "att.ckpt"), TNet(channels=C,
                                                              **flags))
    for k, v in tnet.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k

