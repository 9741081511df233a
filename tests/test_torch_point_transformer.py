"""Point Transformer (``model/point_transformer.py``, ``--arch ptv1``)
against its plain float32 reference (``portbench/reference/
point_transformer.py``), on the CPU: the published depths, strides,
neighbourhoods and weight groups at width 8, B = 2 tiles of 2048 slots
(one padded), seeded random weights, float32, and the plain versions of
the kernels (the selections pick the exact k nearest by the reference's
own squared distance, so both sides gather the same neighbours).

Tolerances. ``LOGIT_TOL``: the largest logit gap is at most 1e-4 of the
largest logit. Both sides run the same float32 operations in another
order (the BatchNorm sums, the interpolation's normalisation, the
attention's sum over neighbours), and ~60 batch-statistic BatchNorms
carry each rounding on; the measured gap is 6.5e-7 of the largest logit
in eval mode and 6e-7 in training mode, so 1e-4 holds with two orders of
room, and a bf16 forward (``test_bfloat16_exceeds_the_float32_tolerance``)
is further off than it by more than two orders. Running statistics:
rtol 1e-5 (sums over up to 3.3e4 pairs in another order). The train
step: the loss within 1e-5 relative, the confusion counts equal, and
each parameter the reference's gradient moves (norm at least 1e-3 of the
median leaf's, as the benchmark's train cells judge; the leaves left out
feed a BatchNorm through a bias, so their true gradient is zero and both
sides hold rounding noise there) within ``GRAD_TOL`` = 1e-3 relative in
its gradient (measured 1.3e-5) and ``CHANGE_TOL`` = 0.02 in its change
(measured 6.2e-3): AdamW's first step moves each element by about
lr x sign(g), so an element whose gradient is near zero moves by a
rounding's whim, and its leaf's change with it.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import weights  # noqa: E402
from portbench.manifest import ROOT  # noqa: E402
from portbench.reference import point_transformer as ref_pt  # noqa: E402
from portbench.reference.train import Trainer  # noqa: E402
from pointstowood_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from pointstowood_tpu_torch.model import Net, PointTransformerSeg  # noqa: E402
from pointstowood_tpu_torch.ops.fps_kernels import fps, fps_plain  # noqa: E402
from pointstowood_tpu_torch.train import trainer  # noqa: E402

C = 8
N = 2048
VALID = (2048, 1500)
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-3
CHANGE_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes on the host's cores at once;
    a full team of torch intra-op threads per process makes each wait for
    cores the others hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(dtype="float32"):
    conf = json.loads((ROOT / "portbench" / "configs" /
                       "ptv1-seg50.json").read_text())["model"]
    return dict(conf, channels=C, compute_dtype=dtype)


def _batch(n=N, valid=VALID, seed=3, garbage=False):
    """Tiles of uniform points in a 4 m cube, valid points first; the
    padding zero, or (``garbage``) far-off points and reflectances."""
    rng = np.random.default_rng(seed)
    b = len(valid)
    pos = torch.from_numpy(rng.uniform(-2, 2, (b, n, 3)).astype(np.float32))
    refl = torch.from_numpy(rng.uniform(-1, 1, (b, n)).astype(np.float32))
    mask = torch.arange(n)[None] < torch.tensor(valid)[:, None]
    fill = (torch.from_numpy(rng.uniform(50, 90, (b, n, 3)).astype(
        np.float32)) if garbage else 0.0)
    pos = torch.where(mask[..., None], pos, fill)
    sf = torch.where(mask, pos.norm(dim=-1), 0.0).amax(1)
    labels = torch.from_numpy((rng.random((b, n)) < 0.3).astype(np.float32))
    return {"pos": pos, "refl": refl, "mask": mask, "sf": sf,
            "labels": labels}


def _port(w, dtype=torch.float32):
    net = PointTransformerSeg(channels=C, dtype=dtype)
    net.load_state_dict(w)
    return net


def _args(b):
    return b["pos"], b["refl"], b["mask"], b["sf"]


def _gap(a, r, mask):
    return float((a - r)[mask].abs().max()), float(r[mask].abs().max())


@pytest.fixture(scope="module")
def setup():
    """Seeded weights, and the same weights with the running statistics a
    reference training forward measures on the batch (so eval logits are
    of the training ones' size)."""
    model = _model()
    w = weights.make_weights(model, 7, "cpu")
    batch = _batch()
    ref = ref_pt.RefPointTransformer(w, model)
    with torch.no_grad():
        logits = ref.forward(*_args(batch), training=True)
    stats = dict(ref.stats)
    wc = dict(w)
    for name, (mean, var, _) in stats.items():
        wc[name + ".running_mean"] = mean.clone()
        wc[name + ".running_var"] = var.clone()
    with torch.no_grad():
        eval_logits = ref_pt.RefPointTransformer(wc, model).forward(
            *_args(batch))
    return {"model": model, "w": w, "wc": wc, "batch": batch,
            "train_logits": logits, "eval_logits": eval_logits,
            "stats": stats}


def test_eval_logits_match_the_reference(setup):
    b, wc = setup["batch"], setup["wc"]
    with torch.no_grad():
        got = _port(wc).eval()(*_args(b))
    gap, scale = _gap(got, setup["eval_logits"], b["mask"])
    assert gap <= LOGIT_TOL * scale, (gap, scale)


@pytest.fixture(scope="module")
def port_training(setup):
    net = _port(setup["w"])
    with torch.no_grad():
        logits = net(*_args(setup["batch"]), training=True)
    return logits, net.state_dict()


def test_training_logits_match_the_reference(setup, port_training):
    gap, scale = _gap(port_training[0], setup["train_logits"],
                      setup["batch"]["mask"])
    assert gap <= LOGIT_TOL * scale, (gap, scale)


def test_running_statistics_update(setup, port_training):
    """Every BatchNorm's running statistics after one training forward:
    (1 - 0.1) running + 0.1 batch, the variance unbiased over the valid
    points or pairs."""
    state, w = port_training[1], setup["w"]
    assert len(setup["stats"]) == sum(
        k.endswith(".running_mean") for k in state)
    for name, (mean, var, n) in setup["stats"].items():
        rm = 0.9 * w[name + ".running_mean"] + 0.1 * mean
        rv = 0.9 * w[name + ".running_var"] + 0.1 * var * n / (n - 1)
        torch.testing.assert_close(state[name + ".running_mean"], rm,
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(state[name + ".running_var"], rv,
                                   rtol=1e-5, atol=1e-6)


def _leaf_gaps(a: dict, r: dict, keys) -> dict:
    return {k: float((a[k].double() - r[k].double()).norm()
                     / r[k].double().norm()) for k in keys}


def test_train_step_matches_the_reference(setup):
    """One ``make_train_step`` (forward, focal loss, backward, the finite
    guard, clipping, AdamW) against the reference's train step."""
    w, b = setup["w"], setup["batch"]
    cfg = TrainConfig(learning_rate=1e-4)
    net = _port(w)
    step = trainer.make_train_step(net, trainer.make_optimizer(net, cfg), cfg)
    loss, counts, finite = step(*_args(b), b["labels"], 1e-4,
                                torch.Generator())
    ref = Trainer(w, setup["model"], "cpu")
    out = ref.step(b, 1e-4, torch.Generator())
    assert finite and out["finite"]
    assert abs(float(loss) - out["loss"]) <= 1e-5 * abs(out["loss"])
    assert torch.equal(counts.double(), out["counts"])
    g = out["grads"]
    med = float(np.median([float(v.norm()) for v in g.values()]))
    moved = [k for k, v in g.items() if float(v.norm()) >= 1e-3 * med]
    assert len(moved) > 0.5 * len(g)
    grads = {k: p.grad for k, p in net.named_parameters()}
    state, after = net.state_dict(), ref.state()
    change = {k: state[k] - w[k] for k in moved}
    change_ref = {k: after[k] - w[k] for k in moved}
    worst = max(_leaf_gaps(grads, g, moved).items(), key=lambda kv: kv[1])
    assert worst[1] <= GRAD_TOL, worst
    worst = max(_leaf_gaps(change, change_ref, moved).items(),
                key=lambda kv: kv[1])
    assert worst[1] <= CHANGE_TOL, worst


def _fps_cases():
    rng = np.random.default_rng(5)
    grid = rng.integers(0, 3, (3, 400, 3)).astype(np.float32)
    return [
        ("uniform", rng.normal(size=(2, 1000, 3)).astype(np.float32),
         [1000, 713]),
        ("grid ties", grid, [400, 399, 128]),
        ("short and empty rows", rng.normal(size=(3, 64, 3)).astype(
            np.float32), [5, 0, 64]),
    ]


@pytest.mark.parametrize("name,pos,valid", _fps_cases(),
                         ids=[c[0] for c in _fps_cases()])
def test_fps_matches_the_reference_index_for_index(name, pos, valid):
    pos = torch.from_numpy(pos)
    mask = torch.arange(pos.shape[1])[None] < torch.tensor(valid)[:, None]
    counts = mask.sum(1) // 4
    m = pos.shape[1] // 4
    idx, ok = fps(pos, mask, counts, m)
    want_idx, want_ok = ref_pt.fps(pos, mask, counts, m)
    assert torch.equal(idx, want_idx) and torch.equal(ok, want_ok)
    assert torch.equal(idx, fps_plain(pos, mask, counts, m)[0])
    for row, n in enumerate(valid):
        picks = idx[row, :n // 4]
        if n:
            assert int(picks[0]) == 0  # the row's first valid point
        assert bool((picks < n).all())  # never a padded slot
        if name == "uniform":  # with distinct points, no point twice
            assert len(set(picks.tolist())) == len(picks)


def test_fps_first_pick_is_the_first_valid_point():
    pos = torch.randn(1, 16, 3)
    mask = torch.zeros(1, 16, dtype=torch.bool)
    mask[0, 5:] = True
    idx, ok = fps(pos, mask, torch.tensor([3]), 4)
    assert int(idx[0, 0]) == 5 and ok.tolist() == [[True] * 3 + [False]]
    assert int(idx[0, 3]) == 0


def test_padding_is_invisible(setup):
    """The same tiles in more slots, the padding holding far-off points:
    the same logits at the valid points, with batch statistics and with
    running ones."""
    wc = setup["wc"]
    small = _batch(n=1024, valid=(1024, 700))
    large = _batch(n=1024 + 256, valid=(1024, 700), garbage=True)
    for k in ("pos", "refl"):
        large[k][:, :1024] = small[k]
    large["sf"] = small["sf"]
    net = _port(wc)
    for training in (True, False):
        with torch.no_grad():
            a = net(*_args(small), training=training)
            b = net(*_args(large), training=training)[:, :1024]
        gap, scale = _gap(b, a, small["mask"])
        assert gap <= LOGIT_TOL * scale, (training, gap, scale)


def test_deepest_levels_with_fewer_points_than_k():
    """Tiles of 256 and 150 points: levels 3-5 hold 16/9, 4/2 and 1/0
    valid points, fewer than K = 16 (and an empty level), and the
    softmax, max and BatchNorms leave the empty slots out."""
    model = _model()
    w = weights.make_weights(model, 11, "cpu")
    b = _batch(n=256, valid=(256, 150), seed=4)
    for training in (True, False):
        with torch.no_grad():
            got = _port(w)(*_args(b), training=training)
            want = ref_pt.RefPointTransformer(w, model).forward(
                *_args(b), training=training)
        assert bool(torch.isfinite(got[b["mask"]]).all())
        gap, scale = _gap(got, want, b["mask"])
        assert gap <= LOGIT_TOL * scale, (training, gap, scale)


def test_bfloat16_exceeds_the_float32_tolerance(setup):
    """The configuration's bf16 products are a different result at this
    tolerance: the comparison above would catch a forward that ran in
    bf16 where float32 was asked for."""
    b, wc = setup["batch"], setup["wc"]
    with torch.no_grad():
        got = _port(wc, torch.bfloat16).eval()(*_args(b))
    gap, scale = _gap(got, setup["eval_logits"], b["mask"])
    assert gap > 100 * LOGIT_TOL * scale, (gap, scale)


def test_cpu_train_and_predict_clis_under_arch_ptv1(tmp_path):
    """``cli.train --arch ptv1`` trains one epoch on a toy tree (plain
    versions) and writes a ``.pth`` that ``cli.predict --arch ptv1``
    loads and runs end to end; without the flag both build the ``Net``."""
    from pointstowood_tpu_torch.cli import predict as cli_predict
    from pointstowood_tpu_torch.cli import train as cli_train
    from pointstowood_tpu_torch.io import read_ply, write_ply
    from pointstowood_tpu_torch.predict.predicter import build_net

    rng = np.random.default_rng(11)
    n_wood, n_leaf = 250, 350
    theta = rng.uniform(0, 2 * np.pi, n_wood)
    r = rng.uniform(0, 0.15, n_wood)
    xyz = np.concatenate([
        np.stack([r * np.cos(theta), r * np.sin(theta),
                  rng.uniform(0, 6, n_wood)], 1),
        np.stack([rng.normal(0, 1.0, n_leaf), rng.normal(0, 1.0, n_leaf),
                  4.0 + rng.normal(0, 0.8, n_leaf)], 1)])
    cloud = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
             "reflectance": np.concatenate([rng.normal(2.0, 0.3, n_wood),
                                            rng.normal(-1.0, 0.5, n_leaf)]),
             "truth": np.concatenate([np.ones(n_wood), np.zeros(n_leaf)])}
    os.makedirs(tmp_path / "data" / "train")
    write_ply(str(tmp_path / "data" / "train" / "plot_train.ply"), cloud)
    flags = ["--arch", "ptv1", "--channels", str(C), "--dtype", "float32",
             "--min_pts", "32", "--max_pts", "256", "--grid_size", "4.0"]
    history = cli_train.main(["--wdir", str(tmp_path), "--preprocess",
                              "--num_epochs", "1", "--batch_size", "2",
                              "--model", "m.pth"] + flags, device="cpu")
    assert len(history) == 1 and np.isfinite(history[0]).all()
    model = tmp_path / "model" / "m.pth"
    plot = tmp_path / "plot.ply"
    write_ply(str(plot), {k: v for k, v in cloud.items() if k != "truth"})
    (rec,) = cli_predict.main(["--point-cloud", str(plot), "--model",
                               str(model), "--batch_size", "2"] + flags,
                              device="cpu")
    out = read_ply(rec["output"])
    assert len(out["x"]) == n_wood + n_leaf
    assert set(np.unique(out["label"])) <= {0.0, 1.0}
    assert np.isfinite(out["pwood"]).all()

    for cli in (cli_train, cli_predict):
        args = cli.parse_args(["--model", "m.pth"])
        assert args.arch == "ptw"
        with pytest.raises(SystemExit):
            cli.parse_args(["--arch", "ptv1", "--model", "m.ckpt"])
    assert type(build_net(ModelConfig(), device="cpu")) is Net
    assert type(build_net(ModelConfig(arch="ptv1", channels=C),
                          device="cpu")) is PointTransformerSeg


def _old_clip_(grads, max_norm):
    """The clip as the train step computed it before it launched a few
    kernels a step: a chain of 0-d additions and a where per tensor."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


@pytest.mark.parametrize("seed", range(6))
def test_update_keeps_the_old_arithmetic(seed):
    """``clip_by_global_norm_`` (the squares' sums added on the host),
    ``all_finite`` (one flat check) and ``flat_copy`` / ``restore_`` give
    the old step's values bit for bit, below and above the clipping norm
    (Point Transformer has 563 parameter tensors: the old per-tensor
    kernels made its update host-bound)."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** (seed - 3)
    grads = [torch.from_numpy((rng.standard_normal(tuple(
        rng.integers(1, 40, size=int(rng.integers(1, 3))))) * scale)
        .astype(np.float32)) for _ in range(int(rng.integers(2, 80)))]
    old = [g.clone() for g in grads]
    assert torch.equal(trainer.clip_by_global_norm_(grads, 1.0),
                       _old_clip_(old, 1.0))
    assert all(torch.equal(a, b) for a, b in zip(grads, old))
    loss = torch.tensor(0.25)
    assert bool(trainer.all_finite(loss, grads))
    grads[int(rng.integers(len(grads)))].view(-1)[0] = (
        np.nan, np.inf, -np.inf)[seed % 3]
    assert not bool(trainer.all_finite(loss, grads))
    assert not bool(trainer.all_finite(torch.tensor(np.inf), old))
    buffers = old + [torch.tensor(3)]
    values = [t.clone() for t in buffers]
    saved = trainer.flat_copy(buffers)
    for t in buffers:
        t.zero_()
    trainer.restore_(saved)
    assert all(torch.equal(a, b) for a, b in zip(buffers, values))
