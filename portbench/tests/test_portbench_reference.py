"""The frozen reference against the port's plain CPU path at C=8: the
network (eval, attention variant, the two-stage route), a train step,
the tiling and the batches, bit for bit or to float32 rounding."""

import numpy as np
import pytest
import torch

from portbench import plots, weights
from portbench.reference import tiling as ref_tiling
from portbench.reference.net import Products, RefNet
from portbench.reference.train import Trainer

MODEL = dict(num_classes=1, channels=8, k=32, sa_resolutions=[0.04, 0.08, 0.16],
             stage_fractions=[0.5, 0.5, 0.5], fp_k=2, knn_mode="fast",
             compute_dtype="float32", voxel_priority="hash",
             attention_knn=False)


def _net(model):
    from pointstowood_tpu_torch.model import Net

    net = Net(channels=model["channels"], knn_method="fast",
              attention_knn=model["attention_knn"], dtype=torch.float32)
    w = weights.make_weights(model, 3, "cpu")
    net.load_state_dict(w)
    return net, w


def _batch(sizes, cap, seed=0, labels=False):
    rng = np.random.default_rng(seed)
    tiles = []
    for n in sizes:
        xyz = rng.normal(0, 1, (n, 3)) * [1, 1, 2]
        cols = [xyz, rng.uniform(-1, 1, (n, 1))]
        if labels:
            cols.append((xyz[:, :1] > 0).astype(float))
        tiles.append(np.concatenate(cols, 1).astype(np.float32))
    b = ref_tiling.pad(tiles, cap, with_labels=labels)
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("attention", [False, True])
def test_eval_forward_equals_the_port(attention):
    model = dict(MODEL, attention_knn=attention)
    net, w = _net(model)
    b = _batch((2048, 1500), 2048)
    batch = weights.calibration_batch(plots.synthetic_plot(1, 1, 0.2)[0], 1,
                                      2, 2048)
    w = weights.calibrate(w, model, batch, "cpu")
    net.load_state_dict(w)
    with torch.no_grad():
        want = net(b["pos"], b["refl"], b["mask"], b["sf"])
        got = RefNet(w, model).forward(b["pos"], b["refl"], b["mask"], b["sf"])
    m = b["mask"]
    assert torch.allclose(got[m], want[m], rtol=1e-4, atol=1e-4)
    assert (got[m] > 0).any() and (got[m] < 0).any()


def test_two_stage_route_equals_the_port():
    """A 24576-point tile: SA1 takes the two-stage group-minimum route."""
    model = dict(MODEL, k=32)
    net, w = _net(model)
    b = _batch((24576,), 24576, seed=2)
    with torch.no_grad():
        want = net(b["pos"], b["refl"], b["mask"], b["sf"])
        got = RefNet(w, model).forward(b["pos"], b["refl"], b["mask"], b["sf"])
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_train_steps_equal_the_port():
    from pointstowood_tpu_torch.config import TrainConfig
    from pointstowood_tpu_torch.train.trainer import (
        make_optimizer,
        make_train_step,
    )

    net, w = _net(MODEL)
    cfg = TrainConfig()
    opt = make_optimizer(net, cfg)
    step = make_train_step(net, opt, cfg)
    ref = Trainer(w, MODEL, "cpu")
    gp, gr = (torch.Generator().manual_seed(5) for _ in range(2))
    b = _batch((2048, 1500), 2048, labels=True)
    loss, counts, finite = step(b["pos"], b["refl"], b["mask"], b["sf"],
                                b["labels"], 1e-3, gp)
    r = ref.step(b, 1e-3, gr)
    assert finite and r["finite"]
    assert float(loss) == pytest.approx(r["loss"], rel=1e-6)
    assert torch.equal(counts.double(), r["counts"])
    params = dict(net.named_parameters())
    norms = {k: float(g.norm()) for k, g in r["grads"].items()}
    med = float(np.median(list(norms.values())))
    for k, g in r["grads"].items():
        if norms[k] >= 1e-3 * med:  # leaves with more than round-off
            got = opt.state[params[k]]["exp_avg"] / 0.1
            assert float(got.norm()) == pytest.approx(norms[k], rel=1e-3), k


def test_control_precision_differs():
    net, w = _net(MODEL)
    b = _batch((1024,), 1024)
    with torch.no_grad():
        a = RefNet(w, MODEL).forward(b["pos"], b["refl"], b["mask"], b["sf"])
        f = RefNet(w, MODEL, Products("fp8")).forward(
            b["pos"], b["refl"], b["mask"], b["sf"])
    assert not torch.allclose(a, f, rtol=1e-2)


def test_tiling_and_batches_equal_the_port():
    from pointstowood_tpu_torch.config import TilingConfig
    from pointstowood_tpu_torch.data.dataset import TileBatcher
    from pointstowood_tpu_torch.data.tiling import preprocess_cloud
    from pointstowood_tpu_torch.io.loader import canonicalize_columns

    table, wood = plots.synthetic_plot(4, 1, 0.5)
    pc, _, _ = canonicalize_columns(dict(table, truth=wood * 1.0),
                                    mode="train")
    prog = preprocess_cloud(pc, TilingConfig(min_pts=512, max_pts=2048),
                            with_labels=True)
    xyz = np.stack([table["x"], table["y"], table["z"]], 1)
    ref, _ = ref_tiling.tile_cloud(xyz, table["intensity"], (2.0, 4.0), 512,
                                   2048, labels=wood * 1.0)
    assert len(prog) == len(ref) > 4
    for p, r in zip(prog, ref):
        assert np.array_equal(p.points, r["points"])
        assert (p.grid_size, p.cell_id) == (r["grid_size"], r["cell_id"])
        assert np.array_equal(p.indices, r["indices"])
    caps = ref_tiling.inference_capacities([len(t) for t in prog], 512, 2048)
    batcher = TileBatcher(prog, 2, 512, 2048, capacity_step=2,
                          scale_batch=True)
    for cap, _, idx in batcher:
        assert all(caps[i] == cap for i in idx)
    mixed = TileBatcher(prog, 2, 512, 2048, with_labels=True, shuffle=True,
                        seed=141191, bucket=False)
    for (_, pb, _), rb in zip(mixed, ref_tiling.training_batches(
            ref, 2, 512, 2048, 141190, epoch=1)):
        for a, k in (("pos", "pos"), ("reflectance", "refl"),
                     ("mask", "mask"), ("sf", "sf"), ("labels", "labels")):
            assert np.array_equal(getattr(pb, a), rb[k])
