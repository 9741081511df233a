"""Architectures found by name (``arch/<name>.py``): the default is the
PointsToWood ``Net`` itself, an unknown name fails before any run, and a
new architecture's train cell needs only new files.

The toy architecture below (two Linear + BatchNorm layers over xyz and
reflectance, then a one-logit head) is written into a directory that
stands in for ``arch/`` for one test; it is never left there. It runs
through ``kinds/train.py`` as it stands. Its predict half waits for the
program's own switch of architecture in the predict CLI, which has only
the ``Net``'s flags: a predict cell of a new architecture cannot run yet.
"""

import copy
import json
import shutil

import pytest
import torch

from portbench import arch, manifest, plots, roofline, weights
from portbench.tests import tiny

TRAIN = "train-b8.ptw-net-c32"

TOY = '''
"""A toy network: fc1, fc2 (Linear + masked BatchNorm + ReLU), head."""

import torch

from portbench.reference.net import BN_EPS, Products

HEAD = "head"
KERNELS = {"toy_op": ["toy_kernel"]}


def build(model):
    from pointstowood_tpu_torch.model.layers import MaskedBatchNorm

    c = model["channels"]

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = torch.nn.Sequential(torch.nn.Linear(4, c),
                                           MaskedBatchNorm(c))
            self.fc2 = torch.nn.Sequential(torch.nn.Linear(c, c),
                                           MaskedBatchNorm(c))
            self.head = torch.nn.Linear(c, model["num_classes"])

        def forward(self, pos, refl, mask, sf, training=False,
                    generator=None):
            x = torch.cat([pos, refl[..., None]], -1)
            for lin, bn in (self.fc1, self.fc2):
                x = torch.relu(bn(lin(x), mask,
                                  use_running_average=not training))
            return self.head(x)[..., 0]

    return Toy()


def param_shapes(model):
    c, out = model["channels"], {}
    for name, n_in in (("fc1", 4), ("fc2", c)):
        out[f"{name}.0.weight"] = (c, n_in)
        out[f"{name}.0.bias"] = (c,)
        for p in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.1.{p}"] = (c,)
        out[f"{name}.1.num_batches_tracked"] = ()
    out["head.weight"] = (model["num_classes"], c)
    out["head.bias"] = (model["num_classes"],)
    return out


class Reference:
    def __init__(self, w, model, products=None):
        self.w, self.p, self.stats = w, products or Products(), {}

    def bn(self, name, x, mask):
        w, b = self.w[name + ".weight"], self.w[name + ".bias"]
        if not self.batch_stats:
            return ((x - self.w[name + ".running_mean"])
                    * torch.rsqrt(self.w[name + ".running_var"] + BN_EPS)
                    * w + b)
        m = mask[..., None]
        n = torch.clamp(m.sum(dtype=torch.float32), min=1.0)
        mean = torch.where(m, x, 0.0).sum((0, 1)) / n
        d = x - mean
        var = torch.where(m, d * d, 0.0).sum((0, 1)) / n
        self.stats[name] = (mean.detach(), var.detach(), n.detach())
        return d * torch.rsqrt(var + BN_EPS) * w + b

    def forward(self, pos, refl, mask, sf, training=False, generator=None,
                batch_stats=None):
        self.batch_stats = training if batch_stats is None else batch_stats
        self.stats = {}
        x = torch.cat([pos.float(), refl.float()[..., None]], -1)
        for name in ("fc1", "fc2"):
            x = self.p.linear(x, self.w[name + ".0.weight"],
                              self.w[name + ".0.bias"])
            x = torch.relu(self.bn(name + ".1", x, mask))
        return self.p.linear(x, self.w["head.weight"],
                             self.w["head.bias"])[..., 0]


def hook(work, net):
    def record(_mod, args, _out):
        if work.tracer.active:
            work.forwards.append(({"n": args[2].sum()},
                                  torch.is_grad_enabled()))

    net.register_forward_hook(record)


def forward_work(counts, model, grad):
    c = model["channels"]
    macs = float(counts["n"]) * (4 * c + c * c + c * model["num_classes"])
    return [], 2 * macs * (3 if grad else 1)
'''


@pytest.fixture
def toy_arch(tmp_path, monkeypatch):
    """A copy of ``arch/`` with the toy beside the files there, and a copy
    of the kernel names to merge the toy's into."""
    for path in arch.HERE.glob("*.py"):
        shutil.copy(path, tmp_path)
    (tmp_path / "toy.py").write_text(TOY)
    monkeypatch.setattr(arch, "HERE", tmp_path)
    monkeypatch.setattr(roofline, "KERNELS", copy.deepcopy(roofline.KERNELS))
    return dict(arch="toy", num_classes=1, channels=16,
                compute_dtype="float32")


@pytest.mark.parametrize("name", [TRAIN, "predict-plot.ptw-net-c32"])
def test_default_arch_is_ptw(name):
    model = manifest.load(name).config["model"]
    assert "arch" not in model
    default, _ = tiny.run(name)
    named, _ = tiny.run(name, model=dict(model, arch="ptw"))
    assert named["checks"] == default["checks"]
    assert named["correct"] and named["attempted"] == default["attempted"]


def test_unknown_arch_fails_at_load(tmp_path, monkeypatch):
    with pytest.raises(KeyError, match=r"no_such\.py.*'ptw\.py'"):
        arch.load({"arch": "no_such"})
    bench = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == "ptw-net-c32")
    model = json.loads((manifest.ROOT / conf["file"]).read_text())
    model["model"]["arch"] = "no_such"
    conf["file"] = "config.json"
    (tmp_path / "config.json").write_text(json.dumps(model))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(manifest, "ROOT", tmp_path)
    with pytest.raises(KeyError, match=r"no_such\.py"):
        manifest.load(TRAIN)


def test_toy_arch_train_cell_is_correct(toy_arch):
    """The sound run is correct and its traced window reads the toy's
    FLOPs; its kernel names join the roofline's, and calibration centres
    its head."""
    toy = arch.load(toy_arch)
    assert roofline.KERNELS["toy_op"] == ["toy_kernel"]
    table = plots.synthetic_plot(1, 1, 0.2)[0]
    batch = weights.calibration_batch(table, 1, 2, 2048)
    w = weights.calibrate(weights.make_weights(toy_arch, 3, "cpu"), toy_arch,
                          batch, "cpu")
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = toy.Reference(w, toy_arch).forward(b["pos"], b["refl"],
                                                b["mask"], b["sf"])
    assert abs(float(logits[b["mask"]].median())) < 1e-4
    result, checks = tiny.run(TRAIN, model=toy_arch, trace=1)
    assert result["correct"], checks
    assert result["metrics"]["mfu.train"]["value"] > 0


@pytest.mark.parametrize("mode", [dict(fault="half_batch"),
                                  dict(fault="state_unchanged"),
                                  dict(control="fp8")])
def test_toy_arch_fault_is_not_correct(toy_arch, mode):
    result, checks = tiny.run(TRAIN, model=toy_arch, **mode)
    assert not result["correct"], checks
