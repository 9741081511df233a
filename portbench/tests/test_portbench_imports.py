"""What the harness loads: never JAX or the JAX package (top-level names
compared whole), and the reference nothing of the program."""

import subprocess
import sys

from portbench.manifest import ROOT

PROBE = """
import sys
sys.path.insert(0, {root!r})
{imports}
names = sorted({{m.split('.')[0] for m in sys.modules}})
print(' '.join(names))
"""


def _loaded(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(
        root=str(ROOT), imports=imports)], capture_output=True, text=True,
        check=True, env={"PATH": "/usr/bin:/bin"})
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    names = _loaded("import portbench.run, portbench.harness\n"
                    "import portbench.kinds.predict, portbench.kinds.train\n"
                    "from pointstowood_tpu_torch.cli import predict, train")
    assert "pointstowood_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "pointstowood_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = _loaded("import portbench.reference.net, portbench.reference.train\n"
                    "import portbench.reference.tiling, portbench.reference.fusion")
    assert not names & {"pointstowood_tpu_torch", "pointstowood_tpu", "jax"}


ARCH_REFERENCES = """
import json
import torch
from portbench import arch, manifest, plots, weights
from portbench.reference.train import Trainer

torch.set_num_threads(2)
bench = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
table = plots.synthetic_plot(1, 1, 0.2)[0]
batch = weights.calibration_batch(table, 1, 1, 2048)
batch = {k: torch.from_numpy(v) for k, v in batch.items()}
batch["labels"] = (batch["refl"] > 0).float()
for conf in bench["configs"]:
    model = json.loads((manifest.ROOT / conf["file"]).read_text())["model"]
    model = dict(model, channels=8)
    ref = arch.load(model).Reference
    assert ref.__module__.startswith("portbench.reference."), ref.__module__
    w = weights.calibrate(weights.make_weights(model, 1, "cpu"), model,
                          {k: v.numpy() for k, v in batch.items()}, "cpu")
    Trainer(w, model, "cpu").step(batch, 1e-4,
                                  torch.Generator().manual_seed(1))
"""


def test_references_of_the_benchmarks_architectures_load_nothing_of_the_program():
    """Each configuration's architecture is loaded and its plain
    ``Reference`` (a module of ``portbench.reference``) calibrates the
    weights and takes one training step; nothing of the program or of
    JAX is loaded on the way, lazily inside a function included."""
    names = _loaded(ARCH_REFERENCES)
    assert "portbench" in names
    assert not names & {"pointstowood_tpu_torch", "pointstowood_tpu", "jax"}


def test_forbidden_names_are_whole():
    import pointstowood_tpu_torch  # noqa: F401
    from portbench import run

    found = run.forbidden_modules()
    assert "pointstowood_tpu_torch" not in found
    assert set(found) <= set(run.FORBIDDEN)
