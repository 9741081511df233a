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


def test_forbidden_names_are_whole():
    import pointstowood_tpu_torch  # noqa: F401
    from portbench import run

    found = run.forbidden_modules()
    assert "pointstowood_tpu_torch" not in found
    assert set(found) <= set(run.FORBIDDEN)
