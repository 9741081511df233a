"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU silently, and
``chip_smoke.py`` fails without a card or without the repo around it."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "pointstowood_tpu_torch"


def _is_jax_package(name: str) -> bool:
    # "pointstowood_tpu_torch".startswith("pointstowood_tpu") is true, so
    # match the JAX package's name exactly or as a dotted prefix
    return name == "pointstowood_tpu" or name.startswith("pointstowood_tpu.")


def _is_jax(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "jaxlib" \
        or name.startswith("jaxlib.") or name == "flax" \
        or name.startswith("flax.")


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_prefix_matcher():
    assert _is_jax_package("pointstowood_tpu")
    assert _is_jax_package("pointstowood_tpu.ops.knn")
    assert not _is_jax_package("pointstowood_tpu_torch")
    assert not _is_jax_package("pointstowood_tpu_torch.ops.knn")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of the port in a fresh interpreter, then look at
    sys.modules."""
    mods = _port_modules()
    assert len(mods) >= 15
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    import json

    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if _is_jax(m)]
    assert not [m for m in loaded if _is_jax_package(m)]
    assert "pointstowood_tpu_torch.predict.predicter" in loaded


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_import(path):
    """Also catches imports inside functions, which the import test above
    does not execute."""
    bad = [n for n in _imports(path) if _is_jax(n) or _is_jax_package(n)]
    assert not bad, bad


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from pointstowood_tpu_torch.config import (
        ModelConfig,
        PredictConfig,
        TilingConfig,
    )
    from pointstowood_tpu_torch.data.tiling import Tile
    from pointstowood_tpu_torch.predict import predicter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        predicter.build_net(ModelConfig(channels=8))
    net = predicter.build_net(ModelConfig(channels=8), device="cpu")
    assert next(net.parameters()).device.type == "cpu"
    tiles = [Tile(points=torch.rand(300, 4).numpy(), grid_size=4.0)]
    with pytest.raises(RuntimeError, match="CUDA"):
        predicter.run_inference(tiles, net, PredictConfig(), TilingConfig())


def test_kernel_wrappers_never_run_plain_on_cuda_tensors():
    """A wrapper runs its plain version only for CPU tensors: any other
    device takes the kernel path (here: meta tensors, which raise)."""
    from pointstowood_tpu_torch.ops.interp_kernels import interp_blend
    from pointstowood_tpu_torch.ops.knn_kernels import knn_top2, knn_topk

    r = torch.zeros((1, 8, 3), device="meta")
    m = torch.ones((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError):
        knn_topk(r, r, m, 4)
    with pytest.raises(RuntimeError):
        knn_top2(r, r, m)
    with pytest.raises(RuntimeError):
        interp_blend(torch.zeros((1, 8, 8), device="meta"),
                     torch.zeros((1, 8, 2), dtype=torch.int32, device="meta"),
                     torch.zeros((1, 8, 2), device="meta"), m)


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    """Alone in a directory, even where a card is reported, the script
    cannot import the port and exits non-zero with no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "No module named 'pointstowood_tpu_torch'" in out.stderr
    assert '"ok"' not in out.stdout
