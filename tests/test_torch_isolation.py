"""The PyTorch port stands alone: it imports neither JAX, pandas, sklearn
nor the JAX package (the card's machine has none of them), importing it
loads no matplotlib (``tools/compare.py`` imports it optionally, inside
``main``), its entry points refuse to fall back to the CPU silently, and
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
    """jax, jaxlib, flax, optax, pandas (which the port replaces with
    column tables) and sklearn (``tools/scores.py``, ``tools/hdbscan.py``)."""
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "jaxlib", "flax", "optax", "pandas",
                           "sklearn"))


def _is_optional(name: str) -> bool:
    """matplotlib: ``tools/compare.main`` draws with it where it is
    installed, so no module may load it on import."""
    return name == "matplotlib" or name.startswith("matplotlib.")


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
    assert _is_jax("pandas") and _is_jax("pandas.core.frame")
    assert _is_jax("flax.linen") and not _is_jax("jaxtyping")
    assert _is_jax("optax") and not _is_jax("optaxx")
    assert _is_jax("sklearn.cluster") and not _is_jax("sklearnx")
    assert _is_optional("matplotlib.pyplot") and not _is_optional("matplot")
    assert not _is_jax_package("pointstowood_tpu_torch")
    assert not _is_jax_package("pointstowood_tpu_torch.ops.knn")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of the port in a fresh interpreter, then look at
    sys.modules (for jax, flax, pandas, sklearn, matplotlib and the JAX
    package)."""
    mods = _port_modules()
    assert len(mods) >= 25
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
    assert not [m for m in loaded if _is_jax(m) or _is_optional(m)]
    assert not [m for m in loaded if _is_jax_package(m)]
    assert "pointstowood_tpu_torch.predict.predicter" in loaded
    assert "pointstowood_tpu_torch.cli.predict" in loaded
    for m in ("cli.train", "train.trainer", "train.loss", "train.metrics",
              "train.schedule", "train.augmentation", "ops.sampling"):
        assert f"pointstowood_tpu_torch.{m}" in loaded
    for m in ("clustering", "collect_attribute", "compare",
              "height_normalisation", "hdbscan", "instance", "pathlength",
              "priors", "scores", "split_ply", "threshold_sweep"):
        assert f"pointstowood_tpu_torch.tools.{m}" in loaded


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
    from pointstowood_tpu_torch.ops.interp_kernels import (
        interp_blend,
        interp_blend_bwd,
    )
    from pointstowood_tpu_torch.ops.knn_kernels import (
        knn_top2,
        knn_topk,
        knn_topk_dim,
        knn_topk_dim_survivors,
    )

    r = torch.zeros((1, 8, 3), device="meta")
    m = torch.ones((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError):
        knn_topk(r, r, m, 4)
    with pytest.raises(RuntimeError):
        knn_top2(r, r, m)
    r_dim = torch.zeros((1, 8, 263), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        knn_topk_dim(r_dim, r_dim, m, 4)
    with pytest.raises(RuntimeError, match="no kernel"):
        knn_topk_dim_survivors(r_dim, r_dim, m, 4)
    with pytest.raises(RuntimeError):
        interp_blend(torch.zeros((1, 8, 8), device="meta"),
                     torch.zeros((1, 8, 2), dtype=torch.int32, device="meta"),
                     torch.zeros((1, 8, 2), device="meta"), m)
    with pytest.raises(RuntimeError, match="no kernel"):
        interp_blend_bwd(torch.zeros((1, 8, 8), device="meta"),
                         torch.zeros((1, 8, 2), dtype=torch.int32,
                                     device="meta"),
                         torch.zeros((1, 8, 2), device="meta"), m, 8)


def test_pair_select_never_runs_plain_on_non_cpu_tensors():
    from pointstowood_tpu_torch.ops.fusion_kernels import pair_select

    def meta(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    with pytest.raises(RuntimeError, match="no kernel"):
        pair_select(meta((2, 16, 3)), meta((2,), torch.int32),
                    meta((40, 3)), meta((40,), torch.int32),
                    meta((2, 4), torch.int32), 32)


def _tiny_plot():
    import numpy as np

    rng = np.random.default_rng(0)
    xyz = rng.uniform(0, 4, (600, 3))
    return {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "reflectance": rng.normal(size=600)}


def test_serving_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """semantic_segmentation, fuse_on_device and the CLI's main default to
    CUDA and raise without it; with device="cpu" they run."""
    import numpy as np

    from pointstowood_tpu_torch.cli import predict as cli
    from pointstowood_tpu_torch.config import (
        ModelConfig,
        PredictConfig,
        TilingConfig,
    )
    from pointstowood_tpu_torch.data.tiling import preprocess_cloud
    from pointstowood_tpu_torch.io import write_ply
    from pointstowood_tpu_torch.predict import device_fusion, predicter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pc = _tiny_plot()
    cfg = TilingConfig(grid_size=(2.0, 4.0), min_pts=32, max_pts=256)
    tiles = preprocess_cloud(pc, cfg)
    batcher = predicter.tile_batcher(tiles, PredictConfig(), cfg)
    sink = device_fusion.sink_for(tiles, batcher, "cpu")
    for _, batch, _ in batcher:
        sink.write(torch.from_numpy(batch.pos), batch.shift,
                   torch.full(batch.mask.shape, 0.5))
    xyz = np.stack([pc["x"], pc["y"], pc["z"]], 1)
    plan = device_fusion.plan_fusion(tiles, xyz, 32, sink.layout)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_fusion.fuse_on_device(plan, sink.arrays(), xyz, 0.5, 1.0)
    fused = device_fusion.fuse_on_device(plan, sink.arrays(), xyz, 0.5, 1.0,
                                         device="cpu")
    assert fused.shape == (600, 2)
    net = predicter.build_net(ModelConfig(channels=8), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        predicter.semantic_segmentation(pc, tiles, net, PredictConfig(), cfg)
    write_ply(str(tmp_path / "p.ply"), pc)
    torch.save({"model_state_dict": net.state_dict()},
               str(tmp_path / "m.pth"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--point-cloud", str(tmp_path / "p.ply"),
                  "--model", str(tmp_path / "m.pth")])


def test_device_tools_raise_without_cuda(monkeypatch, tmp_path):
    """threshold_sweep (main and sweep) and geometric_priors default to
    CUDA and raise without it; with device="cpu" they run."""
    import numpy as np

    from pointstowood_tpu_torch.io import write_ply
    from pointstowood_tpu_torch.tools import priors, threshold_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pc = _tiny_plot()
    write_ply(str(tmp_path / "p.ply"), pc)
    with pytest.raises(RuntimeError, match="CUDA"):
        threshold_sweep.main([str(tmp_path / "p.ply"), "--model",
                              str(tmp_path / "m.pth")])
    classified = np.concatenate(
        [np.stack([pc["x"], pc["y"], pc["z"]], 1), np.zeros((600, 1)),
         np.full((600, 1), 0.7)], 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(threshold_sweep.sweep(classified, pc, [0.5]))
    _, labels = next(threshold_sweep.sweep(classified, pc, [0.5],
                                           device="cpu"))
    assert (labels[:, 0] == 1).all()
    xyz = np.stack([pc["x"], pc["y"], pc["z"]], 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        priors.geometric_priors(xyz, k=8)
    assert priors.geometric_priors(xyz, k=8, device="cpu").shape == (600,)


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """semantic_training, build_train_net and the train CLI's main default
    to CUDA and raise without it, before any work is done."""
    import numpy as np

    from pointstowood_tpu_torch.cli import train as cli
    from pointstowood_tpu_torch.config import (
        ModelConfig,
        TilingConfig,
        TrainConfig,
    )
    from pointstowood_tpu_torch.data.tiling import Tile
    from pointstowood_tpu_torch.train import trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).normal(size=(300, 5)).astype(np.float32)
    tiles = [Tile(points=pts, grid_size=4.0)]
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.semantic_training(tiles, TrainConfig(),
                                  ModelConfig(channels=8), TilingConfig(),
                                  wdir=str(tmp_path), log_fn=lambda s: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.build_train_net(ModelConfig(channels=8), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--wdir", str(tmp_path)])
    assert not (tmp_path / "model").exists()
    assert cli.parse_args([]).device == "cuda"
    net = trainer.build_train_net(ModelConfig(channels=8), 0, device="cpu")
    assert next(net.parameters()).device.type == "cpu"


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
