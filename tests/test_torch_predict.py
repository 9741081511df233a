"""The port's predict CLI (pointstowood_tpu_torch.cli.predict) against the
JAX package's, on the CPU: one synthetic dual-grid PLY and one ``.pth``
written by the JAX package's ``save_torch_checkpoint`` from seeded
weights, run through both CLIs at C=8, fp32, plain kNN, min_pts 64,
max_pts 1024. The outputs have the same columns in the same order, the
same x/y/z and extra columns bit for bit, label agreement >= 0.99 and
mean |delta pwood| <= 0.01 (the two fusions differ: the port selects
exactly, JAX at recall 0.8)."""

import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from pointstowood_tpu.cli import predict as j_cli
from pointstowood_tpu.io import read_ply as j_read_ply
from pointstowood_tpu.io import write_ply as j_write_ply
from pointstowood_tpu.utils.checkpoint_convert import save_torch_checkpoint
from pointstowood_tpu_torch.cli import predict as t_cli
from pointstowood_tpu_torch.config import ModelConfig
from pointstowood_tpu_torch.io import read_ply, write_pcd
from pointstowood_tpu_torch.predict.predicter import build_net
from pointstowood_tpu_torch.utils.checkpoint import load_checkpoint
from pointstowood_tpu_torch.utils.checkpoint_convert import build_key_map

FLAGS = ["--channels", "8", "--dtype", "float32", "--exact_knn",
         "--min_pts", "64", "--max_pts", "1024", "--batch_size", "2"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes on the host's cores at once,
    and a full team of torch intra-op threads per process makes each wait
    for cores the others hold (on the full suite this file took 239 s,
    against ~40 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tree(seed=7, n1=1500, n2=2500):
    """The verify recipe's trunk-and-crown tree, reflectance bright on
    wood, with an extra column."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n1)
    r = rng.uniform(0, 0.15, n1)
    trunk = np.stack([r * np.cos(theta), r * np.sin(theta),
                      rng.uniform(0, 6, n1)], 1)
    crown = np.stack([rng.normal(0, 1.2, n2), rng.normal(0, 1.2, n2),
                      4 + rng.normal(0, 1, n2)], 1)
    xyz = np.concatenate([trunk, crown])
    refl = np.concatenate([rng.normal(2, 0.3, n1), rng.normal(-1, 0.5, n2)])
    return pd.DataFrame({"x": xyz[:, 0] + 100, "y": xyz[:, 1] + 50,
                         "z": xyz[:, 2], "scalar_Refl": refl,
                         "return_number": rng.integers(1, 4, n1 + n2)})


def _variables(seed=0):
    """Seeded weights in the flax layout for C=8 (shapes from the port's
    Net), N(0, 0.2^2) values, running variances in [0.5, 2]."""
    shapes = {k: tuple(v.shape) for k, v in
              build_net(ModelConfig(channels=8), device="cpu")
              .state_dict().items()}
    rng = np.random.default_rng(seed)
    params, stats = {}, {}

    def put(tree, path, **leaves):
        node = tree
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node.update(leaves)

    def normal(shape):
        return (rng.normal(size=shape) * 0.2).astype(np.float32)

    for tpath, (kind, fpath) in build_key_map().items():
        w = shapes[f"{tpath}.weight"]
        if kind in ("linear", "conv1d"):
            put(params, fpath, kernel=normal((w[1], w[0])), bias=normal(w[0]))
        elif kind == "depthwise":
            put(params, fpath, dw_scale=normal(w[0]), dw_bias=normal(w[0]))
        else:
            put(params, fpath, scale=normal(w), bias=normal(w))
            put(stats, fpath, mean=normal(w),
                var=rng.uniform(0.5, 2.0, w).astype(np.float32))
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("predict")
    cloud = str(d / "tree.ply")
    j_write_ply(cloud, _tree())
    model = str(d / "model.pth")
    save_torch_checkpoint(model, _variables())
    jdir, tdir = d / "jax", d / "port"
    jdir.mkdir()
    tdir.mkdir()
    shutil.copy(cloud, jdir / "tree.ply")
    shutil.copy(cloud, tdir / "tree.ply")
    j_cli.main(["--point-cloud", str(jdir / "tree.ply"), "--model", model]
               + FLAGS)
    records = t_cli.main(["--point-cloud", str(tdir / "tree.ply"),
                          "--model", model] + FLAGS, device="cpu")
    return {"dir": d, "cloud": cloud, "model": model, "records": records,
            "jax": j_read_ply(str(jdir / "tree_ours.ply")),
            "port": read_ply(str(tdir / "tree_ours.ply"))}


def test_port_cli_matches_the_jax_cli(runs):
    want, got = runs["jax"], runs["port"]
    assert list(got) == list(want.columns) == [
        "x", "y", "z", "reflectance", "return_number", "n_z", "label",
        "pwood"]
    for c in ("x", "y", "z", "reflectance", "return_number", "n_z"):
        assert np.array_equal(got[c], want[c].to_numpy()), c
    agree = float((got["label"] == want["label"].to_numpy()).mean())
    dp = float(np.abs(got["pwood"] - want["pwood"].to_numpy()).mean())
    print(f"label agreement {agree}, mean |d pwood| {dp}")
    assert agree >= 0.99
    assert dp <= 0.01
    assert set(np.unique(got["label"])) <= {0.0, 1.0}
    assert ((got["pwood"] >= 0) & (got["pwood"] <= 1)).all()


def test_port_cli_keeps_every_row_and_reports_phases(runs):
    src = read_ply(runs["cloud"])
    out = runs["port"]
    for c in ("x", "y", "z"):
        assert np.array_equal(out[c], src[c])
    (rec,) = runs["records"]
    assert rec["points"] == len(src["x"])
    assert set(rec["seconds"]) >= {"read", "preprocess", "model",
                                   "fusion_plan", "fusion", "write"}


def test_port_cli_two_files(runs, tmp_path):
    a, b = tmp_path / "a.ply", tmp_path / "b.ply"
    shutil.copy(runs["cloud"], a)
    j_write_ply(str(b), _tree(seed=8, n1=900, n2=1200))
    records = t_cli.main(["--point-cloud", str(a), str(b),
                          "--model", runs["model"]] + FLAGS, device="cpu")
    assert [r["output"] for r in records] == [
        str(tmp_path / "a_ours.ply"), str(tmp_path / "b_ours.ply")]
    out_a = read_ply(str(tmp_path / "a_ours.ply"))
    for c, v in runs["port"].items():
        assert np.array_equal(out_a[c], v), c
    assert len(read_ply(str(tmp_path / "b_ours.ply"))["x"]) == 2100


def test_port_cli_reruns_on_its_own_output_and_reads_pcd(runs, tmp_path):
    """The output's stale label/pwood columns are dropped in predict mode
    and come back recomputed; a PCD input runs the same path."""
    shutil.copy(runs["cloud"], tmp_path / "t.ply")
    t_cli.main(["--point-cloud", str(tmp_path / "t.ply"), "--model",
                runs["model"]] + FLAGS, device="cpu")
    first = read_ply(str(tmp_path / "t_ours.ply"))
    t_cli.main(["--point-cloud", str(tmp_path / "t_ours.ply"), "--model",
                runs["model"]] + FLAGS, device="cpu")
    again = read_ply(str(tmp_path / "t_ours_ours.ply"))
    assert list(again) == list(first)
    for c in ("x", "y", "z", "n_z"):
        assert np.array_equal(again[c], first[c]), c
    src = read_ply(runs["cloud"])
    write_pcd({"x": src["x"], "y": src["y"], "z": src["z"],
               "intensity": src["scalar_Refl"]}, str(tmp_path / "p.pcd"))
    (rec,) = t_cli.main(["--point-cloud", str(tmp_path / "p.pcd"),
                         "--model", runs["model"]] + FLAGS, device="cpu")
    out = read_ply(rec["output"])
    assert list(out) == ["x", "y", "z", "reflectance", "n_z", "label",
                         "pwood"]
    assert len(out["x"]) == len(src["x"])


def test_fusion_modes(runs, tmp_path, capsys):
    """``host`` fuses alike on the dual grid; ``tpu`` on a single-scale
    tiling does what the JAX package does (predicter.py:253-270, 352-358):
    the index path, which at any-wood 1 (k = 64, more than the 32
    candidates of one scale) searches every row on the host, exactly as
    ``auto`` there (the host path)."""
    shutil.copy(runs["cloud"], tmp_path / "c.ply")
    args = ["--point-cloud", str(tmp_path / "c.ply"), "--model",
            runs["model"]] + FLAGS
    t_cli.main(args + ["--fusion", "host"], device="cpu")
    host = read_ply(str(tmp_path / "c_ours.ply"))
    assert (host["label"] == runs["port"]["label"]).mean() >= 0.98
    assert np.abs(host["pwood"] - runs["port"]["pwood"]).mean() < 0.02
    single = {}
    for mode in ("tpu", "auto"):
        capsys.readouterr()
        t_cli.main(args + ["--fusion", mode, "--grid_size", "4.0"],
                   device="cpu")
        line = [s for s in capsys.readouterr().out.splitlines()
                if s.startswith("fusion:")]
        assert len(line) == 1, line
        single[mode] = (line[0], read_ply(str(tmp_path / "c_ours.ply")))
    n = len(host["x"])
    assert single["tpu"][0].startswith("fusion: index path")
    assert f"{n} points, {n} searched on the host" in single["tpu"][0]
    assert single["auto"][0].startswith("fusion: host path")
    for c in ("label", "pwood"):
        assert np.array_equal(single["tpu"][1][c], single["auto"][1][c])


def test_cli_errors(runs, tmp_path):
    with pytest.raises(FileNotFoundError, match="Point cloud file"):
        t_cli.main(["--point-cloud", str(tmp_path / "nope.ply"),
                    "--model", runs["model"]], device="cpu")
    with pytest.raises(FileNotFoundError, match="No model"):
        t_cli.main(["--point-cloud", runs["cloud"],
                    "--model", str(tmp_path / "nope.pth")], device="cpu")
    with pytest.raises(Exception, match="no input"):
        t_cli.main(["--model", runs["model"]], device="cpu")
    msgpack = tmp_path / "model.ckpt"
    msgpack.write_bytes(b"\x80")  # an empty msgpack map: no variables
    with pytest.raises(ValueError, match="not a flax variables checkpoint"):
        t_cli.main(["--point-cloud", runs["cloud"], "--model", str(msgpack)]
                   + FLAGS, device="cpu")


def test_load_checkpoint_strips_module_prefix(runs, tmp_path):
    net = build_net(ModelConfig(channels=8), device="cpu")
    ref = load_checkpoint(runs["model"], net).state_dict()
    sd = torch.load(runs["model"], weights_only=True)["model_state_dict"]
    wrapped = str(tmp_path / "dp.pt")
    torch.save({f"module.{k}": v for k, v in sd.items()}, wrapped)
    got = load_checkpoint(wrapped, build_net(ModelConfig(channels=8),
                                             device="cpu")).state_dict()
    assert all(torch.equal(got[k], ref[k]) for k in ref)
