"""Two processes of the port's CLIs, after tests/test_multihost.py: the
train CLI, then the predict CLI, each launched with the JAX package's
variables (``PTW_COORDINATOR_ADDRESS``, ``PTW_NUM_PROCESSES=2``,
``PTW_PROCESS_ID``) on the CPU, joined over gloo by
``maybe_init_distributed`` (the bootstrap both CLIs call first).

Asserted: both processes train the same model (identical history rows)
and the loss falls; both label the same cloud alike (identical label and
pwood columns); the checkpoints, the history and the labelled PLY exist
in process 0's working directory only. The worker below is this file run
as a script: ``python tests/test_torch_multihost.py <wdir> <wdir of
process 0>``.

The file also holds the cases of tests/test_torch_parallel.py and the
worker its two spawned processes run (``_rank_main``): this file imports
no JAX, so a spawned process imports only the port.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import seeded_flax_variables
from pointstowood_tpu_torch import config as t_config
from pointstowood_tpu_torch.data.tiling import Tile
from pointstowood_tpu_torch.model import Net as TNet
from pointstowood_tpu_torch.model import network as t_network
from pointstowood_tpu_torch.model.layers import (
    MaskedBatchNorm,
    set_data_group,
)
from pointstowood_tpu_torch.ops import sampling as t_sampling
from pointstowood_tpu_torch.parallel import mesh as t_mesh
from pointstowood_tpu_torch.predict import device_fusion
from pointstowood_tpu_torch.predict import predicter as t_predicter
from pointstowood_tpu_torch.train import trainer as t_trainer
from pointstowood_tpu_torch.utils.checkpoint_convert import (
    state_dict_from_flax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _worker(wdir: str, primary_wdir: str) -> None:
    """One process: the train CLI on ``wdir``, then the predict CLI on its
    copy of the cloud with process 0's model; prints one RESULT line."""
    import torch.distributed as dist

    from pointstowood_tpu_torch.cli import predict, train
    from pointstowood_tpu_torch.io import write_ply
    from pointstowood_tpu_torch.predict import predicter

    torch.set_num_threads(1)
    os.makedirs(os.path.join(wdir, "data", "train"))
    cloud = _toy_tree()
    write_ply(os.path.join(wdir, "data", "train", "tree_train.ply"), cloud)
    history = train.main([
        "--wdir", wdir, "--preprocess", "--num_epochs", "2",
        "--batch_size", "2", "--min_pts", "32", "--max_pts", "512",
        "--grid_size", "4.0", "--model", "m.pth", "--channels", str(C),
        "--dtype", "float32"], device="cpu")
    rank = dist.get_rank()
    # process 0 writes the model; the others read it once it is there
    dist.barrier()
    plot = os.path.join(wdir, "plot.ply")
    write_ply(plot, {k: v for k, v in cloud.items() if k != "truth"})
    tables = []
    real = predicter.semantic_segmentation

    def recording(*a, **k):
        tables.append(real(*a, **k))
        return tables[-1]

    predicter.semantic_segmentation = recording
    predict.main(["--point-cloud", plot, "--model",
                  os.path.join(primary_wdir, "model", "m.pth"),
                  "--channels", str(C), "--dtype", "float32",
                  "--min_pts", "64", "--max_pts", "1024"], device="cpu")
    out = tables[0]
    digest = hashlib.sha256(np.stack([out["label"], out["pwood"]]).astype(
        np.float64).tobytes()).hexdigest()
    files = {
        "ckpt": os.path.exists(os.path.join(wdir, "model", "m.pth")),
        "history": os.path.exists(os.path.join(wdir, "model",
                                               "m_history.csv")),
        "epoch_ckpt": os.path.exists(os.path.join(wdir, "checkpoints",
                                                  "epoch_2.pth")),
        "ply": os.path.exists(os.path.join(wdir, "plot_ours.ply")),
    }
    print("RESULT " + json.dumps({
        "rank": rank, "world": dist.get_world_size(),
        "history": np.asarray(history).tolist(), "digest": digest,
        "rows": len(out["label"]), "wood": float(np.mean(out["label"])),
        "files": files}), flush=True)


# ------- the data-parallel cases of tests/test_torch_parallel.py: their
# inputs, each case's run, and the worker its two spawned processes run.
# They live in this file, which imports no JAX, so that a spawned process
# imports only the port.

C = 8
LR = 1e-3
N = 256
WORLD = 2
NET_KW = dict(channels=C, k=32, knn_method="exact", voxel_priority="last")
_KW = dict(grid_size=(2.0, 4.0), min_pts=64, max_pts=4096)


def _cloud(n=6000, seed=0):
    """tests/test_torch_fusion.py's trunk-and-crown cloud."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n // 3)
    r = rng.uniform(0, 0.2, n // 3)
    trunk = np.stack([3 + r * np.cos(theta), 3 + r * np.sin(theta),
                      rng.uniform(0, 5, n // 3)], 1)
    crown = np.stack([3 + rng.normal(0, 1.2, n - n // 3),
                      3 + rng.normal(0, 1.2, n - n // 3),
                      4 + rng.normal(0, 0.8, n - n // 3)], 1)
    xyz = np.concatenate([trunk, crown])
    return {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "reflectance": rng.normal(size=n)}


def _field(xyz):
    """tests/test_torch_fusion.py's probability field: wood near the
    trunk axis."""
    return 1 / (1 + np.exp((np.linalg.norm(xyz[:, :2] - 3.0, axis=1) - 0.4)
                           * 4))


def _step_inputs(seed=5, b=2, n=512):
    """tests/test_torch_train.py's sparse 0.6 m tiles; the last sample is
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


def _port_rule(mask, capacity, generator, fraction=0.5, group=None):
    """tests/test_torch_train.py's centre rule (the first floor(n_valid /
    2) valid points by a fixed numpy score, the rule its ``_jax_rule``
    gives the JAX package); a row's centres depend on that row alone."""
    n = mask.shape[1]
    scores = np.random.default_rng(1000 + n).random(n).astype(np.float32)
    n_take = torch.clamp((mask.sum(-1) * fraction).long(), max=capacity)
    score = torch.where(mask, torch.from_numpy(scores), torch.inf)
    order = torch.argsort(score, dim=-1, stable=True)
    select = torch.zeros_like(mask).scatter(
        1, order, torch.arange(n) < n_take[:, None])
    return t_sampling.compact_indices(select, capacity)


def _bn_inputs(all_padding_rank: bool):
    """A (4, 24, 16) batch with 1e30 garbage in the padding: rows 2-3 (the
    second process's) all padding, or every row partly valid."""
    rng = np.random.default_rng(23 + all_padding_rank)
    x = (rng.normal(size=(4, 24, 16)) * 2 + 0.5).astype(np.float32)
    mask = rng.random((4, 24)) < 0.7
    if all_padding_rank:
        mask[2:] = False
    x[~mask] = 1e30
    ct = rng.normal(size=x.shape).astype(np.float32)
    state = {"weight": 1 + 0.1 * rng.normal(size=16),
             "bias": 0.1 * rng.normal(size=16),
             "running_mean": 0.1 * rng.normal(size=16),
             "running_var": rng.uniform(0.5, 2.0, 16)}
    return x, mask, ct, {k: torch.tensor(v, dtype=torch.float32)
                         for k, v in state.items()}


def _bn_run(x, mask, ct, state, group=None):
    """Output, input gradient, parameter gradients and running statistics
    of one batch-statistic MaskedBatchNorm call."""
    mod = MaskedBatchNorm(16)
    mod.load_state_dict(state, strict=False)
    mod.data_group = group
    xt = torch.from_numpy(x).requires_grad_()
    mt = torch.from_numpy(mask)
    y = mod(xt, mt, False)
    (torch.where(mt[..., None], y, 0.0) * torch.from_numpy(ct)).sum() \
        .backward()
    return {"y": torch.where(mt[..., None], y.detach(), 0.0),
            "x_grad": xt.grad, "weight_grad": mod.weight.grad,
            "bias_grad": mod.bias.grad,
            "running_mean": mod.running_mean.clone(),
            "running_var": mod.running_var.clone()}


def _sample_inputs():
    mask = torch.zeros((4, 300), dtype=torch.bool)
    mask[0] = True
    mask[1, :123] = True
    mask[2, ::7] = True
    # row 3: an all-padding tile
    return mask


def _sample_run(mask, group=None):
    gen = torch.Generator().manual_seed(31)
    return [t_sampling.random_sample(mask, 150, gen, group=group)
            for _ in range(3)]


def _train_inputs():
    """tests/test_torch_train.py's sparse tiles, four of them; the last
    (the second process's last row) all padding."""
    xyz, refl, mask, sf, labels = _step_inputs(seed=5, b=4, n=N)
    mask[3] = False
    xyz[3] = 0.0
    sf[3] = 1.0
    return xyz, refl, mask, sf, labels


def _train_run(inputs, rule=None, group=None):
    """One port train step from seeded weights: loss, counts, finite, the
    gradients the clip saw (summed over the group), the state after the
    step, the state before it. ``rule`` replaces ``random_sample``."""
    net = TNet(**NET_KW)
    net.load_state_dict(state_dict_from_flax(seeded_flax_variables(net, 7)))
    set_data_group(net, group)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    cfg = t_config.TrainConfig(learning_rate=LR)
    raw = {}
    saved_clip, saved_rule = (t_trainer.clip_by_global_norm_,
                              t_network.random_sample)

    def recording_clip(grads, max_norm):
        raw["grads"] = [g.clone() for g in grads]
        return saved_clip(grads, max_norm)

    try:
        t_trainer.clip_by_global_norm_ = recording_clip
        if rule is not None:
            t_network.random_sample = rule
        opt = t_trainer.make_optimizer(net, cfg)
        step = t_trainer.make_train_step(net, opt, cfg, group)
        args = [torch.from_numpy(np.ascontiguousarray(a))
                for a in t_mesh.shard_rows(group, *inputs)]
        loss, counts, finite = step(*args, LR,
                                    torch.Generator().manual_seed(11))
    finally:
        t_trainer.clip_by_global_norm_ = saved_clip
        t_network.random_sample = saved_rule
    names = [n for n, _ in net.named_parameters()]
    return {"loss": float(loss), "counts": counts.clone(), "finite": finite,
            "grads": dict(zip(names, raw["grads"])),
            "state": {k: v.clone() for k, v in net.state_dict().items()},
            "before": before}


def _infer_tiles():
    rng = np.random.default_rng(141190)
    return [Tile(points=rng.normal(size=(n, 4)).astype(np.float32),
                 grid_size=2.0)
            for n in (100, 150, 200, 120, 180, 90, 240, 110, 130)]


def _infer_run(group=None):
    model_cfg = t_config.ModelConfig(channels=C, compute_dtype="float32",
                                     knn_mode="exact")
    net = t_predicter.build_net(model_cfg, device="cpu")
    net.load_state_dict(state_dict_from_flax(seeded_flax_variables(net, 3)))
    return t_predicter.run_inference(
        _infer_tiles(), net, t_config.PredictConfig(batch_size=3),
        t_config.TilingConfig(grid_size=(2.0,), min_pts=64, max_pts=256),
        device="cpu", group=group)


def _fuse_scene():
    from pointstowood_tpu_torch.data.tiling import preprocess_cloud
    from pointstowood_tpu_torch.io.loader import canonicalize_columns

    pc, _, _ = canonicalize_columns(_cloud(), mode="predict")
    tiles = preprocess_cloud(pc, t_config.TilingConfig(**_KW))
    predict_cfg = t_config.PredictConfig(batch_size=4)
    order = t_predicter.tile_batcher(
        tiles, predict_cfg, t_config.TilingConfig(**_KW)).tile_order()
    probs = _field(np.concatenate([tiles[t].points[:, :3] for t in order]))
    query_xyz = np.stack([pc[c] for c in ("x", "y", "z")], 1)
    layout = device_fusion.layout_tight(tiles, order)
    plan = device_fusion.plan_fusion(tiles, query_xyz, _KW["min_pts"],
                                     layout)
    resident = device_fusion.resident_tight(tiles, order, layout, probs,
                                            "cpu")
    return tiles, query_xyz, plan, resident


def _fuse_run(group=None):
    _, query_xyz, plan, resident = _fuse_scene()
    real = device_fusion.pair_select
    entries = []

    def counting(queries, *a, **k):
        entries.append(queries.shape[0])
        return real(queries, *a, **k)

    device_fusion.pair_select = counting
    try:
        out = device_fusion.fuse_on_device(plan, resident, query_xyz, 0.5,
                                           1.0, device="cpu", group=group)
    finally:
        device_fusion.pair_select = real
    return {"fused": out, "entries": sum(entries),
            "n_entries": int(plan.q_len.size)}


# ----------------------------------------------------- the two processes


def _rank_main(rank, port, out_dir):
    """One of the two gloo processes: every sharded case of this file on
    its rows, results saved to ``out_dir/rank<r>.pt``."""
    import torch.distributed as dist

    # this file's thread count: a BLAS may split a product's sums by it
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    try:
        group = t_mesh.data_group()
        assert group is not None and group.rank == rank
        res = {}
        for pad in (False, True):
            x, mask, ct, state = _bn_inputs(pad)
            xs, ms, cts = t_mesh.shard_rows(group, x, mask, ct)
            out = _bn_run(np.ascontiguousarray(xs), np.ascontiguousarray(ms),
                          np.ascontiguousarray(cts), state, group)
            for k in ("weight_grad", "bias_grad"):
                t_mesh.all_reduce_sum_(group, out[k])
            res[f"bn{int(pad)}"] = out
        res["sample"] = _sample_run(
            t_mesh.shard_rows(group, _sample_inputs())[0], group)
        inputs = _train_inputs()
        res["train"] = _train_run(inputs, group=group)
        res["train_rule"] = _train_run(inputs, rule=_port_rule, group=group)
        res["infer"] = _infer_run(group)
        res["fuse"] = _fuse_run(group)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_train_and_predict_clis(tmp_path):
    port = _free_port()
    wdirs = [str(tmp_path / f"proc{i}") for i in range(2)]
    procs = []
    for i, wdir in enumerate(wdirs):
        env = dict(os.environ, PTW_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   PTW_NUM_PROCESSES="2", PTW_PROCESS_ID=str(i),
                   PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), wdir, wdirs[0]],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=600)[0])
        finally:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
    res = {}
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, f"no RESULT line in:\n{out}"
        r = json.loads(line[-1][len("RESULT "):])
        res[r["rank"]] = r
    assert set(res) == {0, 1} and res[0]["world"] == 2
    assert "Training data-parallel over 2 processes" in outs[0]
    # one model: the same history rows on both processes, and a falling
    # loss on the toy problem
    assert res[0]["history"] == res[1]["history"]
    hist = np.asarray(res[0]["history"])
    assert hist.shape[0] == 2 and hist[-1, 2] < hist[0, 2]
    # the same labelled cloud on both processes
    assert res[0]["digest"] == res[1]["digest"]
    assert res[0]["rows"] == res[1]["rows"] == 2000
    # process 0 alone writes
    assert all(res[0]["files"].values()), res[0]["files"]
    assert not any(res[1]["files"].values()), res[1]["files"]


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
