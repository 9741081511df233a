#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pointstowood_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failed check raises, so the script
exits non-zero and prints no final line):

1. device   -- card name and power limit (nvidia-smi), torch/CUDA versions;
               TF32 is switched off for matrix products and convolutions.
2. build    -- nvcc builds every kernel of ``pointstowood_tpu_torch/csrc``
               for sm_90a (one nvcc per source, all started together).
3. kernel   -- each forward kernel at the shapes the canonical eval forward
               (B=8 tiles x 16384 points, C=32, bf16, fast kNN) gives it,
               held against its plain PyTorch version on the same CUDA
               inputs, with its time, the plain version's time, a one-call
               PyTorch yardstick where one exists, and its bound.
4. forward  -- ``run_inference`` over a synthetic plot (8 full 16384-point
               tiles and a few smaller ones, two capacity buckets) with
               seeded random weights loaded through ``state_dict_from_flax``;
               every forward kernel's launch counter must grow during that
               run. Then the median forward time of one B=8 x 16384 batch,
               and (phase ``profile``) that forward's device time by
               kernel name under torch.profiler, with its idle share.
5. crosscheck -- one full tile through the port on the CPU (plain versions)
               and on the card (kernels): labels and probabilities agree.
6. predict  -- the serving path: a synthetic ~1.2 M-point plot of trees
               over ground is written as PLY under ``build/`` and run
               through ``cli.predict.main`` with the default flags (dual
               2 m / 4 m grid, max_pts 16384, bf16, fast kNN, any-wood 1,
               fusion auto) and a seeded ``.pth``. Every row comes back
               with x/y/z bit-identical, labels in {0, 1}, pwood on the
               1/2046 grid, and all four kernels' launch counters grew.
               Per-phase wall times, points per second, peak memory.
7. kernel (pair_select) -- the fusion kernel on the plot's real entries,
               over the flat arrays the CLI builds (its batcher, FlatSink
               layout and fusion plan), for k_out 64 and 32, with a
               structured probability field (a sigmoid of the distance to
               the trunk axes) written through ``FlatSink.write``; held
               bit for bit against ``pair_select_plain``; times, bound and
               a yardstick over every entry.
8. fusion_crosscheck -- ``fuse_on_device`` on those arrays against the
               host path (exact scipy kNN + median/vote over the tiles'
               own points and the field there) on a seeded sample of
               50 000 query rows.
9. kernel (interp_blend_bwd) -- the interpolation backward kernel at the
               train shapes (B=8, C=512, bf16, random 50% centres): FP3
               4096 <- 2048 on the fused route's top-2, FP2 8192 <- 4096
               and FP1 16384 <- 8192 on the SA transpose neighbours; held
               against ``blend_bwd_plain`` within one bf16 step (the fp32
               sums run in atomic order); time, bound, plain version, and
               one ``index_add_`` of the pre-weighted rows as yardstick.
10. train_crosscheck -- one fp32 train step (fast kNN, centres supplied)
               on one full 16384-point tile on the CPU (plain versions) and
               on the card (kernels; FP3 fused, so the backward kernel runs
               at both of its routes): loss, logits, every gradient and the
               new BatchNorm statistics agree within
               ``CROSSCHECK_TOLERANCES``.
11. train_step -- ten train steps of B=8 x 16384, C=32, bf16, fast kNN with
               seeded weights and labels: median step time, split into
               forward, backward and optimizer; points/s; peak memory;
               every train-path kernel's launch counter must grow (the
               backward's included). Then (phase ``train_profile``) one
               step's device time by kernel family under torch.profiler,
               with its idle share.
12. train    -- ``cli.train.main`` with the default flags and 2 epochs on a
               labelled synthetic plot of another seed (truth: the trunk
               points); the loss is finite and falls from epoch 1 to 2,
               and ``cli.predict.main`` serves the trained ``.pth`` on the
               predict phase's plot, scored by balanced accuracy.
13. the ``{"kernels": [...]}`` line (every CUDA kernel's rows), then the
   card's nvidia-smi line, then the final ``{"ok": true, "device":
   {...}}`` line.

A copy of every printed record goes to ``build/chip_smoke.json``.
The script imports nothing of JAX, nothing of pandas and nothing of the
JAX package.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 141190

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM3 bandwidth. The bound of a kernel is the larger of its
# operations over the first and its bytes over the second.
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

RECORDS: list[dict] = []


def emit(phase: str, **fields) -> dict:
    rec = {"phase": phase, **fields}
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)
    return rec


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops = ops / FP32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------- data


def synthetic_tiles(seed: int):
    """A plot of trunk + crown trees, one tree per 4 m tile: eight full
    16384-point tiles and four of 4500-6000 points (a second capacity
    bucket). Points are float32 [x, y, z, reflectance]; wood (trunk) is
    bright, leaves dark, as in the repo's verify recipe."""
    from pointstowood_tpu_torch.data.tiling import Tile

    rng = np.random.default_rng(seed)
    sizes = [16384] * 8 + [6000, 5500, 5000, 4500]
    tiles = []
    for i, n in enumerate(sizes):
        ox, oy = 100.0 + 4.0 * (i % 4), 50.0 + 4.0 * (i // 4)
        n_trunk = n // 3
        theta = rng.uniform(0, 2 * np.pi, n_trunk)
        r = rng.uniform(0, 0.15, n_trunk)
        trunk = np.stack([ox + 2 + r * np.cos(theta),
                          oy + 2 + r * np.sin(theta),
                          rng.uniform(0, 4, n_trunk)], 1)
        n_crown = n - n_trunk
        crown = np.stack([ox + 2 + rng.normal(0, 0.8, n_crown),
                          oy + 2 + rng.normal(0, 0.8, n_crown),
                          3 + rng.normal(0, 0.5, n_crown)], 1)
        crown = np.clip(crown, [ox, oy, 0], [ox + 3.99, oy + 3.99, 3.99])
        refl = np.concatenate([rng.normal(2, 0.3, n_trunk),
                               rng.normal(-1, 0.5, n_crown)])
        pts = np.concatenate([np.concatenate([trunk, crown]),
                              refl[:, None]], 1).astype(np.float32)
        tiles.append(Tile(points=pts[rng.permutation(n)], grid_size=4.0,
                          cell_id=i))
    return tiles


def seeded_flax_variables(net, seed: int) -> dict:
    """Random weights in the JAX package's variable layout (nested dicts of
    numpy arrays), shaped from the port's own modules: He-scaled linear
    kernels, BatchNorm statistics near identity."""
    from pointstowood_tpu_torch.utils.checkpoint_convert import build_key_map

    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    params: dict = {}
    stats: dict = {}

    def put(tree, path, **leaves):
        node = tree
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node.update(leaves)

    def normal(shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    for tpath, (kind, fpath) in build_key_map().items():
        w = shapes[f"{tpath}.weight"]
        if kind in ("linear", "conv1d"):
            n_out, n_in = w[0], w[1]
            put(params, fpath, kernel=normal((n_in, n_out), np.sqrt(2 / n_in)),
                bias=normal((n_out,), 0.05))
        elif kind == "depthwise":
            put(params, fpath, dw_scale=1 + normal((w[0],), 0.1),
                dw_bias=normal((w[0],), 0.05))
        else:
            put(params, fpath, scale=1 + normal(w, 0.1), bias=normal(w, 0.1))
            put(stats, fpath, mean=normal(w, 0.1),
                var=rng.uniform(0.5, 2.0, w).astype(np.float32))
    return {"params": params, "batch_stats": stats}


def stage_geometry(net, pos, mask):
    """(positions, mask) of every level of the forward: the input points
    and the voxel-sampled centres of SA1-SA3, as the Net samples them."""
    from pointstowood_tpu_torch.model.pointconv import gather_rows
    from pointstowood_tpu_torch.ops.voxel import (
        voxel_cell_ids,
        voxel_representatives,
    )

    levels = [(pos, mask)]
    caps = net.capacities(pos.shape[1])
    for cap, res in zip(caps, net.sa_resolutions):
        p, m = levels[-1]
        ids = voxel_cell_ids(p, res, mask=m)
        cidx, cval = voxel_representatives(ids, cap, mask=m,
                                           priority=net.voxel_priority)
        levels.append((gather_rows(p, cidx).contiguous(), cval))
    return levels


# ---------------------------------------------------------------- the plot


def synthetic_plot(seed: int, n_side: int = 6):
    """A plot of n_side x n_side trees (trunk + crown) on a jittered 4 m
    grid over a ground layer, as a column table {x, y, z, intensity}; wood
    (trunk) is bright, leaves dark, ground in between. n_side = 6: 24 m x
    24 m, about 1.2 M points. Also returns the trunk axes' (x, y) and the
    truth: True for trunk points (wood)."""
    rng = np.random.default_rng(seed)
    cols, refl, axes, wood = [], [], [], []
    side = 4.0 * n_side
    for i in range(n_side * n_side):
        cx = 2.0 + 4.0 * (i % n_side) + rng.uniform(-0.8, 0.8)
        cy = 2.0 + 4.0 * (i // n_side) + rng.uniform(-0.8, 0.8)
        axes.append((cx, cy))
        h = rng.uniform(8.0, 14.0)
        r0 = rng.uniform(0.1, 0.25)
        n_trunk, n_crown = 9000, 20000
        theta = rng.uniform(0, 2 * np.pi, n_trunk)
        r = r0 + rng.normal(0, 0.01, n_trunk)
        cols.append(np.stack([cx + r * np.cos(theta), cy + r * np.sin(theta),
                              rng.uniform(0, h, n_trunk)], 1))
        refl.append(rng.normal(2, 0.3, n_trunk))
        wood.append(np.ones(n_trunk, bool))
        cols.append(np.stack([cx + rng.normal(0, 1.4, n_crown),
                              cy + rng.normal(0, 1.4, n_crown),
                              h - 2 + rng.normal(0, 1.2, n_crown)], 1))
        refl.append(rng.normal(-1, 0.5, n_crown))
        wood.append(np.zeros(n_crown, bool))
    n_ground = int(130000 * (n_side / 6) ** 2)
    cols.append(np.stack([rng.uniform(0, side, n_ground),
                          rng.uniform(0, side, n_ground),
                          rng.normal(0, 0.05, n_ground)], 1))
    refl.append(rng.normal(0.5, 0.5, n_ground))
    wood.append(np.zeros(n_ground, bool))
    xyz = np.concatenate(cols)
    perm = rng.permutation(len(xyz))
    xyz, refl = xyz[perm], np.concatenate(refl)[perm]
    wood = np.concatenate(wood)[perm]
    table = {"x": xyz[:, 0] + 500.0, "y": xyz[:, 1] + 300.0,
             "z": xyz[:, 2] + 20.0, "intensity": refl}
    trunks = np.asarray(axes) + np.array([500.0, 300.0])
    return table, trunks, wood


def trunk_field(xyz: np.ndarray, trunks: np.ndarray) -> np.ndarray:
    """Structured wood probability: a sigmoid of the horizontal distance
    to the nearest trunk axis (as tests/test_tpu_fusion.py builds it), so
    both classes and a sharp boundary appear."""
    from scipy.spatial import cKDTree

    r, _ = cKDTree(trunks).query(xyz[:, :2], k=1)
    return (1 / (1 + np.exp((r - 0.4) * 4))).astype(np.float32)


def select_all(fn, entries, k):
    """``fn`` (pair_select or its plain version) over every entry of the
    plot, in the launches ``fuse_on_device`` makes."""
    import torch

    from pointstowood_tpu_torch.predict.device_fusion import (
        ENTRIES_PER_LAUNCH,
    )

    queries, q_len, regions, src, pay = entries
    ds, ps = [], []
    for e0 in range(0, q_len.shape[0], ENTRIES_PER_LAUNCH):
        e1 = e0 + ENTRIES_PER_LAUNCH
        d, p = fn(queries[e0:e1], q_len[e0:e1], src, pay, regions[e0:e1], k)
        ds.append(d)
        ps.append(p)
    return torch.cat(ds), torch.cat(ps)


# ---------------------------------------------------------------- checks


def check_select(name, d_k, i_k, d_p, i_p):
    """Kernel vs plain top-k: the same finite slots, distances equal to
    within 1e-5 relative (FMA contraction may move the last ulp), and an
    index differing only where its distance is a near-tie of the plain
    version's. Returns the largest absolute distance difference."""
    import torch

    fin = torch.isfinite(d_p)
    if not torch.equal(torch.isfinite(d_k), fin):
        raise AssertionError(f"{name}: finite slots differ")
    diff = (d_k - d_p).abs()[fin]
    tol = 1e-5 * d_p.abs()[fin] + 1e-12
    if bool((diff > tol).any()):
        raise AssertionError(
            f"{name}: distance differs by {float(diff.max())}")
    moved = (i_k != i_p) & fin
    frac = float(moved.float().mean())
    if frac > 1e-3:
        raise AssertionError(f"{name}: {frac:.2e} of slots hold another "
                             "index (more than near-ties explain)")
    return float(diff.max()) if diff.numel() else 0.0


def check_exact(name, d_k, p_k, d_p, p_p):
    """Kernel vs plain pair selection: the kernel computes the plain
    version's rounded difference-form d2 and breaks ties to the lower
    union index, so distances and payloads must be equal bit for bit."""
    import torch

    if not torch.equal(d_k, d_p):
        raise AssertionError(f"{name}: distances differ from the plain "
                             "version")
    if not torch.equal(p_k, p_p):
        moved = float((p_k != p_p).float().mean())
        raise AssertionError(f"{name}: {moved:.2e} of slots hold another "
                             "payload")
    return 0.0


def serving_phases(net, dev, smi, rows, wrappers, n_side=6):
    """Phases 6-8: the predict CLI over the synthetic plot (n_side x
    n_side trees), ``pair_select`` on its entries, and the pair path
    against the host path. Appends the pair_select rows to ``rows`` and
    sets every row's ``launches`` from the predict run. Returns the plot's
    PLY path and its truth (wood) column."""
    import torch

    from pointstowood_tpu_torch.cli import predict as predict_cli
    from pointstowood_tpu_torch.config import PredictConfig, TilingConfig
    from pointstowood_tpu_torch.data.tiling import preprocess_cloud, xyz_of
    from pointstowood_tpu_torch.io import load_file, read_ply, write_ply
    from pointstowood_tpu_torch.io.loader import canonicalize_columns
    from pointstowood_tpu_torch.ops.fusion_kernels import (
        pair_select,
        pair_select_plain,
        quantize_payload,
    )
    from pointstowood_tpu_torch.predict import device_fusion
    from pointstowood_tpu_torch.predict.predicter import tile_batcher
    from pointstowood_tpu_torch.predict.fusion import fuse_labels, knn_indices
    from pointstowood_tpu_torch.utils.checkpoint_convert import (
        state_dict_from_flax,
    )

    # ---- 6. the serving path: cli.predict.main over a ~1.2 M-point plot
    work = os.path.join(ROOT, "build", "chip_smoke_plot")
    os.makedirs(work, exist_ok=True)
    plot, trunks, wood = synthetic_plot(SEED, n_side)
    ply_path = os.path.join(work, "plot.ply")
    write_ply(ply_path, plot)
    model_path = os.path.join(work, "model.pth")
    torch.save({"model_state_dict": state_dict_from_flax(
        seeded_flax_variables(net, SEED))}, model_path)
    src = read_ply(ply_path)
    n_plot = len(src["x"])

    wrappers["pair_select"] = pair_select
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (rec,) = predict_cli.main([
        "--point-cloud", ply_path, "--model", model_path,
        "--grid_size", "2.0", "4.0", "--min_pts", "128",
        "--max_pts", "16384", "--batch_size", "8"], device=dev)
    wall_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    out = read_ply(rec["output"])
    if len(out["x"]) != n_plot:
        raise AssertionError(f"predict: {len(out['x'])} rows != {n_plot}")
    for c in ("x", "y", "z"):
        if not np.array_equal(out[c], src[c]):
            raise AssertionError(f"predict: column {c} changed")
    labels, pwood = out["label"], out["pwood"]
    if not set(np.unique(labels).tolist()) <= {0.0, 1.0}:
        raise AssertionError("predict: labels outside {0, 1}")
    if not (np.isfinite(pwood).all() and pwood.min() >= 0
            and pwood.max() <= 1):
        raise AssertionError("predict: pwood outside [0, 1]")
    if np.abs(pwood * 2046 - np.round(pwood * 2046)).max() > 1e-6:
        raise AssertionError("predict: pwood off the 1/2046 grid")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name}: no launch on the predict path")
    for row in rows:
        row["launches"] = launches[row["wrapper"]]
    emit("predict", nvidia_smi=smi, plot_points=n_plot, tiles=rec["tiles"],
         columns=list(out), seconds=rec["seconds"], wall_s=wall_s,
         points_per_s=n_plot / wall_s, launches=launches,
         max_memory_gib=peak_gib, wood_fraction=float(labels.mean()),
         mean_pwood=float(pwood.mean()))

    # ---- 7. pair_select on the flat arrays the CLI builds (its batcher,
    # FlatSink layout and plan), with a structured field written through
    # FlatSink.write at each batch's positions + tile shifts
    pc, _ = load_file(ply_path, additional_headers=True)
    pc, _, _ = canonicalize_columns(pc, mode="predict")
    tiling_cfg = TilingConfig()  # the CLI defaults: 2 m / 4 m, 128, 16384
    plot_tiles = preprocess_cloud(pc, tiling_cfg)
    batcher = tile_batcher(plot_tiles, PredictConfig(batch_size=8),
                           tiling_cfg)
    sink = device_fusion.sink_for(plot_tiles, batcher, dev)
    for _, batch, _ in batcher:
        bxyz = batch.pos + batch.shift[:, None, :]
        bfield = trunk_field(bxyz.reshape(-1, 3), trunks)
        sink.write(torch.from_numpy(batch.pos).to(dev), batch.shift,
                   torch.from_numpy(bfield.reshape(bxyz.shape[:2])).to(dev))
    query_xyz = xyz_of(pc)
    plan = device_fusion.plan_fusion(plot_tiles, query_xyz,
                                     tiling_cfg.min_pts, sink.layout)
    flat_xyz, flat_probs = sink.arrays()
    entries = (*device_fusion.entry_tensors(plan, query_xyz, dev), flat_xyz,
               quantize_payload(flat_probs))
    ql = plan.q_len.astype(np.float64)
    ul = (plan.regions[:, 1] + plan.regions[:, 3]).astype(np.float64)
    pairs = float((ql * ul).sum())
    n_launch = -(-len(ql) // device_fusion.ENTRIES_PER_LAUNCH)
    queries, _, _, src_t, pay_t = entries
    regions = plan.regions.tolist()
    q_lens = plan.q_len.tolist()
    for k_out in (64, 32):
        name = f"pair_select k={k_out}"
        d_k, p_k = select_all(pair_select, entries, k_out)
        torch.cuda.synchronize()
        d_p, p_p = select_all(pair_select_plain, entries, k_out)
        err = check_exact(name, d_k, p_k, d_p, p_p)
        ms = cuda_ms(lambda: select_all(pair_select, entries, k_out),
                     reps=5, warmup=1)
        plain_ms = cuda_ms(lambda: select_all(pair_select_plain, entries,
                                              k_out), reps=1, warmup=0)

        def library_all():
            for e, ((of, lf, oc, lc), n_q) in enumerate(zip(regions,
                                                             q_lens)):
                u = torch.cat([src_t[of:of + lf], src_t[oc:oc + lc]])
                up = torch.cat([pay_t[of:of + lf], pay_t[oc:oc + lc]])
                _, i = torch.topk(torch.cdist(queries[e, :n_q], u),
                                  min(k_out, lf + lc), dim=-1, largest=False)
                up[i]
        lib_ms = cuda_ms(library_all, reps=3, warmup=1)
        bms, by = bound(
            8.0 * pairs,
            float((ql * 12 + ul * 16).sum()) + float(ql.sum()) * k_out * 8)
        rows.append({
            "name": name, "check": "ok", "route": "cuda",
            "source": "pointstowood_tpu_torch/csrc/fusion.cu",
            "replaces": "pointstowood_tpu/ops/pallas_knn.py:703",
            "wrapper": "pair_select",
            "shape": [len(ql), device_fusion.PAIR_QCHUNK, int(ul.max()),
                      k_out],
            "entries": len(ql), "live_queries": int(ql.sum()),
            "distance_pairs": pairs, "launches_per_plot": n_launch,
            # the wrapper's count on the predict path, which runs k=64
            # (any-wood 1); k=32 is the any-wood != 1 instantiation
            "launches": launches["pair_select"],
            "on_default_path": k_out == 64,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "library_call": "per entry: torch.topk(torch.cdist(q, union), "
                            "k) + payload gather, over every entry of the "
                            "plot",
        })
        emit("kernel", **rows[-1])

    # ---- 8. pair path vs host path on the plot, structured field
    t0 = time.perf_counter()
    fused = device_fusion.fuse_on_device(plan, (flat_xyz, flat_probs),
                                         query_xyz, 0.5, 1.0, device=dev)
    pair_s = time.perf_counter() - t0
    # the host reference is built from the tiles' own points and the field
    # there, independently of the FlatSink's layout, shifts and writes
    classified_xyz = np.concatenate(
        [plot_tiles[t].points[:, :3] for t in batcher.tile_order()])
    field = trunk_field(classified_xyz, trunks)
    rng = np.random.default_rng(SEED)
    pick = np.sort(rng.choice(len(query_xyz), min(50000, len(query_xyz)),
                              replace=False))
    classified = np.concatenate(
        [classified_xyz, (field >= 0.5)[:, None], field[:, None]], axis=1)
    t0 = time.perf_counter()
    idx = knn_indices(classified_xyz, query_xyz[pick], 64)
    host = fuse_labels(classified, query_xyz[pick], 0.5, 1.0, indices=idx,
                       device=dev)
    host_s = time.perf_counter() - t0
    agree = float((fused[pick, 0] == host[:, 0]).mean())
    dpw = float(np.abs(fused[pick, 1] - host[:, 1]).mean())
    emit("fusion_crosscheck", sample=len(pick), label_agreement=agree,
         mean_abs_dpwood=dpw, wood_fraction_host=float(host[:, 0].mean()),
         pair_path_s=pair_s, host_path_sample_s=host_s,
         near_rows=plan.n_near)
    if agree < 0.98 or dpw >= 0.02:
        raise AssertionError("pair path and host path disagree on the plot")
    return ply_path, wood


# ---------------------------------------------------------------- training


def supplied_centres(mask, capacity, generator=None, fraction=0.5):
    """Centre rule for the CPU-vs-card crosscheck: the first
    floor(n_valid * fraction) valid points of each row by a fixed numpy
    score, drawn on the host, so both devices train on the same centres.
    Same signature and result contract as ``ops.sampling.random_sample``."""
    import torch

    from pointstowood_tpu_torch.ops.sampling import compact_indices

    m = mask.cpu()
    n = m.shape[1]
    score = torch.from_numpy(
        np.random.default_rng(1000 + n).random(n).astype(np.float32))
    n_take = torch.clamp((m.sum(-1) * fraction).long(), max=capacity)
    order = torch.argsort(torch.where(m, score, torch.inf), dim=-1,
                          stable=True)
    select = torch.zeros_like(m).scatter(
        1, order, torch.arange(n) < n_take[:, None])
    idx, valid = compact_indices(select, capacity)
    return idx.to(mask.device), valid.to(mask.device)


def train_geometry(pos, mask, caps, gen):
    """(idx, d2, target mask, n_src) of the three FP stages of a training
    forward: random 50% centres per level; FP3 takes the fused route
    (``knn_top2`` of its targets among its sources), FP2 and FP1 the SA
    stage's transpose top-2 (``knn_top2`` with rows = the level's points,
    columns = its centres)."""
    from pointstowood_tpu_torch.model.pointconv import gather_rows
    from pointstowood_tpu_torch.ops.knn_kernels import knn_top2
    from pointstowood_tpu_torch.ops.sampling import random_sample

    levels = [(pos, mask)]
    for cap in caps:
        p, m = levels[-1]
        cidx, cval = random_sample(m, cap, gen)
        levels.append((gather_rows(p, cidx).contiguous(), cval))
    out = {}
    for name, lvl in (("FP3", 2), ("FP2", 1), ("FP1", 0)):
        (tp, tm), (sp, sm) = levels[lvl], levels[lvl + 1]
        d2, idx = knn_top2(tp, sp, sm)
        out[name] = (idx, d2, tm, sp.shape[1])
    return out


def check_blend_bwd(name, d_k, d_p):
    """Kernel vs plain backward: every contribution is rounded alike, but
    the fp32 sums into one source row are taken in another (atomic) order,
    and the sum is then rounded to bf16. Tolerance: one bf16 step of the
    value (2^-7 |p|) plus 1e-5 of the largest |p| for the reordered fp32
    sum. Returns the largest absolute difference."""
    import torch

    k, p = d_k.float(), d_p.float()
    if not bool(torch.isfinite(k).all()):
        raise AssertionError(f"{name}: non-finite gradient")
    err = (k - p).abs()
    tol = 2.0 ** -7 * p.abs() + 1e-5 * float(p.abs().max())
    if bool((err > tol).any()):
        raise AssertionError(f"{name}: differs from the plain version by "
                             f"{float(err.max())}")
    return float(err.max())


def blend_bwd_rows(dev, rows, seed):
    """Phase 9: ``interp_blend_bwd`` at the train shapes (B=8, C=512 bf16;
    FP3 4096 <- 2048 fused, FP2 8192 <- 4096 and FP1 16384 <- 8192 on the
    transpose neighbours), held against ``blend_bwd_plain``."""
    import torch

    from pointstowood_tpu_torch.data.dataset import pad_tiles
    from pointstowood_tpu_torch.ops.interp_kernels import (
        blend_bwd_plain,
        interp_blend_bwd,
    )

    tiles = synthetic_tiles(seed)
    batch = pad_tiles([t.points for t in tiles if len(t) == 16384][:8], 16384)
    pos = torch.from_numpy(batch.pos).to(dev)
    mask = torch.from_numpy(batch.mask).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    geo = train_geometry(pos, mask, (8192, 4096, 2048), gen)
    c = 512
    for name in ("FP3", "FP2", "FP1"):
        idx, d2, tm, n_src = geo[name]
        bsz, n_t = idx.shape[:2]
        d_y = torch.randn((bsz, n_t, c), generator=gen, device=dev).to(
            torch.bfloat16)
        d_k = interp_blend_bwd(d_y, idx, d2, tm, n_src)
        torch.cuda.synchronize()
        d_p = blend_bwd_plain(d_y, idx, d2, tm, n_src)
        err = check_blend_bwd(f"interp_blend_bwd {name}", d_k, d_p)
        ms = cuda_ms(lambda: interp_blend_bwd(d_y, idx, d2, tm, n_src))
        plain_ms = cuda_ms(lambda: blend_bwd_plain(d_y, idx, d2, tm, n_src),
                           reps=5)
        # yardstick: one index_add_ of the pre-weighted rows of the live
        # slots into an fp32 (B * S, C) buffer
        w = torch.where(torch.isfinite(d2), 1.0 / torch.clamp(d2, min=1e-16),
                        0.0)
        den = torch.clamp(w.sum(-1, keepdim=True), min=1e-16)
        live = (w > 0) & tm[..., None]
        flat = (idx.long() + (torch.arange(bsz, device=dev)
                              * n_src)[:, None, None])[live]
        wrows = ((w / den)[..., None] * d_y.float()[:, :, None, :])[live]
        acc = torch.zeros((bsz * n_src, c), device=dev)
        lib_ms = cuda_ms(lambda: acc.index_add_(0, flat, wrows))
        n_live, n_tgt = int(live.sum()), int(tm.sum())
        bms, by = bound(2.0 * n_live * c + n_tgt * c,
                        bsz * n_t * c * 2 + bsz * n_t * 2 * (4 + 4)
                        + bsz * n_src * c * 2)
        rows.append({
            "name": f"interp_blend_bwd {name}", "check": "ok", "route": "cuda",
            "source": "pointstowood_tpu_torch/csrc/interp.cu",
            "replaces": "pointstowood_tpu/ops/pallas_interp.py:207",
            "jax_route": ("fp_interpolate_fast custom VJP (Pallas)"
                          if name == "FP3" else
                          "gather VJP, XLA scatter-add "
                          "(pointstowood_tpu/model/pointconv.py:85-103)"),
            "wrapper": "interp_blend_bwd", "shape": [bsz, n_t, n_src, c],
            "live_slots": n_live, "max_abs_err": err,
            "tolerance": "2^-7 |plain| + 1e-5 max|plain| (bf16 rounding of "
                         "an fp32 sum taken in atomic order)",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms,
            "library_call": "Tensor.index_add_ of the pre-weighted live "
                            "rows into an fp32 (B*S, C) buffer",
        })
        emit("kernel", **rows[-1])


def rel_l1(a, b) -> float:
    den = float(b.abs().sum())
    return float((a - b).abs().sum()) / den if den else float(a.abs().sum())


# CPU vs card, one fp32 train step. The forward agrees to fp32 rounding;
# ~45 batch-statistic BatchNorms and masked maxima amplify that rounding
# on the way back to the encoder (the CPU tests measure the JAX package at
# up to ~6% relative L1 against itself when only the order of a batch
# changes), so the encoder's gradients are held to a few %, the head's and
# the loss to fp32 rounding.
CROSSCHECK_TOLERANCES = {
    "loss_rel": 1e-5, "logits_mean_abs": 1e-3, "logits_max_abs": 0.05,
    "grads_rel_l1_total": 0.06, "grads_rel_l1_tensor": 0.2,
    "grads_rel_l1_conv2": 1e-4, "running_stats_rel": 1e-4,
}


def train_crosscheck(dev, seed):
    """Phase 10: one fp32 train step (fast kNN, centres supplied) on one
    full 16384-point tile, on the CPU (plain versions) and on the card
    (kernels); FP3 takes the fused route only at this size. Returns the
    record."""
    import torch

    from pointstowood_tpu_torch.config import ModelConfig, TrainConfig
    from pointstowood_tpu_torch.data.dataset import pad_tiles
    from pointstowood_tpu_torch.model import network
    from pointstowood_tpu_torch.train import trainer
    from pointstowood_tpu_torch.utils.checkpoint_convert import (
        state_dict_from_flax,
    )

    tiles = synthetic_tiles(seed)
    batch = pad_tiles([tiles[0].points], 16384, with_labels=False)
    rng = np.random.default_rng(seed)
    labels = (batch.reflectance > 0.5).astype(np.float32)
    flip = rng.random(labels.shape) < 0.1
    labels = np.where(flip, 1 - labels, labels).astype(np.float32)
    cfg = TrainConfig(learning_rate=1e-3)
    base = trainer.build_train_net(ModelConfig(compute_dtype="float32"), seed,
                                   device="cpu")
    base.load_state_dict(state_dict_from_flax(seeded_flax_variables(base,
                                                                    seed)))
    if base.stage_routes(16384, training=True) != ["transpose", "transpose",
                                                    "fused"]:
        raise AssertionError("train routes at N=16384 are not "
                             "transpose/transpose/fused")
    results = {}
    saved_rule, saved_clip = network.random_sample, trainer.clip_by_global_norm_
    try:
        network.random_sample = supplied_centres
        for where in ("cpu", "cuda"):
            net = copy.deepcopy(base).to(where)
            opt = trainer.make_optimizer(net, cfg)
            rec = {}

            def recording_clip(grads, max_norm, rec=rec):
                rec["grads"] = [g.detach().cpu().clone() for g in grads]
                return saved_clip(grads, max_norm)

            trainer.clip_by_global_norm_ = recording_clip
            hook = net.register_forward_hook(
                lambda m, i, o, rec=rec: rec.__setitem__(
                    "logits", o.detach().cpu().clone()))
            step = trainer.make_train_step(net, opt, cfg)
            args = [torch.from_numpy(a).to(where) for a in
                    (batch.pos, batch.reflectance, batch.mask, batch.sf,
                     labels)]
            gen = torch.Generator(device=where)
            t0 = time.perf_counter()
            loss, _, finite = step(*args, cfg.learning_rate, gen)
            if where == "cuda":
                torch.cuda.synchronize()
            rec["seconds"] = time.perf_counter() - t0
            hook.remove()
            if not finite:
                raise AssertionError(f"train_crosscheck: non-finite step "
                                     f"on {where}")
            rec["loss"] = float(loss)
            rec["state"] = {k: v.detach().cpu().clone()
                            for k, v in net.state_dict().items()}
            rec["names"] = [n for n, _ in net.named_parameters()]
            results[where] = rec
    finally:
        network.random_sample = saved_rule
        trainer.clip_by_global_norm_ = saved_clip
    cpu, gpu = results["cpu"], results["cuda"]
    m = torch.from_numpy(batch.mask)
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    dl = (gpu["logits"] - cpu["logits"]).abs()[m]
    logit_scale = float(cpu["logits"].abs()[m].max())
    grads_c = dict(zip(cpu["names"], cpu["grads"]))
    grads_g = dict(zip(gpu["names"], gpu["grads"]))
    per = {k: rel_l1(grads_g[k], grads_c[k]) for k in grads_c
           if float(grads_c[k].abs().max()) > 0}
    total = (sum(float((grads_g[k] - grads_c[k]).abs().sum()) for k in per)
             / sum(float(grads_c[k].abs().sum()) for k in per))
    stats = max(float(((gpu["state"][k] - cpu["state"][k]).abs()
                       / (cpu["state"][k].abs() + 1)).max())
                for k in cpu["state"] if "running" in k)
    # per tensor, over the tensors that carry >= 0.1% of the gradient's
    # L1 mass: the others are biases right in front of a batch-statistic
    # BatchNorm, whose true gradient is 0 and whose computed one is
    # rounding noise on both devices
    mass = sum(float(g.abs().sum()) for g in grads_c.values())
    carried = {k: v for k, v in per.items()
               if float(grads_c[k].abs().sum()) >= 1e-3 * mass}
    worst = sorted(carried.items(), key=lambda kv: -kv[1])[:5]
    rec = emit("train_crosscheck", points=int(batch.mask.sum()),
               loss_cpu=cpu["loss"], loss_card=gpu["loss"],
               loss_rel=loss_rel, logits_max_abs=float(dl.max()),
               logits_mean_abs=float(dl.mean()), logits_max=logit_scale,
               grads_rel_l1_total=total, grads_rel_l1_worst=worst,
               grads_tensors_checked=len(carried),
               grads_rel_l1_conv2=per["conv2.weight"],
               running_stats_max_rel=stats, cpu_step_s=cpu["seconds"],
               card_step_s=gpu["seconds"],
               tolerances=CROSSCHECK_TOLERANCES)
    tol = CROSSCHECK_TOLERANCES
    checks = {
        "loss_rel": loss_rel <= tol["loss_rel"],
        "logits_mean_abs": float(dl.mean()) <= tol["logits_mean_abs"],
        "logits_max_abs": float(dl.max()) <= tol["logits_max_abs"],
        "grads_rel_l1_total": total <= tol["grads_rel_l1_total"],
        "grads_rel_l1_tensor": all(v <= tol["grads_rel_l1_tensor"]
                                   for v in carried.values()),
        "grads_rel_l1_conv2": per["conv2.weight"] <= tol["grads_rel_l1_conv2"],
        "running_stats_rel": stats <= tol["running_stats_rel"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train_crosscheck: CPU and card disagree on "
                             f"{failed}")
    return rec


def train_step_phase(dev, smi, wrappers, seed):
    """Phase 11: B=8 x 16384, C=32, bf16, fast kNN train steps with seeded
    weights and labels: median step time, split into forward, backward
    and optimizer; points/s; peak memory; every train-path kernel's
    launch counter; then one step under torch.profiler."""
    import torch

    from pointstowood_tpu_torch.config import ModelConfig, TrainConfig
    from pointstowood_tpu_torch.data.dataset import pad_tiles
    from pointstowood_tpu_torch.train import trainer
    from pointstowood_tpu_torch.train.loss import poly1_focal_loss
    from pointstowood_tpu_torch.utils.checkpoint_convert import (
        state_dict_from_flax,
    )

    tiles = synthetic_tiles(seed)
    batch = pad_tiles([t.points for t in tiles if len(t) == 16384][:8],
                      16384)
    labels = np.random.default_rng(seed).random(batch.mask.shape) < 0.3
    args = [torch.from_numpy(a).to(dev) for a in
            (batch.pos, batch.reflectance, batch.mask, batch.sf,
             labels.astype(np.float32))]
    cfg = TrainConfig()
    net = trainer.build_train_net(ModelConfig(), seed, device=dev)
    net.load_state_dict(state_dict_from_flax(seeded_flax_variables(net,
                                                                   seed)))
    opt = trainer.make_optimizer(net, cfg)
    step = trainer.make_train_step(net, opt, cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lr = 1e-4
    step(*args, lr, gen)  # warm-up (allocator, first launches)

    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, skipped = [], [], 0
    for _ in range(10):
        t0 = time.perf_counter()
        loss, _, finite = step(*args, lr, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        skipped += not finite
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30

    # the split: forward + loss alone, then with the backward; the
    # optimizer (finite check, clip, AdamW) is the rest of the full step
    def forward():
        logits = net(*args[:4], training=True, generator=gen)
        return poly1_focal_loss(logits, args[4], label_smoothing=0.1,
                                mask=args[2])[0]

    def timed(fn, reps=10):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    fwd_ms = timed(forward)
    fwd_bwd_ms = timed(lambda: forward().backward())
    opt.zero_grad(set_to_none=False)
    step_ms = statistics.median(times)
    n_valid = float(batch.mask.sum())
    rec = emit("train_step", nvidia_smi=smi, batch=[8, 16384],
               channels=net.channels, dtype="bfloat16",
               step_ms=step_ms, step_ms_all=times,
               forward_ms=fwd_ms, backward_ms=fwd_bwd_ms - fwd_ms,
               optimizer_ms=step_ms - fwd_bwd_ms,
               points_per_s=n_valid / (step_ms / 1e3),
               max_memory_gib=peak, launches=launches,
               launches_per_step={k: v / 10 for k, v in launches.items()},
               losses=losses, parameters=sum(p.numel()
                                             for p in net.parameters()))
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name}: no launch on the train path")
    if skipped or not np.isfinite(losses).all():
        raise AssertionError("train_step: non-finite step")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*args, lr, gen)
        torch.cuda.synchronize()
    # device events only, without the optimizer's user annotation (a span
    # over the whole optimizer step, gaps included)
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA
                   and not getattr(ev, "is_user_annotation", False)
                   and not ev.name.startswith("Optimizer."))
    by_kernel: dict = {}
    by_family: dict = {}
    busy_us, cur_end = 0.0, None
    for start, end, name in spans:
        ms = (end - start) / 1e3
        by_kernel[name] = by_kernel.get(name, 0.0) + ms
        fam = kernel_family(name)
        by_family[fam] = by_family.get(fam, 0.0) + ms
        if cur_end is None or start > cur_end:
            busy_us += end - start
            cur_end = end
        elif end > cur_end:
            busy_us += end - cur_end
            cur_end = end
    span_us = (spans[-1][1] - spans[0][0]) if spans else 0.0
    emit("train_profile", device_events=len(spans),
         device_busy_ms=busy_us / 1e3 if spans else None,
         device_span_ms=span_us / 1e3 if spans else None,
         idle_share=(1 - busy_us / span_us) if span_us else None,
         families_ms=sorted(by_family.items(), key=lambda kv: -kv[1]),
         top_kernels_ms=sorted(by_kernel.items(),
                               key=lambda kv: -kv[1])[:20])
    return rec, launches


def kernel_family(name: str) -> str:
    """Coarse family of a CUDA kernel name, for the train-step breakdown."""
    low = name.lower()
    for fam, keys in (
            ("port kernels (csrc/*.cu)", ("knn_select", "knn_top2",
                                          "interp_blend", "cast_bf16",
                                          "pair_select")),
            ("GEMM", ("gemm", "cutlass", "xmma", "sm90_", "cublas")),
            ("optimizer (foreach)", ("multi_tensor", "foreach")),
            ("copies and casts", ("copy_kernel", "direct_copy", "memcpy",
                                  "memset", "catarraybatchedcopy",
                                  "fill_kernel")),
            ("index, gather, scatter", ("index", "gather", "scatter")),
            ("reductions", ("reduce",)),
            ("sort", ("sort", "radix")),
            ("elementwise", ("elementwise", "vectorized", "unrolled"))):
        if any(k in low for k in keys):
            return fam
    return "other"


def train_cli_phase(dev, smi, wrappers, eval_ply, eval_wood, n_side=6):
    """Phase 12: ``cli.train.main`` with the default flags and 2 epochs on
    a labelled synthetic plot (another seed than the predict phase's;
    truth = trunk points), then ``cli.predict.main`` with the trained
    ``.pth`` on the predict phase's plot, scored against its truth."""
    import shutil

    import torch

    from pointstowood_tpu_torch.cli import predict as predict_cli
    from pointstowood_tpu_torch.cli import train as train_cli
    from pointstowood_tpu_torch.data.tiling import load_tiles
    from pointstowood_tpu_torch.io import read_ply, write_ply

    wdir = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(wdir, ignore_errors=True)
    os.makedirs(os.path.join(wdir, "data", "train"))
    plot, _, wood = synthetic_plot(SEED + 1, n_side)
    plot["truth"] = wood.astype(np.float64)
    write_ply(os.path.join(wdir, "data", "train", "plot_train.ply"), plot)

    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = train_cli.main(["--wdir", wdir, "--preprocess",
                              "--num_epochs", "2"], device=dev)
    wall_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    n_tiles = len(load_tiles(os.path.join(wdir, "data", "train", "voxels")))
    steps = 2 * -(-n_tiles // 2)
    losses = [row[2] for row in history]
    model = os.path.join(wdir, "model", "model.pth")

    t1 = time.perf_counter()
    (rec,) = predict_cli.main(["--point-cloud", eval_ply, "--model", model],
                              device=dev)
    pred_s = time.perf_counter() - t1
    labels = read_ply(rec["output"])["label"] > 0.5
    tpr = float((labels & eval_wood).sum() / max(eval_wood.sum(), 1))
    tnr = float((~labels & ~eval_wood).sum() / max((~eval_wood).sum(), 1))
    rec = emit("train", nvidia_smi=smi, plot_points=len(wood),
                wood_fraction=float(wood.mean()), tiles=n_tiles,
                wall_s=wall_s, steps=steps, steps_per_s=steps / wall_s,
                history=history, loss_per_epoch=losses,
                ba_per_epoch=[row[3] for row in history],
                launches=launches,
                max_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                predict_s=pred_s, eval_points=len(eval_wood),
                eval_wood_fraction=float(labels.mean()),
                eval_balanced_accuracy=(tpr + tnr) / 2,
                eval_recall_wood=tpr, eval_recall_leaf=tnr)
    if not (np.isfinite(np.asarray(history)).all() and len(history) == 2):
        raise AssertionError(f"train: bad history {history}")
    if not losses[1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name}: no launch in the train CLI run")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pointstowood_tpu_torch.config import (
        ModelConfig,
        PredictConfig,
        TilingConfig,
    )
    from pointstowood_tpu_torch.data.dataset import pad_tiles
    from pointstowood_tpu_torch.ops import build
    from pointstowood_tpu_torch.ops.interp_kernels import (
        blend_plain,
        interp_blend,
    )
    from pointstowood_tpu_torch.ops.knn_kernels import (
        knn_top2,
        knn_topk,
        select_plain,
    )
    from pointstowood_tpu_torch.predict.predicter import (
        build_net,
        forward_probs,
        run_inference,
    )
    from pointstowood_tpu_torch.utils.checkpoint_convert import (
        state_dict_from_flax,
    )

    # ---- 1. device
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # ---- 2. build
    t0 = time.perf_counter()
    build.build_all(verbose=True)
    for name in build.SOURCES:
        build.library(name)
    emit("build", seconds=time.perf_counter() - t0,
         sources=[f"pointstowood_tpu_torch/csrc/{n}.cu"
                  for n in build.SOURCES])

    # ---- 3. kernels at the canonical shapes
    tiles = synthetic_tiles(SEED)
    model_cfg = ModelConfig()  # C=32, k=32, fast, bf16, hash voxels
    net = build_net(model_cfg, device=dev)
    net.load_state_dict(
        state_dict_from_flax(seeded_flax_variables(net, SEED)))
    full = [t.points for t in tiles if len(t) == 16384][:8]
    batch = pad_tiles(full, 16384)
    pos = torch.from_numpy(batch.pos).to(dev)
    mask = torch.from_numpy(batch.mask).to(dev)
    lv = stage_geometry(net, pos, mask)
    k = model_cfg.k
    rows = []

    knn_src = "pointstowood_tpu_torch/csrc/knn.cu"
    pk = "pointstowood_tpu/ops/pallas_knn.py"
    select_cases = [
        # (name, wrapper, rows level, cols level, k, replaces)
        ("knn_topk SA1", knn_topk, 1, 0, k, f"{pk}:572"),
        ("knn_topk SA2", knn_topk, 2, 1, k, f"{pk}:572"),
        ("knn_topk SA3", knn_topk, 3, 2, k, f"{pk}:399"),
        ("knn_top2 SA1 transpose", knn_top2, 0, 1, 2, f"{pk}:572"),
        ("knn_top2 SA2 transpose", knn_top2, 1, 2, 2, f"{pk}:572"),
        ("knn_top2 FP3", knn_top2, 2, 3, 2, f"{pk}:836"),
    ]
    selected = {}
    for name, fn, ri, ci, kk, replaces in select_cases:
        r, (c, cm) = lv[ri][0], lv[ci]
        call = ((lambda: fn(r, c, cm, kk)) if fn is knn_topk
                else (lambda: fn(r, c, cm)))
        d_k, i_k = call()
        torch.cuda.synchronize()
        d_p, i_p = select_plain(r, c, cm, kk)
        err = check_select(name, d_k, i_k, d_p, i_p)
        selected[name] = (i_k, d_k)
        b, nr, nc = r.shape[0], r.shape[1], c.shape[1]
        ms = cuda_ms(call)
        plain_ms = cuda_ms(lambda: select_plain(r, c, cm, kk), reps=3,
                           warmup=1)
        lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(r, c), kk, dim=-1,
                                            largest=False), reps=5)
        bms, by = bound(8.0 * b * nr * nc,
                        12 * b * (nr + nc) + b * nc + 8 * b * nr * kk)
        rows.append({
            "name": name, "check": "ok", "route": "cuda", "source": knn_src,
            "replaces": replaces, "wrapper": fn.__name__,
            "shape": [b, nr, nc, kk], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms,
            "library_call": "torch.topk(torch.cdist(rows, cols)), no mask",
        })
        emit("kernel", **rows[-1])

    # K3 at FP3 (the FP3 top-2 above), FP2 and FP1 (the SA2 and SA1
    # transposes): 512 bf16 channels on the coarser level's points,
    # blended onto the finer level's.
    g = torch.Generator(device=dev).manual_seed(SEED)
    c_fp = net.channels * 16
    blend_cases = [("interp_blend FP3", "knn_top2 FP3", 2),
                   ("interp_blend FP2", "knn_top2 SA2 transpose", 1),
                   ("interp_blend FP1", "knn_top2 SA1 transpose", 0)]
    for name, source_case, lvl in blend_cases:
        x = torch.randn((8, lv[lvl + 1][0].shape[1], c_fp), generator=g,
                        device=dev).to(torch.bfloat16)
        idx, d2 = selected[source_case]
        tmask = lv[lvl][1]
        y_k = interp_blend(x, idx, d2, tmask)
        torch.cuda.synchronize()
        y_p = blend_plain(x, idx, d2, tmask)
        err = float((y_k.float() - y_p.float()).abs().max())
        tol = 1e-2 * float(y_p.float().abs().max())  # one bf16 step
        if not (torch.isfinite(y_k.float()).all() and err <= tol):
            raise AssertionError(f"{name}: max abs err {err} > {tol}")
        ms = cuda_ms(lambda: interp_blend(x, idx, d2, tmask))
        plain_ms = cuda_ms(lambda: blend_plain(x, idx, d2, tmask), reps=5)
        # yardstick: one embedding_bag call (sum of weighted gathered
        # rows) with the weights normalised beforehand
        bsz, n_s, _ = x.shape
        w = torch.where(torch.isfinite(d2),
                        1.0 / torch.clamp(d2, min=1e-16), 0.0)
        w = (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-16))
        flat = idx.long() + (torch.arange(bsz, device=dev)
                             * n_s)[:, None, None]
        flat2, w2 = flat.reshape(-1, 2), w.reshape(-1, 2).to(x.dtype)
        x_flat = x.reshape(-1, c_fp)
        lib_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
            flat2, x_flat, per_sample_weights=w2, mode="sum"))
        # bytes this data needs: each source row that a live slot uses,
        # the neighbour lists and mask, the output
        live = torch.isfinite(d2) & tmask[..., None]
        n_rows_read = int(torch.unique(flat[live]).numel())
        n_t = idx.shape[1]
        bms, by = bound(
            float(live.sum()) * 2 * c_fp + float(tmask.sum()) * c_fp,
            n_rows_read * c_fp * 2 + bsz * n_t * (8 * 2 + 1)
            + bsz * n_t * c_fp * 2)
        rows.append({
            "name": name, "check": "ok", "route": "cuda",
            "source": "pointstowood_tpu_torch/csrc/interp.cu",
            "replaces": "pointstowood_tpu/ops/pallas_interp.py:168",
            "wrapper": "interp_blend", "shape": [bsz, n_t, n_s, c_fp],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "library_call": "torch.nn.functional.embedding_bag(mode='sum', "
                            "per_sample_weights)",
        })
        emit("kernel", **rows[-1])

    # ---- 4. the main path: run_inference over the plot
    wrappers = {"knn_topk": knn_topk, "knn_top2": knn_top2,
                "interp_blend": interp_blend}
    for fn in wrappers.values():
        fn.launches = 0
    predict_cfg = PredictConfig(batch_size=8)
    tiling_cfg = TilingConfig(grid_size=(4.0,), min_pts=128, max_pts=16384)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_inference(tiles, net, predict_cfg, tiling_cfg, device=dev)
    run_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    n_pts = sum(len(t) for t in tiles)
    if out.shape != (n_pts, 5):
        raise AssertionError(f"run_inference rows {out.shape} != {n_pts}")
    probs = out[:, 4]
    if not (np.isfinite(out).all() and probs.min() >= 0
            and probs.max() <= 1):
        raise AssertionError("run_inference: probabilities not in [0, 1]")
    order_xyz = np.concatenate([t.points[:, :3] for t in tiles
                                if len(t) < 16384]
                               + [t.points[:, :3] for t in tiles
                                  if len(t) == 16384])
    if not np.allclose(out[:, :3], order_xyz, atol=1e-4):
        raise AssertionError("run_inference: xyz rows out of order")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name}: no launch on the main path")
    for row in rows:
        row["launches_forward"] = launches[row["wrapper"]]

    refl = torch.from_numpy(batch.reflectance).to(dev)
    sf = torch.from_numpy(batch.sf).to(dev)
    fwd = []
    for i in range(12):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        forward_probs(net, pos, refl, mask, sf)
        torch.cuda.synchronize()
        if i >= 2:
            fwd.append((time.perf_counter() - t1) * 1e3)
    fwd_ms = statistics.median(fwd)
    emit("forward", plot_points=n_pts, tiles=len(tiles),
         run_inference_s=run_s, launches=launches,
         wood_fraction=float((out[:, 3] > 0).mean()),
         forward_ms_b8x16384=fwd_ms, forward_ms_all=fwd,
         points_per_s=float(batch.mask.sum()) / (fwd_ms / 1e3),
         max_memory_gib=torch.cuda.max_memory_allocated() / 2**30)

    # where one forward's device time goes, by kernel name, and the share
    # of the forward's device span in which no kernel ran
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        forward_probs(net, pos, refl, mask, sf)
        torch.cuda.synchronize()
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    by_kernel: dict = {}
    busy_us, cur_end = 0.0, None
    for start, end, name in spans:
        by_kernel[name] = by_kernel.get(name, 0.0) + (end - start) / 1e3
        if cur_end is None or start > cur_end:
            busy_us += end - start
            cur_end = end
        elif end > cur_end:
            busy_us += end - cur_end
            cur_end = end
    span_us = (spans[-1][1] - spans[0][0]) if spans else 0.0
    emit("profile", device_events=len(spans),
         device_busy_ms=busy_us / 1e3 if spans else None,
         device_span_ms=span_us / 1e3 if spans else None,
         idle_share=(1 - busy_us / span_us) if span_us else None,
         top_kernels_ms=sorted(by_kernel.items(),
                               key=lambda kv: -kv[1])[:20])

    # ---- 5. one full tile on the CPU (plain versions) vs the card
    one = pad_tiles([full[0]], 16384)
    cpu_net = copy.deepcopy(net).to("cpu")
    args = [torch.from_numpy(a) for a in
            (one.pos, one.reflectance, one.mask, one.sf)]
    t1 = time.perf_counter()
    p_cpu = forward_probs(cpu_net, *args)[0].float().numpy()
    cpu_s = time.perf_counter() - t1
    p_gpu = forward_probs(net, *(a.to(dev) for a in args))[0].float()
    p_gpu = p_gpu.cpu().numpy()
    m = one.mask[0]
    agree = float(((p_cpu[m] >= 0.5) == (p_gpu[m] >= 0.5)).mean())
    dp = np.abs(p_cpu[m] - p_gpu[m])
    p99 = float(np.quantile(dp, 0.99))
    emit("crosscheck", label_agreement=agree, p99_abs_dprob=p99,
         max_abs_dprob=float(dp.max()), mean_prob=float(p_gpu[m].mean()),
         cpu_seconds=cpu_s)
    if agree < 0.995 or p99 > 0.02:
        raise AssertionError("CPU and card disagree on the full tile")

    eval_ply, eval_wood = serving_phases(net, dev, smi, rows, wrappers)

    # ---- 9-12. training
    from pointstowood_tpu_torch.ops.interp_kernels import interp_blend_bwd

    n_fwd = len(rows)
    blend_bwd_rows(dev, rows, SEED)
    train_crosscheck(dev, SEED)
    train_wrappers = {"knn_topk": knn_topk, "knn_top2": knn_top2,
                      "interp_blend": interp_blend,
                      "interp_blend_bwd": interp_blend_bwd}
    _, step_launches = train_step_phase(dev, smi, train_wrappers, SEED)
    for row in rows:
        row["launches_train_step"] = step_launches.get(row["wrapper"], 0)
    for row in rows[n_fwd:]:
        row["launches"] = step_launches["interp_blend_bwd"]
    train_cli_phase(dev, smi, train_wrappers, eval_ply, eval_wood)

    # ---- 13. results
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump({"records": RECORDS, "kernels": rows}, f, indent=1)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
