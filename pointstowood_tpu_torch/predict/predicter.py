"""Inference engine: padded tile batches -> per-point wood probabilities
-> fusion onto the original cloud (port of ``build_net``, ``_forward``,
``run_inference`` and ``semantic_segmentation`` of
pointstowood_tpu/predict/predicter.py).

Tiles stream through ``forward_probs`` one padded batch at a time; the
probabilities come back with the per-tile centring undone
(reference predicter.py:211-214). ``semantic_segmentation`` then labels
every original point, on the device pair path or the device index path
(``predict/device_fusion.py``) where the tiling allows it, else on the
host path (``predict/fusion.py``).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import time
from typing import Sequence

import numpy as np
import torch

from pointstowood_tpu_torch.config import (
    ModelConfig,
    PredictConfig,
    TilingConfig,
)
from pointstowood_tpu_torch.data.dataset import TileBatcher
from pointstowood_tpu_torch.data.tiling import Tile, xyz_of
from pointstowood_tpu_torch.model import Net
from pointstowood_tpu_torch.ops.voxel import check_voxel_pack_range
from pointstowood_tpu_torch.predict import device_fusion
from pointstowood_tpu_torch.predict.fusion import Fusion, knn_indices
from pointstowood_tpu_torch.utils.device import resolve_device


def build_net(model_cfg: ModelConfig, device=None) -> Net:
    """The eval-mode Net of a model config, on ``device`` (default CUDA).
    Load weights with ``utils.checkpoint.load_checkpoint`` or
    ``net.load_state_dict`` (reference layout; see
    utils/checkpoint_convert.py)."""
    dev = resolve_device(device)
    net = Net(
        num_classes=model_cfg.num_classes,
        channels=model_cfg.channels,
        k=model_cfg.k,
        sa_resolutions=tuple(model_cfg.sa_resolutions),
        stage_fractions=tuple(model_cfg.stage_fractions),
        fp_k=model_cfg.fp_k,
        knn_method=model_cfg.knn_mode,
        voxel_priority=model_cfg.voxel_priority,
        dtype=getattr(torch, model_cfg.compute_dtype),
    )
    return net.to(dev).eval()


def forward_probs(net: Net, pos, refl, mask, sf) -> torch.Tensor:
    """sigmoid(nan_to_num(logits)) of one padded batch (the JAX
    ``_forward``)."""
    with torch.inference_mode():
        return torch.sigmoid(torch.nan_to_num(net(pos, refl, mask, sf)))


def tile_batcher(tiles, predict_cfg, tiling_cfg) -> TileBatcher:
    """The batcher ``run_inference`` iterates: bucketed capacities with
    scaled batch sizes, deterministic order."""
    return TileBatcher(
        tiles, batch_size=predict_cfg.batch_size,
        min_pts=tiling_cfg.min_pts, max_pts=tiling_cfg.max_pts,
        capacity_step=2, scale_batch=True,
    )


def run_inference(
    tiles: Sequence[Tile],
    net: Net,
    predict_cfg: PredictConfig,
    tiling_cfg: TilingConfig,
    device=None,
    sink: device_fusion.FlatSink | None = None,
    with_readback: bool = True,
) -> np.ndarray | None:
    """Classify all tiles; returns (M, 5) float64 rows [x, y, z, pred,
    prob] for every valid tile point, tiles in batcher order (reference
    predicter.py:192-217). ``net`` must live on ``device`` (default
    CUDA). The host readback of batch i overlaps the device work of batch
    i+1 (two batches in flight).

    ``sink``: a ``device_fusion.FlatSink`` that receives each batch's
    device positions and probabilities as they are produced. With
    ``with_readback=False`` nothing is read back (the device pair path
    never needs the classified rows) and the function returns None."""
    dev = resolve_device(device)
    check_voxel_pack_range(max(tiling_cfg.grid_size), min(net.sa_resolutions))
    batcher = tile_batcher(tiles, predict_cfg, tiling_cfg)
    outputs = []
    pending = []  # (device probs, host batch)

    def drain(entry):
        probs_dev, batch = entry
        probs = probs_dev.float().cpu().numpy()
        preds = (probs >= predict_cfg.is_wood).astype(np.float64)
        xyz = (batch.pos.astype(np.float64)
               + batch.shift[:, None, :].astype(np.float64))
        out = np.concatenate(
            [xyz, preds[..., None], probs.astype(np.float64)[..., None]],
            axis=-1)
        outputs.append(out[batch.mask])

    n_batches = 0
    for _, batch, _ in batcher:
        n_batches += 1
        pos, refl, mask, sf = (
            torch.from_numpy(a).to(dev, non_blocking=True)
            for a in (batch.pos, batch.reflectance, batch.mask, batch.sf))
        probs_dev = forward_probs(net, pos, refl, mask, sf)
        if sink is not None:
            sink.write(pos, batch.shift, probs_dev)
        if with_readback:
            pending.append((probs_dev, batch))
            if len(pending) > 2:
                drain(pending.pop(0))
    while pending:
        drain(pending.pop(0))
    if not n_batches:
        raise ValueError("no tiles to classify (cloud smaller than min_pts?)")
    if not with_readback:
        return None
    return np.vstack(outputs)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def semantic_segmentation(
    pc: dict,
    tiles: Sequence[Tile],
    net: Net,
    predict_cfg: PredictConfig,
    tiling_cfg: TilingConfig,
    verbose: bool = False,
    profile_dir: str | None = None,
    device=None,
    timings: dict | None = None,
) -> dict:
    """Classify the tiles and fuse the predictions onto every row of the
    column table ``pc``; returns a new table with ``label`` and ``pwood``
    set. ``net`` must live on ``device`` (default CUDA).

    Fusion path (``predict_cfg.fusion``), as the JAX package chooses it
    (pointstowood_tpu/predict/predicter.py:253-270, 329-361):

    * the device pair path where ``device_fusion.declines`` accepts the
      tiling and the mode is not ``host``;
    * else the index path (``device_fusion.fusion_indices``: tile-local
      kNN on the device, the host search for uncovered rows) where the
      mode is ``tpu``, or ``auto`` with no ``cluster_features``,
      ``min_pts >= 32``, k <= 32 per grid scale and every tile carrying a
      cell id (one grid scale at ``any_wood != 1``);
    * else the host path (scipy ``cKDTree`` over every classified point).

    One ``fusion:`` line names the path taken and the rows searched on the
    host. The fusion plan (pair path) or the host kNN index (host path) is
    built in a worker thread while the model runs; the index path runs on
    the device after it.

    ``profile_dir``: write a torch.profiler trace of the model phase
    there. ``timings`` (optional dict) receives per-phase seconds:
    ``model``, ``fusion_plan`` (worker thread, overlapped with the model;
    pair and host paths), ``fusion_wait``, ``fusion_index`` (index path)
    and ``fusion``."""
    dev = resolve_device(device)
    timings = {} if timings is None else timings
    cluster_features = tiling_cfg.cluster_features
    mode = predict_cfg.fusion
    if mode not in ("auto", "host", "tpu"):
        raise ValueError(f"unknown fusion mode {mode!r}")
    batcher = tile_batcher(tiles, predict_cfg, tiling_cfg)
    order = batcher.tile_order()
    query_xyz = xyz_of(pc)
    k = min(64 if predict_cfg.any_wood == 1 else 32,
            int(sum(len(tiles[ti]) for ti in order)))
    n_scales = len({t.grid_size for t in tiles})
    reason = device_fusion.declines(tiles, tiling_cfg.min_pts,
                                    cluster_features)
    if mode != "host" and reason is None:
        path = "pair"
    elif mode == "tpu" or (
            mode == "auto" and not cluster_features
            and tiling_cfg.min_pts >= device_fusion.K_PER_SCALE
            and k <= device_fusion.K_PER_SCALE * n_scales
            and all(t.cell_id >= 0 for t in tiles)):
        path = "index"
    else:
        path = "host"
    sink = (device_fusion.sink_for(tiles, batcher, dev) if path == "pair"
            else None)

    def source_xyz():
        return np.concatenate([tiles[ti].points[:, :3] for ti in order])

    def prepare():
        t = time.perf_counter()
        if path == "pair":
            out = device_fusion.plan_fusion(
                tiles, query_xyz, tiling_cfg.min_pts, sink.layout,
                cluster_features=cluster_features)
        elif path == "host":
            out = knn_indices(source_xyz(), query_xyz, k)
        else:
            return None
        timings["fusion_plan"] = time.perf_counter() - t
        return out

    ctx = contextlib.nullcontext()
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        ctx = profile(activities=activities)
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        prepared = ex.submit(prepare)
        t0 = time.perf_counter()
        with ctx as prof:
            classified = run_inference(
                tiles, net, predict_cfg, tiling_cfg, device=dev, sink=sink,
                with_readback=sink is None)
            _sync(dev)
        t1 = time.perf_counter()
        if profile_dir:
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(profile_dir, "model_phase.json"))
        timings["model"] = t1 - t0
        if verbose:
            n_pts = int(sum(len(t) for t in tiles))
            print(f"model phase: {t1 - t0:.2f}s, {len(tiles)} tiles, "
                  f"{n_pts} classified points "
                  f"({n_pts / max(t1 - t0, 1e-9):,.0f} pts/s)")
        prep = prepared.result()
    t2 = time.perf_counter()
    timings["fusion_wait"] = t2 - t1
    fusion = Fusion(predict_cfg.is_wood, predict_cfg.any_wood, device=dev)
    n_host = 0
    if path == "pair":
        fused = device_fusion.fuse_on_device(
            prep, sink.arrays(), query_xyz, predict_cfg.is_wood,
            predict_cfg.any_wood, verbose=verbose, device=dev,
            timings=timings)
        out = fusion.collect_predictions(None, pc, fused=fused)
        how = "device pair path (pair_select kernel + torch median/vote)"
    elif path == "index":
        indices, n_host = device_fusion.fusion_indices(
            tiles, order, source_xyz(), query_xyz, k, tiling_cfg.min_pts,
            cluster_features=cluster_features, device=dev)
        timings["fusion_index"] = time.perf_counter() - t2
        out = fusion.collect_predictions(classified, pc, indices=indices)
        how = (f"index path (tile-local device kNN, k={k} + torch "
               f"median/vote; pair path declined: {reason})")
    else:
        out = fusion.collect_predictions(classified, pc, indices=prep)
        n_host = len(query_xyz)
        how = ("host path (scipy cKDTree + torch median/vote"
               + (f"; pair path declined: {reason})" if reason else ")"))
    _sync(dev)
    timings["fusion"] = time.perf_counter() - t2
    print(f"fusion: {how}, {len(query_xyz)} points, {n_host} searched on "
          f"the host, in {timings['fusion']:.2f}s")
    return out
