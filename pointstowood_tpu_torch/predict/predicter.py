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

Data parallelism (the JAX package's ``mesh=``) is ``group=``, a
``parallel.DataGroup``: every process tiles the same cloud and iterates
the same batches, forwards its own rows of each (``parallel.shard_rows``)
and gathers the batch's probabilities back (``parallel.fetch``), so every
process ends with every tile's probabilities; the pair fusion splits its
entries over the processes.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
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
from pointstowood_tpu_torch.model.point_transformer import PointTransformerSeg
from pointstowood_tpu_torch.ops.voxel import check_voxel_pack_range
from pointstowood_tpu_torch.parallel.mesh import (
    DataGroup,
    fetch,
    round_batch_size,
    shard_rows,
    spans_processes,
)
from pointstowood_tpu_torch.predict import device_fusion
from pointstowood_tpu_torch.predict.fusion import (
    NBRS_CACHE,
    Fusion,
    knn_indices,
)
from pointstowood_tpu_torch.utils import trace
from pointstowood_tpu_torch.utils.device import resolve_device


def build_net(model_cfg: ModelConfig, device=None) -> torch.nn.Module:
    """The eval-mode network of a model config (``model_cfg.arch``: the
    ``Net``, or ``PointTransformerSeg`` for 'ptv1'), on ``device``
    (default CUDA). Load weights with ``utils.checkpoint.load_checkpoint``
    or ``net.load_state_dict`` (reference layout; see
    utils/checkpoint_convert.py)."""
    dev = resolve_device(device)
    if model_cfg.arch == "ptv1":
        net = PointTransformerSeg(
            num_classes=model_cfg.num_classes, channels=model_cfg.channels,
            knn_method=model_cfg.knn_mode,
            dtype=getattr(torch, model_cfg.compute_dtype))
        return net.to(dev).eval()
    if model_cfg.arch != "ptw":
        raise ValueError(f"unknown architecture {model_cfg.arch!r}")
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


def tile_batcher(tiles, predict_cfg, tiling_cfg,
                 group: DataGroup | None = None) -> TileBatcher:
    """The batcher ``run_inference`` iterates: bucketed capacities with
    scaled batch sizes, deterministic order. Under ``group`` the batch
    size is rounded to a multiple of the number of processes (the JAX
    package's rule), which every scaled batch size keeps: each is a
    multiple of it."""
    return TileBatcher(
        tiles, batch_size=round_batch_size(predict_cfg.batch_size, group),
        min_pts=tiling_cfg.min_pts, max_pts=tiling_cfg.max_pts,
        capacity_step=2, scale_batch=True,
    )


@trace.entry_point
def run_inference(
    tiles: Sequence[Tile],
    net: Net,
    predict_cfg: PredictConfig,
    tiling_cfg: TilingConfig,
    device=None,
    sink: device_fusion.FlatSink | None = None,
    with_readback: bool = True,
    group: DataGroup | None = None,
) -> np.ndarray | None:
    """Classify all tiles; returns (M, 5) float64 rows [x, y, z, pred,
    prob] for every valid tile point, tiles in batcher order (reference
    predicter.py:192-217). ``net`` must live on ``device`` (default
    CUDA). The host readback of batch i overlaps the device work of batch
    i+1 (two batches in flight).

    ``sink``: a ``device_fusion.FlatSink`` that receives each batch's
    device positions and probabilities as they are produced. With
    ``with_readback=False`` nothing is read back (the device pair path
    never needs the classified rows) and the function returns None.

    ``group``: this process forwards its rows of every batch and gathers
    the batch's probabilities from the others, so it returns every row,
    as one process would. A sink cannot hold the other processes' rows
    (as in the JAX package): it is refused under a group."""
    dev = resolve_device(device)
    if isinstance(net, Net):
        check_voxel_pack_range(max(tiling_cfg.grid_size),
                               min(net.sa_resolutions))
    if sink is not None and spans_processes(group):
        raise ValueError("run_inference: a FlatSink takes one process's "
                         "batches; under a data group fuse from the "
                         "gathered rows (device_fusion.layout_tight)")
    batcher = iter(tile_batcher(tiles, predict_cfg, tiling_cfg, group))
    outputs = []
    pending = []  # (device probs, host batch)

    def drain(entry):
        probs_dev, batch = entry
        with trace.span("model.drain"):
            probs = probs_dev.float().cpu().numpy()
        preds = (probs >= predict_cfg.is_wood).astype(np.float64)
        xyz = (batch.pos.astype(np.float64)
               + batch.shift[:, None, :].astype(np.float64))
        out = np.concatenate(
            [xyz, preds[..., None], probs.astype(np.float64)[..., None]],
            axis=-1)
        outputs.append(out[batch.mask])

    n_batches = 0
    while True:
        with trace.span("model.batch"):
            item = next(batcher, None)
        if item is None:
            break
        batch = item[1]
        n_batches += 1
        with trace.span("model.upload"):
            pos, refl, mask, sf = (
                torch.from_numpy(a).to(dev, non_blocking=True)
                for a in shard_rows(group, batch.pos, batch.reflectance,
                                    batch.mask, batch.sf))
        with trace.span("model.forward"):
            probs_dev = fetch(group, forward_probs(net, pos, refl, mask, sf))
        if sink is not None:
            with trace.span("model.sink"):
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


@trace.entry_point
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
    group: DataGroup | None = None,
) -> dict:
    """Classify the tiles and fuse the predictions onto every row of the
    column table ``pc``; returns a new table with ``label`` and ``pwood``
    set. ``net`` must live on ``device`` (default CUDA).

    Fusion path (``predict_cfg.fusion``), as the JAX package chooses it
    (pointstowood_tpu/predict/predicter.py:233-270, 329-361):

    * the host path with the indices of ``nbrs.npy``, and no search,
      whenever the working directory holds that cache (whatever the mode);
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
    there (``model_phase.json``). ``timings`` (optional dict) receives
    per-phase seconds, each the tracer's span of that name
    (``utils/trace.py``): ``model``, ``fusion_plan`` (worker thread,
    overlapped with the model; pair and host paths), ``fusion_wait``,
    ``fusion_index`` (index path) and ``fusion``.

    ``group`` (a ``parallel.DataGroup``): every process classifies its
    rows of every batch and gathers the rest (``run_inference``). The
    pair path then fuses from the gathered probabilities in the tight
    host-upload layout (``device_fusion.layout_tight``; the JAX package
    takes it too, its FlatSink holding one process's rows), each process
    selecting over its share of the entries and gathering the codes; the
    index and host paths run whole on every process. Every process
    returns the same table."""
    dev = resolve_device(device)
    timings = {} if timings is None else timings
    cluster_features = tiling_cfg.cluster_features
    mode = predict_cfg.fusion
    if mode not in ("auto", "host", "tpu"):
        raise ValueError(f"unknown fusion mode {mode!r}")
    batcher = tile_batcher(tiles, predict_cfg, tiling_cfg, group)
    order = batcher.tile_order()
    query_xyz = xyz_of(pc)
    k = min(64 if predict_cfg.any_wood == 1 else 32,
            int(sum(len(tiles[ti]) for ti in order)))
    n_scales = len({t.grid_size for t in tiles})
    reason = device_fusion.declines(tiles, tiling_cfg.min_pts,
                                    cluster_features)
    if os.path.exists(NBRS_CACHE):
        path = "cache"
    elif mode != "host" and reason is None:
        path = "pair"
    elif mode == "tpu" or (
            mode == "auto" and not cluster_features
            and tiling_cfg.min_pts >= device_fusion.K_PER_SCALE
            and k <= device_fusion.K_PER_SCALE * n_scales
            and all(t.cell_id >= 0 for t in tiles)):
        path = "index"
    else:
        path = "host"
    sink = layout = None
    if path == "pair" and not spans_processes(group):
        sink = device_fusion.sink_for(tiles, batcher, dev)
        layout = sink.layout
    elif path == "pair":
        layout = device_fusion.layout_tight(tiles, order)

    def source_xyz():
        return np.concatenate([tiles[ti].points[:, :3] for ti in order])

    def prepare(parent):
        if path == "pair":
            with trace.timed(timings, "fusion_plan", parent=parent):
                return device_fusion.plan_fusion(
                    tiles, query_xyz, tiling_cfg.min_pts, layout,
                    cluster_features=cluster_features)
        if path == "host":
            with trace.timed(timings, "fusion_plan", parent=parent), \
                    trace.span("fusion.host_search"):
                trace.count("fusion.host_rows", len(query_xyz))
                return knn_indices(source_xyz(), query_xyz, k)
        return None

    ctx = contextlib.nullcontext()
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        ctx = profile(activities=activities)
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        prepared = ex.submit(prepare, trace.current())
        with trace.timed(timings, "model"):
            with ctx as prof:
                if profile_dir:  # the spans' place on this profile's clock
                    trace.anchor()
                classified = run_inference(
                    tiles, net, predict_cfg, tiling_cfg, device=dev,
                    sink=sink, with_readback=sink is None, group=group)
                _sync(dev)
        if profile_dir:
            trace.resolve(prof.profiler.kineto_results.events())
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(profile_dir, "model_phase.json"))
        if verbose:
            n_pts = int(sum(len(t) for t in tiles))
            dt = timings["model"]
            print(f"model phase: {dt:.2f}s, {len(tiles)} tiles, "
                  f"{n_pts} classified points "
                  f"({n_pts / max(dt, 1e-9):,.0f} pts/s)")
        with trace.timed(timings, "fusion_wait"):
            prep = prepared.result()
    with trace.timed(timings, "fusion"):
        fusion = Fusion(predict_cfg.is_wood, predict_cfg.any_wood,
                        device=dev)
        n_host = 0
        if path == "pair":
            resident = (sink.arrays() if sink is not None else
                        device_fusion.resident_tight(tiles, order, layout,
                                                     classified[:, 4], dev))
            fused = device_fusion.fuse_on_device(
                prep, resident, query_xyz, predict_cfg.is_wood,
                predict_cfg.any_wood, verbose=verbose, device=dev,
                group=group)
            out = fusion.collect_predictions(None, pc, fused=fused)
            how = "device pair path (pair_select kernel + torch median/vote"
            how += (")" if not spans_processes(group) else
                    f"; entries split over {group.world_size} processes)")
        elif path == "index":
            with trace.timed(timings, "fusion_index"):
                indices, n_host = device_fusion.fusion_indices(
                    tiles, order, source_xyz(), query_xyz, k,
                    tiling_cfg.min_pts, cluster_features=cluster_features,
                    device=dev)
            out = fusion.collect_predictions(classified, pc, indices=indices)
            how = (f"index path (tile-local device kNN, k={k} + torch "
                   f"median/vote; pair path declined: {reason})")
        elif path == "cache":
            out = fusion.collect_predictions(classified, pc)
            how = (f"host path (indices of {NBRS_CACHE}, no search + torch "
                   "median/vote)")
        else:
            out = fusion.collect_predictions(classified, pc, indices=prep)
            n_host = len(query_xyz)
            how = ("host path (scipy cKDTree + torch median/vote"
                   + (f"; pair path declined: {reason})" if reason else ")"))
        _sync(dev)
    print(f"fusion: {how}, {len(query_xyz)} points, {n_host} searched on "
          f"the host, in {timings['fusion']:.2f}s")
    return out
