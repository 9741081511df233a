"""Training engine (port of pointstowood_tpu/train/trainer.py).

Rebuild of the reference SemanticTraining loop
(reference: pointstowood/src/trainer.py:96-320): AdamW (lr 1e-4, wd 1e-2;
--tune: lr 1e-6 with cosine-warmup-restarts), Poly1 focal loss with label
smoothing 0.1, global-norm grad clipping at 1.0, per-*epoch* LR stepping,
per-batch metrics averaged batchwise, history CSV, epoch checkpoints and
rolling best-model saves, optional test split evaluated each epoch.

As in the JAX package:
  * the update is applied only when the loss and every gradient are
    finite (the reference snapshots the state dict before every batch and
    rolls back on errors, trainer.py:171-192); a skipped step also puts
    back the BatchNorm running statistics its forward had updated;
  * the optimizer is optax's: clip by global norm (scaled by
    max_norm / norm only when norm >= max_norm; ``clip_grad_norm_`` would
    add 1e-6), then AdamW (b1 0.9, b2 0.999, eps 1e-8) with weight decay on
    every parameter, the ReflectanceGate's gradient-free ones included;
  * compute runs in the model's dtype (bf16 is the AMP analogue) with fp32
    parameters, so no loss scaling is needed;
  * padded static-shape batches; the last partial batch is padded with
    empty tiles instead of dropped (the reference uses drop_last=True);
  * after training, the BatchNorm statistics are re-estimated under the
    eval sampling (see ``make_stats_step``).

Parameters, BatchNorm statistics and optimizer state live in the ``Net``
and the optimizer and are updated in place. Data parallelism (the JAX
package's ``mesh=``) is ``group=``, a ``parallel.DataGroup``: every
process builds the same shuffled global batch and uploads its own rows;
the BatchNorm statistics, the training centres, the loss's count of
valid points and the metrics are the global batch's, and the gradients
are summed over the group in one flat bucket before the finite guard and
the clip, so every process takes the same step and holds the same
parameters (``parallel/mesh.py``). Only process 0 writes files.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import math
import os
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from pointstowood_tpu_torch.config import ModelConfig, TilingConfig, TrainConfig
from pointstowood_tpu_torch.data.dataset import TileBatcher
from pointstowood_tpu_torch.data.tiling import Tile
from pointstowood_tpu_torch.model import Net
from pointstowood_tpu_torch.model.layers import set_data_group
from pointstowood_tpu_torch.ops.voxel import check_voxel_pack_range
from pointstowood_tpu_torch.parallel.mesh import (
    DataGroup,
    all_reduce_sum_,
    is_primary,
    round_batch_size,
    shard_rows,
    spans_processes,
)
from pointstowood_tpu_torch.predict.predicter import build_net
from pointstowood_tpu_torch.train.augmentation import augment_tile
from pointstowood_tpu_torch.train.loss import poly1_focal_loss
from pointstowood_tpu_torch.train.metrics import batch_metrics, binary_counts
from pointstowood_tpu_torch.train.schedule import (
    cosine_warmup_restarts_lr,
    onecycle_cos_lr,
)
from pointstowood_tpu_torch.utils import trace
from pointstowood_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from pointstowood_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    net: Net
    optimizer: torch.optim.Optimizer
    epoch: int = 0


def init_parameters(net: torch.nn.Module, generator: torch.Generator):
    """The reference's (torch's default) initialisation, drawn from
    ``generator``: Linear and Conv1d weights kaiming-uniform with
    a = sqrt(5), biases (where a layer has one) uniform in
    +-1/sqrt(fan_in); BatchNorm and LayerNorm at identity.
    Returns ``net``."""
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, (torch.nn.Linear, torch.nn.Conv1d)):
                torch.nn.init.kaiming_uniform_(mod.weight, a=math.sqrt(5),
                                               generator=generator)
                if mod.bias is not None:
                    fan_in = mod.weight[0].numel()
                    bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0.0
                    torch.nn.init.uniform_(mod.bias, -bound, bound,
                                           generator=generator)
            elif isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.LayerNorm)):
                mod.reset_parameters()
    return net


def build_train_net(model_cfg: ModelConfig, seed: int, device=None) -> Net:
    """``predict.predicter.build_net``'s Net with fresh weights from
    ``seed`` (drawn on the CPU, so every device gets the same), on
    ``device`` (default CUDA)."""
    dev = resolve_device(device)
    net = build_net(model_cfg, device="cpu")
    return init_parameters(net, torch.Generator().manual_seed(seed)).to(dev)


def make_optimizer(net: Net, cfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW over every parameter; the learning rate is set per epoch
    (like the reference schedulers, trainer.py:123,219) by the train step,
    and the clipping runs in the train step before it."""
    return torch.optim.AdamW(net.parameters(), lr=0.0, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=cfg.weight_decay)


def epoch_lr(cfg: TrainConfig, epoch0: int) -> float:
    """LR for 0-based epoch index, matching the reference's two schedules."""
    if cfg.tune:
        return cosine_warmup_restarts_lr(
            epoch0,
            first_cycle_steps=max(cfg.num_epochs // 5, 6),
            max_lr=cfg.tune_lr, min_lr=1e-8, warmup_steps=5, gamma=0.5,
        )
    return onecycle_cos_lr(
        epoch0, max_lr=cfg.learning_rate, total_steps=cfg.num_epochs,
        pct_start=0.05, div_factor=100.0,
    )


_STEP = threading.local()  # .replays: the running train step's graphs


@contextlib.contextmanager
def _replaying(replays: dict):
    """``replayed`` keeps its graphs in ``replays`` (a train step's own)
    inside this block; outside any, it runs its function as it is."""
    before = getattr(_STEP, "replays", None)
    _STEP.replays = replays
    try:
        yield
    finally:
        _STEP.replays = before


def replayed(fn, tensors: Sequence[torch.Tensor]):
    """``fn(tensors)`` (pure, a few kernels a tensor) through a CUDA
    graph of the kernels it launches, captured when it first meets these
    tensors (each one's address, shape, strides and dtype) and replayed
    while they come back (the train step's gradients keep theirs:
    ``zero_grad(set_to_none=False)``), so a call costs one launch; the
    same kernels on the same memory give the same results. Its outputs
    are overwritten by the next replay. The graphs are the running train
    step's (``_replaying``); outside a step, and on the CPU, ``fn`` runs
    as it is."""
    replays = getattr(_STEP, "replays", None)
    if replays is None or not tensors[0].is_cuda:
        return fn(tensors)
    key = tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype,
                 t.device) for t in tensors)
    entry = replays.get(fn)
    if entry is None or entry[0] != key:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(tensors)  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(tensors)
        entry = replays[fn] = (key, graph, out)
    entry[1].replay()
    return entry[2]


def _sums_of_squares(grads):
    return torch.stack([torch.sum(t) for t in torch._foreach_mul(grads,
                                                                 grads)])


def _finite(tensors):
    return torch.isfinite(torch.cat([t.reshape(-1) for t in tensors])).all()


def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient becomes
    ``g / norm * max_norm`` when ``norm >= max_norm``, else stays. Returns
    the norm (a 0-d float32 tensor on the gradients' device).

    The norm is sqrt of the tensors' sums of squares added one after
    another in float32, as a chain of 0-d additions would add them: the
    sums are taken on the device (``replayed``) and added on the host (one
    read, which waits for them), so a step launches no addition kernel a
    tensor; IEEE float32 additions and square roots round alike on both
    sides. At or past the limit the scaling is two foreach kernels (a
    division by the norm, then a product by the limit: the same two
    roundings of each element)."""
    sums = replayed(_sums_of_squares, grads)
    host = np.sqrt(np.cumsum(sums.cpu().numpy(), dtype=np.float32)[-1])
    norm = torch.tensor(host, device=grads[0].device)
    if not host < np.float32(max_norm):
        grads = list(grads)
        torch._foreach_div_(grads, norm)
        torch._foreach_mul_(grads, max_norm)
    return norm


def all_finite(loss: torch.Tensor, grads: Sequence[torch.Tensor]
               ) -> torch.Tensor:
    """Whether the loss and every gradient are finite (a 0-d bool tensor,
    no host sync), the gradients over one flat copy (``replayed``)."""
    return torch.isfinite(loss) & replayed(_finite, grads)


def flat_copy(tensors: Sequence[torch.Tensor]) -> list:
    """A copy of ``tensors`` as one flat tensor a dtype, in few launches;
    ``restore_`` writes it back."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return [(ts, torch.cat([t.reshape(-1) for t in ts]))
            for ts in groups.values()]


def restore_(saved: list) -> None:
    with torch.no_grad():
        for ts, flat in saved:
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))


def make_train_step(net: Net, optimizer: torch.optim.Optimizer,
                    loss_cfg: TrainConfig, group: DataGroup | None = None):
    """One training step over a padded batch: forward with random 50%
    centres and masked batch statistics, Poly1 focal loss, backward, the
    finite guard, clipping and the AdamW update, all in place.

    train_step(pos, refl, mask, sf, labels, lr, generator) -> (loss,
    counts, finite): the loss (0-d tensor), the (tp, fp, tn, fn) counts of
    the batch's predictions, and whether the update was applied.

    ``group``: the inputs are this process's rows of the global batch
    (``parallel.shard_rows``) and ``net`` takes its statistics over the
    group (``set_data_group``); the gradients, loss and counts are summed
    over the group in one collective, so the finite guard and the clip
    read the global gradients and every process applies the same
    update.

    Traced (``utils/trace.py``) as ``step`` (its request: the step's
    number) over ``step.forward``, ``step.backward`` (loss, backward,
    counts, the collective), ``step.guard`` (the host's read of the
    finite flag, which waits for the device) and ``step.update`` (clip
    and AdamW, or the statistics' restore), each with device marks; the
    step then reads the flag again, which waits for the update."""
    params = list(net.parameters())
    buffers = [b for _, b in net.named_buffers()]
    steps = itertools.count()
    replays: dict = {}  # the guard's and the clip's graphs (``replayed``)

    @trace.entry_point
    def train_step(pos, refl, mask, sf, labels, lr: float,
                   generator: torch.Generator):
        dev = pos.device
        with trace.span("step", request=next(steps)):
            with trace.span("step.forward", marks=dev):
                saved = flat_copy(buffers)
                optimizer.zero_grad(set_to_none=False)
                logits = net(pos, refl, mask, sf, training=True,
                             generator=generator)
            with trace.span("step.backward", marks=dev):
                loss, _ = poly1_focal_loss(
                    logits, labels, epsilon=loss_cfg.poly_epsilon,
                    gamma=loss_cfg.focal_gamma, alpha=None,
                    label_smoothing=loss_cfg.label_smoothing, mask=mask,
                    reduction="mean", group=group)
                loss.backward()
                for p in params:
                    # parameters off the graph (the ReflectanceGate) get a
                    # zero gradient, so AdamW still decays them as optax
                    # does
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                grads = [p.grad for p in params]
                with torch.no_grad():
                    preds = (torch.sigmoid(logits) >= 0.5).float()
                    counts = binary_counts(preds, labels, mask)
                loss = loss.detach()
                if spans_processes(group):
                    # one bucket: every gradient, the loss and the counts,
                    # summed in float64 (exact for two float32 shares, and
                    # rounded once for more, so a gradient that the
                    # shares' signs cancel keeps the one process's
                    # precision)
                    flat = all_reduce_sum_(group, torch.cat(
                        [g.reshape(-1) for g in grads]
                        + [loss.reshape(1), counts]).double())
                    for g, part in zip(grads, flat.split(
                            [g.numel() for g in grads] + [1, 4])):
                        g.copy_(part.view_as(g))
                    loss, counts = flat[-5].float(), flat[-4:].float()
            # the host waits here for the device to finish the backward
            with trace.span("step.guard", marks=dev), _replaying(replays):
                finite = all_finite(loss, grads)
                ok = bool(finite)
            with trace.span("step.update", marks=dev), _replaying(replays):
                if ok:
                    clip_by_global_norm_(grads, loss_cfg.grad_clip_norm)
                    for param_group in optimizer.param_groups:
                        param_group["lr"] = lr
                    optimizer.step()
                else:
                    restore_(saved)
            # the second read waits for the update, so the step ends with
            # the device drained
            finite = bool(finite)
        return loss, counts, finite

    return train_step


def make_stats_step(net: Net):
    """Eval-sampling forward that refreshes the BatchNorm running
    statistics.

    Training collects BN stats under random-50% sampling, but inference
    samples voxel representatives; the activation distributions differ
    enough that train-collected running stats collapse eval accuracy
    (measured in the JAX package: BA 0.87 -> 0.57 on identical data).
    After training, a few passes of this step over the training tiles
    re-estimate the stats under the sampling the model will see at
    inference. (The reference has the same train/eval asymmetry,
    model.py:113-116, and no such correction.)"""

    def stats_step(pos, refl, mask, sf):
        with torch.no_grad():
            net(pos, refl, mask, sf, training=False,
                use_running_average=False)

    return stats_step


@trace.entry_point
def _batch_arrays(batch, device: torch.device,
                  group: DataGroup | None = None):
    """The batch's arrays as tensors on ``device``: this process's rows of
    them under ``group`` (traced as ``batch.upload``)."""
    with trace.span("batch.upload"):
        arrays = shard_rows(group, batch.pos, batch.reflectance, batch.mask,
                            batch.sf, batch.labels)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            device, non_blocking=True) for a in arrays)


def recalibrate_batch_stats(net: Net, tiles, cfg: TrainConfig,
                            tiling_cfg: TilingConfig, passes: int = 3,
                            stats_step=None, device=None,
                            group: DataGroup | None = None) -> None:
    """EMA the BN running stats of ``net`` in place under eval-path
    forwards (see make_stats_step). A few shuffled passes give the
    momentum-0.1 EMA a >=30-batch horizon on typical tile counts. Under
    ``group`` each process forwards its rows of every batch."""
    dev = resolve_device(device)
    if stats_step is None:
        stats_step = make_stats_step(net)
    for p in range(passes):
        batcher = TileBatcher(
            tiles, batch_size=cfg.batch_size,
            min_pts=tiling_cfg.min_pts, max_pts=tiling_cfg.max_pts,
            with_labels=True, shuffle=True, seed=cfg.seed + 77_000 + p,
            bucket=False,
        )
        for _, batch, _ in batcher:
            pos, refl, mask, sf, _ = _batch_arrays(batch, dev, group)
            stats_step(pos, refl, mask, sf)


def make_eval_step(net: Net, group: DataGroup | None = None):
    """eval_step(pos, refl, mask, sf, labels) -> the (tp, fp, tn, fn)
    counts of the batch (of the global batch under ``group``)."""
    def eval_step(pos, refl, mask, sf, labels):
        with torch.no_grad():
            logits = net(pos, refl, mask, sf, training=False)
            preds = (torch.sigmoid(logits) >= 0.5).float()
            return all_reduce_sum_(group, binary_counts(preds, labels, mask))

    return eval_step


@trace.entry_point
def semantic_training(
    train_tiles: Sequence[Tile],
    cfg: TrainConfig,
    model_cfg: ModelConfig,
    tiling_cfg: TilingConfig,
    wdir: str = ".",
    model_name: str = "model.pth",
    test_tiles: Optional[Sequence[Tile]] = None,
    checkpoints: Sequence[int] = (),
    use_wandb: bool = False,
    verbose: bool = False,
    log_fn: Callable[[str], None] = print,
    device=None,
    group: DataGroup | None = None,
):
    """Run the full training loop on ``device`` (default CUDA); returns
    the final TrainState and the history.

    ``group`` (a ``parallel.DataGroup``, the counterpart of the JAX
    package's ``mesh=``): every process runs this loop on the same tiles
    and the same seeded, shuffled global batches, and forwards its rows
    of each; batch sizes are rounded to a multiple of the number of
    processes (padding tiles are all-masked, so metrics and BatchNorm
    statistics are unaffected). Parameters, statistics, optimizer state
    and history come out the same on every process; only process 0
    writes checkpoints and the history.

    History rows match the reference CSV layout (trainer.py:256-267):
    [epoch, lr, train_loss, train_ba, train_f1, train_precision,
    train_recall, (+ test_ba, test_f1, test_precision, test_recall)].
    Checkpoints take ``model_name``'s format (a reference-layout
    ``.pth``/``.pt``, else the JAX package's flax msgpack, e.g. ``.ckpt``):
    ``<wdir>/model/<model_name>``, ``<wdir>/model/{ba,f1,precision}-
    <model_name>`` and ``<wdir>/checkpoints/epoch_<n>`` with its suffix.
    An existing ``<wdir>/model/<model_name>`` is resumed from."""
    dev = resolve_device(device)
    net = set_data_group(build_train_net(model_cfg, cfg.seed, device=dev),
                         group)
    if isinstance(net, Net):
        check_voxel_pack_range(max(tiling_cfg.grid_size),
                               min(net.sa_resolutions))
    eval_batch_size = max(cfg.batch_size // 2, 1)
    if group is not None:
        bs = round_batch_size(cfg.batch_size, group)
        if bs != cfg.batch_size:
            log_fn(f"Rounding batch_size {cfg.batch_size} -> {bs} "
                   f"({group.world_size} processes)")
            cfg = dataclasses.replace(cfg, batch_size=bs)
        w = group.world_size
        eval_batch_size = max(cfg.batch_size // 2, w) // w * w

    # one process writes (the others hold the same state)
    primary = is_primary(group)

    def save_ckpt(path, module):
        if primary:
            save_checkpoint(path, module)

    model_path = os.path.join(wdir, "model", model_name)
    if primary:
        os.makedirs(os.path.join(wdir, "model"), exist_ok=True)
    # every process looks before process 0 may write the file
    found = os.path.isfile(model_path)
    if spans_processes(group):
        torch.distributed.barrier(group=group.process_group)
    if found:
        log_fn("Loading model")
        try:
            load_checkpoint(model_path, net)
        except (RuntimeError, ValueError, KeyError, EOFError) as e:
            # the reference creates a fresh file when the load fails
            log_fn(f"Failed to load ({e}), creating new...")
            save_ckpt(model_path, net)
    else:
        log_fn("\nModel not found, creating new file...")
        save_ckpt(model_path, net)

    optimizer = make_optimizer(net, cfg)
    n_params = sum(p.numel() for p in net.parameters())
    log_fn(f"Model contains {n_params} parameters")
    train_step = make_train_step(net, optimizer, cfg, group)
    eval_step = make_eval_step(net, group)

    if use_wandb:
        import wandb

        wandb.init(
            project="PointsToWood",
            config={
                "architecture": "pointnet++",
                "dataset": "high resolution 2 & 4 m voxels",
                "epochs": cfg.num_epochs,
            },
        )

    history = []
    best = {"ba_train": 0.0, "f1_train": 0.0, "ba_test": 0.0, "f1_test": 0.0,
            "precision_test": 0.0}
    best_snapshots: dict = {}  # prefix -> state_dict before recalibration
    sample_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 2)

    # Best-model saves must be usable if the run is killed mid-training:
    # train-path BN stats collapse eval BA, so each best save recalibrates
    # a copy of the stats over a fixed tile subsample first (one pass; the
    # end-of-run re-save below does the full recalibration).
    stats_step = make_stats_step(net)
    calib_rng = np.random.default_rng(cfg.seed + 55_000)
    calib_tiles = list(train_tiles)
    calib_rng.shuffle(calib_tiles)
    calib_tiles = calib_tiles[: max(16 * cfg.batch_size, 32)]

    def save_best(stat, key, path_prefix):
        if stat > best[key]:
            best[key] = stat
            p = os.path.join(wdir, "model",
                             path_prefix + os.path.basename(model_name))
            snapshot = {k: v.clone() for k, v in net.state_dict().items()}
            recalibrate_batch_stats(net, calib_tiles, cfg, tiling_cfg,
                                    passes=1, stats_step=stats_step,
                                    device=dev, group=group)
            save_ckpt(p, net)
            net.load_state_dict(snapshot)
            # remember for the end-of-run full BN recalibration re-save
            best_snapshots[path_prefix] = snapshot
            log_fn(f"Saving {p}")
        return best[key]

    for epoch in range(1, cfg.num_epochs + 1):
        lr = epoch_lr(cfg, epoch - 1)
        batcher = TileBatcher(
            train_tiles, batch_size=cfg.batch_size,
            min_pts=tiling_cfg.min_pts, max_pts=tiling_cfg.max_pts,
            with_labels=True, shuffle=True, seed=cfg.seed + epoch,
            augment=(functools.partial(augment_tile, mode="train")
                     if cfg.augmentation else None),
            bucket=False,  # mixed-size batches: see TileBatcher docstring
        )
        sums = {"loss": 0.0, "precision": 0.0, "recall": 0.0,
                "balanced_accuracy": 0.0, "f1": 0.0}
        n_batches = 0
        for _, batch, _ in batcher:
            pos, refl, mask, sf, labels = _batch_arrays(batch, dev, group)
            loss, counts, finite = train_step(pos, refl, mask, sf, labels,
                                              lr, sample_gen)
            if not finite:
                log_fn("Skipping a batch due to non-finite loss/grads")
                continue
            m = batch_metrics(counts)
            sums["loss"] += float(loss)
            for k in ("precision", "recall", "balanced_accuracy", "f1"):
                sums[k] += m[k]
            n_batches += 1
        n_batches = max(n_batches, 1)
        row = [
            epoch, lr, sums["loss"] / n_batches,
            sums["balanced_accuracy"] / n_batches, sums["f1"] / n_batches,
            sums["precision"] / n_batches, sums["recall"] / n_batches,
        ]
        if verbose:
            log_fn(
                f"epoch {epoch} lr {lr:.3g} loss {row[2]:.4f} "
                f"ba {row[3]:.3f} f1 {row[4]:.3f}"
            )

        test_row = []
        if test_tiles is not None:
            tsums = {"precision": 0.0, "recall": 0.0,
                     "balanced_accuracy": 0.0, "f1": 0.0}
            tn = 0
            tbatcher = TileBatcher(
                test_tiles, batch_size=eval_batch_size,
                min_pts=tiling_cfg.min_pts, max_pts=tiling_cfg.max_pts,
                with_labels=True, shuffle=True, seed=cfg.seed + 10_000 + epoch,
                augment=(functools.partial(augment_tile, mode="test")
                         if cfg.augmentation else None),
                bucket=False,
            )
            for _, batch, _ in tbatcher:
                pos, refl, mask, sf, labels = _batch_arrays(batch, dev,
                                                            group)
                m = batch_metrics(eval_step(pos, refl, mask, sf, labels))
                for k in tsums:
                    tsums[k] += m[k]
                tn += 1
            tn = max(tn, 1)
            test_row = [
                tsums["balanced_accuracy"] / tn, tsums["f1"] / tn,
                tsums["precision"] / tn, tsums["recall"] / tn,
            ]
        history.append(row + test_row)

        # history CSV (trainer.py:138-145)
        hist_path = os.path.join(
            wdir, "model", os.path.splitext(model_name)[0] + "_history.csv"
        )
        if primary:
            try:
                np.savetxt(hist_path, np.asarray(history))
            except OSError:
                np.savetxt(hist_path + ".backup", np.asarray(history))

        if epoch in set(int(c) for c in checkpoints) and primary:
            ckpt_dir = os.path.join(wdir, "checkpoints")
            os.makedirs(ckpt_dir, exist_ok=True)
            suffix = os.path.splitext(model_name)[1]
            save_checkpoint(
                os.path.join(ckpt_dir, f"epoch_{epoch}{suffix}"), net)

        # Early stopping: reproduced faithfully from trainer.py:279-293 —
        # the counter is re-initialized every epoch there, so the >=10
        # branch can never fire; training effectively never stops early.
        if cfg.stop_early and epoch > 10:
            consec_decreases = 0
            if history[-1][3] < history[-2][3]:
                consec_decreases += 1
            if consec_decreases >= 10:  # pragma: no cover - inert by design
                log_fn(f"Stopping early at epoch {epoch}")
                break

        if epoch > int(cfg.num_epochs * 0.10) and test_tiles is None:
            save_best(row[3], "ba_train", "ba-")
            save_best(row[4], "f1_train", "f1-")
        if test_tiles is not None and epoch > int(cfg.num_epochs * 0.5):
            save_best(test_row[0], "ba_test", "ba-")
            save_best(test_row[1], "f1_test", "f1-")
            save_best(test_row[2], "precision_test", "precision-")

        if epoch == cfg.num_epochs:
            log_fn("Recalibrating BatchNorm statistics under the eval path")
            recalibrate_batch_stats(net, train_tiles, cfg, tiling_cfg,
                                    stats_step=stats_step, device=dev,
                                    group=group)
            log_fn("Saving final GLOBAL model")
            save_ckpt(model_path, net)
            # re-save the rolling best checkpoints with their own
            # recalibrated statistics
            final = {k: v.clone() for k, v in net.state_dict().items()}
            for prefix, snapshot in best_snapshots.items():
                net.load_state_dict(snapshot)
                recalibrate_batch_stats(net, train_tiles, cfg, tiling_cfg,
                                        passes=2, stats_step=stats_step,
                                        device=dev, group=group)
                p = os.path.join(
                    wdir, "model", prefix + os.path.basename(model_name)
                )
                save_ckpt(p, net)
                log_fn(f"Re-saved {p} with recalibrated BN statistics")
            net.load_state_dict(final)

        if use_wandb:
            import wandb

            wandb.log({
                "Epoch": epoch, "Learning Rate": lr,
                "Loss": round(row[2], 4), "Accuracy": round(row[3], 4),
                "Precision": round(row[5], 4), "Recall": round(row[6], 4),
                "F1": round(row[4], 4),
                "Test F1": round(test_row[1], 4) if test_row else 0.0,
                "Test Accuracy": round(test_row[0], 4) if test_row else 0.0,
            })

    return TrainState(net=net, optimizer=optimizer,
                      epoch=cfg.num_epochs), history
