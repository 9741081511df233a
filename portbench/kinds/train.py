"""Traffic kind ``train``: a user training on labelled plots.

Set-up makes one labelled plot (the traffic's fixed layout, the seed's
reflectances and row order; trunk points are wood),
tiles it with the program's preprocessing at the traffic's tiling, makes
the configuration's weights on the device, and builds one training
object: the program's network of the configuration's architecture
(``arch/<name>.py``, its ``build``) with those weights, its AdamW
(``make_optimizer``) and its step (``make_train_step``). It drives that
object through its first steps, as the window does, and hands it to the
window. The window continues the trainer's loop: ``TileBatcher``
epochs shuffled from the seed (``TrainConfig.seed``) back to back, each batch uploaded
(``trainer._batch_arrays``) and stepped, until ``--seconds`` have passed.

Judged after the window: the tiling and the judged steps' batches
against the reference's; the reference's first steps from the same
weights and the same centre draws: each step's loss and confusion
counts, the first gradient as the optimizer got it (from AdamW's first
moment after one step) and the change of every parameter and running
statistic after the last of them, leaf by leaf; and one step of the
measured window, drawn from the seed past the traced steps: the
reference takes that step from the program's state before it (weights,
running statistics, AdamW's moments and count, the centre generator) on
its own batch, and its loss, counts and change are compared with the
program's.
"""

from __future__ import annotations

import contextlib
import itertools
import time

import numpy as np
import torch

from portbench import arch, plots, probe, weights
from portbench.kinds import tile_mismatch
from portbench.reference import tiling as ref_tiling
from portbench.reference.net import Products
from portbench.reference.train import BUFFER_SUFFIXES, Trainer

BETA1 = 0.9
TRACED_FROM = 5  # the traced window's first step of the measured window


class Cell:
    def __init__(self, cell, seed: int, device, fault: str | None = None):
        self.cell = cell
        self.model = cell.config["model"]
        self.arch = arch.load(self.model)
        self.traffic = cell.traffic
        self.seed = seed
        self.device = torch.device(device)
        self.fault = fault
        self.steps = []
        self.tracer = None
        self.work = None

    # ---------------------------------------------------------- set-up
    def setup(self):
        from pointstowood_tpu_torch.config import TilingConfig, TrainConfig
        from pointstowood_tpu_torch.data.tiling import preprocess_cloud
        from pointstowood_tpu_torch.io.loader import canonicalize_columns
        from pointstowood_tpu_torch.train.trainer import (
            make_optimizer,
            make_train_step,
        )

        tr = self.traffic
        spec = tr["plot"]
        table, wood = plots.synthetic_plot(tr["layout_seed"], spec["n_side"],
                                           spec["density"], seed=self.seed)
        self.table = dict(table, truth=wood.astype(np.float64))
        pc, _, _ = canonicalize_columns(dict(self.table), mode="train")
        self.tiling = TilingConfig(grid_size=tuple(tr["grid_size"]),
                                   min_pts=tr["min_pts"],
                                   max_pts=tr["max_pts"])
        self.tiles = preprocess_cloud(pc, self.tiling, with_labels=True)
        m = self.model
        self.w0 = weights.make_weights(m, self.seed, self.device)
        net = self.arch.build(m)
        net.load_state_dict(self.w0)
        self.net = net.to(self.device)
        self.cfg = TrainConfig(batch_size=tr["batch_size"],
                               learning_rate=tr["learning_rate"],
                               seed=self.seed)
        self.opt = make_optimizer(self.net, self.cfg)
        self.step_fn = make_train_step(self.net, self.opt, self.cfg)
        self.gen = torch.Generator(device=self.device).manual_seed(
            self.seed + 2)
        self.epoch = 0
        self.feed = self._batches()
        self.judged = []
        names = [k for k, _ in self.net.named_parameters()]
        for i in range(tr["judged_steps"]):
            batch, out = self._step()
            self.judged.append({"batch": batch, "loss": float(out[0]),
                                "counts": out[1].double().cpu()})
            if i == 0:
                state = dict(self.net.named_parameters())
                self.first_grads = {
                    k: (self.opt.state[state[k]]["exp_avg"] / (1 - BETA1)
                        ).cpu() for k in names}
        self.after = {k: v.detach().cpu().clone()
                      for k, v in self.net.state_dict().items()}
        lo, hi = tr["judged_window_step"]
        self.window_step = int(np.random.default_rng(self.seed + 3)
                               .integers(lo, hi + 1))
        self.at_step = None

    def _batches(self):
        from pointstowood_tpu_torch.data.dataset import TileBatcher

        while True:
            self.epoch += 1
            yield from (b for _, b, _ in TileBatcher(
                self.tiles, batch_size=self.cfg.batch_size,
                min_pts=self.tiling.min_pts, max_pts=self.tiling.max_pts,
                with_labels=True, shuffle=True,
                seed=self.cfg.seed + self.epoch, bucket=False))

    def _step(self, tracer=None):
        from pointstowood_tpu_torch.train.trainer import _batch_arrays

        span = tracer.span if tracer else (lambda _n: contextlib.nullcontext())
        t0 = time.perf_counter()
        with span("batch"):
            batch = next(self.feed)
            pos, refl, mask, sf, labels = _batch_arrays(batch, self.device)
        self.host_ms = (time.perf_counter() - t0) * 1e3
        if self.fault == "half_batch":
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = False
        saved = ({k: v.clone() for k, v in self.net.state_dict().items()}
                 if self.fault == "state_unchanged" else None)
        with span("step"):
            out = self.step_fn(pos, refl, mask, sf, labels,
                               self.cfg.learning_rate, self.gen)
        if saved is not None:
            self.net.load_state_dict(saved)
        return batch, out

    # ---------------------------------------------------------- window
    def window(self, seconds: float, tracer) -> None:
        self.tracer = tracer
        self.work = probe.Work(tracer, self.model)
        if tracer.enabled:
            self.work.hook(self.net)
        n_traced = self.traffic["traced_steps"]
        first = TRACED_FROM
        with probe.Patches() as patches:
            if tracer.enabled:
                probe.claim_operations(patches, tracer)
            t0 = t_prev = time.perf_counter()
            while True:
                i = len(self.steps)
                if i == first:
                    ctx = tracer.window()
                    ctx.__enter__()
                before = self._snapshot() if i == self.window_step else None
                batch, (loss, counts, finite) = self._step(tracer)
                if before is not None:
                    self.at_step = {"before": before, "batch": batch,
                                    "loss": loss, "counts": counts,
                                    "after": _clone(self.net.state_dict())}
                t_end = time.perf_counter()
                if i == first + n_traced - 1:
                    ctx.__exit__(None, None, None)
                self.steps.append({"ms": (t_end - t_prev) * 1e3,
                                   "host_ms": self.host_ms,
                                   "points": int(batch.mask.sum()),
                                   "finite": finite})
                t_prev = t_end
                if (t_end - t0 >= seconds and i >= self.window_step
                        and not first <= i < first + n_traced - 1):
                    break
            self.window_s = t_prev - t0
            if tracer.enabled and tracer.events is None:
                with tracer.window():
                    for _ in range(n_traced):
                        self._step(tracer)

    def _snapshot(self) -> dict:
        """The program's training state before a step, as device copies:
        weights and running statistics, AdamW's moments and step count,
        the centre generator."""
        params = dict(self.net.named_parameters())
        return {"state": _clone(self.net.state_dict()),
                "m": {k: self.opt.state[p]["exp_avg"].clone()
                      for k, p in params.items()},
                "v": {k: self.opt.state[p]["exp_avg_sq"].clone()
                      for k, p in params.items()},
                "t": int(self.opt.state[next(iter(params.values()))]["step"]),
                "gen": self.gen.get_state()}

    # ---------------------------------------------------------- metrics
    def attempted(self) -> int:
        return len(self.steps)

    def failed(self) -> int:
        return sum(not s["finite"] for s in self.steps)

    def end_to_end(self) -> dict:
        ms = [s["ms"] for s in self.steps]
        return {"train_points_per_s":
                sum(s["points"] for s in self.steps) / self.window_s,
                "train_step_p90_ms": float(np.percentile(ms, 90))}

    def view(self) -> dict:
        ops, flops = self.work.ops_and_flops() if self.work else ([], 0.0)
        return {"kind": "train", "steps": self.steps, "ops": ops,
                "flops": flops,
                "trace": self.tracer.summary() if self.tracer else None}

    def release(self) -> None:
        del self.net, self.opt, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- judging
    def check(self, control: str | None = None) -> dict:
        tr = self.traffic
        table = self.table
        xyz = np.stack([table["x"], table["y"], table["z"]], 1)
        tiles, _ = ref_tiling.tile_cloud(xyz, table["intensity"],
                                         tr["grid_size"], tr["min_pts"],
                                         tr["max_pts"], labels=table["truth"])
        epochs = (b for e in itertools.count(1)
                  for b in ref_tiling.training_batches(
                      tiles, tr["batch_size"], tr["min_pts"], tr["max_pts"],
                      self.seed, epoch=e))
        n = tr["judged_steps"]
        batches = list(itertools.islice(epochs, n + self.window_step + 1))
        first, at = batches[:n], batches[-1]
        out = {}
        ref = self._reference(first, Products())
        ref_w = self._window_reference(at, Products())
        if control:
            alt = self._reference(first, Products(control))
            alt_w = self._window_reference(at, Products(control))
        else:
            out["tiles_mismatched"] = tile_mismatch(self.tiles, tiles)
            out["batches_mismatched"] = sum(
                not _same_batch(j["batch"], b)
                for j, b in zip(self.judged, first)) + (
                not _same_batch(self.at_step["batch"], at))
            alt = {"losses": [j["loss"] for j in self.judged],
                   "counts": [j["counts"] for j in self.judged],
                   "grads": self.first_grads, "state": self.after}
            alt_w = {"loss": float(self.at_step["loss"]),
                     "counts": self.at_step["counts"].double().cpu(),
                     "state": _cpu(self.at_step["after"])}
        out.update(_compare(alt, ref, self.w0))
        out.update(_window_compare(alt_w, ref_w,
                                   _cpu(self.at_step["before"]["state"])))
        return out

    def _reference(self, batches, products) -> dict:
        trainer = Trainer(self.w0, self.model, self.device, products)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 2)
        losses, counts, grads = [], [], None
        for i, b in enumerate(batches):
            d = {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}
            r = trainer.step(d, self.traffic["learning_rate"], gen)
            losses.append(r["loss"])
            counts.append(r["counts"])
            if i == 0:
                grads = {k: g.cpu() for k, g in r["grads"].items()}
        state = {k: v.cpu() for k, v in trainer.state().items()}
        return {"losses": losses, "counts": counts, "grads": grads,
                "state": state}

    def _window_reference(self, batch, products) -> dict:
        """The reference's step from the program's state before the judged
        window step, on the reference's own batch."""
        before = self.at_step["before"]
        trainer = Trainer(before["state"], self.model, self.device, products)
        trainer.m = {k: v.clone() for k, v in before["m"].items()}
        trainer.v = {k: v.clone() for k, v in before["v"].items()}
        trainer.t = before["t"]
        gen = torch.Generator(device=self.device)
        gen.set_state(before["gen"])
        d = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        r = trainer.step(d, self.traffic["learning_rate"], gen)
        return {"loss": r["loss"], "counts": r["counts"],
                "grads": {k: g.cpu() for k, g in r["grads"].items()},
                "state": {k: v.cpu() for k, v in trainer.state().items()}}

    def close(self) -> None:
        pass


def _same_batch(program, ref) -> bool:
    return all(np.array_equal(getattr(program, a), ref[b]) for a, b in (
        ("pos", "pos"), ("reflectance", "refl"), ("mask", "mask"),
        ("sf", "sf"), ("labels", "labels")))




def _clone(tensors: dict) -> dict:
    return {k: v.detach().clone() for k, v in tensors.items()}


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def _leaf_gaps(a: dict, r: dict, keys) -> dict:
    """Each leaf's |norm(a) - norm(r)| over max(norm(r), median leaf
    norm of r), with both norms."""
    na = {k: float(a[k].double().norm()) for k in keys}
    nr = {k: float(r[k].double().norm()) for k in keys}
    med = float(np.median(list(nr.values())))
    return {k: (abs(na[k] - nr[k]) / max(nr[k], med), na[k], nr[k])
            for k in keys}


DETAILS = {}  # the last comparison's per-step gaps and leaves, for readings


def _compare(alt: dict, ref: dict, w0: dict) -> dict:
    """Every number the train cells can compare (``limits`` picks)."""
    g = ref["grads"]
    med = float(np.median([float(v.double().norm()) for v in g.values()]))
    moved = [k for k, v in g.items() if float(v.double().norm()) >= 1e-3 * med]
    w0 = {k: v.cpu() for k, v in w0.items()}
    buffers = [k for k in ref["state"] if k.endswith(BUFFER_SUFFIXES[:2])]
    d_alt = {k: alt["state"][k].double() - w0[k].double()
             for k in moved + buffers}
    d_ref = {k: ref["state"][k].double() - w0[k].double()
             for k in moved + buffers}
    losses = [abs(a - r) / abs(r) for a, r in zip(alt["losses"],
                                                   ref["losses"])]
    counts = [float((a.double() - r.double()).abs().sum()) / float(2 * r.sum())
              for a, r in zip(alt["counts"], ref["counts"])]
    grad = _ranked(_leaf_gaps(alt["grads"], g, moved))
    change = _ranked(_leaf_gaps(d_alt, d_ref, moved + buffers))
    DETAILS.clear()
    DETAILS.update(losses=losses, counts=counts, grad=grad, change=change)
    return {"loss_gap": max(losses), "loss_gap_first": losses[0],
            "counts_gap": max(counts), "counts_gap_first": counts[0],
            "grad_gap": grad["worst"][0][1][0],
            "grad_gap_median": grad["median_gap"],
            "change_gap": change["worst"][0][1][0]}


def _window_compare(alt: dict, ref: dict, before: dict) -> dict:
    """The judged window step's numbers: its loss and counts, and the
    change it made to each parameter the reference's gradient moves
    (under 1e-3 of the median leaf's left out) and to each running
    statistic."""
    g = ref["grads"]
    med = float(np.median([float(v.double().norm()) for v in g.values()]))
    moved = [k for k, v in g.items() if float(v.double().norm()) >= 1e-3 * med]
    buffers = [k for k in ref["state"] if k.endswith(BUFFER_SUFFIXES[:2])]
    d_alt = {k: alt["state"][k].double() - before[k].double()
             for k in moved + buffers}
    d_ref = {k: ref["state"][k].double() - before[k].double()
             for k in moved + buffers}
    change = _ranked(_leaf_gaps(d_alt, d_ref, moved + buffers))
    params = _ranked(_leaf_gaps(d_alt, d_ref, moved))
    counts = (float((alt["counts"].double() - ref["counts"].double())
                    .abs().sum()) / float(2 * ref["counts"].sum()))
    DETAILS["window"] = {"change": change, "params": params}
    return {"window_loss_gap": abs(alt["loss"] - ref["loss"])
            / abs(ref["loss"]),
            "window_counts_gap": counts,
            "window_change_gap": change["worst"][0][1][0],
            "window_param_change_gap": params["worst"][0][1][0]}


def _ranked(gaps: dict) -> dict:
    order = sorted(gaps.items(), key=lambda kv: -kv[1][0])
    return {"worst": order[:3], "median_gap": float(np.median(
        [v[0] for v in gaps.values()])), "leaves": len(gaps)}
