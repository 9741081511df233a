"""Traffic kind ``predict``: a user labelling a folder of plots.

Set-up writes the traffic's plots (``plots.synthetic_plot``: the
traffic's fixed layouts, the seed's reflectances and row order) as PLY
files into a fresh directory, makes the configuration's weights on the device
(calibrated so that both classes occur) and writes them as the ``.pth``
checkpoint the CLI reads, and labels a warm-up plot of the window's
plots' size once (after a smaller one, the window's first call ran
about a second slower than the rest). The
window then calls ``pointstowood_tpu_torch.cli.predict.main`` on the
whole folder, back to back (a closed loop), until ``--seconds`` have
passed; the call in flight is finished. The CLI runs with its working
directory a fresh, empty one (a ``nbrs.npy`` there would change the
fusion path).

Judged after the window, for the last call: every written plot (x/y/z
kept, both classes present); for one plot drawn from the seed, the
tiling against the reference's, the network's probabilities of sampled
tiles against the reference network's, and the fused ``label`` and
``pwood`` of the cloud rows those tiles cover against the reference
fusion.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import arch, plots, probe, weights
from portbench.kinds import tile_mismatch
from portbench.reference import fusion as ref_fusion
from portbench.reference.net import Products
from portbench.reference.tiling import inference_capacities, pad, tile_cloud


def _flag(argv, name, default):
    if name in argv:
        i = argv.index(name)
        vals = []
        for v in argv[i + 1:]:
            if v.startswith("--"):
                break
            vals.append(float(v))
        return vals if len(vals) > 1 else vals[0]
    return default


class Cell:
    def __init__(self, cell, seed: int, device, fault: str | None = None):
        self.cell = cell
        self.model = cell.config["model"]
        self.arch = arch.load(self.model)
        self.traffic = cell.traffic
        self.seed = seed
        self.device = torch.device(device)
        self.fault = fault
        argv = list(cell.traffic["argv"])
        self.grid = _flag(argv, "--grid_size", [2.0, 4.0])
        self.grid = self.grid if isinstance(self.grid, list) else [self.grid]
        self.min_pts = int(_flag(argv, "--min_pts", 128))
        self.max_pts = int(_flag(argv, "--max_pts", 16384))
        self.is_wood = _flag(argv, "--is-wood", 0.5)
        self.any_wood = _flag(argv, "--any-wood", 1.0)
        self.calls = []
        self.capture = None
        self.tracer = None
        self.work = None

    # ---------------------------------------------------------- set-up
    def setup(self):
        tmp = os.environ.get("TMPDIR") or None
        self.dir = tempfile.mkdtemp(prefix="portbench-predict-", dir=tmp)
        os.makedirs(os.path.join(self.dir, "plots"))
        os.makedirs(os.path.join(self.dir, "cwd"))
        self.tables, self.paths = [], []
        for i, spec in enumerate(self.traffic["plots"]):
            table, _ = plots.synthetic_plot(
                self.traffic["layout_seed"] + spec["seed_offset"],
                spec["n_side"], spec["density"],
                seed=self.seed + spec["seed_offset"])
            path = os.path.join(self.dir, "plots", f"plot_{i}.ply")
            plots.write_ply(path, table)
            self.tables.append(table)
            self.paths.append(path)
        rng = np.random.default_rng(self.seed)
        self.judged = int(rng.integers(len(self.tables)))
        cal = self.traffic["calibration"]
        w = weights.make_weights(self.model, self.seed, self.device)
        batch = weights.calibration_batch(self.tables[0], self.seed,
                                          cal["tiles"], cal["capacity"])
        self.weights = weights.calibrate(w, self.model, batch, self.device)
        self.model_path = os.path.join(self.dir, "model.pth")
        torch.save({"model_state_dict": {k: v.cpu() for k, v in
                                         self.weights.items()}},
                   self.model_path)
        warm = self.traffic["warmup_plot"]
        table, _ = plots.synthetic_plot(
            self.traffic["layout_seed"] + warm["seed_offset"],
            warm["n_side"], warm["density"], seed=self.seed)
        warm_path = os.path.join(self.dir, "warmup", "warmup.ply")
        os.makedirs(os.path.dirname(warm_path))
        plots.write_ply(warm_path, table)
        self._call([warm_path])

    def argv(self, paths):
        return (["--point-cloud", *paths, "--model", self.model_path]
                + self.arch.cli_args(self.model) + list(self.traffic["argv"]))

    def _call(self, paths):
        from pointstowood_tpu_torch.cli import predict

        here = os.getcwd()
        os.chdir(os.path.join(self.dir, "cwd"))
        try:
            with contextlib.redirect_stdout(sys.stderr):
                return predict.main(self.argv(paths), device=(
                    None if self.device.type == "cuda" else "cpu"))
        finally:
            os.chdir(here)

    # ---------------------------------------------------------- window
    def _patches(self, tracer) -> probe.Patches:
        import pointstowood_tpu_torch.io as pio
        from pointstowood_tpu_torch.data import tiling
        from pointstowood_tpu_torch.predict import device_fusion, predicter
        from pointstowood_tpu_torch.predict.fusion import Fusion

        head = np.asarray(self.tables[self.judged]["x"][:64])
        p = probe.Patches()

        def segmentation(fn):
            def wrapper(pc, tiles, net, *args, **kwargs):
                if np.array_equal(np.asarray(pc["x"][:64]), head):
                    self.capture = {"tiles": tiles, "batches": []}
                if tracer.active:
                    self.work.hook(net)
                try:
                    return fn(pc, tiles, net, *args, **kwargs)
                finally:
                    if self.capture is not None:
                        self.capture["open"] = False
            return wrapper

        def forward_probs(fn):
            def wrapper(net, pos, refl, mask, sf):
                probs = fn(net, pos, refl, mask, sf)
                if self.fault == "half_batch":
                    probs = probs.clone()
                    probs[probs.shape[0] // 2:] = 0.0
                cap = self.capture
                if cap is not None and cap.get("open", True):
                    cap["batches"].append((pos, mask, sf, probs))
                return probs
            return wrapper

        def collect(fn):
            def wrapper(*args, **kwargs):
                out = fn(*args, **kwargs)
                if self.fault == "flip_labels":
                    out["label"] = 1.0 - out["label"]
                return out
            return wrapper

        p.put(predicter, "semantic_segmentation", segmentation)
        p.put(predicter, "forward_probs", forward_probs)
        p.put(Fusion, "collect_predictions", collect)
        if tracer.enabled:
            probe.claim_operations(p, tracer)
            p.put(device_fusion, "pair_select", self.work.pair_select)
            p.put(device_fusion, "knn_masked", self.work.tile_knn)
            for owner, name, label in (
                    (pio, "load_file", "read"), (pio, "save_file", "write"),
                    (tiling, "preprocess_cloud", "preprocess"),
                    (predicter, "run_inference", "model"),
                    (device_fusion, "plan_fusion", "fusion_plan"),
                    (device_fusion, "fuse_on_device", "fusion"),
                    (device_fusion, "fusion_indices", "fusion_index")):
                p.put(owner, name, probe.spanned(tracer, label))
        return p

    def window(self, seconds: float, tracer) -> None:
        self.tracer = tracer
        self.work = probe.Work(tracer, self.model)
        with self._patches(tracer):
            t0 = time.perf_counter()
            while True:
                traced = len(self.calls) == 1
                with tracer.window() if traced else contextlib.nullcontext():
                    with tracer.span("call"):
                        tc = time.perf_counter()
                        records = self._call(self.paths)
                        wall = time.perf_counter() - tc
                self.calls.append({"wall": wall, "records": records,
                                   "traced": traced})
                print(f"portbench: call {len(self.calls)} {wall:.3f} s: "
                      + "; ".join(" ".join(f"{k} {v:.3f}" for k, v in
                                           r["seconds"].items())
                                  for r in records), file=sys.stderr)
                if time.perf_counter() - t0 >= seconds:
                    break
            if tracer.enabled and tracer.events is None:
                # a window of one call: trace one more, outside it
                with tracer.window():
                    with tracer.span("call"):
                        self._call(self.paths)
        self.window_s = time.perf_counter() - t0

    # ---------------------------------------------------------- metrics
    def attempted(self) -> int:
        return sum(len(c["records"]) for c in self.calls)

    def end_to_end(self) -> dict:
        pts = sum(r["points"] for c in self.calls for r in c["records"])
        wall = sum(c["wall"] for c in self.calls)
        return {"predict_points_per_s": pts / wall}

    def view(self) -> dict:
        ops, flops = self.work.ops_and_flops() if self.work else ([], 0.0)
        return {"kind": "predict", "calls": self.calls, "ops": ops,
                "flops": flops,
                "trace": self.tracer.summary() if self.tracer else None}

    def release(self) -> None:
        """Return the program's freed memory (its net lived in the CLI
        call); the judged batches stay."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- judging
    def _probs(self, tiles, tile_ids, products, cache):
        caps = self.caps
        need = [t for t in tile_ids if t not in cache]
        for cap in sorted({caps[t] for t in need}):
            group = [t for t in need if caps[t] == cap]
            for lo in range(0, len(group), 8):
                part = group[lo:lo + 8]
                b = pad([tiles[t]["points"] for t in part], cap)
                d = {k: torch.from_numpy(v).to(self.device)
                     for k, v in b.items()}
                with torch.no_grad():
                    logits = self.arch.Reference(
                        self.weights, self.model, products).forward(
                        d["pos"], d["refl"], d["mask"], d["sf"])
                    p = torch.sigmoid(logits).cpu().numpy()
                for j, t in enumerate(part):
                    cache[t] = p[j, :len(tiles[t]["points"])]
        return {t: cache[t] for t in tile_ids}

    def _sample(self, tiles):
        """Cloud rows judged: the rows of ``anchors`` cells of the finest
        grid drawn from the seed (the largest tile's among them) and, on
        one grid scale, rows whose cell holds no tile."""
        table = self.tables[self.judged]
        xyz = np.stack([table["x"], table["y"], table["z"]], 1)
        rng = np.random.default_rng(self.seed + 1)
        fine = min(self.grid)
        cand = [t for t, tile in enumerate(tiles) if tile["grid_size"] == fine]
        n_anchor = self.traffic["check"]["anchors"]
        largest = max(cand, key=lambda t: len(tiles[t]["points"]))
        rest = [t for t in cand if t != largest]
        anchors = [largest] + list(rng.choice(rest, size=min(
            n_anchor - 1, len(rest)), replace=False))
        ids = ref_fusion.cell_ids(xyz.astype(np.float32), fine)
        want = np.array([tiles[t]["cell_id"] for t in anchors])
        rows = np.flatnonzero(np.isin(ids, want))
        if len(self.grid) == 1:
            have = np.array([t["cell_id"] for t in tiles])
            loose = np.flatnonzero(~np.isin(ids, have))
            n_loose = min(self.traffic["check"]["uncovered_rows"], len(loose))
            rows = np.concatenate([rows, rng.choice(loose, n_loose,
                                                    replace=False)])
        return xyz, np.sort(rows)

    def check(self, control: str | None = None) -> dict:
        """The numbers compared, by name. With ``control`` the reference
        in that precision stands in the program's place (tiling and files
        are then not judged)."""
        out = {}
        table = self.tables[self.judged]
        tiles, _ = tile_cloud(np.stack([table["x"], table["y"], table["z"]], 1),
                              table["intensity"], self.grid, self.min_pts,
                              self.max_pts)
        self.caps = inference_capacities([len(t["points"]) for t in tiles],
                                         self.min_pts, self.max_pts)
        xyz, rows = self._sample(tiles)
        ref_cache, alt_cache = {}, {}

        def ref_probs(ids):
            return self._probs(tiles, ids, Products(), ref_cache)

        path = (ref_fusion.pair_path if len(self.grid) == 2
                else ref_fusion.index_path)
        lab_r, pw_r = path(tiles, xyz, rows, ref_probs, self.is_wood,
                           self.any_wood, self.device)
        rng = np.random.default_rng(self.seed + 2)
        more = rng.choice(len(tiles), size=min(
            self.traffic["check"]["net_tiles"], len(tiles)), replace=False)
        ref_probs(sorted(set(more.tolist()) | set(ref_cache)))
        if control:
            def alt(ids):
                return self._probs(tiles, ids, Products(control), alt_cache)
            lab_p, pw_p = path(tiles, xyz, rows, alt, self.is_wood,
                               self.any_wood, self.device)
            alt(sorted(ref_cache))
            prog = {t: alt_cache[t] for t in ref_cache}
        else:
            out.update(self._files())
            out["tiles_mismatched"] = tile_mismatch(self.capture["tiles"],
                                                     tiles)
            prog, out["net_tiles_unmatched"] = self._program_probs(
                tiles, sorted(ref_cache))
            written = plots.read_ply(self._out_path(self.judged))
            lab_p = written["label"][rows]
            pw_p = written["pwood"][rows]
        pr = np.concatenate([prog[t] for t in sorted(prog)])
        rr = np.concatenate([ref_cache[t] for t in sorted(prog)])
        out["net_label_flip_share"] = float(
            np.mean((pr >= self.is_wood) != (rr >= self.is_wood)))
        out["net_p_abs_p99"] = float(np.quantile(np.abs(pr - rr), 0.99))
        out["fused_label_flip_share"] = float(np.mean(lab_p != lab_r))
        out["fused_pwood_abs_p99"] = float(np.quantile(np.abs(pw_p - pw_r),
                                                       0.99))
        return out

    def _out_path(self, i):
        return os.path.splitext(self.paths[i])[0] + "_ours.ply"

    def _files(self) -> dict:
        changed, missing = 0, 0
        for i, table in enumerate(self.tables):
            out = plots.read_ply(self._out_path(i))
            if len(out["x"]) != len(table["x"]):
                changed += len(table["x"])
                continue
            changed += int(np.sum((out["x"] != table["x"])
                                  | (out["y"] != table["y"])
                                  | (out["z"] != table["z"])))
            missing = max(missing, 2 - len(np.unique(out["label"])))
        return {"xyz_rows_changed": changed, "classes_missing": missing}

    def _program_probs(self, tiles, tile_ids):
        """The timed path's probabilities of these reference tiles, found
        by their centred points in the judged plot's batches; and how many
        were not found (or found at another capacity)."""
        index = {}
        for b, (pos, mask, sf, probs) in enumerate(self.capture["batches"]):
            for r, (n, s) in enumerate(zip(mask.sum(1).tolist(),
                                           sf.float().cpu().tolist())):
                index[(n, s)] = (b, r)
        found, missing = {}, 0
        for t in tile_ids:
            pts = tiles[t]["points"]
            ref = pad([pts], self.caps[t])
            key = (len(pts), float(ref["sf"][0]))
            hit = index.get(key)
            if hit is None:
                missing += 1
                continue
            pos, mask, sf, probs = self.capture["batches"][hit[0]]
            row = pos[hit[1]].float().cpu().numpy()
            if pos.shape[1] != self.caps[t] or not np.array_equal(
                    row, ref["pos"][0]):
                missing += 1
                continue
            found[t] = probs[hit[1], :len(pts)].float().cpu().numpy()
        return found, missing

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
