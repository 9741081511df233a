#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pointstowood_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--compare-with DIR] [--accuracy-epochs E]

With ``--compare-with DIR`` (an earlier tree's ``knn.cu``,
``fusion.cu``, ``group_min.cu`` and ``interp.cu``, and ``knn_dim.cu``
where it has one, with any header they include), ``knn_topk`` at SA1-SA3
(k = 32 and 64), ``knn_top2`` at its three shapes, ``pair_select`` over
the plot's entries, ``group_min`` at its three shapes, the interpolation
backward at FP3-FP1 and ``knn_topk_dim`` at SA2/SA3 (as that tree's
exhaustive scan, ``earlier_knn_dim``) are also timed with that tree's
kernels, built by the port's own build
(``build.build_all``) and loaded by ``earlier_library``, launched through
the port's wrappers on the same inputs (an earlier ``knn_top2`` entry
without a lane count through ``earlier_top2``, the earlier atomic
``ptw_interp_blend_bwd`` through ``earlier_blend_bwd``), in turns
(earlier, current, current, earlier): each row gains ``compared_ms`` and
``turns_ms``; the build phase also reads the earlier selections' SASS
(``build_compared``). A kernel PR uses it to time its new kernel against
its parent's in one call.

Every phase runs in a fresh working directory, ``build/chip_smoke_cwd``:
the fusion paths read a neighbour cache ``nbrs.npy`` from the working
directory, and none may be there. ``--accuracy-epochs`` sets the epochs
of phase ``accuracy`` (default 45: the reference script's 50 take just
over the phase's 180 s on an H100).

Phases, each printing one JSON line (any failed check raises, so the script
exits non-zero and prints no final line):

1. device   -- card name and power limit (nvidia-smi), torch/CUDA versions;
               TF32 is switched off for matrix products and convolutions.
2. build    -- nvcc builds every kernel of ``pointstowood_tpu_torch/csrc``
               for sm_90a (one nvcc per source, all started together);
               registers and spills (``-Xptxas -v``), and the SASS
               instruction count by opcode of the inner loops of
               ``knn_topk_kernel``, ``knn_top2_kernel``,
               ``pair_select_kernel``, ``group_min_kernel``,
               ``knn_dim_kernel`` and ``knn_dim_filter_kernel``
               (``cuobjdump -sass``; the dump goes to ``build/sass/``);
               the filter's SASS must hold tensor-core instructions
               (HMMA / HGMMA, ``filter_tensor_core_ops``).
3. kernel   -- each forward kernel at the shapes the canonical eval forward
               (B=8 tiles x 16384 points, C=32, bf16, fast kNN) gives it,
               held against its plain PyTorch version on the same CUDA
               inputs (the selections ``knn_topk``/``knn_top2`` bit for
               bit; ``knn_topk`` also at k = 64 and 48, Net(k=64)'s, and
               at k = 128, Net(k=128)'s: two passes of K = 64, the second
               held alone against ``select_plain_above``), with
               its time (``ms``: calls queued back to back, ``cuda_ms``;
               ``bracketed_ms``: each call bracketed alone), the plain
               version's time, a one-call PyTorch yardstick where one
               exists, and its bound. At the top-2 shapes
               (phase ``top2_route``) ``knn_top2`` and ``knn_topk``'s warp
               selection at K = 2, bit for bit against the plain version
               and timed in turns; (phase ``top2_lanes``) ``knn_top2`` with
               every lane count, bit for bit and timed.
               (phase ``kernel``, ``knn_topk`` k = 65/96/200/512) the
               passes past 64 at SA3's shape, driven through
               ``ops.knn.knn_masked(method="fast")``: launches = passes,
               bit for bit, timed.
               Then (phase ``adversarial``) the selections on inputs that
               break a wrong one, each bit for bit against its plain
               version: duplicated columns, triplicated columns (ties
               across slots 63/64 and 127/128), descending distances,
               fewer columns than k, a ragged column count with a NaN row
               and masks, a fully masked batch, 1 and 33 rows,
               ``knn_top2`` with every lane count and ``knn_topk`` at
               k = 2/8/16/32/48/64/65/96/128/200/512;
               ``pair_select`` entries with empty fine or coarse regions,
               a union shorter than k, q_len 0 and Q, a NaN query.
3b. ptv1    -- Point Transformer's kernels at the train-b8.ptv1-seg50
               cell's shapes (``ptv1_phase``): ``fps`` at its four levels
               and on inputs that break a wrong sampling
               (``fps_adversarial_inputs``: distance ties, a short and an
               empty row, N = 32768), and ``knn_topk`` at K = 8 / 16 / 3
               over 64-16384 sources, all bit for bit against the plain
               versions and timed; then the network's launches, forward
               and train step ms and peak memory. ``--only ptv1`` runs
               phases 1, 2 and this one alone.
4. forward  -- ``run_inference`` over a synthetic plot (8 full 16384-point
               tiles and a few smaller ones, two capacity buckets) with
               seeded random weights loaded through ``state_dict_from_flax``;
               every forward kernel's launch counter must grow during that
               run. Then the median forward time of one B=8 x 16384 batch,
               and (phase ``profile``) that forward's device time by
               kernel name under torch.profiler, with its idle share.
               Then (phase ``forward_k64``) the same batch through a
               ``Net(k=64)`` (every SA kNN on ``knn_topk``'s K = 64
               instance): finite probabilities, three ``knn_topk``
               launches, its forward time; and (phase ``forward_k128``)
               through a ``Net(k=128)``: six ``knn_topk`` launches (two
               passes a stage), its forward time. ``interp_blend`` at
               k = 16 (the instance past 8 slots), driven through
               ``ops.interpolate.knn_interpolate_batched(k=16,
               method="fast")`` at FP1's shape: bit for bit against
               ``blend_plain``, timed.
4d. attention -- the JAX package's attention variants at C=32 with seeded
               weights: ``run_inference`` over the plot's tiles with
               ``Net(attention_knn=True)`` and with
               ``Net(attention_conv=True)`` (counts set to 0 before each;
               ``knn_topk_dim`` must launch under ``attention_knn``, the
               3-dim kernels under both); ``knn_topk_dim`` (kernel rows)
               on the embeddings a B=8 x 16384 forward gives it, SA2
               (D = 263) and SA3 (D = 519) at k = 32 and SA3 of
               ``Net(k=64)`` / ``Net(k=128)`` with ``attention_knn``, bit
               for bit against ``select_plain_dim``, timed against its
               bound and a ``topk(cdist().square())`` yardstick, each
               launch kind timed (``split_ms``: filter, rescore,
               exhaustive rows) and the filter's survivors and candidates
               a row (``knn_topk_dim_survivors``), with the TF32 and
               FMA-free bounds in the phase record; (phase
               ``attention_adversarial``) ties, ties across the passes
               past 64, NaN rows and columns, masks, fewer columns than k,
               D = 1 and D = 37 (not a multiple of the kernel's chunk),
               the filter's cases at 400 and 2048 columns
               (``filter_cases``: cancellation at an offset of 1e4, norms
               past fp32, subnormal coordinates, duplicates at the k-th
               place; the last, 600 duplicates, and the SA2 inputs with
               600 duplicates at the k-th place of 4 rows a batch,
               ``sa2_overflow_case``, must send rows to the exhaustive
               scan in the call whose output is held), and D = 3 against
               ``knn_topk``, all bit for bit; each
               variant's forward time and peak memory, one tile CPU vs
               card (fp32: labels >= 99.5%, p99 |dp| <= 0.02; bf16
               recorded), and ten train steps on a fixed batch (finite,
               the loss falls; step ms, peak memory, launches a step).
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
6b. ckpt     -- the predict phase's seeded weights written as a flax
               msgpack ``.ckpt`` by the port's own encoder
               (``utils/msgpack.py``) and decoded again, every leaf bit for
               bit; ``cli.predict.main --model model.ckpt`` on the plot
               gives label and pwood bit-identical to the ``.pth`` run.
6c. las      -- the plot written as LAS 1.4 point format 7 (intensity an
               f8 extra dimension) by ``save_file``; ``load_file`` gives
               exactly X * 0.001 + offset; ``cli.predict.main`` on the
               ``.las`` gives label and pwood bit-identical to a PLY of
               the decoded x/y/z.
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
9. kernel (group_min) -- the two-stage kNN's first kernel on the inputs
               the main path gives it over a large-tile plot (4 x 4 trees
               at three times phase 6's density, ~1.57 M points, whose
               4 m cells fill the 24576 and 32768 buckets): SA1 of its
               most padded B=8 x 32768 batch (two blocks of 16384) and
               B=8 x 24576 batch (three blocks of 8192), and one
               index-path launch of cap 32768 over windows masked past
               each tile's length; held bit for bit (minima and slots)
               against ``group_min_plain``, with +inf minima where every
               member is masked, and again with NaN, +inf and -inf rows;
               times (as in 3), bound, plain version, the
               ``cdist().square().amin`` yardstick, and the whole
               two-stage kNN beside ``knn_topk`` at the same shape.
10. crosscheck_large -- one full 32768-point tile of that plot (SA1 on
               the two-stage kNN, one group_min launch) on the CPU (plain
               versions) and on the card.
11. predict_large -- ``cli.predict.main`` on that plot with
               ``--grid_size 4.0 --max_pts 32768 --any-wood 0.5``: large
               tiles and one grid scale at k = 32, so the model's SA1 runs
               the two-stage kNN (one group_min launch per batch past
               16384 points) and fusion the index path; group_min's
               launch counter must grow in the model phase and again in
               fusion. Tiles and batches per capacity bucket, per-phase
               walls, points per second, peak memory, and the index
               fusion's seconds by part (group_min, topk, member_index,
               knn_topk, readback, host search, remainder).
12. index_fusion_crosscheck -- ``fusion_indices`` on that tiling against
               exact host fusion (trunk field as probabilities) on a seeded
               sample of 50 000 rows.
13. kernel (interp_blend_bwd) -- the interpolation backward at the train
               shapes (B=8, C=512, bf16, random 50% centres): FP3
               4096 <- 2048 on the fused route's top-2, FP2 8192 <- 4096
               and FP1 16384 <- 8192 on the SA transpose neighbours; held
               bit for bit against ``blend_bwd_plain``, and the same on a
               second call; its time (the list build and the gather), the
               list build's alone (rows ``blend_bwd_lists``: offsets bit
               for bit, each list the plain one's set of entries with
               their weights and dens), bound,
               plain version, and one ``index_add_`` of the pre-weighted
               rows as yardstick. Then (phase ``adversarial_bwd``) bit for
               bit on a source every target names, sources named by none,
               all-masked batches, +inf slots and masked targets holding
               garbage indices, k = 1/3/8/16, f32 and bf16, T = 0 and S
               not a power of two.
14. train_crosscheck -- one fp32 train step (fast kNN, centres supplied)
               on one full 16384-point tile on the CPU (plain versions) and
               on the card (kernels; FP3 fused, so the backward kernel runs
               at both of its routes): loss, logits, every gradient and the
               new BatchNorm statistics agree within
               ``CROSSCHECK_TOLERANCES``. The card's step runs twice more
               from the same state: whether its gradients repeat bit for
               bit, and (the second, under
               ``torch.use_deterministic_algorithms(warn_only=True)``)
               the ops torch names as nondeterministic.
15. train_step -- ten train steps of B=8 x 16384, C=32, bf16, fast kNN with
               seeded weights and labels: median step time, split into
               forward, backward and optimizer; points/s; peak memory;
               every train-path kernel's launch counter must grow (the
               backward's included). Then (phase ``train_profile``) one
               step's device time by kernel family under torch.profiler,
               with its idle share.
16. train    -- ``cli.train.main`` with the default flags and 2 epochs on a
               labelled synthetic plot of another seed (truth: the trunk
               points); the loss is finite and falls from epoch 1 to 2,
               and ``cli.predict.main`` serves the trained ``.pth`` on the
               predict phase's plot, scored by balanced accuracy.
16b. accuracy -- scripts/c32_accuracy_and_knn_deviation.py on the card:
               C=32, fast kNN, ``make_forest(seed=1)`` (a copy of
               scripts/accuracy_smoke.py's), batch 8, lr 1e-3,
               augmentation, into ``c32.ckpt`` (flax msgpack); the
               held-out ``make_forest(seed=99)`` scored through
               ``semantic_segmentation`` with the exact and the fast kNN:
               balanced accuracy against the truth for each, their label
               agreement and |delta pwood|, training wall time, final
               loss, steps per second, each epoch's seconds. It fails
               below BA 0.70 with either route, above 90% of points
               labelled wood, or below 99% agreement of the routes.
16c. tools   -- the port's analysis tools on the held-out forest (written
               as a PLY with its truth column): ``threshold_sweep.main``
               with ``c32.ckpt`` at ``--max_pts 8192``, thresholds
               0.3-0.7 (wood fraction, BA, F1 each; the 0.50 row's BA
               within 0.01 of phase ``accuracy``'s fast BA; ``knn_topk``,
               ``knn_top2`` and ``interp_blend`` must launch; BASELINE.md
               row 2's JAX sweep printed beside it as JAX's);
               ``geometric_priors`` (k = 128) on the card and on the CPU
               (p99 |delta| <= 1e-4; the card's seconds); ``pathlengths``,
               then ``compare.main`` over a ``_ours.ply`` (the 0.50
               labels, the path lengths) and a ``_fsct.ply`` (the exact
               route's labels as FSCT's 2 = wood): each BA in its
               ``results.csv`` equals the BA computed directly, rounded as
               the file rounds it; ``instance_segment`` on the 0.50 labels
               with ``n_z``: instances against the 4 trees, each tree's
               share in its largest instance, seconds.
16d. ddp     -- data parallelism (``pointstowood_tpu_torch/parallel``)
               on the card's one device. One process on NCCL
               (``PTW_NUM_PROCESSES=1``; phase ``ddp_nccl``): the predict
               CLI on a small plot bootstraps the process group itself,
               one NCCL all-reduce, then one train step of B = 8 x 16384
               (C = 32) as a data group of one, in fp32 with the exact kNN
               and in bf16 with the fast kNN. Then two processes on
               ``cuda:0`` over gloo (NCCL refuses two ranks on one
               device), 4 tiles each: the same steps (phase ``ddp_step``:
               fp32 within 1e-5 of the one process's in loss, counts,
               logits, gradients and state, bf16 within
               ``CROSSCHECK_TOLERANCES``; both under torch's
               deterministic algorithms; each rank's step ms, peak
               memory and kernel launches), then ``cli.predict.main`` on
               the phase-6 plot; and the one-process CLI on the same
               plot (phase ``ddp_predict``: labels >= 0.995, p99
               |delta pwood| <= 0.02, the ranks' tables identical,
               ``pair_select`` launched on both ranks over entry shares
               that add up to the plan's, the labelled PLY written by
               rank 0). Kernel rows gain each rank's launches on the
               sharded train step and predict.
17. floors   -- each selection's and ``group_min``'s issue-rate floor:
               its distance pairs times the SASS hot path's instructions
               a pair (phase 2) over the SMs' issue rate (``knn_topk_dim``:
               its filter's and its exhaustive scan's); arithmetic, kept
               out of the kernels line.
18. the ``{"kernels": [...]}`` line (every CUDA kernel's rows), then the
   card's nvidia-smi line, then the final ``{"ok": true, "device":
   {...}}`` line.

A copy of every printed record goes to ``build/chip_smoke.json``.
The script imports nothing of JAX, nothing of pandas and nothing of the
JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 141190

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM3 bandwidth. The bound of a kernel is the larger of its
# operations over the op rate and its bytes over the second.
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# One operation a lane a cycle: 132 SMs x 128 fp32 lanes x the 1980 MHz
# maximum SM clock. The data sheet's 67 TFLOP/s counts an FMA as two
# operations; the selections and group_min use no FMA (their d2 must
# equal the plain version's bit for bit), so their operations run at half
# of it. It is also the rate at which the SMs issue thread instructions,
# which gives their issue-rate floor: instructions a pair (from the
# SASS of the kernel's inner loop) x pairs over this rate (phase
# ``floors``).
LANE_OPS_PER_S = 132 * 128 * 1.98e9
# The kernels whose inner loops the build phase reads in the SASS, by
# library: the FMA-free selections and group_min.
SASS_KERNELS = {"knn": ("knn_topk_kernel", "knn_top2_kernel",
                        "knn_topk_above_kernel"),
                "fusion": ("pair_select_kernel",),
                "group_min": ("group_min_kernel",),
                "knn_dim": ("knn_dim_kernel", "knn_dim_filter_kernel")}
# The opcode that marks a kernel's distance loops (FMUL unless named) and
# how many of it a unit of the kernel's work takes: a 3-dim distance pair
# squares dx, dy and dz; knn_dim_kernel's unit is a pair and dimension,
# one square; the filter's HMMA (mma.sync m16n8k8) is 1024 products of a
# warp, 32 pair-dimensions a thread instruction.
LOOP_OP = {"knn_dim_filter_kernel": "HMMA"}
OPS_PER_UNIT = {"knn_dim_kernel": 1, "knn_dim_filter_kernel": 1 / 32}
# Dense TF32 on the H100 SXM's tensor cores (NVIDIA data sheet)
TF32_FLOPS = 495e12

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


def demangle(names: list[str]) -> list[str]:
    """Kernel names as ``cu++filt`` (which ships with nvcc) gives them, up
    to the argument list: "void <unnamed>::knn_topk_kernel<(int)32>(const
    float *, ...)" -> "knn_topk_kernel<32>", "knn_dim_kernel<(int)64,
    (bool)1>(...)" -> "knn_dim_kernel<64, 1>"."""
    import re

    from pointstowood_tpu_torch.ops import build

    filt = os.path.join(os.path.dirname(build._nvcc()), "cu++filt")
    if not names or not os.path.exists(filt):
        return names
    out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return [re.sub(r"<unnamed>::|\((?:unsigned )?int\)|\(bool\)", "", n)
            .split("(")[0].removeprefix("void ") for n in out.splitlines()]


def sass_inner_loops(lib_path, prefixes, dump_dir) -> dict:
    """The SASS (``cuobjdump -sass``, which ships with the toolkit) of the
    kernels whose names start with one of ``prefixes``, written to
    ``dump_dir``, and for each such kernel its innermost loops that
    evaluate distances: the instructions from a backward branch's target
    to the branch, holding FMULs, no EXIT and no shorter such loop (a
    branch back from the stubs that nvcc puts after the kernel's EXIT for
    a diverged warp, which a ``BRA.DIV`` jumps to, makes no loop; on the
    hot path a ``BRA.DIV`` falls through, as it does for a converged
    warp; ``knn_dim_filter_kernel``'s loops hold HMMA, ``LOOP_OP``). Per
    loop: its
    instructions, and those of its hot path, the shortest path from its
    head to its branch back (forward branches taken or not: it skips what
    a loop runs only now and then, such as an insertion, or a variant for
    rare rows), with their count by opcode, their distance pairs (FMUL /
    3: dx, dy and dz are squared once a pair; for ``knn_dim_kernel`` the
    pair-dimensions, FMUL / 1; for the filter HMMA x 32, ``OPS_PER_UNIT``)
    and instructions a pair. ``per_pair`` of the kernel is its leanest
    loop's hot path's; ``tensor_core_ops`` counts its HMMA / HGMMA
    instructions."""
    import re
    from collections import Counter

    from pointstowood_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    os.makedirs(dump_dir, exist_ok=True)
    with open(os.path.join(dump_dir, Path(lib_path).stem + ".sass"),
              "w") as f:
        f.write(text)
    funcs: dict = {}
    cur = None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            cur = funcs.setdefault(head.group(1), [])
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if ins and cur is not None:
            text_ins = ins.group(2).strip()
            body = re.sub(r"^@!?U?P\w+\s+", "", text_ins)
            target = re.search(r"0x([0-9a-f]+)", body)
            cur.append({"addr": int(ins.group(1), 16),
                        "op": body.split()[0],
                        "conditional": (body != text_ins
                                        or body.startswith("BRA.DIV")),
                        "target": (int(target.group(1), 16)
                                   if body.startswith("BRA") and target
                                   else None)})

    def hot_path(span):
        # shortest path over the loop's forward edges: fall through
        # (unless an unconditional branch) and forward branches inside
        best = [None] * len(span)
        prev = [None] * len(span)
        best[0] = 1
        where = {ins["addr"]: i for i, ins in enumerate(span)}
        for i, ins in enumerate(span[:-1]):
            if best[i] is None:
                continue
            nxt = []
            if not (ins["op"].startswith("BRA") and not ins["conditional"]):
                nxt.append(i + 1)
            if ins["target"] is not None and ins["target"] > ins["addr"] \
                    and ins["target"] in where:
                nxt.append(where[ins["target"]])
            for j in nxt:
                if best[j] is None or best[i] + 1 < best[j]:
                    best[j], prev[j] = best[i] + 1, i
        path, i = [], len(span) - 1
        while i is not None:
            path.append(span[i]["op"])
            i = prev[i]
        return path

    out = {}
    for mangled, name in zip(funcs, demangle(list(funcs))):
        if not name.startswith(tuple(prefixes)):
            continue
        code = funcs[mangled]
        base = name.split("<")[0]
        marker = LOOP_OP.get(base, "FMUL")
        loops = []
        for end, ins in enumerate(code):
            if ins["target"] is None or ins["target"] > ins["addr"]:
                continue
            span = [c for c in code[:end + 1] if c["addr"] >= ins["target"]]
            ops = {c["op"].split(".")[0] for c in span}
            if marker in ops and "EXIT" not in ops:
                loops.append((span[0]["addr"], ins["addr"], span))
        inner = [lp for lp in loops
                 if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1]
                            for o in loops)]
        rec = []
        for start, end, span in inner:
            path = hot_path(span)
            pairs = sum(o.split(".")[0] == marker for o in path) / \
                OPS_PER_UNIT.get(base, 3)
            rec.append({"range": [hex(start), hex(end)],
                        "instructions": len(span),
                        "hot_path_instructions": len(path),
                        "pairs": pairs,
                        "per_pair": len(path) / pairs if pairs else None,
                        "opcodes": dict(Counter(path).most_common())})
        out[name] = {"loops": rec,
                     "per_pair": min((r["per_pair"] for r in rec
                                      if r["per_pair"]), default=None),
                     "tensor_core_ops": sum(
                         c["op"].startswith(("HMMA", "HGMMA"))
                         for c in code)}
    return out


def ptxas_usage(log: str) -> dict:
    """Registers, spill bytes and shared memory of every kernel entry in
    nvcc's ``-Xptxas -v`` output, by kernel name (demangled by
    ``cu++filt``, which ships with nvcc, up to its argument list)."""
    import re

    from pointstowood_tpu_torch.ops import build

    blocks = log.split("Compiling entry function")[1:]
    names = demangle([re.search(r"'([^']*)'", block).group(1)
                      for block in blocks])
    usage = {}
    for name, block in zip(names, blocks):
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        usage[name] = {"registers": int(regs.group(1)) if regs else None,
                       "spill_stores": int(spill.group(1)) if spill else None,
                       "spill_loads": int(spill.group(2)) if spill else None,
                       "smem_bytes": int(smem.group(1)) if smem else 0}
    return usage


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Device milliseconds of one call of ``fn``: ``reps`` calls queued
    behind a sleep kernel long enough for the host to enqueue all of them
    (the wrappers' Python and the launches), between two CUDA events, over
    ``reps``. So the card runs the calls back to back and the time is the
    device's, not the host's: a call bracketed alone also holds the time
    between its first event and its launch, tens of microseconds, which
    at the small shapes is most of it. A call that synchronises makes the
    host wait for the sleep and counts its own host time too."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # spin cycles at up to the 1980 MHz maximum SM clock
    torch.cuda._sleep(int(min(0.5, 2 * reps * enqueue_s + 1e-3) * 1.98e9))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bracketed_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` calls, each bracketed
    alone by two CUDA events: device time plus the host time between the
    first event and the launch. Kernel rows carry it beside ``cuda_ms``'s
    ``ms`` (as ``bracketed_ms``), so that a time taken with either timer
    can be set against this run's."""
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


def bound(ops: float, nbytes: float,
          op_rate: float = FP32_FLOPS) -> tuple[float, str]:
    t_ops = ops / op_rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def in_turns(time_a, time_b) -> tuple[float, float, list]:
    """Two timings taken in turns (a, b, b, a): (a's mean ms, b's mean ms,
    the four turns)."""
    turns = [time_a(), time_b(), time_b(), time_a()]
    return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, turns


# C signatures of the entry points that the compare path launches in an
# earlier tree's libraries: this tree's, the thread-per-row
# ``ptw_knn_top2`` (no lane count) of a knn.cu without the split top-2,
# and the atomic ``ptw_interp_blend_bwd`` of an interp.cu without the
# source-major gather.
_EARLIER_LIBS: dict = {}
_EARLIER_TOP2 = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_EARLIER_BWD = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def earlier_library(name: str, src_dir: str):
    """The library ``name`` built from ``src_dir`` (an earlier tree's
    csrc) by ``build.build_all``, loaded with ctypes, with the entry
    points that the compare path launches declared: those of this tree
    that it has (the port's wrappers launch them), and an earlier
    thread-per-row ``ptw_knn_top2`` or atomic ``ptw_interp_blend_bwd``
    where it has one."""
    from pointstowood_tpu_torch.ops import build

    key = (name, src_dir)
    if key not in _EARLIER_LIBS:
        path = build.build_all((name,), csrc=Path(src_dir))[name]
        lib = ctypes.CDLL(str(path))
        # this tree's entry points where the earlier library has them,
        # and the earlier atomic backward
        entries = [fn for fn in build._SIGNATURES[name] if hasattr(lib, fn)]
        signatures = dict(build._SIGNATURES[name])
        signatures["ptw_interp_blend_bwd"] = _EARLIER_BWD
        if hasattr(lib, "ptw_interp_blend_bwd"):
            entries.append("ptw_interp_blend_bwd")
        if name == "knn" and not hasattr(lib, "ptw_knn_top2_split"):
            entries.append("ptw_knn_top2")
            signatures["ptw_knn_top2"] = _EARLIER_TOP2
        for fn in entries:
            f = getattr(lib, fn)
            f.argtypes = signatures[fn]
            f.restype = ctypes.c_int
        _EARLIER_LIBS[key] = lib
    return _EARLIER_LIBS[key]


@contextlib.contextmanager
def kernels_from(src_dir: str):
    """Within it, the port's wrappers launch the kernels of
    ``earlier_library(name, src_dir)``."""
    from pointstowood_tpu_torch.ops import build

    own = build.library
    build.library = lambda name, csrc=None: earlier_library(name, src_dir)
    try:
        yield
    finally:
        build.library = own


def timed(call, compare_with=None, earlier_call=None, **timing) -> tuple:
    """(ms, earlier ms, turns) of ``call``: with ``compare_with`` (a
    source directory) timed in turns with that directory's kernels
    (earlier, current, current, earlier), launched by ``earlier_call``
    where given (an earlier entry point that the wrapper no longer
    calls), else by ``call`` itself; without it alone (earlier ms and
    turns None)."""
    if compare_with is None:
        return cuda_ms(call, **timing), None, None

    def earlier():
        if earlier_call is not None:
            return cuda_ms(earlier_call, **timing)
        with kernels_from(compare_with):
            return cuda_ms(call, **timing)

    compared_ms, ms, turns = in_turns(
        earlier, lambda: cuda_ms(call, **timing))
    return ms, compared_ms, turns


def earlier_top2(src_dir: str):
    """``knn_top2`` with the kernel of an earlier tree whose knn.cu has no
    ``ptw_knn_top2_split``: its thread-per-row ``ptw_knn_top2`` (no lane
    argument), launched through the port's launch helper; None where the
    earlier tree has the split kernel (the wrapper then launches it)."""
    from pointstowood_tpu_torch.ops import knn_kernels

    lib = earlier_library("knn", src_dir)
    if hasattr(lib, "ptw_knn_top2_split"):
        return None
    return lambda r, c, m: knn_kernels._launch_select(
        knn_kernels.knn_top2, lib.ptw_knn_top2, r, c, m, 2)


def earlier_knn_dim(src_dir: str, r, c, m, k):
    """A call of ``knn_topk_dim`` as the exhaustive-scan tree (an earlier
    knn_dim.cu whose ``ptw_knn_topk_dim`` is the whole kernel) ran it: one
    launch a pass of ``topk_plan(k)``, each later pass above the last slot
    of the pass before; None where ``src_dir`` has no knn_dim.cu."""
    import torch

    from pointstowood_tpu_torch.ops import build
    from pointstowood_tpu_torch.ops.knn_kernels import topk_plan

    if not os.path.exists(os.path.join(src_dir, "knn_dim.cu")):
        return None
    lib = earlier_library("knn_dim", src_dir)
    inst, passes = topk_plan(k)
    b, n_rows, n_cols, dim = r.shape[0], r.shape[1], c.shape[1], r.shape[2]

    def call():
        out_d = torch.empty((passes, b, n_rows, inst), device=r.device)
        out_i = torch.empty((passes, b, n_rows, inst), dtype=torch.int32,
                            device=r.device)
        stream = torch.cuda.current_stream(r.device).cuda_stream
        for p in range(passes):
            prev = ((out_d[p - 1].data_ptr(), out_i[p - 1].data_ptr())
                    if p else (None, None))
            build.check(lib.ptw_knn_topk_dim(
                r.data_ptr(), c.data_ptr(), m.data_ptr(), *prev,
                out_d[p].data_ptr(), out_i[p].data_ptr(), b, n_rows, n_cols,
                dim, inst, stream), "earlier knn_topk_dim")
        return out_d, out_i
    return call


def knn_dim_split(r, c, cm, k) -> dict:
    """Device ms (``cuda_ms``) of each launch kind of one ``knn_topk_dim``
    call on these inputs: the filter (prep and both sweeps), the rescore,
    the exhaustive rows, and past k = 64 one floor pass."""
    import torch

    from pointstowood_tpu_torch.ops import build
    from pointstowood_tpu_torch.ops import knn_kernels as kn

    lib = build.library("knn_dim")
    inst, passes = kn.topk_plan(k)
    s = kn._dim_scratch(r, c)
    out_d = torch.empty((2, r.shape[0], r.shape[1], inst), device=r.device)
    out_i = torch.empty((2, r.shape[0], r.shape[1], inst),
                        dtype=torch.int32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    split = {
        "filter_ms": cuda_ms(lambda: kn._dim_filter(
            lib, r, c, cm, s, inst, stream), reps=5),
        "rescore_ms": cuda_ms(lambda: kn._dim_rescore(
            lib, s, out_d[0], out_i[0], inst, stream), reps=5),
        "exhaustive_ms": cuda_ms(lambda: kn._dim_exhaustive(
            lib, r, c, cm, s, out_d[0], out_i[0], inst, stream), reps=5)}
    if passes > 1:
        split["floor_pass_ms"] = cuda_ms(lambda: build.check(
            lib.ptw_knn_topk_dim(
                r.data_ptr(), c.data_ptr(), cm.data_ptr(),
                out_d[0].data_ptr(), out_i[0].data_ptr(),
                out_d[1].data_ptr(), out_i[1].data_ptr(), r.shape[0],
                r.shape[1], c.shape[1], r.shape[2], inst, stream),
            "knn_topk_dim"), reps=3)
    return split


def earlier_blend_bwd(src_dir: str, d_y, idx, d2, tmask, n_src):
    """A call of an earlier tree's atomic interpolation backward,
    ``ptw_interp_blend_bwd`` (zero an fp32 (B, S, C) buffer, scatter with
    atomicAdd, cast), on the inputs ``interp_blend_bwd`` takes, as its
    wrapper launched it (k <= 8); None where that tree's interp.cu has
    the gather instead."""
    import torch

    from pointstowood_tpu_torch.ops import build

    lib = earlier_library("interp", src_dir)
    if not hasattr(lib, "ptw_interp_blend_bwd"):
        return None  # the gather: the wrapper launches it
    b, n_tgt, c = d_y.shape
    idx = idx.to(torch.int32).contiguous()

    def call():
        acc = torch.empty((b, n_src, c), dtype=torch.float32,
                          device=d_y.device)
        d_x = acc if d_y.dtype == torch.float32 else torch.empty(
            (b, n_src, c), dtype=d_y.dtype, device=d_y.device)
        build.check(lib.ptw_interp_blend_bwd(
            d_y.data_ptr(), idx.data_ptr(), d2.data_ptr(), tmask.data_ptr(),
            acc.data_ptr(), d_x.data_ptr(), b, n_src, n_tgt, c,
            idx.shape[-1], int(d_y.dtype == torch.bfloat16),
            torch.cuda.current_stream(d_y.device).cuda_stream),
            "earlier interp_blend_bwd")
        return d_x
    return call


# ---------------------------------------------------------------- data


def attention_net(flags: dict, dev, k: int = 32, dtype=None):
    """``ModelConfig(k=k)``'s Net (C=32, fast kNN, bf16 unless ``dtype``
    says otherwise) with the JAX package's attention flags, which only
    ``Net`` takes (as in JAX), and seeded weights loaded through
    ``state_dict_from_flax``."""
    import torch

    from pointstowood_tpu_torch.config import ModelConfig
    from pointstowood_tpu_torch.model import Net
    from pointstowood_tpu_torch.utils.checkpoint_convert import (
        state_dict_from_flax,
    )

    cfg = ModelConfig(k=k)
    net = Net(num_classes=cfg.num_classes, channels=cfg.channels, k=cfg.k,
              sa_resolutions=tuple(cfg.sa_resolutions),
              stage_fractions=tuple(cfg.stage_fractions), fp_k=cfg.fp_k,
              knn_method=cfg.knn_mode, voxel_priority=cfg.voxel_priority,
              dtype=dtype or getattr(torch, cfg.compute_dtype), **flags)
    net.load_state_dict(state_dict_from_flax(seeded_flax_variables(net,
                                                                   SEED)))
    return net.to(dev).eval()


@contextlib.contextmanager
def recorded_knn_dim(calls: list):
    """Within it, every ``knn_topk_dim`` call of ``ops.knn.knn_masked``
    appends its inputs (rows, cols, col_mask, k) to ``calls``."""
    from pointstowood_tpu_torch.ops import knn

    own = knn.knn_topk_dim

    def record(rows, cols, col_mask, k):
        calls.append((rows, cols, col_mask, k))
        return own(rows, cols, col_mask, k)

    knn.knn_topk_dim = record
    try:
        yield
    finally:
        knn.knn_topk_dim = own


def adversarial_dim_cases(seed):
    """``knn_topk_dim`` inputs that break a wrong selection, from numpy:
    (name, rows (2, R, D), cols (2, C, D), mask (2, C), k); batch 1 of each
    case is fully masked. Duplicated columns (exact ties, and rows placed
    on columns) at D = 37 (not a multiple of the kernel's 16-dimension
    chunk) with k = 32, 65 and 128 (ties across the passes' boundaries);
    NaN rows and NaN column coordinates with masked columns at D = 263;
    fewer valid columns than k; 1 and 17 rows; D = 1."""
    rng = np.random.default_rng(seed)
    cases = []
    base = rng.normal(size=(90, 37))
    dup = np.repeat(base, 3, axis=0)[rng.permutation(270)]
    rows = rng.normal(size=(2, 33, 37))
    rows[:, :5] = dup[:5]
    for k in (32, 65, 128):
        cases.append((f"tied columns D=37, k={k}", rows, np.stack([dup, dup]),
                      None, k))
    cols = rng.normal(size=(2, 1000, 263))
    cols[0, 7, 100] = np.nan
    r = rng.normal(size=(2, 17, 263))
    r[0, 3, 5] = np.nan
    mask = rng.random((2, 1000)) >= 0.3
    cases.append(("NaN rows and columns, masked, D=263, k=32", r, cols,
                  mask, 32))
    cases.append(("20 columns, k=32, D=519", rng.normal(size=(2, 1, 519)),
                  rng.normal(size=(2, 20, 519)), None, 32))
    cases.append(("D=1, k=8", rng.normal(size=(2, 40, 1)),
                  rng.normal(size=(2, 300, 1)), None, 8))
    out = []
    for name, r, c, m, k in cases:
        m = np.ones(c.shape[:2], bool) if m is None else m.copy()
        m[1] = False
        out.append((name, r.astype(np.float32), c.astype(np.float32), m, k))
    return out


def filter_cases(seed, n_rows=24, n_cols=(400, 2048)):
    """Inputs that test ``knn_topk_dim``'s certified filter, from numpy:
    (name, rows (2, R, D), cols (2, C, D), mask (2, C), k) at D = 263 and
    519 (SA2's and SA3's), k = 32, for each column count C of ``n_cols``
    (2048: 16 tiles, so that columns are listed under the sweep's running
    threshold as well as on its last visits; 400: the sweep's 8 priming
    tiles and its last visits only, where every column of the cases below
    that all survive fits a candidate list): a standardised embedding
    (rows near columns); the same offset by 1e4 (the expansion form
    cancels: every column survives); magnitudes of 1e19-1e20 (squared
    norms overflow, close pairs stay finite); subnormal coordinates (half
    the points wholly, a third of every other point's dimensions); exact
    duplicates tied at the k-th place (20 columns nearer, 30 copies of one
    point); NaN rows and columns with a third of the columns masked. Then
    ``DIM_CANDIDATES`` + 88 copies of one point at the k-th place of every
    row (D = 263, the largest C): more survivors than a candidate list
    holds, so the rows go to the exhaustive scan."""
    from pointstowood_tpu_torch.ops.knn_kernels import DIM_CANDIDATES

    rng = np.random.default_rng(seed)
    out = []
    for n_c in n_cols:
        for d in (263, 519):
            at = f"D={d} C={n_c}"
            cols = rng.normal(size=(2, n_c, d))
            near = rng.choice(n_c, n_rows, replace=False)
            rows = cols[:, near] + 0.3 * rng.normal(size=(2, n_rows, d))
            out.append((f"standardised {at}", rows, cols, None))
            out.append((f"offset 1e4 {at}", rows + 1e4, cols + 1e4, None))
            big = np.exp(rng.uniform(np.log(1e19), np.log(1e20),
                                     cols.shape))
            big *= rng.choice([-1.0, 1.0], cols.shape)
            out.append((f"magnitudes 1e19-1e20 {at}",
                        big[:, near] * (1 + 1e-6 * rng.normal(
                            size=(2, n_rows, d))), big, None))
            tiny_r, tiny_c = rows.copy(), cols.copy()
            tiny_r[:, ::2] *= 1e-40
            tiny_c[:, ::2] *= 1e-40
            tiny_r[:, 1::2, ::3] *= 1e-40
            tiny_c[:, 1::2, ::3] *= 1e-40
            out.append((f"subnormal coordinates {at}", tiny_r, tiny_c,
                        None))
            tied_r = rng.normal(size=(2, n_rows, d))
            tied_c = rng.normal(size=(2, n_c, d))
            slots = rng.permutation(n_c)
            tied_c[:, slots[:20]] = tied_r[:, :1] + 0.1 * rng.normal(
                size=(2, 20, d))
            tied_c[:, slots[20:50]] = tied_r[:, :1] + 0.5 * rng.normal(
                size=(2, 1, d))
            out.append((f"duplicates tied at the k-th place {at}", tied_r,
                        tied_c, None))
            nan_r, nan_c = rows.copy(), cols.copy()
            nan_c[0, 7, 100] = np.nan
            nan_c[1, 30, 0] = np.nan
            nan_r[0, 3, 5] = np.nan
            out.append((f"NaN rows and columns, masked, {at}", nan_r, nan_c,
                        rng.random((2, n_c)) >= 1 / 3))
    n_copy, n_c = DIM_CANDIDATES + 88, max(n_cols)
    many_r = rng.normal(size=(2, 8, 263))
    many_c = rng.normal(size=(2, n_c, 263))
    slots = rng.permutation(n_c)
    many_c[:, slots[:10]] = many_r[:, :1] + 0.1 * rng.normal(size=(2, 10, 263))
    many_c[:, slots[10:10 + n_copy]] = many_r[:, :1] + 0.5 * rng.normal(
        size=(2, 1, 263))
    out.append((f"{n_copy} duplicates at the k-th place, D=263 C={n_c}",
                many_r, many_c, None))
    return [(name, r.astype(np.float32), c.astype(np.float32),
             np.ones(c.shape[:2], bool) if m is None else m, 32)
            for name, r, c, m in out]


def sa2_overflow_case(rows, cols, col_mask, seed):
    """The recorded SA2 inputs (the main path's shape) with
    ``DIM_CANDIDATES`` + 88 exact copies of one point, 1e-3 times a
    seeded normal vector away from the row, placed for each of rows 0,
    R/4, R/2 and 3R/4 of every batch on columns drawn from ``seed`` (their
    mask set): the copies take the k-th place of those rows, which then
    have more candidates than a list holds, so the exhaustive scan serves
    them while the rescore serves the rest."""
    import torch

    from pointstowood_tpu_torch.ops.knn_kernels import DIM_CANDIDATES

    rng = np.random.default_rng(seed)
    b, n_rows, n_cols, d = (rows.shape[0], rows.shape[1], cols.shape[1],
                            rows.shape[2])
    picks = [0, n_rows // 4, n_rows // 2, 3 * n_rows // 4]
    n_copy = DIM_CANDIDATES + 88
    step = torch.from_numpy(1e-3 * rng.normal(size=d).astype(np.float32))
    step = step.to(rows.device)
    cols, col_mask = cols.clone(), col_mask.clone()
    for bi in range(b):
        slots = torch.from_numpy(rng.permutation(n_cols)[
            :n_copy * len(picks)].reshape(len(picks), n_copy))
        for j, row in enumerate(picks):
            at = slots[j].to(rows.device)
            cols[bi, at] = rows[bi, row] + step
            col_mask[bi, at] = True
    return rows, cols, col_mask


def attention_phase(dev, smi, tiles, rows, wrappers, ptxas, sass,
                    compare_with=None):
    """Phase ``attention``: the JAX package's attention variants on the
    card at C=32, B=8 x 16384, seeded weights.

    * main path: ``run_inference`` over the plot's tiles with
      ``Net(attention_knn=True)`` and with ``Net(attention_conv=True)``,
      every count set to 0 just before each and read just after;
      ``knn_topk_dim`` must launch under ``attention_knn`` (SA2 and SA3
      of every forward), the 3-dim kernels under both;
    * ``knn_topk_dim`` on the inputs that a B=8 x 16384 forward gives it
      (recorded), at SA2 (D = 263) and SA3 (D = 519), k = 32, and at SA3
      of ``Net(k=64)`` and ``Net(k=128)`` with ``attention_knn`` (one
      forward each, counts set to 0 before it: 2 and 4 launches): bit for
      bit against ``select_plain_dim``; its time (in turns with the
      ``compare_with`` tree's exhaustive scan where given) and each launch
      kind's (``knn_dim_split``), the filter's survivors a row
      (``knn_topk_dim_survivors``), its bound, plain version and
      ``topk(cdist().square())`` yardstick; then the adversarial cases
      (``adversarial_dim_cases``, the filter's ``filter_cases``, of which
      the last, and ``sa2_overflow_case``, must send rows to the
      exhaustive scan: ``knn_topk_dim`` and ``knn_topk_dim_survivors``
      held bit for bit, the rows past M counted in the latter's own
      call) and D = 3 against
      ``knn_topk``, bit for bit;
    * each variant's forward time and peak memory, and one tile CPU vs
      card: in fp32 held to labels >= 99.5%, p99 |dp| <= 0.02; in bf16
      recorded (under ``attention_knn`` the neighbour search runs in a
      learned embedding of bf16 features, whose last bit differs between
      the CPU's and the card's products, so the sets and all after them
      differ by more than the 3-dim search's rounding);
    * ten train steps of each variant on a fixed batch: finite, the loss
      falls, step time, peak memory, launches a step."""
    import torch

    from pointstowood_tpu_torch.config import (
        PredictConfig,
        TilingConfig,
        TrainConfig,
    )
    from pointstowood_tpu_torch.data.dataset import pad_tiles
    from pointstowood_tpu_torch.ops.knn_kernels import (
        knn_topk,
        knn_topk_dim,
        knn_topk_dim_survivors,
        select_plain,
        select_plain_dim,
        topk_plan,
    )
    from pointstowood_tpu_torch.predict.predicter import (
        forward_probs,
        run_inference,
    )
    from pointstowood_tpu_torch.train import trainer

    kinds = ("filter_launches", "rescore_launches", "exhaustive_launches")

    t_phase = time.perf_counter()
    full = [t.points for t in tiles if len(t) == 16384][:8]
    batch = pad_tiles(full, 16384)
    args = [torch.from_numpy(a).to(dev) for a in
            (batch.pos, batch.reflectance, batch.mask, batch.sf)]
    variants = {"attention_knn": {"attention_knn": True},
                "attention_conv": {"attention_conv": True}}
    paths = {}
    for name, flags in variants.items():
        net = attention_net(flags, dev)
        for fn in wrappers.values():
            fn.launches = 0
        for kind in kinds:
            setattr(knn_topk_dim, kind, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_inference(tiles, net, PredictConfig(batch_size=8),
                            TilingConfig(grid_size=(4.0,), min_pts=128,
                                         max_pts=16384), device=dev)
        run_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        dim_kinds = {kind: getattr(knn_topk_dim, kind) for kind in kinds}
        if any(n != launches["knn_topk_dim"] for n in dim_kinds.values()):
            raise AssertionError(f"{name}: knn_topk_dim launch kinds "
                                 f"{dim_kinds}, passes "
                                 f"{launches['knn_topk_dim']}")
        n_pts = sum(len(t) for t in tiles)
        if out.shape != (n_pts, 5) or not np.isfinite(out).all() \
                or out[:, 4].min() < 0 or out[:, 4].max() > 1:
            raise AssertionError(f"{name}: run_inference output malformed")
        need = ["knn_topk", "knn_top2", "interp_blend"] + (
            ["knn_topk_dim"] if "knn" in name else [])
        for kname in need:
            if launches[kname] == 0:
                raise AssertionError(f"{name}: {kname} launched no time on "
                                     "the main path")
        paths[name] = {"net": net, "launches": launches, "run_s": run_s,
                       "knn_topk_dim_launch_kinds": dim_kinds,
                       "routes": net.stage_routes(16384)}

    # ---- knn_topk_dim on the inputs of one B=8 x 16384 forward at k = 32,
    # 64 and 128 (the counts of that forward are each row's launches)
    src = "pointstowood_tpu_torch/csrc/knn_dim.cu"
    pk = "pointstowood_tpu/ops/pallas_knn.py"
    usage = {n: u for n, u in ptxas.items() if n.startswith("knn_dim")}
    filter_sass = {n: {"per_pair": v["per_pair"],
                       "tensor_core_ops": v["tensor_core_ops"],
                       "hot_path_opcodes": [lp["opcodes"]
                                            for lp in v["loops"]]}
                   for n, v in sass.items()
                   if n.startswith("knn_dim_filter_kernel")}
    cases = []
    dim_bounds = {}
    for kk in (32, 64, 128):
        net = (paths["attention_knn"]["net"] if kk == 32 else
               attention_net(variants["attention_knn"], dev, k=kk))
        calls: list = []
        knn_topk_dim.launches = 0
        with recorded_knn_dim(calls):
            forward_probs(net, *args)
        torch.cuda.synchronize()
        n_launch = knn_topk_dim.launches
        if len(calls) != 2 or n_launch != 2 * topk_plan(kk)[1]:
            raise AssertionError(f"attention_knn k={kk} forward: "
                                 f"{len(calls)} knn_topk_dim calls, "
                                 f"{n_launch} launches")
        if kk == 32:
            cases += [("knn_topk_dim SA2", calls[0], n_launch),
                      ("knn_topk_dim SA3", calls[1], n_launch)]
        else:
            cases.append((f"knn_topk_dim SA3 k={kk}", calls[1], n_launch))
            del net
    for name, (r, c, cm, kk), n_launch in cases:
        b, nr, nc, d = r.shape[0], r.shape[1], c.shape[1], r.shape[2]
        call = functools.partial(knn_topk_dim, r, c, cm, kk)
        d_k, i_k = call()
        d_s, i_s, survivors = knn_topk_dim_survivors(r, c, cm, kk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_p, i_p = select_plain_dim(r, c, cm, kk)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = check_exact(name, d_k, i_k, d_p, i_p)
        check_exact(f"{name} (knn_topk_dim_survivors)", d_s, i_s, d_p, i_p)
        del d_p, i_p, d_s, i_s

        def library():
            d2 = torch.cdist(r, c).square()
            d2.masked_fill_(~cm[:, None, :], math.inf)
            return torch.topk(d2, kk, dim=-1, largest=False)

        lib_ms = cuda_ms(library, reps=3, warmup=1)
        pairs = float(b * nr * nc)
        # the least work of the design: one TF32 product of every pair
        # (2 flops a pair and dimension at the tensor cores' rate), then
        # the exact rescore of this run's survivors (3 FMA-free operations
        # a pair and dimension); beside it the scan's bound, 3 FMA-free
        # operations for every pair and dimension; inputs once, outputs
        # once
        tf32_ms = 2.0 * pairs * d / TF32_FLOPS * 1e3
        fma_free_ms = 3.0 * pairs * d / LANE_OPS_PER_S * 1e3
        ops_ms = tf32_ms + (3.0 * survivors["mean"] * b * nr * d
                            / LANE_OPS_PER_S * 1e3)
        bytes_ms = bound(0.0, 4 * b * (nr + nc) * d + b * nc
                         + 8 * b * nr * kk)[0]
        bms, by = ((ops_ms, "operations") if ops_ms >= bytes_ms
                   else (bytes_ms, "bytes"))
        passes = topk_plan(kk)[1]
        earlier = (earlier_knn_dim(compare_with, r, c, cm, kk)
                   if compare_with else None)
        ms, compared_ms, turns = timed(call, compare_with if earlier
                                       else None, earlier, reps=5)
        split = knn_dim_split(r, c, cm, kk)
        rows.append({
            "name": name, "check": "ok", "route": "cuda", "source": src,
            "replaces": f"{pk}:399 (and {pk}:181, two-stage route), "
                        "at D > 3",
            "wrapper": "knn_topk_dim", "shape": [b, nr, nc, d, kk],
            "max_abs_err": err, "ms": ms, "compared_ms": compared_ms,
            "turns_ms": turns, "split_ms": split,
            "bracketed_ms": bracketed_ms(call, reps=5),
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "survivors": survivors,
            "distance_pairs": pairs, "pair_dims": pairs * d,
            "passes": passes, "library_ms": lib_ms,
            "library_call": "torch.topk(torch.cdist(rows, cols).square(), "
                            "masked)",
            "launches": n_launch,
            "launches_forward": n_launch,
            "launches_path": f"one B=8 x 16384 forward of Net(k={kk}, "
                             "attention_knn=True) (phase attention)",
        })
        emit("kernel", **rows[-1])
        dim_bounds[name] = {"tf32_bound_ms": tf32_ms,
                            "fma_free_bound_ms": fma_free_ms}
    run_launches = paths["attention_knn"]["launches"]["knn_topk_dim"]
    sa2 = cases[0][1][:3]
    del cases, calls

    # ---- adversarial cases, bit for bit; the filter's cases with their
    # survivors, the last two through the exhaustive scan
    checked = []
    for name, r, c, m, kk in adversarial_dim_cases(SEED):
        r, c, m = (torch.from_numpy(a).to(dev) for a in (r, c, m))
        d_k, i_k = knn_topk_dim(r, c, m, kk)
        torch.cuda.synchronize()
        check_exact(name, d_k, i_k, *select_plain_dim(r, c, m, kk))
        checked.append(name)
    filter_checked = {}
    cases_f = [(name, *(torch.from_numpy(a).to(dev) for a in (r, c, m)), kk)
               for name, r, c, m, kk in filter_cases(SEED)]
    cases_f.append(("SA2 inputs, 600 duplicates at the k-th place of 4 "
                    "rows a batch", *sa2_overflow_case(*sa2, SEED), 32))
    del sa2
    for i, (name, r, c, m, kk) in enumerate(cases_f):
        d_k, i_k = knn_topk_dim(r, c, m, kk)
        d_s, i_s, stats = knn_topk_dim_survivors(r, c, m, kk)
        torch.cuda.synchronize()
        d_p, i_p = select_plain_dim(r, c, m, kk)
        check_exact(name, d_k, i_k, d_p, i_p)
        check_exact(f"{name} (knn_topk_dim_survivors)", d_s, i_s, d_p, i_p)
        # the rows past the list's capacity are the ones the exhaustive
        # scan wrote in the call whose output was just held exact
        if i >= len(cases_f) - 2 and stats["over_capacity"] == 0:
            raise AssertionError(f"{name}: no row went to the exhaustive "
                                 f"scan: {stats}")
        filter_checked[name] = stats
    del cases_f
    r, c, cm = args[0][:, :2048].contiguous(), args[0], args[2]
    d_k, i_k = knn_topk_dim(r, c, cm, 32)
    d_3, i_3 = knn_topk(r, c, cm, 32)
    torch.cuda.synchronize()
    check_exact("knn_topk_dim D=3 vs knn_topk", d_k, i_k, d_3, i_3)
    check_exact("knn_topk_dim D=3 vs select_plain", d_k, i_k,
                *select_plain(r, c, cm, 32))
    checked.append("D=3, 8 x 2048 x 16384, k=32: knn_topk and select_plain")
    emit("attention_adversarial", cases=checked,
         filter_cases=filter_checked, result="bit for bit")

    # ---- forward time, peak memory, one tile CPU vs card
    one = pad_tiles([full[0]], 16384)
    one_args = [torch.from_numpy(a) for a in
                (one.pos, one.reflectance, one.mask, one.sf)]
    m = one.mask[0]
    for name, path in paths.items():
        net = path["net"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fwd = []
        for i in range(7):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            p = forward_probs(net, *args)
            torch.cuda.synchronize()
            if i >= 2:
                fwd.append((time.perf_counter() - t1) * 1e3)
        live = p.float()[args[2]]
        if not bool(torch.isfinite(live).all()):
            raise AssertionError(f"{name}: non-finite probabilities")
        peak = torch.cuda.max_memory_allocated() / 2**30
        path.update(forward_ms=statistics.median(fwd), forward_ms_all=fwd,
                    max_memory_gib=peak, mean_prob=float(live.mean()))
        net32 = attention_net(variants[name], dev, dtype=torch.float32)
        for dname, card_net in (("bfloat16", net), ("float32", net32)):
            cpu_net = copy.deepcopy(card_net).to("cpu")
            t1 = time.perf_counter()
            p_cpu = forward_probs(cpu_net, *one_args)[0].float().numpy()
            cpu_s = time.perf_counter() - t1
            del cpu_net
            p_gpu = forward_probs(card_net,
                                  *(a.to(dev) for a in one_args))[0]
            p_gpu = p_gpu.float().cpu().numpy()
            agree = float(((p_cpu[m] >= 0.5) == (p_gpu[m] >= 0.5)).mean())
            dp = np.abs(p_cpu[m] - p_gpu[m])
            path[f"crosscheck_{dname}"] = {
                "label_agreement": agree,
                "p99_abs_dprob": float(np.quantile(dp, 0.99)),
                "max_abs_dprob": float(dp.max()), "cpu_seconds": cpu_s}
        del net32
        check = path["crosscheck_float32"]
        if check["label_agreement"] < 0.995 or check["p99_abs_dprob"] > 0.02:
            raise AssertionError(f"{name}: CPU and card disagree on a tile "
                                 f"in fp32: {check}")

    # ---- train steps on a fixed batch
    labels = torch.from_numpy((np.random.default_rng(SEED).random(
        batch.mask.shape) < 0.3).astype(np.float32)).to(dev)
    cfg = TrainConfig()
    for name, flags in variants.items():
        net = attention_net(flags, dev).train()
        opt = trainer.make_optimizer(net, cfg)
        step = trainer.make_train_step(net, opt, cfg)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        lr = 1e-3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        times, losses, skipped = [], [], 0
        for _ in range(10):
            t0 = time.perf_counter()
            loss, _, finite = step(*args, labels, lr, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            skipped += not finite
        launches = {k: fn.launches for k, fn in wrappers.items()}
        paths[name].update(
            train_step_ms=statistics.median(times[1:]),
            train_step_ms_all=times, train_losses=losses,
            train_max_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
            train_launches_per_step={k: v / 10 for k, v in launches.items()
                                     if v})
        if skipped or not np.isfinite(losses).all():
            raise AssertionError(f"{name}: non-finite train step")
        if not min(losses[-3:]) < losses[0]:
            raise AssertionError(f"{name}: the loss did not fall over ten "
                                 f"steps on a fixed batch: {losses}")
        if "knn" in name and launches["knn_topk_dim"] != 20:
            raise AssertionError(f"{name}: {launches['knn_topk_dim']} "
                                 "knn_topk_dim launches in ten steps, not "
                                 "20")
        del net, opt, step
    for row in rows:
        if row["wrapper"] == "knn_topk_dim":
            row["launches_train_step"] = (
                paths["attention_knn"]["train_launches_per_step"]
                ["knn_topk_dim"] if row["shape"][-1] == 32 else 0)
    emit("attention", nvidia_smi=smi, batch=[8, 16384], channels=32,
         dtype="bfloat16", knn_topk_dim_run_inference_launches=run_launches,
         knn_dim_ptxas=usage, knn_dim_filter_sass=filter_sass,
         knn_topk_dim_bounds=dim_bounds,
         variants={name: {k: v for k, v in path.items() if k != "net"}
                   for name, path in paths.items()},
         seconds=time.perf_counter() - t_phase)
    for path in paths.values():
        del path["net"]
    torch.cuda.empty_cache()


def synthetic_tiles(seed: int,
                    sizes=(16384,) * 8 + (6000, 5500, 5000, 4500)):
    """A plot of trunk + crown trees, one tree per 4 m tile, of the given
    point counts: by default eight full 16384-point tiles and four of
    4500-6000 points (a second capacity bucket). Points are float32
    [x, y, z, reflectance]; wood (trunk) is bright, leaves dark, as in the
    repo's verify recipe."""
    from pointstowood_tpu_torch.data.tiling import Tile

    rng = np.random.default_rng(seed)
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
    numpy arrays), shaped from the port's own modules (the attention
    variants' included): He-scaled linear kernels, BatchNorm statistics
    and LayerNorm scales near identity."""
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

    flags = {"attention_knn": getattr(net, "attention_knn", False),
             "attention_conv": getattr(net, "attention_conv", False)}
    for tpath, (kind, fpath) in build_key_map(**flags).items():
        w = shapes[f"{tpath}.weight"]
        if kind in ("linear", "conv1d"):
            n_out, n_in = w[0], w[1]
            put(params, fpath, kernel=normal((n_in, n_out), np.sqrt(2 / n_in)),
                bias=normal((n_out,), 0.05))
        elif kind == "linear_nobias":
            put(params, fpath,
                kernel=normal((w[1], w[0]), np.sqrt(2 / w[1])))
        elif kind == "layernorm":
            put(params, fpath, scale=1 + normal(w, 0.1), bias=normal(w, 0.1))
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


def synthetic_plot(seed: int, n_side: int = 6, density: float = 1.0):
    """A plot of n_side x n_side trees (trunk + crown) on a jittered 4 m
    grid over a ground layer, as a column table {x, y, z, intensity}; wood
    (trunk) is bright, leaves dark, ground in between. n_side = 6: 24 m x
    24 m, about 1.2 M points at density 1 (9 000 trunk and 20 000 crown
    points per tree); density scales every layer's point count. Also
    returns the trunk axes' (x, y) and the truth: True for trunk points
    (wood)."""
    rng = np.random.default_rng(seed)
    cols, refl, axes, wood = [], [], [], []
    side = 4.0 * n_side
    for i in range(n_side * n_side):
        cx = 2.0 + 4.0 * (i % n_side) + rng.uniform(-0.8, 0.8)
        cy = 2.0 + 4.0 * (i // n_side) + rng.uniform(-0.8, 0.8)
        axes.append((cx, cy))
        h = rng.uniform(8.0, 14.0)
        r0 = rng.uniform(0.1, 0.25)
        n_trunk, n_crown = int(9000 * density), int(20000 * density)
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
    n_ground = int(130000 * density * (n_side / 6) ** 2)
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


def check_exact(name, d_k, i_k, d_p, i_p):
    """Kernel vs plain selection (``knn_topk``, ``knn_top2``,
    ``pair_select``): the kernels compute the plain versions' rounded
    difference-form d2 and break ties to the lower column (union) index,
    so distances and indices (payloads) must be equal bit for bit."""
    import torch

    if not torch.equal(d_k, d_p):
        raise AssertionError(f"{name}: distances differ from the plain "
                             "version")
    if not torch.equal(i_k, i_p):
        moved = float((i_k != i_p).float().mean())
        raise AssertionError(f"{name}: {moved:.2e} of slots hold another "
                             "index or payload")
    return 0.0


def adversarial_knn_inputs(seed):
    """Inputs that break a wrong selection, from numpy: (name, rows
    (2, R, 3), cols (2, C, 3), mask (2, C)) for R in {1, 33}; batch 1 of
    every case is fully masked. Duplicated columns (40 points 64 times
    each, shuffled: exact ties across lanes and shared-memory tiles),
    triplicated columns (250 points 3 times each, shuffled: every third
    slot starts a tie, so ties straddle slots 63/64 and 127/128, the
    boundaries of ``knn_topk``'s passes), columns in descending-distance
    order (each beats every column before it), 5 columns (fewer than k),
    and 2085 random columns (not a multiple of the tile) with a masked
    fifth and one NaN row."""
    rng = np.random.default_rng(seed)
    cases = []
    for n_rows in (1, 33):
        rows = (rng.normal(size=(2, n_rows, 3)) * 0.1).astype(np.float32)
        base = rng.normal(size=(40, 3))
        dup = np.repeat(base, 64, axis=0)[rng.permutation(2560)]
        trip = np.repeat(rng.normal(size=(250, 3)), 3,
                         axis=0)[rng.permutation(750)]
        x = np.linspace(50.0, 1.0, 3000)
        desc = np.stack([x, np.zeros_like(x), np.zeros_like(x)], 1)
        short = rng.normal(size=(5, 3))
        ragged = rng.normal(size=(2085, 3))
        for name, cols in (("duplicated columns", dup),
                           ("triplicated columns", trip),
                           ("descending distances", desc),
                           ("5 columns", short),
                           ("2085 columns, NaN row", ragged)):
            r = rows.copy()
            mask = np.ones((2, len(cols)), bool)
            mask[1] = False
            if name.startswith("2085"):
                mask[0] = rng.random(len(cols)) >= 0.2
                r[0, n_rows // 2, 1] = np.nan
            cases.append((f"{name}, {n_rows} rows", r,
                          np.stack([cols, cols]).astype(np.float32), mask))
    return cases


def adversarial_pair_inputs(seed):
    """``pair_select`` entries that break a wrong selection, from numpy:
    (queries (6, 100, 3), q_len (6,), src (N, 3), pay (N,), regions
    (6, 4)). Entry 0: fine and coarse regions holding the same points
    (ties across regions go to the fine copy), q_len = Q; 1: an empty
    fine region; 2: an empty coarse region; 3: a union of 20 rows (fewer
    than k); 4: q_len 0; 5: a union of 2085 rows in descending-distance
    order (not a multiple of the tile), with one NaN query row."""
    rng = np.random.default_rng(seed)
    n_q = 100
    dup = rng.integers(-3, 4, size=(1500, 3))
    x = np.linspace(50.0, 1.0, 2085)
    desc = np.stack([x, np.zeros_like(x), np.zeros_like(x)], 1)
    src = np.concatenate([dup, dup[rng.permutation(1500)], desc,
                          rng.normal(size=(400, 3))]).astype(np.float32)
    pay = rng.integers(0, 1024, size=len(src)).astype(np.int32)
    regions = np.array([[0, 1500, 1500, 1500],
                        [0, 0, 1500, 1500],
                        [3000, 2085, 0, 0],
                        [5085, 12, 5097, 8],
                        [0, 1500, 1500, 1500],
                        [3000, 1000, 4000, 1085]], np.int32)
    q_len = np.array([n_q, 37, 1, 64, 0, 77], np.int32)
    queries = rng.integers(-3, 4, size=(6, n_q, 3)).astype(np.float32)
    queries[2:4] = rng.normal(size=(2, n_q, 3))
    queries[5] = rng.normal(size=(n_q, 3)) * 0.1
    queries[5, 40] = np.nan
    return queries, q_len, src, pay, regions


def adversarial_phase(dev):
    """Phase ``adversarial``: every case of ``adversarial_knn_inputs``
    through ``knn_top2`` (with every lane count it has) and ``knn_topk``
    at k = 2, 8, 16, 32, 48 and 64 and, in passes of K = 64, at k = 65,
    96, 128, 200 and 512, and ``adversarial_pair_inputs`` through
    ``pair_select`` at k = 32 and 64, each held bit for bit against its
    plain version."""
    import torch

    from pointstowood_tpu_torch.ops.fusion_kernels import (
        pair_select,
        pair_select_plain,
    )
    from pointstowood_tpu_torch.ops.knn_kernels import (
        TOP2_LANES,
        knn_top2,
        knn_topk,
        select_plain,
    )

    checked = []
    for name, rows, cols, mask in adversarial_knn_inputs(SEED):
        r, c, m = (torch.from_numpy(a).to(dev) for a in (rows, cols, mask))
        calls = [(f"knn_top2 k=2 lanes={lanes}",
                  functools.partial(knn_top2, r, c, m, lanes), 2)
                 for lanes in TOP2_LANES]
        calls += [(f"knn_topk k={k}", functools.partial(knn_topk, r, c, m, k),
                   k) for k in (2, 8, 16, 32, 48, 64, 65, 96, 128, 200,
                                512)]
        for what, call, k in calls:
            d_k, i_k = call()
            torch.cuda.synchronize()
            d_p, i_p = select_plain(r, c, m, k)
            label = f"{name}, {what}"
            check_exact(f"adversarial {label}", d_k, i_k, d_p, i_p)
            checked.append(label)
    entries = [torch.from_numpy(a).to(dev)
               for a in adversarial_pair_inputs(SEED)]
    for k in (32, 64):
        d_k, p_k = pair_select(*entries, k)
        torch.cuda.synchronize()
        d_p, p_p = pair_select_plain(*entries, k)
        check_exact(f"adversarial pair_select k={k}", d_k, p_k, d_p, p_p)
        if not (torch.isinf(d_k[4]).all() and torch.isinf(d_k[5, 40]).all()
                and torch.isinf(d_k[3, :, 20:]).all()):
            raise AssertionError("adversarial pair_select: a dead query, "
                                 "the NaN row or a short union's tail is "
                                 "not (+inf, 0)")
        checked.append(f"pair_select entries, k={k}")
    return emit("adversarial", cases=len(checked), checked=checked,
                tolerance="bit for bit (torch.equal on d2 and index or "
                          "payload)")


def blend_k16_row(lv, rows, gen, c_fp):
    """Phase ``kernel``: ``interp_blend`` at k = 16, the instance past
    eight slots, at FP1's shape (8 x 16384 targets <- 8192 centres, C=512
    bf16), driven through ``ops.interpolate.knn_interpolate_batched(k=16,
    method="fast")`` (the gather route: ``knn_topk``, d2 from the gathered
    positions, then ``interp_blend``), launches counted in that call; the
    blend held bit for bit against ``blend_plain`` on the same (idx, d2),
    timed alone."""
    import torch

    from pointstowood_tpu_torch.model.pointconv import gather_rows
    from pointstowood_tpu_torch.ops.interp_kernels import (
        blend_plain,
        interp_blend,
    )
    from pointstowood_tpu_torch.ops.interpolate import (
        knn_interpolate_batched,
    )
    from pointstowood_tpu_torch.ops.knn import knn_masked
    from pointstowood_tpu_torch.ops.knn_kernels import knn_topk

    (tp, tm), (sp, sm) = lv[0], lv[1]
    bsz, n_s = sp.shape[:2]
    x = torch.randn((bsz, n_s, c_fp), generator=gen,
                    device=sp.device).to(torch.bfloat16)
    interp_blend.launches = knn_topk.launches = 0
    y_k = knn_interpolate_batched(x, sp, tp, k=16, source_mask=sm,
                                  target_mask=tm, method="fast")
    torch.cuda.synchronize()
    launches = interp_blend.launches
    if launches != 1 or knn_topk.launches != 1:
        raise AssertionError(f"interp_blend k=16: {launches} blend and "
                             f"{knn_topk.launches} knn_topk launches")
    # the route's own (idx, d2)
    idx, _, valid = knn_masked(tp, sp, 16, query_mask=tm, source_mask=sm,
                               method="fast")
    rel = gather_rows(sp.float(), idx) - tp.float()[:, :, None]
    sq = rel * rel
    d2 = torch.where(valid, (sq[..., 0] + sq[..., 1]) + sq[..., 2],
                     math.inf)
    y_p = blend_plain(x, idx, d2, tm)
    if not torch.equal(y_k, y_p):
        err = float((y_k.float() - y_p.float()).abs().max())
        raise AssertionError(f"interp_blend k=16: differs from blend_plain "
                             f"by {err}")
    idx32 = idx.to(torch.int32).contiguous()
    w = torch.where(valid, 1.0 / torch.clamp(d2, min=1e-16), 0.0)
    w = (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-16))
    flat = idx.long() + (torch.arange(bsz, device=sp.device)
                         * n_s)[:, None, None]
    flat2, w2 = flat.reshape(-1, 16), w.reshape(-1, 16).to(x.dtype)
    x_flat = x.reshape(-1, c_fp)
    live = valid & tm[..., None]
    n_rows_read = int(torch.unique(flat[live]).numel())
    n_t = tp.shape[1]
    bms, by = bound(float(live.sum()) * 2 * c_fp + float(tm.sum()) * c_fp,
                    n_rows_read * c_fp * 2 + bsz * n_t * (8 * 16 + 1)
                    + bsz * n_t * c_fp * 2)
    rows.append({
        "name": "interp_blend FP1 k=16", "check": "ok", "route": "cuda",
        "source": "pointstowood_tpu_torch/csrc/interp.cu",
        "replaces": "pointstowood_tpu/ops/pallas_interp.py:168",
        "wrapper": "interp_blend", "shape": [bsz, n_t, n_s, c_fp],
        "launches": launches,
        "launches_path": "ops.interpolate.knn_interpolate_batched(k=16, "
                         "method='fast') at this shape, one call",
        "max_abs_err": 0.0, "tolerance": "bit for bit (torch.equal)",
        "ms": cuda_ms(lambda: interp_blend(x, idx32, d2, tm)),
        "bracketed_ms": bracketed_ms(lambda: interp_blend(x, idx32, d2, tm)),
        "plain_ms": cuda_ms(lambda: blend_plain(x, idx, d2, tm), reps=5),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(lambda: torch.nn.functional.embedding_bag(
            flat2, x_flat, per_sample_weights=w2, mode="sum")),
        "library_call": "torch.nn.functional.embedding_bag(mode='sum', "
                        "per_sample_weights)",
    })
    emit("kernel", **rows[-1])


def check_second_pass(name, r, c, cm):
    """One launch of ``ptw_knn_topk_above`` (pass 2 of a k > 64
    selection) on the plain K = 64 selection of the same inputs, held bit
    for bit against ``select_plain_above`` over its last slot."""
    import torch

    from pointstowood_tpu_torch.ops import build
    from pointstowood_tpu_torch.ops.knn_kernels import (
        select_plain,
        select_plain_above,
    )

    prev_d, prev_i = select_plain(r, c, cm, 64)
    b, nr, nc = r.shape[0], r.shape[1], c.shape[1]
    out_d = torch.empty_like(prev_d)
    out_i = torch.empty_like(prev_i)
    build.check(build.library("knn").ptw_knn_topk_above(
        r.data_ptr(), c.data_ptr(), cm.data_ptr(), prev_d.data_ptr(),
        prev_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), b, nr, nc,
        torch.cuda.current_stream(r.device).cuda_stream), name)
    torch.cuda.synchronize()
    check_exact(f"{name} pass 2", out_d, out_i,
                *select_plain_above(r, c, cm, 64, prev_d[..., -1],
                                    prev_i[..., -1]))


def topk_passes_rows(lv, rows):
    """Phase ``kernel``: ``knn_topk`` past k = 64 at SA3's shape (8 x 2048
    centres x 4096 points), at k = 65, 96, 200 and 512, driven through the
    op a caller uses, ``ops.knn.knn_masked(method="fast")`` (its route is
    the in-kernel top-k up to k = 512): launches (= passes) counted in that
    call, the result bit for bit against ``select_plain``, timed."""
    import torch

    from pointstowood_tpu_torch.ops.knn import knn_masked
    from pointstowood_tpu_torch.ops.knn_kernels import (
        fast_route,
        knn_topk,
        select_plain,
        topk_plan,
    )

    (r, rm), (c, cm) = lv[3], lv[2]
    b, nr, nc = r.shape[0], r.shape[1], c.shape[1]
    for kk in (65, 96, 200, 512):
        name = f"knn_topk SA3 k={kk}"
        if fast_route(nc, kk) != "topk":
            raise AssertionError(f"{name}: route {fast_route(nc, kk)}")
        knn_topk.launches = 0
        idx, d2, _ = knn_masked(r, c, kk, source_mask=cm, method="fast")
        torch.cuda.synchronize()
        launches = knn_topk.launches
        passes = topk_plan(kk)[1]
        if launches != passes:
            raise AssertionError(f"{name}: {launches} launches, not "
                                 f"{passes} passes")
        d_p, i_p = select_plain(r, c, cm, kk)
        err = check_exact(name, d2, idx.int(), d_p, i_p)

        def call():
            return knn_topk(r, c, cm, kk)
        pairs = float(b * nr * nc)
        bms, by = bound(8.0 * pairs,
                        12 * b * (nr + nc) + b * nc + 8 * b * nr * kk,
                        LANE_OPS_PER_S)
        rows.append({
            "name": name, "check": "ok", "route": "cuda",
            "source": "pointstowood_tpu_torch/csrc/knn.cu",
            "replaces": "pointstowood_tpu/ops/pallas_knn.py:399",
            "wrapper": "knn_topk", "shape": [b, nr, nc, kk],
            "passes": passes, "launches": launches,
            "launches_path": "ops.knn.knn_masked(method='fast') at this "
                             "shape, one call",
            "max_abs_err": err, "ms": cuda_ms(call),
            "bracketed_ms": bracketed_ms(call),
            "plain_ms": cuda_ms(lambda: select_plain(r, c, cm, kk), reps=3,
                                warmup=1),
            "bound_ms": bms, "bound_by": by, "distance_pairs": pairs,
            "library_ms": cuda_ms(lambda: torch.topk(
                torch.cdist(r, c), kk, dim=-1, largest=False), reps=5),
            "library_call": "torch.topk(torch.cdist(rows, cols)), no mask",
        })
        emit("kernel", **rows[-1])


def top2_lanes_phase(lv, selected):
    """Phase ``top2_lanes``: ``knn_top2`` with every lane count it has at
    its three canonical shapes, each held bit for bit against the checked
    result of phase ``kernel``, and timed: the evidence for
    ``top2_lanes``'s rule."""
    import torch

    from pointstowood_tpu_torch.ops.knn_kernels import (
        TOP2_LANES,
        knn_top2,
        top2_lanes,
    )

    for name, ri, ci in (("knn_top2 SA1 transpose", 0, 1),
                         ("knn_top2 SA2 transpose", 1, 2),
                         ("knn_top2 FP3", 2, 3)):
        r, (c, cm) = lv[ri][0], lv[ci]
        i_ref, d_ref = selected[name]
        ms = {}
        for lanes in TOP2_LANES:
            call = functools.partial(knn_top2, r, c, cm, lanes)
            d_k, i_k = call()
            torch.cuda.synchronize()
            check_exact(f"{name} lanes={lanes}", d_k, i_k, d_ref, i_ref)
            ms[lanes] = cuda_ms(call)
        emit("top2_lanes", name=name, shape=[r.shape[0], r.shape[1],
                                             c.shape[1], 2],
             ms_by_lanes=ms, chosen=top2_lanes(r.shape[0], r.shape[1]),
             fastest=min(ms, key=ms.get))


def serving_phases(net, dev, smi, rows, wrappers, compare_with=None,
                   n_side=6):
    """Phases 6-8: the predict CLI over the synthetic plot (n_side x
    n_side trees), ``pair_select`` on its entries, and the pair path
    against the host path. Appends the pair_select rows to ``rows`` and
    sets every row's ``launches`` from the predict run; with
    ``compare_with`` (a source directory) it times that tree's
    pair_select in turns with the current one. Returns the plot's PLY
    path, its truth (wood) column and the seeded ``.pth``."""
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
        if "launches_path" not in row:  # rows driven on a path of their own
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
        ms, compared_ms, turns = timed(
            lambda: select_all(pair_select, entries, k_out), compare_with,
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
            float((ql * 12 + ul * 16).sum()) + float(ql.sum()) * k_out * 8,
            LANE_OPS_PER_S)
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
            "bound_ms": bms, "bound_by": by,
            "bracketed_ms": bracketed_ms(
                lambda: select_all(pair_select, entries, k_out), reps=5,
                warmup=1),
            "compared_ms": compared_ms, "turns_ms": turns,
            "library_ms": lib_ms,
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
    return ply_path, wood, model_path


# ---------------------------------------------------------------- large tiles


def large_tile_plot(seed):
    """The large-tile plot of phases 9-12: 4 x 4 trees at three times the
    phase-6 density (27 000 trunk and 60 000 crown points per tree over
    390 000 ground points in all: 16 m x 16 m, about 1.57 M points),
    whose 4 m cells fill the 24576 and 32768 buckets, written as PLY
    under ``build/``; with the predict CLI's tiling and batcher at
    ``--grid_size 4.0 --max_pts 32768`` and the trunk axes."""
    from types import SimpleNamespace

    from pointstowood_tpu_torch.config import PredictConfig, TilingConfig
    from pointstowood_tpu_torch.data.tiling import preprocess_cloud
    from pointstowood_tpu_torch.io import load_file, write_ply
    from pointstowood_tpu_torch.io.loader import canonicalize_columns
    from pointstowood_tpu_torch.predict.predicter import tile_batcher

    work = os.path.join(ROOT, "build", "chip_smoke_plot")
    os.makedirs(work, exist_ok=True)
    plot, trunks, _ = synthetic_plot(seed, n_side=4, density=3.0)
    ply_path = os.path.join(work, "plot_large.ply")
    write_ply(ply_path, plot)
    pc, _ = load_file(ply_path, additional_headers=True)
    pc, _, _ = canonicalize_columns(pc, mode="predict")
    tiling_cfg = TilingConfig(grid_size=(4.0,), max_pts=32768)
    tiles = preprocess_cloud(pc, tiling_cfg)
    batcher = tile_batcher(tiles, PredictConfig(batch_size=8), tiling_cfg)
    return SimpleNamespace(ply_path=ply_path, trunks=trunks, pc=pc,
                           tiling_cfg=tiling_cfg, tiles=tiles,
                           batcher=batcher, order=batcher.tile_order())


def group_min_rows(net, dev, rows, large, compare_with=None):
    """Phase ``kernel`` (group_min): the two-stage kNN's first kernel on
    the inputs the large-tile plot's main path gives it: SA1 of its B=8 x
    32768 batch (16384 centres; two blocks of 16384) and of its B=8 x
    24576 batch (12288 centres; three blocks of 8192) with the most padded
    sources (short tiles and the empty tiles that fill a bucket's last
    batch), and one index-path launch at cap 32768 (the eight shortest
    tiles of that cap, 8192 of each tile's rows as queries, against their
    ``source_windows``: masked past each tile's length). Each is held bit
    for bit against ``group_min_plain`` (minima and slots) and must hold
    +inf minima (groups with every member masked), also with three rows
    made non-finite (a NaN, a +inf and a -inf coordinate: the kernel's
    masked loop); its time (in turns with ``compare_with``'s kernel where
    given, and bracketed alone), bound, plain time, the one-expression
    yardstick, and the whole two-stage kNN beside ``knn_topk`` at the same
    shape."""
    import torch

    from pointstowood_tpu_torch.ops.knn import knn_masked
    from pointstowood_tpu_torch.ops.knn_kernels import (
        group_min,
        group_min_plain,
        knn_topk,
        n_block,
        supported,
    )
    from pointstowood_tpu_torch.predict import device_fusion

    cases = []
    for cap in (32768, 24576):
        batch = min((b for c, b, _ in large.batcher if c == cap),
                    key=lambda b: int(b.mask.sum()))
        lv = stage_geometry(net, torch.from_numpy(batch.pos).to(dev),
                            torch.from_numpy(batch.mask).to(dev))
        cases.append((f"group_min SA1 8x{cap}", lv[1][0], *lv[0]))
    flat, offsets, lens = device_fusion.flat_tiles(large.tiles, large.order,
                                                   dev)
    ids = sorted((t for t in large.order
                  if device_fusion._next_cap(int(lens[t])) == 32768),
                 key=lambda t: lens[t])[:8]
    cols, cmask = device_fusion.source_windows(flat, offsets, lens,
                                               np.array(ids), 32768)
    queries = torch.from_numpy(np.stack(
        [large.tiles[t].points[:device_fusion.QCHUNK, :3]
         for t in ids])).to(dev)
    cases.append(("group_min index path cap 32768", queries, cols, cmask))
    for name, r, c, m in cases:
        b, nq, nc = r.shape[0], r.shape[1], c.shape[1]
        if b != 8:
            raise AssertionError(f"{name}: batch of {b}, not 8")
        g = supported(nc, 32)
        nb = n_block(nc)
        m_k, s_k = group_min(r, c, m, g)
        torch.cuda.synchronize()
        m_p, s_p = group_min_plain(r, c, m, g)
        if not (torch.equal(m_k, m_p) and torch.equal(s_k, s_p)):
            raise AssertionError(f"{name}: differs from the plain version")
        n_inf = int(torch.isinf(m_k).sum())
        if not n_inf:
            raise AssertionError(f"{name}: no group with every member "
                                 f"masked")
        del m_k, s_k, m_p, s_p
        bad = r.clone()
        for i, (row, axis, value) in enumerate(((1, 0, math.nan),
                                                (2, 1, math.inf),
                                                (3, 2, -math.inf))):
            bad[i, 64 * row + 5, axis] = value
        m_k, s_k = group_min(bad, c, m, g)
        torch.cuda.synchronize()
        m_p, s_p = group_min_plain(bad, c, m, g)
        # NaN minima: compare the bits
        if not (torch.equal(m_k.view(torch.int32), m_p.view(torch.int32))
                and torch.equal(s_k, s_p)
                and bool(torch.isnan(m_k[0, 69]).any())):
            raise AssertionError(f"{name}: differs from the plain version "
                                 f"on non-finite rows")
        del m_k, s_k, m_p, s_p, bad
        ms, compared_ms, turns = timed(lambda: group_min(r, c, m, g),
                                       compare_with)
        plain_ms = cuda_ms(lambda: group_min_plain(r, c, m, g), reps=1,
                           warmup=0)
        lib_ms = cuda_ms(lambda: torch.cdist(r, c).square().view(
            b, nq, nc // nb, g, nb // g).amin(3), reps=3, warmup=1)
        torch.cuda.empty_cache()
        two_stage_ms = cuda_ms(lambda: knn_masked(r, c, 32, source_mask=m,
                                                  method="fast"), reps=5)
        topk_ms = cuda_ms(lambda: knn_topk(r, c, m, 32), reps=5)
        pairs = float(b * nq * nc)
        bms, by = bound(8.0 * pairs,
                        12 * b * (nq + nc) + b * nc + 5 * b * nq * (nc // g),
                        LANE_OPS_PER_S)
        rows.append({
            "name": name, "check": "ok", "route": "cuda",
            "source": "pointstowood_tpu_torch/csrc/group_min.cu",
            "replaces": "pointstowood_tpu/ops/pallas_knn.py:181",
            "wrapper": "group_min", "shape": [b, nq, nc, g],
            "n_block": nb, "masked_sources": int((~m).sum()),
            "inf_minima": n_inf, "max_abs_err": 0.0,
            "tolerance": "bit for bit (minima and slots; also with NaN, "
                         "+inf and -inf row coordinates)",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "distance_pairs": pairs,
            "bracketed_ms": bracketed_ms(lambda: group_min(r, c, m, g)),
            "compared_ms": compared_ms, "turns_ms": turns,
            "library_ms": lib_ms,
            "library_call": "torch.cdist(q, s).square().view(B, Q, "
                            "n_blocks, g, n_block / g).amin(3)",
            "two_stage_knn_ms": two_stage_ms, "knn_topk_ms": topk_ms,
        })
        emit("kernel", **rows[-1])


def crosscheck_large(net, dev, large, wrappers):
    """Phase ``crosscheck_large``: one full 32768-point tile of the
    large-tile plot through the port on the CPU (plain versions) and on
    the card (kernels; SA1 takes the two-stage kNN): labels and
    probabilities agree. Returns the card forward's launches of each
    kernel."""
    import torch

    from pointstowood_tpu_torch.data.dataset import pad_tiles
    from pointstowood_tpu_torch.predict.predicter import forward_probs

    if net.stage_routes(32768)[0] != "gather":
        raise AssertionError("SA1 at N=32768 does not take the gather route")
    tile = next(t for t in large.tiles if len(t) == 32768)
    one = pad_tiles([tile.points], 32768)
    args = [torch.from_numpy(a) for a in
            (one.pos, one.reflectance, one.mask, one.sf)]
    t0 = time.perf_counter()
    p_cpu = forward_probs(copy.deepcopy(net).to("cpu"), *args)[0]
    cpu_s = time.perf_counter() - t0
    for fn in wrappers.values():
        fn.launches = 0
    p_gpu = forward_probs(net, *(a.to(dev) for a in args))[0].float().cpu()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    p_cpu, p_gpu = p_cpu.float().numpy(), p_gpu.numpy()
    m = one.mask[0]
    agree = float(((p_cpu[m] >= 0.5) == (p_gpu[m] >= 0.5)).mean())
    dp = np.abs(p_cpu[m] - p_gpu[m])
    p99 = float(np.quantile(dp, 0.99))
    emit("crosscheck_large", points=int(m.sum()), label_agreement=agree,
         p99_abs_dprob=p99, max_abs_dprob=float(dp.max()),
         mean_prob=float(p_gpu[m].mean()), cpu_seconds=cpu_s,
         launches=launches)
    if agree < 0.995 or p99 > 0.02:
        raise AssertionError("CPU and card disagree on the 32768-point tile")
    if launches["group_min"] != 1:
        raise AssertionError(f"group_min: {launches['group_min']} launches "
                             f"in a 32768-point forward, not 1 (SA1)")
    return launches


@contextlib.contextmanager
def index_fusion_clock(parts: dict):
    """Within it, the index fusion path's parts add their host-clock
    seconds to ``parts``, each timed between two synchronisations of the
    card: ``group_min``; ``topk`` (the ``torch.topk`` over its minima and
    the slot gather, from the end of ``group_min`` to the start of
    ``member_index``); ``member_index``; ``knn_topk`` (the windows of up to
    16384 points); ``host_search`` (the rows no tile covers). The route is
    unchanged; only the synchronisations are added."""
    import torch

    from pointstowood_tpu_torch.ops import knn as knn_mod
    from pointstowood_tpu_torch.predict import device_fusion

    last_min = [None]  # when the last group_min ended

    def clocked(module, name, part):
        fn = getattr(module, name)

        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if part == "member_index" and last_min[0] is not None:
                parts["topk"] = parts.get("topk", 0.0) + t0 - last_min[0]
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            parts[part] = parts.get(part, 0.0) + t1 - t0
            last_min[0] = t1 if part == "group_min" else None
            return out
        return fn, run

    targets = [(knn_mod, "group_min", "group_min"),
               (knn_mod, "member_index", "member_index"),
               (knn_mod, "knn_topk", "knn_topk"),
               (device_fusion, "knn_indices", "host_search")]
    saved = []
    try:
        for module, name, part in targets:
            fn, run = clocked(module, name, part)
            saved.append((module, name, fn))
            setattr(module, name, run)
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def predict_large_phases(dev, smi, rows, wrappers, large, model_path):
    """Phases ``predict_large`` and ``index_fusion_crosscheck``: the
    predict CLI on the large-tile plot at one 4 m grid, max_pts 32768,
    any-wood 0.5 (SA1 of every 24576 and 32768 batch takes the two-stage
    kNN, one group_min launch each; one grid scale at k = 32: the index
    fusion path), with group_min's launches counted apart in the model and
    fusion phases and the index fusion's seconds split by part
    (``index_fusion_clock``; the readback re-timed after the run on
    device arrays of the same sizes, the remainder the rest of
    ``fusion_indices``'s wall); then ``fusion_indices`` against exact
    host fusion on a seeded sample of 50 000 rows, with the trunk field
    as probabilities."""
    import io

    import torch

    from pointstowood_tpu_torch.cli import predict as predict_cli
    from pointstowood_tpu_torch.data.tiling import xyz_of
    from pointstowood_tpu_torch.io import read_ply
    from pointstowood_tpu_torch.predict import device_fusion
    from pointstowood_tpu_torch.predict.fusion import fuse_labels, knn_indices

    src = read_ply(large.ply_path)
    n_plot = len(src["x"])
    fusion_launches: dict = {}
    real_indices = device_fusion.fusion_indices

    split: dict = {}

    def counted_indices(*args, **kwargs):
        before = {k: fn.launches for k, fn in wrappers.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with index_fusion_clock(split):
            out = real_indices(*args, **kwargs)
        split["fusion_indices"] = time.perf_counter() - t0
        fusion_launches.update({k: fn.launches - before[k]
                                for k, fn in wrappers.items()})
        return out

    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    device_fusion.fusion_indices = counted_indices
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            (rec,) = predict_cli.main([
                "--point-cloud", large.ply_path, "--model", model_path,
                "--grid_size", "4.0", "--max_pts", "32768",
                "--any-wood", "0.5"], device=dev)
    finally:
        device_fusion.fusion_indices = real_indices
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(log.getvalue(), end="", flush=True)
    fusion_lines = [s for s in log.getvalue().splitlines()
                    if s.startswith("fusion:")]
    if len(fusion_lines) != 1 or "index path" not in fusion_lines[0]:
        raise AssertionError(f"predict_large: fusion took another path: "
                             f"{fusion_lines}")
    out = read_ply(rec["output"])
    if len(out["x"]) != n_plot:
        raise AssertionError(f"predict_large: {len(out['x'])} rows != "
                             f"{n_plot}")
    for c in ("x", "y", "z"):
        if not np.array_equal(out[c], src[c]):
            raise AssertionError(f"predict_large: column {c} changed")
    labels, pwood = out["label"], out["pwood"]
    if not set(np.unique(labels).tolist()) <= {0.0, 1.0}:
        raise AssertionError("predict_large: labels outside {0, 1}")
    if not (np.isfinite(pwood).all() and pwood.min() >= 0
            and pwood.max() <= 1):
        raise AssertionError("predict_large: pwood outside [0, 1]")
    model_launches = {k: v - fusion_launches.get(k, 0)
                      for k, v in launches.items()}
    # the readback of tile_knn_indices: (N, 32) int64 indices and the (N,)
    # covered flags (one scale at k = 32 reads no distances back)
    n_q = n_plot
    back = (torch.zeros((n_q, 32), dtype=torch.int64, device=dev),
            torch.zeros(n_q, dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in back:
        t.cpu().numpy()
    split["readback"] = time.perf_counter() - t0
    del back
    split["remainder"] = split["fusion_indices"] - sum(
        v for k, v in split.items() if k != "fusion_indices")

    # the CLI's tiling, for the bucket counts: SA1 takes the two-stage
    # kNN once per batch of more than 16384 points
    tiles_per_bucket: dict = {}
    batches_per_bucket: dict = {}
    for cap, ids in large.batcher.batch_plan():
        tiles_per_bucket[cap] = tiles_per_bucket.get(cap, 0) + len(ids)
        batches_per_bucket[cap] = batches_per_bucket.get(cap, 0) + 1
    large_batches = sum(n for cap, n in batches_per_bucket.items()
                        if cap > 16384)
    n_cls = int(sum(len(t) for t in large.tiles))
    emit("predict_large", nvidia_smi=smi, plot_points=n_plot,
         tiles=rec["tiles"], classified_points=n_cls,
         tiles_per_bucket={str(k): v
                           for k, v in sorted(tiles_per_bucket.items())},
         batches_per_bucket={str(k): v
                             for k, v in sorted(batches_per_bucket.items())},
         index_windows_32768=sum(
             device_fusion._next_cap(len(t)) == 32768 for t in large.tiles),
         seconds=rec["seconds"], wall_s=wall_s,
         points_per_s=n_plot / wall_s, launches=launches,
         launches_model=model_launches, launches_fusion=fusion_launches,
         index_fusion_split_s=split,
         max_memory_gib=peak_gib, fusion_line=fusion_lines[0],
         wood_fraction=float(labels.mean()), mean_pwood=float(pwood.mean()))
    if not (batches_per_bucket.get(32768) and batches_per_bucket.get(24576)):
        raise AssertionError(f"predict_large: buckets {batches_per_bucket} "
                             f"miss 24576 or 32768")
    if model_launches["group_min"] != large_batches:
        raise AssertionError(f"group_min: {model_launches['group_min']} "
                             f"launches in the model, not one per batch "
                             f"past 16384 points ({large_batches})")
    if not fusion_launches["group_min"]:
        raise AssertionError("group_min: no launch in the index fusion path")
    for row in rows:
        if row["wrapper"] == "group_min":
            row["launches"] = launches["group_min"]
            row["launches_model_per_plot"] = model_launches["group_min"]
            row["launches_fusion_per_plot"] = fusion_launches["group_min"]

    classified_xyz = np.concatenate([large.tiles[t].points[:, :3]
                                     for t in large.order])
    field = trunk_field(classified_xyz, large.trunks)
    classified = np.concatenate(
        [classified_xyz, (field >= 0.5)[:, None], field[:, None]], axis=1)
    query_xyz = xyz_of(large.pc)
    t0 = time.perf_counter()
    idx, n_host = device_fusion.fusion_indices(
        large.tiles, large.order, classified_xyz, query_xyz, 32,
        large.tiling_cfg.min_pts, device=dev)
    index_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    pick = np.sort(rng.choice(len(query_xyz), min(50000, len(query_xyz)),
                              replace=False))
    got = fuse_labels(classified, query_xyz[pick], 0.5, 0.5,
                      indices=idx[pick], device=dev)
    host = fuse_labels(classified, query_xyz[pick], 0.5, 0.5,
                       indices=knn_indices(classified_xyz, query_xyz[pick],
                                           32), device=dev)
    agree = float((got[:, 0] == host[:, 0]).mean())
    dpw = float(np.abs(got[:, 1] - host[:, 1]).mean())
    emit("index_fusion_crosscheck", sample=len(pick), label_agreement=agree,
         mean_abs_dpwood=dpw, wood_fraction_host=float(host[:, 0].mean()),
         index_path_s=index_s, host_rows=n_host)
    if agree < 0.98 or dpw >= 0.02:
        raise AssertionError("index path and host path disagree on the plot")


# ---------------------------------------------------------------- training


def supplied_centres(mask, capacity, generator=None, fraction=0.5,
                     group=None):
    """Centre rule for the CPU-vs-card crosscheck: the first
    floor(n_valid * fraction) valid points of each row by a fixed numpy
    score, drawn on the host, so both devices train on the same centres.
    Same signature and result contract as ``ops.sampling.random_sample``
    (a row's centres depend on that row alone, so ``group`` changes
    nothing)."""
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
    """Kernel vs plain backward: both sum each source's contributions in
    ascending entry order with the same roundings, so they must be equal
    bit for bit (``torch.equal``). Returns 0.0."""
    import torch

    if not torch.equal(d_k, d_p):
        err = float((d_k.float() - d_p.float()).abs().max())
        raise AssertionError(f"{name}: differs from the plain version by "
                             f"{err} (must be bit for bit)")
    return 0.0


def check_lists(name, got, ref):
    """``blend_bwd_lists`` vs its plain version: offsets bit for bit; each
    list the same set of (entry id, weight, den) bit for bit (the kernel
    fills a list in no fixed order; the gather orders it)."""
    import torch

    o_k, o_p = got[0], ref[0]
    if not torch.equal(o_k, o_p):
        raise AssertionError(f"{name}: offsets differ")
    n = int(o_p[-1])
    o = o_p.long()
    cell = torch.repeat_interleave(torch.arange(len(o) - 1, device=o.device),
                                   o[1:] - o[:-1])
    order = torch.sort(cell * 2**31 + got[1][:n].long()).indices
    for a_k, a_p in zip(got[1:], ref[1:]):
        if not torch.equal(a_k[:n][order], a_p):
            raise AssertionError(f"{name}: a list holds other entries, "
                                 f"weights or dens")


def blend_bwd_rows(dev, rows, seed, ptxas, compare_with=None):
    """Phase ``kernel`` (interp_blend_bwd): the interpolation backward at
    the train shapes (B=8, C=512 bf16; FP3 4096 <- 2048 fused, FP2 8192 <-
    4096 and FP1 16384 <- 8192 on the transpose neighbours), held bit for
    bit against ``blend_bwd_plain`` and against itself on a second call;
    timed in turns with ``compare_with``'s atomic kernel where given; and
    its list build (``blend_bwd_lists``) held against
    ``blend_bwd_lists_plain`` and timed alone, each in a row of its own."""
    import torch

    from pointstowood_tpu_torch.data.dataset import pad_tiles
    from pointstowood_tpu_torch.ops.interp_kernels import (
        blend_bwd_lists,
        blend_bwd_lists_plain,
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
    usage = {n: u for n, u in ptxas.items() if n.startswith("bwd_")}
    for name in ("FP3", "FP2", "FP1"):
        idx, d2, tm, n_src = geo[name]
        bsz, n_t = idx.shape[:2]
        k = idx.shape[-1]
        d_y = torch.randn((bsz, n_t, c), generator=gen, device=dev).to(
            torch.bfloat16)

        def call():
            return interp_blend_bwd(d_y, idx, d2, tm, n_src)
        d_k = call()
        torch.cuda.synchronize()
        d_p = blend_bwd_plain(d_y, idx, d2, tm, n_src)
        err = check_blend_bwd(f"interp_blend_bwd {name}", d_k, d_p)
        check_blend_bwd(f"interp_blend_bwd {name}, second call", call(), d_k)
        lists_p = blend_bwd_lists_plain(idx, d2, tm, n_src)
        check_lists(f"blend_bwd_lists {name}",
                    blend_bwd_lists(idx, d2, tm, n_src), lists_p)
        ms, compared_ms, turns = timed(
            call, compare_with,
            (earlier_blend_bwd(compare_with, d_y, idx, d2, tm, n_src)
             if compare_with else None))
        lists_ms = cuda_ms(lambda: blend_bwd_lists(idx, d2, tm, n_src))
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
                        bsz * n_t * c * 2 + bsz * n_t * (k * 8 + 1)
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
            "tolerance": "bit for bit (torch.equal), and the same tensor "
                         "on a second call",
            "ms": ms, "lists_ms": lists_ms,
            "bracketed_ms": bracketed_ms(call),
            "compared_ms": compared_ms, "turns_ms": turns,
            "compared": ("the earlier tree's atomic ptw_interp_blend_bwd "
                         "(memset, atomicAdd scatter, cast)"
                         if compare_with else None),
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms,
            "library_call": "Tensor.index_add_ of the pre-weighted live "
                            "rows into an fp32 (B*S, C) buffer",
            "ptxas": usage,
        })
        emit("kernel", **rows[-1])
        # the list build alone: reads idx, d2, tmask; writes offsets and
        # the live entries with their weights and dens
        lbms, lby = bound(float(bsz * n_t * k),
                          bsz * n_t * (k * 8 + 1)
                          + (bsz * n_src + 1) * 4 + n_live * 12)
        rows.append({
            "name": f"blend_bwd_lists {name}", "check": "ok",
            "route": "cuda",
            "source": "pointstowood_tpu_torch/csrc/interp.cu",
            "replaces": "pointstowood_tpu/ops/pallas_interp.py:207",
            "wrapper": "blend_bwd_lists", "shape": [bsz, n_t, n_src, k],
            "live_slots": n_live, "max_abs_err": 0.0,
            "tolerance": "offsets bit for bit, each list the plain "
                         "one's set of (entry, weight, den)",
            "ms": lists_ms,
            "bracketed_ms": bracketed_ms(
                lambda: blend_bwd_lists(idx, d2, tm, n_src)),
            "plain_ms": cuda_ms(
                lambda: blend_bwd_lists_plain(idx, d2, tm, n_src), reps=5),
            "bound_ms": lbms, "bound_by": lby,
            "library_ms": cuda_ms(lambda: torch.sort(flat, stable=True)),
            "library_call": "torch.sort(stable=True) of the live entries' "
                            "flat source index",
        })
        emit("kernel", **rows[-1])


def adversarial_bwd_inputs(seed):
    """Backward inputs that break a wrong gather, from numpy: (name, d_y
    (B, T, C) f32, idx (B, T, k) int64, d2 (B, T, k) f32, tmask (B, T),
    S). At k = 1, 3, 8, 16 (S = 777, not a power of two): the last 50
    sources named by none, 30% empty slots (+inf) and every masked target
    holding garbage nonzero indices, an all-masked batch, a coincident
    source (d2 = 0); 37 sources of 500 targets at k = 3 (lists of about
    30-45 entries, across the register sort's 32); d_y with zeros, -0,
    tiny, subnormal, huge and +inf values and den_t past 2^60 (k = 128
    coincident sources), which the gather's exact redo pass takes; a
    source that every target names (lists of 4096 entries: the rank
    sort); T = 0."""
    rng = np.random.default_rng(seed)
    cases = []

    def make(name, b, t, s, k, c, named=None, empty=0.3):
        named = s if named is None else named
        idx = rng.integers(0, named, (b, t, k))
        d2 = rng.uniform(0.01, 4.0, (b, t, k)).astype(np.float32)
        hole = rng.random((b, t, k)) < empty
        d2[hole] = np.inf
        idx[hole] = rng.integers(1, s, int(hole.sum()))
        tmask = rng.random((b, t)) > 0.2
        if b > 2:
            tmask[2] = False
        idx[~tmask] = rng.integers(1, s, (int((~tmask).sum()), k))
        if t:
            d2[0, min(5, t - 1), 0] = 0.0
        d_y = rng.normal(size=(b, t, c)).astype(np.float32)
        cases.append((name, d_y, idx, d2, tmask, s))
        return cases[-1]

    for k in (1, 3, 8, 16):
        make(f"k={k}, S=777, unnamed sources, garbage idx, masked batch",
             3, 1000, 777, k, 64, named=727)
    make("37 sources, lists across 32", 2, 500, 37, 3, 64, empty=0.1)
    # values the gather's fast division does not vouch for (its exact
    # redo pass) beside zeros, which it does
    d_y = make("zeros, tiny, subnormal, huge and +inf d_y values", 2, 600,
               211, 3, 64)[1]
    for j, v in enumerate((0.0, -0.0, 1e-30, 1e-40, 1e30, 3e38, np.inf)):
        d_y[0, 7 * j:7 * j + 5, j::7] = v
    # den_t past 2^60: 128 coincident sources (w = 1e16 each)
    d2 = make("k=128, den past 2^60", 2, 40, 90, 128, 64)[3]
    d2[:, :10] = 0.0
    _, _, idx, d2, tmask, _ = make("a source every target names", 2, 4096,
                                   300, 2, 64, empty=0.0)
    idx[:, :, 0] = 3
    tmask[:] = True
    make("T = 0", 2, 0, 100, 2, 64)
    return cases


def adversarial_bwd_phase(dev):
    """Phase ``adversarial_bwd``: every case of ``adversarial_bwd_inputs``
    in f32 and bf16 through ``interp_blend_bwd``, bit for bit against
    ``blend_bwd_plain`` and against a second call, the lists against
    ``blend_bwd_lists_plain`` (T >= 1)."""
    import torch

    from pointstowood_tpu_torch.ops.interp_kernels import (
        blend_bwd_lists,
        blend_bwd_lists_plain,
        blend_bwd_plain,
        interp_blend_bwd,
    )

    checked = []
    for name, d_y, idx, d2, tmask, s in adversarial_bwd_inputs(SEED):
        i, d, m = (torch.from_numpy(a).to(dev) for a in (idx, d2, tmask))
        if d_y.shape[1]:
            check_lists(f"adversarial blend_bwd_lists {name}",
                        blend_bwd_lists(i, d, m, s),
                        blend_bwd_lists_plain(i, d, m, s))
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.from_numpy(d_y).to(dev).to(dtype)
            d_k = interp_blend_bwd(g, i, d, m, s)
            torch.cuda.synchronize()
            label = f"{name}, {str(dtype).removeprefix('torch.')}"
            check_blend_bwd(f"adversarial {label}", d_k,
                            blend_bwd_plain(g, i, d, m, s))
            check_blend_bwd(f"adversarial {label}, second call",
                            interp_blend_bwd(g, i, d, m, s), d_k)
            checked.append(label)
    return emit("adversarial_bwd", cases=len(checked), checked=checked,
                tolerance="bit for bit (torch.equal), and the same tensor "
                          "on a second call")


def floors_phase(rows, sass) -> None:
    """Phase ``floors``: the issue-rate floor of each row of the FMA-free
    selections and of ``group_min``, the least time the SMs need to issue
    the instructions of its inner loop's hot path (the build's SASS count a
    pair, ``sass``) for its distance pairs at ``LANE_OPS_PER_S``
    (``knn_topk_dim``: a pair-dimension, for its pair-dimensions: its
    filter's two sweeps, and beside it the floor of the exhaustive scan
    of every row). Arithmetic over a count, not a measurement: it stays
    out of the ``kernels`` line."""
    from pointstowood_tpu_torch.ops.knn_kernels import (
        dim_padded,
        topk_instance,
    )

    def kernel_of(row):
        last = row["shape"][-1]
        return {"knn_topk": f"knn_topk_kernel<{topk_instance(last)}>",
                "knn_top2": f"knn_top2_kernel<{row.get('lanes')}>",
                "pair_select": f"pair_select_kernel<{last}>",
                "group_min": f"group_min_kernel<{last}>",
                "knn_topk_dim": f"knn_dim_kernel<{topk_instance(last)}, 0>",
                }[row["wrapper"]]

    floor_pass = {"knn_topk": "knn_topk_above_kernel<64>",
                  "knn_topk_dim": "knn_dim_kernel<64, 1>"}

    floors = []
    for row in rows:
        if row["wrapper"] not in ("knn_topk", "knn_top2", "pair_select",
                                  "group_min", "knn_topk_dim"):
            continue
        kernel = kernel_of(row)
        per_pair = sass.get(kernel, {}).get("per_pair")
        pairs = row.get("pair_dims", row["distance_pairs"])
        passes = row.get("passes", 1)
        if passes > 1 and per_pair:
            # pass 1 on the K = 64 instance, the others on the floor pass
            above_kernel = floor_pass[row["wrapper"]]
            above = sass.get(above_kernel, {}).get("per_pair")
            kernel += f" + {passes - 1} x {above_kernel}"
            per_pair = (per_pair + (passes - 1) * above) if above else None
        floors.append({
            "name": row["name"], "sass_kernel": kernel,
            "distance_pairs": pairs, "instructions_per_pair": per_pair,
            "issue_floor_ms": (pairs * per_pair / LANE_OPS_PER_S * 1e3
                               if per_pair else None),
            "ms": row["ms"]})
        if row["wrapper"] == "knn_topk_dim":
            # the filter's units: pair-dimensions of the TF32 copy (D up
            # to a multiple of 32) over its visits (every 128-column tile,
            # and the first 8 again)
            floors[-1]["name"] += " (exhaustive scan of every row)"
            kernel = (f"knn_dim_filter_kernel"
                      f"<{topk_instance(row['shape'][-1])}>")
            per_pair = sass.get(kernel, {}).get("per_pair")
            n_tiles = -(-row["shape"][2] // 128)
            units = (row["distance_pairs"] * dim_padded(row["shape"][3], 32)
                     * (n_tiles + min(8, n_tiles)) / n_tiles)
            floors.append({
                "name": row["name"] + " (filter)",
                "sass_kernel": kernel, "distance_pairs": units,
                "instructions_per_pair": per_pair,
                "issue_floor_ms": (units * per_pair / LANE_OPS_PER_S * 1e3
                                   if per_pair else None),
                "ms": row["split_ms"]["filter_ms"]})
    emit("floors", rate_per_s=LANE_OPS_PER_S, rows=floors)


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
    """Phase 14: one fp32 train step (fast kNN, centres supplied) on one
    full 16384-point tile, on the CPU (plain versions) and on the card
    (kernels); FP3 takes the fused route only at this size. The card's
    step runs twice more from the same state: whether its loss, logits and
    gradients repeat bit for bit on the second run, which gradients do
    not, and (the third, under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``) the ops torch names as nondeterministic. Returns
    the record."""
    import warnings

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
    flagged = set()
    saved_rule, saved_clip = network.random_sample, trainer.clip_by_global_norm_
    try:
        network.random_sample = supplied_centres
        for run in ("cpu", "cuda", "cuda again", "cuda deterministic",
                    "cuda deterministic again"):
            where = run.split()[0]
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
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if "deterministic" in run:
                    torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    loss, _, finite = step(*args, cfg.learning_rate, gen)
                    if where == "cuda":
                        torch.cuda.synchronize()
                finally:
                    torch.use_deterministic_algorithms(False)
            flagged |= {str(w.message).split(" does not have")[0][:200]
                        for w in caught
                        if "deterministic" in str(w.message)}
            rec["seconds"] = time.perf_counter() - t0
            hook.remove()
            if not finite:
                raise AssertionError(f"train_crosscheck: non-finite step "
                                     f"on {where}")
            rec["loss"] = float(loss)
            rec["state"] = {k: v.detach().cpu().clone()
                            for k, v in net.state_dict().items()}
            rec["names"] = [n for n, _ in net.named_parameters()]
            results[run] = rec
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
    # the card against itself, same state and inputs: by default, and
    # under torch's deterministic algorithms
    def moved_between(a, b):
        return [n for n, g, h in zip(a["names"], a["grads"], b["grads"])
                if not torch.equal(g, h)]

    def repeats(a, b):
        return (a["loss"] == b["loss"] and torch.equal(a["logits"],
                                                       b["logits"])
                and not moved_between(a, b))

    again = results["cuda again"]
    det, det_again = (results["cuda deterministic"],
                      results["cuda deterministic again"])
    moved = moved_between(gpu, again)
    repeatable = repeats(gpu, again)
    rec = emit("train_crosscheck", points=int(batch.mask.sum()),
               loss_cpu=cpu["loss"], loss_card=gpu["loss"],
               loss_rel=loss_rel, logits_max_abs=float(dl.max()),
               logits_mean_abs=float(dl.mean()), logits_max=logit_scale,
               grads_rel_l1_total=total, grads_rel_l1_worst=worst,
               grads_tensors_checked=len(carried),
               grads_rel_l1_conv2=per["conv2.weight"],
               running_stats_max_rel=stats, cpu_step_s=cpu["seconds"],
               card_step_s=gpu["seconds"],
               card_repeatable_bit_for_bit=repeatable,
               card_logits_repeat=torch.equal(again["logits"],
                                              gpu["logits"]),
               card_grads_checked=len(gpu["names"]),
               card_grads_moved=len(moved),
               # in forward order: the last are the nearest the loss, where
               # the backward first met an op that sums in another order
               card_grads_moved_nearest_loss=moved[-6:],
               card_repeatable_deterministic_algorithms=repeats(det,
                                                                det_again),
               card_grads_moved_deterministic_algorithms=len(
                   moved_between(det, det_again)),
               card_nondeterministic_ops=sorted(flagged),
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


def train_step_phase(dev, smi, wrappers, seed, required):
    """Phase 11: B=8 x 16384, C=32, bf16, fast kNN train steps with seeded
    weights and labels: median step time, split into forward, backward
    and optimizer; points/s; peak memory; the launch counter of every
    kernel in ``wrappers``, where each in ``required`` (the train path's)
    must grow; then one step under torch.profiler."""
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
    for name in required:
        if launches[name] == 0:
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
            ("port kernels (csrc/*.cu)", ("knn_topk", "knn_top2",
                                          "interp_blend", "bwd_count_kernel",
                                          "bwd_scan_kernel", "bwd_fill_kernel",
                                          "bwd_gather_kernel",
                                          "bwd_redo_kernel",
                                          "pair_select", "group_min")),
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


# ---------------------------------------------------------------- files


def ckpt_phase(net, dev, smi, ply_path, pth_output):
    """Phase ``ckpt``: the canonical seeded weights written as a flax
    msgpack ``.ckpt`` by the port's encoder, decoded again (every leaf
    bit for bit the source's), and served by ``cli.predict.main`` on the
    predict phase's plot: label and pwood bit-identical to the ``.pth``
    run's output ``pth_output``."""
    import torch

    from pointstowood_tpu_torch.cli import predict as predict_cli
    from pointstowood_tpu_torch.io import read_ply
    from pointstowood_tpu_torch.utils import msgpack

    work = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    os.makedirs(work, exist_ok=True)
    variables = seeded_flax_variables(net, SEED)
    ckpt = os.path.join(work, "model.ckpt")
    with open(ckpt, "wb") as f:
        f.write(msgpack.packb(variables))
    with open(ckpt, "rb") as f:
        decoded = msgpack.unpackb(f.read())

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    src, got = dict(leaves(variables)), dict(leaves(decoded))
    if src.keys() != got.keys():
        raise AssertionError(f"ckpt: leaves differ: "
                             f"{sorted(src.keys() ^ got.keys())[:5]}")
    for name, a in src.items():
        b = got[name]
        if not (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes()):
            raise AssertionError(f"ckpt: leaf {name} changed")
    ref = read_ply(pth_output)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (rec,) = predict_cli.main(["--point-cloud", ply_path, "--model", ckpt],
                              device=dev)
    wall_s = time.perf_counter() - t0
    out = read_ply(rec["output"])
    same = {c: bool(np.array_equal(out[c], ref[c]))
            for c in ("x", "y", "z", "label", "pwood")}
    emit("ckpt", nvidia_smi=smi, leaves=len(src),
         file_bytes=os.path.getsize(ckpt), leaves_bit_for_bit=True,
         bit_identical_to_pth=same, plot_points=len(out["x"]),
         wall_s=wall_s, seconds=rec["seconds"],
         wood_fraction=float(out["label"].mean()))
    if not all(same.values()):
        raise AssertionError(f"ckpt: the .ckpt run differs from the .pth "
                             f"run: {same}")


def las_phase(dev, smi, plot, model_path):
    """Phase ``las``: the predict phase's plot written as LAS 1.4 format 7
    (its intensity an f8 extra dimension) by ``save_file``/``write_las``;
    ``load_file`` must give exactly X * 0.001 + offset (X the stored
    integers, offset the xyz minimum); ``cli.predict.main`` on the
    ``.las`` must give label and pwood bit-identical to a PLY holding the
    decoded x/y/z."""
    import torch

    from pointstowood_tpu_torch.cli import predict as predict_cli
    from pointstowood_tpu_torch.io import (
        load_file,
        read_ply,
        save_file,
        write_ply,
    )

    work = os.path.join(ROOT, "build", "chip_smoke_las")
    os.makedirs(work, exist_ok=True)
    las_path = os.path.join(work, "plot.las")
    t0 = time.perf_counter()
    save_file(las_path, plot, additional_fields=["intensity"])
    write_s = time.perf_counter() - t0
    xyz = np.stack([plot[c] for c in "xyz"], 1)
    offset = xyz.min(axis=0)
    stored = np.round((xyz - offset) / 0.001) * 0.001 + offset
    t0 = time.perf_counter()
    decoded = load_file(las_path)
    read_s = time.perf_counter() - t0
    if sorted(decoded) != ["x", "y", "z"]:
        raise AssertionError(f"las: columns {sorted(decoded)}")
    for i, c in enumerate("xyz"):
        if not np.array_equal(decoded[c], stored[:, i]):
            raise AssertionError(f"las: {c} is not X * scale + offset")
    max_q = float(np.abs(stored - xyz).max())
    if max_q > 0.0005 + 1e-9:
        raise AssertionError(f"las: quantisation error {max_q} > 0.5 mm")
    ply_path = os.path.join(work, "plot_xyz.ply")
    write_ply(ply_path, decoded)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (rec_las,) = predict_cli.main(["--point-cloud", las_path,
                                   "--model", model_path], device=dev)
    las_s = time.perf_counter() - t0
    (rec_ply,) = predict_cli.main(["--point-cloud", ply_path,
                                   "--model", model_path], device=dev)
    a, b = read_ply(rec_las["output"]), read_ply(rec_ply["output"])
    same = {c: bool(np.array_equal(a[c], b[c]))
            for c in ("x", "y", "z", "label", "pwood")}
    emit("las", nvidia_smi=smi, plot_points=len(a["x"]),
         file_bytes=os.path.getsize(las_path), write_s=write_s,
         read_s=read_s, max_abs_quantisation_m=max_q,
         xyz_equal_x_scale_plus_offset=True,
         bit_identical_to_decoded_ply=same, predict_las_wall_s=las_s,
         seconds=rec_las["seconds"], wood_fraction=float(a["label"].mean()))
    if not all(same.values()):
        raise AssertionError(f"las: the .las run differs from the PLY of "
                             f"its decoded x/y/z: {same}")


# ---------------------------------------------------------------- accuracy


def make_forest(seed, n_trees=4, pts_per_tree=25000):
    """scripts/accuracy_smoke.py's synthetic forest as a column table
    {x, y, z, reflectance, truth}: the same numpy draws in the same order,
    so the same arrays. Trees of a cylindrical trunk and branch lines
    (wood, truth 1) and a diffuse crown (leaf, truth 0); reflectance
    weakly informative."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n_trees):
        cx, cy = rng.uniform(0, 30, 2)
        height = rng.uniform(8, 14)
        n_wood = pts_per_tree // 3
        n_leaf = pts_per_tree - n_wood
        theta = rng.uniform(0, 2 * np.pi, n_wood // 2)
        r = rng.uniform(0.05, 0.25, n_wood // 2)
        trunk = np.stack(
            [cx + r * np.cos(theta), cy + r * np.sin(theta),
             rng.uniform(0, height * 0.7, n_wood // 2)], 1)
        n_br = n_wood - n_wood // 2
        ang = rng.uniform(0, 2 * np.pi, n_br)
        tdist = rng.uniform(0, 2.0, n_br)
        bz = rng.uniform(height * 0.4, height * 0.9, n_br)
        branches = np.stack(
            [cx + tdist * np.cos(ang), cy + tdist * np.sin(ang), bz], 1
        ) + rng.normal(0, 0.02, (n_br, 3))
        crown = np.stack(
            [cx + rng.normal(0, 1.5, n_leaf), cy + rng.normal(0, 1.5, n_leaf),
             height * 0.65 + rng.normal(0, height * 0.2, n_leaf)], 1)
        xyz = np.concatenate([trunk, branches, crown])
        refl = np.concatenate(
            [rng.normal(1.0, 0.6, n_wood), rng.normal(-0.5, 0.6, n_leaf)])
        label = np.concatenate([np.ones(n_wood), np.zeros(n_leaf)])
        parts.append((xyz, refl, label))
    xyz = np.concatenate([p[0] for p in parts])
    return {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "reflectance": np.concatenate([p[1] for p in parts]),
            "truth": np.concatenate([p[2] for p in parts])}


def balanced_accuracy(truth, pred) -> float:
    """sklearn's ``balanced_accuracy_score`` (the port's
    ``tools/scores.py``): the mean of the per-class recall over the classes
    present in ``truth``."""
    import warnings

    from pointstowood_tpu_torch.tools import scores

    with warnings.catch_warnings():
        # a predicted class absent from the truth has no recall: dropped
        warnings.simplefilter("ignore")
        return scores.balanced_accuracy(truth, pred)


# The reference script trains 50 epochs. On an H100 at 700 W they took
# 180.8 s (3.2 s a median epoch, 2.8-6.1 s), over the phase's budget of
# 180 s; 45 is the largest count that fits with 10% left for that spread.
# ``--accuracy-epochs 50`` runs the reference's count (see PERF.md).
ACCURACY_EPOCHS = 45
# the trained model must have learnt, and both kNN routes must agree: JAX's
# BA at 50 epochs is 0.774 (fast) / 0.785 (exact), the truth 33% wood
ACCURACY_MIN_BA = 0.70
ACCURACY_MAX_WOOD = 0.9
ACCURACY_MIN_AGREEMENT = 0.99


def accuracy_phase(dev, smi, wrappers, epochs, channels=32):
    """Phase ``accuracy`` (a port of
    scripts/c32_accuracy_and_knn_deviation.py:62-131): train C=32 with the
    fast kNN on ``make_forest(seed=1)`` for ``epochs`` epochs into
    ``c32.ckpt`` (flax msgpack, the port's encoder), then score the
    held-out ``make_forest(seed=99, n_trees=4)`` through
    ``semantic_segmentation`` with the exact and the fast kNN: balanced
    accuracy against the truth for each, and their label agreement and
    |delta pwood|. The JAX package's numbers at 50 epochs: BA 0.774 (fast)
    and 0.785 (exact), BASELINE.md."""
    import dataclasses
    import shutil

    import torch

    from pointstowood_tpu_torch.config import (
        ModelConfig,
        PredictConfig,
        TilingConfig,
        TrainConfig,
    )
    from pointstowood_tpu_torch.data.tiling import preprocess_cloud
    from pointstowood_tpu_torch.io.loader import canonicalize_columns
    from pointstowood_tpu_torch.predict.predicter import (
        build_net,
        semantic_segmentation,
    )
    from pointstowood_tpu_torch.train.trainer import semantic_training
    from pointstowood_tpu_torch.utils.checkpoint import load_checkpoint

    wdir = os.path.join(ROOT, "build", "chip_smoke_accuracy")
    shutil.rmtree(wdir, ignore_errors=True)
    tiling = TilingConfig(grid_size=(2.0, 4.0), min_pts=128, max_pts=8192)
    model_cfg = ModelConfig(channels=channels)  # fast kNN
    train_pc, _, _ = canonicalize_columns(make_forest(seed=1), mode="train")
    tiles = preprocess_cloud(train_pc, tiling, with_labels=True)
    cfg = TrainConfig(num_epochs=epochs, batch_size=8, learning_rate=1e-3,
                      augmentation=True)
    epoch_end = []

    def log(line):
        if line.startswith("epoch "):
            epoch_end.append(time.perf_counter())

    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, history = semantic_training(tiles, cfg, model_cfg, tiling, wdir=wdir,
                                   model_name="c32.ckpt", verbose=True,
                                   log_fn=log, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    epoch_s = np.diff([t0] + epoch_end).tolist()
    steps = epochs * -(-len(tiles) // cfg.batch_size)
    losses = [row[2] for row in history]
    ckpt = os.path.join(wdir, "model", "c32.ckpt")

    test_raw = make_forest(seed=99, n_trees=4)
    truth = test_raw.pop("truth")
    results = {}
    for mode in ("exact", "fast"):
        pc, _, _ = canonicalize_columns(dict(test_raw), mode="predict")
        test_tiles = preprocess_cloud(pc, tiling, seed=141190)
        mcfg = dataclasses.replace(model_cfg, knn_mode=mode)
        net = load_checkpoint(ckpt, build_net(mcfg, device=dev))
        t1 = time.perf_counter()
        out = semantic_segmentation(pc, test_tiles, net,
                                    PredictConfig(batch_size=8), tiling,
                                    device=dev)
        results[mode] = (out, balanced_accuracy(truth, out["label"]),
                         time.perf_counter() - t1)
    (ex, ba_exact, s_exact), (fa, ba_fast, s_fast) = (results["exact"],
                                                     results["fast"])
    dp = np.abs(fa["pwood"] - ex["pwood"])
    rec = emit(
        "accuracy", nvidia_smi=smi, channels=channels, epochs=epochs,
        epochs_of_the_reference_script=50, train_points=len(train_pc["x"]),
        train_tiles=len(tiles), steps=steps, train_wall_s=train_s,
        steps_per_s=steps / train_s, epoch_s=epoch_s,
        first_epoch_s=epoch_s[0] if epoch_s else None,
        median_epoch_s=(statistics.median(epoch_s[1:]) if len(epoch_s) > 1
                        else None),
        final_loss=losses[-1], loss_per_epoch=losses,
        train_ba_per_epoch=[row[3] for row in history], launches=launches,
        test_points=len(truth), test_wood_fraction=float(truth.mean()),
        ba_exact=ba_exact, ba_fast=ba_fast,
        wood_fraction_exact=float(ex["label"].mean()),
        wood_fraction_fast=float(fa["label"].mean()),
        label_agreement=float((fa["label"] == ex["label"]).mean()),
        mean_abs_dpwood=float(dp.mean()),
        p99_abs_dpwood=float(np.quantile(dp, 0.99)),
        score_s={"exact": s_exact, "fast": s_fast},
        jax_ba_50_epochs={"fast": 0.774, "exact": 0.785})
    if not (np.isfinite(np.asarray(history)).all()
            and len(history) == epochs):
        raise AssertionError(f"accuracy: bad history {history}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name}: no launch in the accuracy run")
    if not (min(ba_exact, ba_fast) >= ACCURACY_MIN_BA
            and max(rec["wood_fraction_exact"], rec["wood_fraction_fast"])
            <= ACCURACY_MAX_WOOD
            and rec["label_agreement"] >= ACCURACY_MIN_AGREEMENT):
        raise AssertionError(
            f"accuracy: BA {ba_exact:.4f} / {ba_fast:.4f} (exact / fast), "
            f"wood {rec['wood_fraction_exact']:.3f}, agreement "
            f"{rec['label_agreement']:.4f}")
    return rec, ckpt, ex["label"]


# ------------------------------------------------------------------- tools

# BASELINE.md row 2: the JAX package's sweep (a different run: another
# checkpoint, on a TPU), threshold -> (BA, F1)
JAX_SWEEP = {0.3: (0.696, 0.622), 0.4: (0.781, 0.698), 0.5: (0.788, 0.723),
             0.6: (0.779, 0.713), 0.7: (0.769, 0.699)}
TOOLS_MAX_DBA = 0.01
TOOLS_MAX_PRIOR_P99 = 1e-4


def tools_phase(dev, smi, wrappers, accuracy, ckpt, exact_labels):
    """Phase ``tools`` (see the module docstring, 16c): the port's
    threshold sweep, priors, path length, compare and instance tools on
    ``make_forest(seed=99, n_trees=4)`` with phase ``accuracy``'s
    checkpoint and exact-route labels."""
    import shutil

    import torch

    from pointstowood_tpu_torch.io import write_ply
    from pointstowood_tpu_torch.ops.normalization import ground_normalize_np
    from pointstowood_tpu_torch.predict.fusion import knn_indices
    from pointstowood_tpu_torch.tools import (
        compare,
        instance,
        pathlength,
        priors,
        scores,
        threshold_sweep,
    )

    t_phase = time.perf_counter()
    wdir = os.path.join(ROOT, "build", "chip_smoke_tools")
    shutil.rmtree(wdir, ignore_errors=True)
    os.makedirs(wdir)
    forest = make_forest(seed=99, n_trees=4)
    truth = forest["truth"]
    xyz = np.stack([forest[c] for c in ("x", "y", "z")], 1)
    ply = os.path.join(wdir, "forest.ply")
    write_ply(ply, forest)

    # the sweep: one classification, a fusion a threshold
    thresholds = [0.3, 0.4, 0.5, 0.6, 0.7]
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = threshold_sweep.main(
        [ply, "--model", ckpt, "--max_pts", "8192", "--thresholds"]
        + [str(t) for t in thresholds], device=dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    table = [{k: r[k] for k in ("threshold", "wood_frac", "balanced_acc",
                                "f1")} for r in rows]
    at50 = next(r for r in rows if r["threshold"] == 0.5)
    labels50 = at50["labels"]
    dba = abs(at50["balanced_acc"] - accuracy["ba_fast"])

    # priors on the card and on the CPU, from the same host kNN indices
    t0 = time.perf_counter()
    idx = knn_indices(xyz, xyz, 128)
    knn_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pr_card = priors.geometric_priors(xyz, k=128, indices=idx, device=dev)
    torch.cuda.synchronize()
    prior_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pr_cpu = priors.geometric_priors(xyz, k=128, indices=idx, device="cpu")
    prior_cpu_s = time.perf_counter() - t0
    dp = np.abs(pr_card.astype(np.float64) - pr_cpu)

    # path length, then compare against a synthetic FSCT file
    t0 = time.perf_counter()
    plen = pathlength.pathlengths(xyz)
    path_s = time.perf_counter() - t0
    cdir = os.path.join(wdir, "compare")
    os.makedirs(cdir)
    base = {c: forest[c] for c in ("x", "y", "z")}
    write_ply(os.path.join(cdir, "forest_ours.ply"),
              {**base, "truth": truth, "label": labels50[:, 0],
               "pathlength": plen})
    write_ply(os.path.join(cdir, "forest_fsct.ply"),
              {**base, "truth": truth, "label": 2.0 * exact_labels})
    compare.main([cdir])
    with open(os.path.join(cdir, "results.csv")) as f:
        header, *lines = [line.strip().split(",") for line in f]
    csv = {(r[0], r[1]): {k: float(v) if v else math.nan
                          for k, v in zip(header[2:], r[2:])}
           for r in lines}
    ours, fsct = labels50[:, 0] > 0, exact_labels > 0
    direct = {
        ("Other", "ours", "balanced_accuracy"):
            scores.balanced_accuracy(truth > 0, ours),
        ("Other", "fsct", "balanced_accuracy"):
            scores.balanced_accuracy(truth > 0, fsct),
        ("Other", "ours", "weighted_balanced_accuracy"):
            scores.balanced_accuracy(
                truth > 0, ours, sample_weight=plen / max(plen.max(), 1e-12)),
    }
    csv_vs_direct = {f"{c}/{m}/{k}": (csv[c, m][k], v)
                     for (c, m, k), v in direct.items()}

    # instances on the 0.50 labels
    n_z = ground_normalize_np(xyz, grid_resolution=5.0)
    t0 = time.perf_counter()
    inst = instance.instance_segment(
        {**base, "label": labels50[:, 0], "pwood": labels50[:, 1],
         "n_z": n_z})
    instance_s = time.perf_counter() - t0
    tree = np.arange(len(truth)) // (len(truth) // 4)
    share = []
    for t in range(4):
        ids = inst[(tree == t) & (inst >= 0)]
        share.append(float(np.bincount(ids).max() / (tree == t).sum())
                     if len(ids) else 0.0)

    rec = emit(
        "tools", nvidia_smi=smi, points=len(truth), checkpoint=os.path.relpath(
            ckpt, ROOT), sweep=table, sweep_s=sweep_s, launches=launches,
        ba_050=at50["balanced_acc"], accuracy_ba_fast=accuracy["ba_fast"],
        abs_dba=dba, f1_exact_route=scores.f1(truth > 0, fsct),
        jax_sweep_baseline_row2={
            "note": "the JAX package's sweep, BASELINE.md row 2: another "
                    "checkpoint, another run, on a TPU",
            "ba_f1": {str(t): v for t, v in JAX_SWEEP.items()}},
        priors_k=128, priors_knn_s=knn_s, priors_card_s=prior_card_s,
        priors_cpu_s=prior_cpu_s, priors_p99_abs_delta=float(
            np.quantile(dp, 0.99)), priors_max_abs_delta=float(dp.max()),
        priors_mean=float(pr_card.mean()), pathlength_s=path_s,
        pathlength_max=float(plen.max()), results_csv_vs_direct=csv_vs_direct,
        instances=int(len(np.unique(inst[inst >= 0]))), trees=4,
        instance_largest_share=share,
        instance_unassigned=float((inst < 0).mean()), instance_s=instance_s,
        seconds=time.perf_counter() - t_phase)
    print("threshold  BA (port)  F1 (port)  BA (JAX, BASELINE.md row 2)  "
          "F1 (JAX)", flush=True)
    for r in table:
        jba, jf1 = JAX_SWEEP[r["threshold"]]
        print(f"{r['threshold']:9.2f}  {r['balanced_acc']:9.3f}  "
              f"{r['f1']:9.3f}  {jba:27.3f}  {jf1:8.3f}", flush=True)
    for name in ("knn_topk", "knn_top2", "interp_blend"):
        if launches[name] == 0:
            raise AssertionError(f"tools: {name} did not launch in the sweep")
    if not dba <= TOOLS_MAX_DBA:
        raise AssertionError(
            f"tools: the sweep's 0.50 BA {at50['balanced_acc']} is {dba} "
            f"from the fast BA {accuracy['ba_fast']}")
    if not (np.isfinite(pr_card).all()
            and rec["priors_p99_abs_delta"] <= TOOLS_MAX_PRIOR_P99):
        raise AssertionError(f"tools: priors card vs CPU p99 "
                             f"{rec['priors_p99_abs_delta']}")
    for key, (in_csv, value) in csv_vs_direct.items():
        if in_csv != round(value, 3):
            raise AssertionError(f"tools: results.csv {key} {in_csv} != "
                                 f"{value} rounded to 3 places")
    return rec


# ---- phase ddp: data parallelism on one card (parallel/mesh.py)

# The sharded train step against one process: fp32 with the exact kNN
# within the CPU test's bar (tests/test_torch_parallel.py), under
# torch's deterministic algorithms on both sides (the card's own step
# repeats bit for bit only so, phase train_crosscheck); bf16 with the
# fast kNN within CROSSCHECK_TOLERANCES.
DDP_STEP_TOL = 1e-5
DDP_LR = 1e-4
DDP_STEP_CONFIGS = (("fp32_exact", {"compute_dtype": "float32",
                                    "knn_mode": "exact"}),
                    ("bf16_fast", {}))
DDP_TRAIN_KERNELS = ("knn_topk", "knn_top2", "interp_blend",
                     "blend_bwd_lists", "interp_blend_bwd")
DDP_PREDICT_KERNELS = ("knn_topk", "knn_top2", "interp_blend",
                       "pair_select")


def _kernel_wrappers() -> dict:
    from pointstowood_tpu_torch.ops.fusion_kernels import pair_select
    from pointstowood_tpu_torch.ops.interp_kernels import (
        blend_bwd_lists,
        interp_blend,
        interp_blend_bwd,
    )
    from pointstowood_tpu_torch.ops.knn_kernels import knn_top2, knn_topk

    return {"knn_topk": knn_topk, "knn_top2": knn_top2,
            "interp_blend": interp_blend, "blend_bwd_lists": blend_bwd_lists,
            "interp_blend_bwd": interp_blend_bwd, "pair_select": pair_select}


def ddp_step_batch(seed):
    """The train_step phase's batch: eight full 16384-point tiles and
    seeded labels."""
    from pointstowood_tpu_torch.data.dataset import pad_tiles

    tiles = synthetic_tiles(seed)
    batch = pad_tiles([t.points for t in tiles if len(t) == 16384][:8],
                      16384)
    labels = np.random.default_rng(seed).random(batch.mask.shape) < 0.3
    return (batch.pos, batch.reflectance, batch.mask, batch.sf,
            labels.astype(np.float32))


def ddp_steps(group, seed) -> dict:
    """One train step of each DDP_STEP_CONFIGS configuration from the
    seeded weights, this process's rows of ``ddp_step_batch`` under
    ``group`` (a ``parallel.DataGroup``): loss, counts, logits (this
    process's rows), the gradients the clip saw, the state after the
    step, the step's ms and peak memory, the launches of the train
    path's kernels (counts set to 0 just before); for bf16 also three
    more steps' ms."""
    import torch

    from pointstowood_tpu_torch.config import ModelConfig, TrainConfig
    from pointstowood_tpu_torch.model.layers import set_data_group
    from pointstowood_tpu_torch.parallel.mesh import shard_rows
    from pointstowood_tpu_torch.train import trainer
    from pointstowood_tpu_torch.utils.checkpoint_convert import (
        state_dict_from_flax,
    )

    wrappers = _kernel_wrappers()
    arrays = ddp_step_batch(seed)
    out = {}
    saved_clip = trainer.clip_by_global_norm_
    for name, kw in DDP_STEP_CONFIGS:
        net = trainer.build_train_net(ModelConfig(**kw), seed, device="cuda")
        net.load_state_dict(state_dict_from_flax(seeded_flax_variables(
            net, seed)))
        set_data_group(net, group)
        cfg = TrainConfig()
        opt = trainer.make_optimizer(net, cfg)
        step = trainer.make_train_step(net, opt, cfg, group)
        args = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                for a in shard_rows(group, *arrays)]
        gen = torch.Generator(device="cuda").manual_seed(seed)
        rec = {}

        def recording_clip(grads, max_norm, rec=rec):
            rec["grads"] = [g.detach().cpu().clone() for g in grads]
            return saved_clip(grads, max_norm)

        hook = net.register_forward_hook(
            lambda m, i, o, rec=rec: rec.__setitem__(
                "logits", o.detach().float().cpu().clone()))
        for fn in wrappers.values():
            fn.launches = 0
        torch.use_deterministic_algorithms(True, warn_only=True)
        trainer.clip_by_global_norm_ = recording_clip
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, counts, finite = step(*args, DDP_LR, gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            trainer.clip_by_global_norm_ = saved_clip
            torch.use_deterministic_algorithms(False)
        hook.remove()
        rec.update(
            loss=float(loss), counts=counts.cpu().tolist(), finite=finite,
            ms=ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            launches={n: fn.launches for n, fn in wrappers.items()},
            names=[n for n, _ in net.named_parameters()],
            state={k: v.detach().cpu().clone()
                   for k, v in net.state_dict().items()})
        if name == "bf16_fast":
            more = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(*args, DDP_LR, gen)
                torch.cuda.synchronize()
                more.append((time.perf_counter() - t0) * 1e3)
            rec["more_ms"] = more
        out[name] = rec
        del net, opt, step, args
        torch.cuda.empty_cache()
    return out


def _ddp_launch_env(rank: int, world: int, port: int) -> None:
    """The JAX package's launch variables for process ``rank`` of
    ``world`` on this host's one card."""
    os.environ.update(PTW_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                      PTW_NUM_PROCESSES=str(world),
                      PTW_PROCESS_ID=str(rank), LOCAL_RANK="0")


def _recorded_predict(argv) -> tuple:
    """``cli.predict.main(argv)`` with the labelled table it builds, the
    pair entries each launch of ``pair_select`` took, and the launches of
    the serving path's kernels (counts set to 0 just before)."""
    from pointstowood_tpu_torch.cli import predict as predict_cli
    from pointstowood_tpu_torch.predict import device_fusion, predicter

    wrappers = _kernel_wrappers()
    tables, entries = [], []
    real_seg, real_select = (predicter.semantic_segmentation,
                             device_fusion.pair_select)

    def seg(*a, **k):
        tables.append(real_seg(*a, **k))
        return tables[-1]

    def select(queries, *a, **k):
        entries.append(int(queries.shape[0]))
        return real_select(queries, *a, **k)

    for fn in wrappers.values():
        fn.launches = 0
    predicter.semantic_segmentation = seg
    device_fusion.pair_select = select
    try:
        (rec,) = predict_cli.main(argv)
    finally:
        predicter.semantic_segmentation = real_seg
        device_fusion.pair_select = real_select
    launches = {n: fn.launches for n, fn in wrappers.items()}
    return rec, tables[0], entries, launches


def _predict_argv(ply_path, model_path):
    return ["--point-cloud", ply_path, "--model", model_path,
            "--grid_size", "2.0", "4.0", "--min_pts", "128",
            "--max_pts", "16384", "--batch_size", "8"]


def ddp_one_process_worker(_, port, work, model_path, seed):
    """Phase ddp, one process on NCCL: the predict CLI on a small plot
    bootstraps the process group itself from ``PTW_NUM_PROCESSES=1``
    (NCCL, the default on CUDA), one NCCL all-reduce, then the one-process
    train steps: as a data group of one (the data-parallel numerics, float64
    batch statistics, without collectives: the reference of the split
    run), and without a group (float32 statistics, as the CLIs run one
    process: timed beside it). Results to ``work/one.pt``."""
    import torch
    import torch.distributed as dist

    from pointstowood_tpu_torch.parallel.mesh import DataGroup, data_group

    _ddp_launch_env(0, 1, port)
    rec, table, entries, launches = _recorded_predict(_predict_argv(
        os.path.join(work, "nccl", "small.ply"), model_path))
    backend = dist.get_backend()
    probe = torch.full((4,), 3.0, device="cuda")
    dist.all_reduce(probe)
    torch.cuda.synchronize()
    result = {"backend": backend, "world": dist.get_world_size(),
              "group_is_none": data_group() is None,
              "all_reduce": probe.cpu().tolist(), "cli_points": rec["points"],
              "cli_seconds": rec["seconds"], "cli_launches": launches,
              "cli_wood": float(np.mean(table["label"])),
              "steps": ddp_steps(DataGroup(0, 1, None), seed),
              "ungrouped": {name: {k: v for k, v in rec.items()
                                   if k in ("loss", "ms", "more_ms",
                                            "peak_gib")}
                            for name, rec in ddp_steps(None, seed).items()}}
    torch.save(result, os.path.join(work, "one.pt"))
    dist.destroy_process_group()


def ddp_rank_worker(rank, world, port, work, ply_path, model_path, seed):
    """Phase ddp, one of ``world`` processes on ``cuda:0`` over gloo: the
    sharded train steps, then ``cli.predict.main`` on the plot (its own
    bootstrap finds the group made here). Results to
    ``work/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from pointstowood_tpu_torch.parallel.mesh import (
        data_group,
        maybe_init_distributed,
    )

    _ddp_launch_env(rank, world, port)
    if not maybe_init_distributed(backend="gloo"):
        raise AssertionError("ddp: the group did not form")
    group = data_group()
    steps = ddp_steps(group, seed)
    torch.cuda.reset_peak_memory_stats()
    rec, table, entries, launches = _recorded_predict(
        _predict_argv(ply_path, model_path))
    torch.save({"rank": rank, "backend": dist.get_backend(), "steps": steps,
                "predict": {"seconds": rec["seconds"], "entries": entries,
                            "launches": launches,
                            "label": np.asarray(table["label"]),
                            "pwood": np.asarray(table["pwood"]),
                            "peak_gib": torch.cuda.max_memory_allocated()
                            / 2**30}},
               os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ddp_compare_steps(one: dict, ranks: list) -> dict:
    """The two processes' steps against the one process's: fp32_exact
    within DDP_STEP_TOL (loss, counts, logits, every gradient carrying
    >= 1e-6 of the gradient's L1 mass per tensor, the whole gradient,
    the running statistics and those parameters after the step; the
    parameters whose gradient is rounding noise within 2.1 lr),
    bf16_fast within CROSSCHECK_TOLERANCES; the processes' states
    identical. Raises on a miss; returns the measured distances."""
    import torch

    out = {}
    m = torch.from_numpy(ddp_step_batch(SEED)[2])
    for name, _ in DDP_STEP_CONFIGS:
        ref = one[name]
        grads_r = dict(zip(ref["names"], ref["grads"]))
        mass = sum(float(g.abs().sum()) for g in grads_r.values())
        logits = torch.cat([r[name]["logits"] for r in ranks])
        dl = (logits - ref["logits"]).abs()[m]
        rec = {"loss_one": ref["loss"],
               "loss_rel": max(abs(r[name]["loss"] - ref["loss"])
                               / abs(ref["loss"]) for r in ranks),
               "counts_equal": all(r[name]["counts"] == ref["counts"]
                                   for r in ranks),
               "logits_max_abs": float(dl.max()),
               "logits_mean_abs": float(dl.mean())}
        per, total, stats, state, noise_step = {}, 0.0, 0.0, 0.0, 0.0
        for r in ranks:
            grads = dict(zip(r[name]["names"], r[name]["grads"]))
            total = max(total, sum(float((grads[k] - g).abs().sum())
                                   for k, g in grads_r.items()) / mass)
            for k, g in grads_r.items():
                if float(g.abs().sum()) >= 1e-6 * mass:
                    per[k] = max(per.get(k, 0.0), rel_l1(grads[k], g))
            for k, v in ref["state"].items():
                if not v.is_floating_point():
                    continue
                d = float(((r[name]["state"][k] - v).abs()
                           / (v.abs() + 1)).max())
                if "running" in k:
                    stats = max(stats, d)
                g = grads_r.get(k)
                if g is not None and float(g.abs().sum()) < 1e-6 * mass:
                    # a rounding-noise gradient (a bias or depthwise
                    # scale right in front of a batch-statistic
                    # BatchNorm): Adam's first step moves the parameter
                    # by up to ~lr on any nonzero one
                    noise_step = max(noise_step, float(
                        (r[name]["state"][k] - v).abs().max()))
                else:
                    state = max(state, d)
        mass_share = {k: float(g.abs().sum()) / mass
                      for k, g in grads_r.items()}
        worst = sorted(per.items(), key=lambda kv: -kv[1])[:5]
        rec.update(grads_rel_l1_total=total, grads_rel_l1_worst=worst,
                   grads_rel_l1_conv2=per.get("conv2.weight"),
                   running_stats_max_rel=stats, state_max_rel=state,
                   noise_gradient_params_max_abs=noise_step,
                   ranks_state_identical=all(
                       torch.equal(v, ranks[1][name]["state"][k])
                       for k, v in ranks[0][name]["state"].items()))
        if name == "fp32_exact":
            tol = DDP_STEP_TOL
            checks = {
                "loss_rel": rec["loss_rel"] <= tol,
                "counts": rec["counts_equal"],
                "logits": rec["logits_max_abs"] <= tol * max(
                    1.0, float(ref["logits"].abs()[m].max())),
                "grads_per_tensor": all(v <= tol for v in per.values()),
                "grads_total": total <= tol,
                "state": state <= tol,
                "noise_gradient_params": noise_step <= 2.1 * DDP_LR,
            }
        else:
            tol = CROSSCHECK_TOLERANCES
            carried = {k: v for k, v in per.items()
                       if mass_share[k] >= 1e-3}
            checks = {
                "loss_rel": rec["loss_rel"] <= tol["loss_rel"],
                "logits_mean_abs": rec["logits_mean_abs"]
                <= tol["logits_mean_abs"],
                "logits_max_abs": rec["logits_max_abs"]
                <= tol["logits_max_abs"],
                "grads_rel_l1_total": total <= tol["grads_rel_l1_total"],
                "grads_rel_l1_tensor": all(
                    v <= tol["grads_rel_l1_tensor"]
                    for v in carried.values()),
                "grads_rel_l1_conv2": per["conv2.weight"]
                <= tol["grads_rel_l1_conv2"],
                "running_stats_rel": stats <= tol["running_stats_rel"],
            }
        checks["ranks_state_identical"] = rec["ranks_state_identical"]
        checks["finite"] = ref["finite"] and all(r[name]["finite"]
                                                 for r in ranks)
        rec["checks"] = checks
        out[name] = rec
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"ddp {name}: two processes and one "
                                 f"disagree on {failed}: {rec}")
    return out


def ddp_phase(smi, ply_path, ckpt):
    """Phase ddp: data parallelism on the card's one device. One process
    (``ddp_one_process_worker``: the predict CLI bootstraps NCCL from
    ``PTW_NUM_PROCESSES=1``; the one-process train steps), then two
    processes on ``cuda:0`` over gloo (``ddp_rank_worker``: the sharded
    train steps, the predict CLI on the phase-6 plot), and the one-process
    predict CLI here on the same plot; the two runs held against one
    (``ddp_compare_steps``; labels >= 0.995, p99 |delta pwood| <= 0.02,
    the ranks' tables identical, ``pair_select`` launched on both ranks
    over shares of the entries that add up to the plan's). The predict
    CLI runs ``ckpt``, the accuracy phase's trained C = 32 model, so that
    the plot holds both classes (checked) and the comparison is not
    trivial; the wood fraction and the spread of pwood are recorded. Two
    processes on one card are not a speed-up: their step ms is recorded,
    not claimed. Returns each rank's launches on the bf16 train step and on
    the predict CLI."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    from pointstowood_tpu_torch.io import write_ply

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_ddp")
    shutil.rmtree(work, ignore_errors=True)
    for sub in ("nccl", "one", "two"):
        os.makedirs(os.path.join(work, sub))
    write_ply(os.path.join(work, "nccl", "small.ply"),
              synthetic_plot(SEED + 3, n_side=2)[0])
    plys = {}
    for sub in ("one", "two"):
        plys[sub] = os.path.join(work, sub, "plot.ply")
        shutil.copyfile(ply_path, plys[sub])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # cuBLAS repeats its sums only with a fixed workspace
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

    t0 = time.perf_counter()
    mp.spawn(ddp_one_process_worker,
             args=(_free_port(), work, ckpt, SEED), nprocs=1)
    one_s = time.perf_counter() - t0
    one = torch.load(os.path.join(work, "one.pt"), weights_only=False)
    if one["backend"] != "nccl" or one["world"] != 1 \
            or not one["group_is_none"] or one["all_reduce"] != [3.0] * 4:
        raise AssertionError(f"ddp: NCCL bootstrap: {one['backend']}, "
                             f"world {one['world']}, {one['all_reduce']}")
    emit("ddp_nccl", backend=one["backend"], world=one["world"],
         all_reduce=one["all_reduce"], cli_points=one["cli_points"],
         cli_seconds=one["cli_seconds"], cli_launches=one["cli_launches"],
         cli_wood_fraction=one["cli_wood"], process_s=one_s)

    t0 = time.perf_counter()
    mp.spawn(ddp_rank_worker,
             args=(2, _free_port(), work, plys["two"], ckpt, SEED),
             nprocs=2)
    two_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    compared = ddp_compare_steps(one["steps"], [r["steps"] for r in ranks])
    step_rec = {}
    for name, _ in DDP_STEP_CONFIGS:
        step_rec[name] = {
            "one_process": {k: one["steps"][name][k] for k in
                            ("loss", "counts", "ms", "peak_gib", "launches")
                            + (("more_ms",) if name == "bf16_fast" else ())},
            "ranks": [{k: r["steps"][name][k] for k in
                       ("loss", "counts", "ms", "peak_gib", "launches")
                       + (("more_ms",) if name == "bf16_fast" else ())}
                      for r in ranks],
            # float32 statistics: the one-process numerics of the CLIs
            "one_process_ungrouped": one["ungrouped"][name],
            "compared": compared[name]}
    for r in ranks:
        for k in DDP_TRAIN_KERNELS:
            if r["steps"]["bf16_fast"]["launches"][k] == 0:
                raise AssertionError(f"ddp: {k} did not launch on rank "
                                     f"{r['rank']}'s train step")
    emit("ddp_step", nvidia_smi=smi, batch=[8, 16384], ranks=2,
         backend=ranks[0]["backend"], device="cuda:0 (both ranks)",
         tolerance_fp32_exact=DDP_STEP_TOL,
         tolerances_bf16_fast=CROSSCHECK_TOLERANCES,
         deterministic_algorithms=True, **step_rec, processes_s=two_s)

    # the one-process predict CLI on the same plot, here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec1, table1, entries1, launches1 = _recorded_predict(
        _predict_argv(plys["one"], ckpt))
    one_wall = time.perf_counter() - t0
    preds = [r["predict"] for r in ranks]
    for p in preds[1:]:
        if not (np.array_equal(p["label"], preds[0]["label"])
                and np.array_equal(p["pwood"], preds[0]["pwood"])):
            raise AssertionError("ddp: the ranks' labelled tables differ")
    agree = float((preds[0]["label"] == table1["label"]).mean())
    dp = np.abs(preds[0]["pwood"] - table1["pwood"])
    p99 = float(np.quantile(dp, 0.99))
    shares = [sum(p["entries"]) for p in preds]
    wood = float(np.mean(table1["label"]))
    pwood1 = np.asarray(table1["pwood"])
    rec = emit("ddp_predict", nvidia_smi=smi, ranks=2, points=len(dp),
               model=os.path.relpath(ckpt, ROOT),
               wood_fraction_one_process=wood,
               wood_fraction_two_ranks=float(np.mean(preds[0]["label"])),
               pwood_one_process_quantiles={
                   q: float(np.quantile(pwood1, q))
                   for q in (0.01, 0.1, 0.5, 0.9, 0.99)},
               pwood_one_process_std=float(pwood1.std()),
               label_agreement=agree, p99_abs_dpwood=p99,
               max_abs_dpwood=float(dp.max()),
               entries_one_process=sum(entries1), entries_per_rank=shares,
               pair_select_calls_per_rank=[len(p["entries"]) for p in preds],
               launches_per_rank=[p["launches"] for p in preds],
               launches_one_process=launches1,
               seconds_per_rank=[p["seconds"] for p in preds],
               seconds_one_process=rec1["seconds"],
               wall_one_process_s=one_wall,
               peak_gib_per_rank=[p["peak_gib"] for p in preds],
               ply_written=[os.path.exists(os.path.join(
                   work, sub, "plot_ours.ply")) for sub in ("one", "two")])
    if agree < 0.995 or p99 > 0.02:
        raise AssertionError(f"ddp: two ranks and one process disagree on "
                             f"the plot: {agree}, p99 {p99}")
    if not 0.0 < wood < 1.0:
        raise AssertionError(f"ddp: the model labels {wood} of the plot as "
                             f"wood: a comparison of one class")
    for p in preds:
        for k in DDP_PREDICT_KERNELS:
            if p["launches"][k] == 0:
                raise AssertionError(f"ddp: {k} did not launch on a rank's "
                                     f"predict")
    if min(shares) == 0 or sum(shares) != sum(entries1):
        raise AssertionError(f"ddp: entry shares {shares} against "
                             f"{sum(entries1)}")
    if not all(rec["ply_written"]):
        raise AssertionError("ddp: rank 0 wrote no labelled PLY")
    emit("ddp", seconds=time.perf_counter() - t_phase)
    return ([r["steps"]["bf16_fast"]["launches"] for r in ranks],
            [p["launches"] for p in preds])


PTV1_VALID = (16384, 16384, 12000, 9000, 8192, 15001, 10007, 16383)


def fps_adversarial_inputs(seed):
    """``fps`` inputs that break a wrong sampling, from numpy: (name, pos
    (B, N, 3), n_valid a row, counts a row or None for n_valid // 4, m):
    coordinates on a coarse grid (exact distance ties everywhere), every
    point of a row on one spot, a short padded row and an empty one,
    counts past the slots (clamped), odd and tiny N, and N = 32768 (the
    kernel's path without shared memory)."""
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 4, (4, 2048, 3)).astype(np.float32)
    same = np.full((2, 1024, 3), 0.25, np.float32)
    return [
        ("grid ties", grid, [2048, 2048, 1500, 777], None, 512),
        ("one spot", same, [1024, 600], None, 256),
        ("short and empty rows", rng.normal(size=(3, 1024, 3)).astype(
            np.float32), [5, 0, 1024], None, 256),
        ("counts past the slots", rng.normal(size=(2, 300, 3)).astype(
            np.float32), [300, 299], [100, 80], 64),
        ("N = 100", rng.normal(size=(3, 100, 3)).astype(np.float32),
         [100, 37, 1], None, 25),
        ("N = 1", rng.normal(size=(2, 1, 3)).astype(np.float32), [1, 0],
         [1, 0], 1),
        ("N = 32768", rng.uniform(-2, 2, (2, 32768, 3)).astype(np.float32),
         [32768, 20001], None, 8192),
    ]


def ptv1_phase(dev, smi, rows, ptxas):
    """Phase ``ptv1``: Point Transformer's kernels at the
    ``train-b8.ptv1-seg50`` cell's shapes (B = 8 rows of 16384 slots,
    mixed valid counts ``PTV1_VALID``): ``fps`` at each level
    (16384 -> 4096 -> 1024 -> 256 -> 64, floor(n_valid / 4) picks a
    row) bit for bit against ``fps_plain``, timed against its bound;
    ``knn_topk`` at each level's self-search (K = 8 at level 1, 16
    below: 16384, 4096, 1024, 256 and 64 sources), centre search (K = 16)
    and interpolation search (k = 3), bit for bit against
    ``select_plain``; ``interp_blend`` and ``interp_blend_bwd`` of each
    TransitionUp (8x16384 <- 4096, 4096 <- 1024, 1024 <- 256, 256 <- 64
    at C = 32, 64, 128, 256 bf16) on the model's own (idx, sqrt(d2) +
    1e-8) from those k = 3 searches, the forward within a bf16 step of
    ``blend_plain``, the backward bit for bit against
    ``blend_bwd_plain``, each timed against its bound; ``fps`` on
    ``fps_adversarial_inputs``, bit for bit; then the network
    (``PointTransformerSeg``, C = 32, bf16, fast kNN, torch's
    initialisation) on that batch: launches a forward and a training
    forward and backward (``layers``, launched kernel by kernel: the
    step's replayed graphs launch the same kernels), forward ms, the
    replayed step's ms, peak memory (the process's)."""
    import torch

    from pointstowood_tpu_torch.config import TrainConfig
    from pointstowood_tpu_torch.model import PointTransformerSeg
    from pointstowood_tpu_torch.ops.fps_kernels import fps, fps_plain
    from pointstowood_tpu_torch.ops.interp_kernels import (
        blend_bwd_plain,
        blend_plain,
        interp_blend,
        interp_blend_bwd,
    )
    from pointstowood_tpu_torch.ops.knn import knn_masked
    from pointstowood_tpu_torch.ops.knn_kernels import knn_topk, select_plain
    from pointstowood_tpu_torch.train import trainer

    def fps_check(name, p, m, counts, slots):
        i_k, v_k = fps(p, m, counts, slots)
        torch.cuda.synchronize()
        i_p, v_p = fps_plain(p, m, counts, slots)
        if not (torch.equal(i_k, i_p) and torch.equal(v_k, v_p)):
            moved = float((i_k != i_p).float().mean())
            raise AssertionError(f"fps {name}: {moved:.2e} of the picks "
                                 "differ from the plain version")
        return i_k, v_k

    rng = np.random.default_rng(SEED + 18)
    b, n = len(PTV1_VALID), max(PTV1_VALID)
    valid_n = torch.tensor(PTV1_VALID, device=dev)
    pos = torch.from_numpy(rng.uniform(-2.0, 2.0, (b, n, 3)).astype(
        np.float32)).to(dev)
    mask = torch.arange(n, device=dev)[None] < valid_n[:, None]
    levels = [(pos, mask)]
    rows_b = torch.arange(b, device=dev)[:, None]
    regs = {k: v for k, v in ptxas.items() if k.startswith("fps_kernel")}
    for lvl in range(1, 5):
        p, m = levels[-1]
        slots = p.shape[1] // 4
        counts = m.sum(1) // 4
        idx, valid = fps_check(f"level {lvl + 1}", p, m, counts, slots)

        def call(p=p, m=m, counts=counts, slots=slots):
            return fps(p, m, counts, slots)

        nv, picks = m.sum(1).double(), counts.double()
        bms, by = bound(10.0 * float((nv * picks).sum()),
                        13.0 * float(nv.sum()) + 8.0 * float(picks.sum()),
                        LANE_OPS_PER_S)
        rows.append({
            "name": f"fps level {lvl + 1}", "check": "ok", "route": "cuda",
            "source": "pointstowood_tpu_torch/csrc/fps.cu",
            "replaces": "none (Point Transformer's furthestsampling)",
            "wrapper": "fps", "shape": [b, p.shape[1], slots],
            "picks": int(picks.sum()), "ms": cuda_ms(call),
            "bracketed_ms": bracketed_ms(call),
            "plain_ms": cuda_ms(lambda: fps_plain(p, m, counts, slots),
                                reps=1, warmup=1),
            "bound_ms": bms, "bound_by": by, "registers": regs})
        emit("kernel", **rows[-1])
        levels.append((p[rows_b, idx], valid))

    knn_src = "pointstowood_tpu_torch/csrc/knn.cu"
    cases = [(f"knn_topk ptv1 self L{i + 1}", i, i, 8 if i == 0 else 16)
             for i in range(5)]
    cases += [(f"knn_topk ptv1 centres L{i + 1}", i, i - 1, 16)
              for i in range(1, 5)]
    cases += [(f"knn_topk ptv1 interp L{i}", i - 1, i, 3)
              for i in range(1, 5)]
    for name, ri, ci, k in cases:
        (r, rm), (c, cm) = levels[ri], levels[ci]
        d_k, i_k = knn_topk(r, c, cm, k)
        torch.cuda.synchronize()
        check_exact(name, d_k, i_k, *select_plain(r, c, cm, k))
        pairs = float((rm.sum(1).double() * cm.sum(1).double()).sum())
        bms, by = bound(8.0 * pairs, 13.0 * float(rm.sum() + cm.sum())
                        + 8.0 * k * float(rm.sum()), LANE_OPS_PER_S)
        rows.append({
            "name": name, "check": "ok", "route": "cuda", "source": knn_src,
            "replaces": "none (Point Transformer's knnquery)",
            "wrapper": "knn_topk", "shape": [b, r.shape[1], c.shape[1], k],
            "ms": cuda_ms(lambda: knn_topk(r, c, cm, k)),
            "bound_ms": bms, "bound_by": by, "distance_pairs": pairs})
        emit("kernel", **rows[-1])

    # each TransitionUp's blend: the coarser level's C_{l-1} features onto
    # the finer level's points, at the model's (idx, sqrt(d2) + 1e-8)
    # (a centre on its own point weighs 1e8)
    interp_src = "pointstowood_tpu_torch/csrc/interp.cu"
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    for lvl in range(1, 5):
        (fp, fm), (cp, cm) = levels[lvl - 1], levels[lvl]
        c = 32 * 2 ** (lvl - 1)
        idx, d2, _ = knn_masked(fp, cp, 3, query_mask=fm, source_mask=cm,
                                method="topk")
        dist = torch.sqrt(d2) + 1e-8
        x = torch.randn((b, cp.shape[1], c), generator=g, device=dev).to(
            torch.bfloat16)
        name = f"interp_blend ptv1 L{lvl}<-L{lvl + 1}"
        y_k = interp_blend(x, idx, dist, fm)
        torch.cuda.synchronize()
        y_p = blend_plain(x, idx, dist, fm)
        err = float((y_k.float() - y_p.float()).abs().max())
        tol = 1e-2 * float(y_p.float().abs().max())  # one bf16 step
        if not (torch.isfinite(y_k.float()).all() and err <= tol):
            raise AssertionError(f"{name}: max abs err {err} > {tol}")
        live = torch.isfinite(dist) & fm[..., None]
        flat = (idx.long() + (torch.arange(b, device=dev)
                              * cp.shape[1])[:, None, None])[live]
        n_rows_read = int(torch.unique(flat).numel())
        n_t = fp.shape[1]
        bms, by = bound(float(live.sum()) * 2 * c + float(fm.sum()) * c,
                        n_rows_read * c * 2 + b * n_t * (3 * 8 + 1)
                        + b * n_t * c * 2)
        rows.append({
            "name": name, "check": "ok", "route": "cuda",
            "source": interp_src,
            "replaces": "none (Point Transformer's interpolation)",
            "wrapper": "interp_blend", "shape": [b, n_t, cp.shape[1], c],
            "max_abs_err": err, "bit_equal": bool(torch.equal(y_k, y_p)),
            "ms": cuda_ms(lambda: interp_blend(x, idx, dist, fm)),
            "bound_ms": bms, "bound_by": by})
        emit("kernel", **rows[-1])
        d_y = torch.randn((b, n_t, c), generator=g, device=dev).to(
            torch.bfloat16)
        name = f"interp_blend_bwd ptv1 L{lvl}<-L{lvl + 1}"

        def call(d_y=d_y, idx=idx, dist=dist, fm=fm, n_s=cp.shape[1]):
            return interp_blend_bwd(d_y, idx, dist, fm, n_s)
        d_k = call()
        torch.cuda.synchronize()
        check_blend_bwd(name, d_k, blend_bwd_plain(d_y, idx, dist, fm,
                                                   cp.shape[1]))
        check_blend_bwd(f"{name}, second call", call(), d_k)
        n_live = int(live.sum())
        bms, by = bound(2.0 * n_live * c + float(fm.sum()) * c,
                        b * n_t * c * 2 + b * n_t * (3 * 8 + 1)
                        + b * cp.shape[1] * c * 2)
        rows.append({
            "name": name, "check": "ok", "route": "cuda",
            "source": interp_src,
            "replaces": "none (Point Transformer's interpolation)",
            "wrapper": "interp_blend_bwd", "shape": [b, n_t, cp.shape[1], c],
            "live_slots": n_live, "tolerance": "bit for bit (torch.equal), "
            "and the same tensor on a second call",
            "ms": cuda_ms(call), "bound_ms": bms, "bound_by": by})
        emit("kernel", **rows[-1])

    adversarial = []
    for name, p_np, nv, cnt, slots in fps_adversarial_inputs(SEED + 19):
        p = torch.from_numpy(p_np).to(dev)
        m = (torch.arange(p.shape[1], device=dev)[None]
             < torch.tensor(nv, device=dev)[:, None])
        counts = (m.sum(1) // 4 if cnt is None
                  else torch.tensor(cnt, device=dev))
        fps_check(name, p, m, counts, slots)
        adversarial.append(name)
    emit("fps_adversarial", cases=adversarial, check="ok")

    torch.manual_seed(SEED)
    net = PointTransformerSeg(channels=32, dtype=torch.bfloat16).to(dev)
    refl = torch.from_numpy(rng.uniform(-1, 1, (b, n)).astype(
        np.float32)).to(dev)
    sf = pos.norm(dim=-1).amax(1)
    labels = (torch.from_numpy(rng.random((b, n))) < 0.3).float().to(dev)
    wrappers = {"fps": fps, "knn_topk": knn_topk,
                "interp_blend": interp_blend,
                "interp_blend_bwd": interp_blend_bwd}
    with torch.no_grad():
        net.eval()
        net(pos, refl, mask, sf)
        for fn in wrappers.values():
            fn.launches = 0
        logits = net(pos, refl, mask, sf)
        torch.cuda.synchronize()
    fwd_launches = {k: fn.launches for k, fn in wrappers.items()}
    if not bool(torch.isfinite(logits[mask]).all()):
        raise AssertionError("PointTransformerSeg: non-finite logits")
    if fwd_launches["fps"] != 4:
        raise AssertionError(f"PointTransformerSeg: {fwd_launches['fps']} "
                             "fps launches a forward, not 4")
    fwd = []
    with torch.no_grad():
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net(pos, refl, mask, sf)
            torch.cuda.synchronize()
            fwd.append((time.perf_counter() - t0) * 1e3)
    net.train()
    # a training forward and backward launched kernel by kernel count a
    # step's launches (its replayed graphs launch the same kernels and
    # count none)
    for fn in wrappers.values():
        fn.launches = 0
    net.layers(pos, refl, mask, sf, False)[mask].float().sum().backward()
    torch.cuda.synchronize()
    step_launches = {k: fn.launches for k, fn in wrappers.items()}
    cfg = TrainConfig()
    step = trainer.make_train_step(net, trainer.make_optimizer(net, cfg), cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step(pos, refl, mask, sf, labels, 1e-4, gen)
    torch.cuda.synchronize()
    times, finite_all = [], True
    for _ in range(5):
        t0 = time.perf_counter()
        _, _, finite = step(pos, refl, mask, sf, labels, 1e-4, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        finite_all &= finite
    if not finite_all:
        raise AssertionError("PointTransformerSeg: a train step was not "
                             "finite")
    traced = ptv1_traced_step(net, step, (pos, refl, mask, sf, labels),
                              gen)
    update_check = update_arithmetic_check(dev)
    if step_launches["interp_blend_bwd"] != 4:
        raise AssertionError(f"PointTransformerSeg: "
                             f"{step_launches['interp_blend_bwd']} blend "
                             "backward launches a step, not 4")
    for row in rows:
        if row["name"].startswith("fps level") or " ptv1 " in row["name"]:
            row["launches_forward"] = fwd_launches[row["wrapper"]]
            row["launches_train_step"] = step_launches[row["wrapper"]]
    emit("ptv1", nvidia_smi=smi, batch=[b, n], n_valid=list(PTV1_VALID),
         launches_forward=fwd_launches, launches_train_step=step_launches,
         forward_ms=statistics.median(fwd), forward_ms_all=fwd,
         train_step_ms=statistics.median(times), train_step_ms_all=times,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
         cuda_graphs=sorted(str(k[0][0]) for k in net._graphs),
         traced_step=traced, update_arithmetic=update_check)
    del net, step


def update_arithmetic_check(dev) -> dict:
    """The train step's guard and clip on the card (``all_finite``,
    ``clip_by_global_norm_`` inside a step's ``_replaying``) against the
    per-tensor arithmetic they replace, bit for bit, below and past the
    limit: a chain of 0-d additions for the norm, ``g / norm * limit`` a
    tensor, one finiteness check a tensor; each case twice (the second
    replays the captured graphs)."""
    import torch

    from pointstowood_tpu_torch.train import trainer

    def old_clip(grads, max_norm):
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))
        return norm

    rng = np.random.default_rng(SEED + 21)
    grads = [torch.from_numpy(rng.standard_normal(tuple(
        rng.integers(1, 300, size=int(rng.integers(1, 3))))).astype(
        np.float32)).to(dev) for _ in range(600)]
    replays, cases = {}, []
    for scale in (1e-4, 1e-3, 0.03, 1.0, 30.0):
        for _ in range(2):
            for g, v in zip(grads, rng.standard_normal(len(grads))):
                g.normal_(0.0, scale * abs(float(v)))
            old = [g.clone() for g in grads]
            with trainer._replaying(replays):
                finite = bool(trainer.all_finite(torch.tensor(0.5, device=dev),
                                                 grads))
                norm = trainer.clip_by_global_norm_(grads, 1.0)
            want = old_clip(old, 1.0)
            if not (finite and torch.equal(norm, want)
                    and all(torch.equal(a, b) for a, b in zip(grads, old))):
                raise AssertionError(f"update arithmetic: scale {scale}, "
                                     f"norm {float(norm)} vs {float(want)}")
            cases.append(float(want))
    grads[123].view(-1)[0] = float("nan")
    with trainer._replaying(replays):
        if bool(trainer.all_finite(torch.tensor(0.5, device=dev), grads)):
            raise AssertionError("update arithmetic: a NaN gradient passed")
    return {"norms": cases, "check": "ok"}


def ptv1_traced_step(net, step, batch, gen) -> dict:
    """A traced step of the replayed graphs: ``trace_graphs()``, one step
    to capture them again with stamps, then one under ``torch.profiler``.
    Its ``pt.fps`` spans (from the stamps) must hold the ``fps_kernel``
    time the profiler records in the replay (the span adds a division
    and the launch gaps), and it must record 4 ``pt.fps``, 5 ``pt.knn``
    and 18 ``pt.attention`` spans and the ``pt.pairs`` counter."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pointstowood_tpu_torch.utils import trace

    net.trace_graphs()
    step(*batch, 1e-4, gen)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*batch, 1e-4, gen)
        torch.cuda.synchronize()
    rec = trace.collected()
    ms = {}
    for sp in rec["spans"]:
        if sp["name"].startswith("pt.") and sp["device_ms"] is not None:
            a, b = sp["device_ms"]
            ms.setdefault(sp["name"], []).append(b - a)
    fps_kernel_ms = sum(
        e.duration_ns() for e in prof.profiler.kineto_results.events()
        if "fps_kernel" in e.name() and "CUDA" in str(e.device_type())) * 1e-6
    counts = {k: len(v) for k, v in ms.items()}
    if counts != {"pt.fps": 4, "pt.knn": 5, "pt.attention": 18}:
        raise AssertionError(f"traced replay: spans {counts}")
    fps_ms = sum(ms["pt.fps"])
    if not fps_kernel_ms <= fps_ms <= fps_kernel_ms + 0.5:
        raise AssertionError(f"traced replay: pt.fps spans {fps_ms} ms, "
                             f"fps_kernel {fps_kernel_ms} ms")
    pairs = rec["counters"].get("pt.pairs", 0)
    if pairs <= 0:
        raise AssertionError("traced replay: no pt.pairs")
    return {"spans": counts, "pt.fps_ms": fps_ms,
            "fps_kernel_ms": fps_kernel_ms,
            "pt.attention_ms": sum(ms["pt.attention"]),
            "pt.knn_ms": sum(ms["pt.knn"]), "pt.pairs": pairs}


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--compare-with", metavar="DIR",
        help="a directory holding an earlier tree's knn.cu, fusion.cu, "
             "group_min.cu and interp.cu, and knn_dim.cu where it has one "
             "(with their headers): its knn_topk, knn_top2, pair_select, "
             "group_min, interpolation backward and knn_topk_dim are timed "
             "in turns with the current ones at the same shapes")
    parser.add_argument(
        "--only", choices=("ptv1",), default=None,
        help="run the device and build phases, then this phase alone")
    parser.add_argument(
        "--accuracy-epochs", type=int, default=ACCURACY_EPOCHS,
        help="epochs of the accuracy phase's C=32 training (the reference "
             "script's are 50)")
    opts = parser.parse_args(argv)
    # every phase runs in another working directory (below)
    compare_with = (os.path.abspath(opts.compare_with) if opts.compare_with
                    else None)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    # every phase runs in a fresh working directory: the fusion paths
    # read a neighbour cache nbrs.npy from the working directory
    cwd = os.path.join(ROOT, "build", "chip_smoke_cwd")
    import shutil

    shutil.rmtree(cwd, ignore_errors=True)
    os.makedirs(cwd)
    os.chdir(cwd)
    from pointstowood_tpu_torch.config import (
        ModelConfig,
        PredictConfig,
        TilingConfig,
    )
    from pointstowood_tpu_torch.data.dataset import pad_tiles
    from pointstowood_tpu_torch.ops import build
    from pointstowood_tpu_torch.ops.fusion_kernels import pair_select
    from pointstowood_tpu_torch.ops.interp_kernels import (
        blend_bwd_lists,
        blend_plain,
        interp_blend,
        interp_blend_bwd,
    )
    from pointstowood_tpu_torch.ops.knn_kernels import (
        group_min,
        knn_top2,
        knn_topk,
        knn_topk_dim,
        select_plain,
        top2_lanes,
        topk_plan,
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
    import io

    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        paths = build.build_all(verbose=True)
    print(log.getvalue(), end="", flush=True)
    for name in build.SOURCES:
        build.library(name)
    sass_dir = os.path.join(ROOT, "build", "sass")
    sass = {}
    for name, prefixes in SASS_KERNELS.items():
        sass.update(sass_inner_loops(paths[name], prefixes, sass_dir))
    ptxas = ptxas_usage(log.getvalue())
    tensor_ops = {n: v["tensor_core_ops"] for n, v in sass.items()
                  if n.startswith("knn_dim_filter_kernel")}
    if not tensor_ops or not all(tensor_ops.values()):
        raise AssertionError(f"knn_dim_filter_kernel: no HMMA / HGMMA in "
                             f"its SASS: {tensor_ops}")
    emit("build", seconds=time.perf_counter() - t0,
         filter_tensor_core_ops=tensor_ops,
         sources=[f"pointstowood_tpu_torch/csrc/{n}.cu"
                  for n in build.SOURCES],
         ptxas=ptxas, sass_inner_loops=sass)
    earlier_knn_top2 = None
    if compare_with:
        t0 = time.perf_counter()
        old = build.build_all(
            ("knn", "fusion", "group_min", "interp")
            + (("knn_dim",) if os.path.exists(
                os.path.join(compare_with, "knn_dim.cu")) else ()),
            csrc=Path(compare_with))
        earlier_knn_top2 = earlier_top2(compare_with)
        old_sass = {}
        for name, prefixes in SASS_KERNELS.items():
            if name not in old:
                continue
            old_sass.update(sass_inner_loops(
                old[name], prefixes, os.path.join(sass_dir, "compared")))
        emit("build_compared", source=compare_with,
             seconds=time.perf_counter() - t0,
             per_pair={n: (v["per_pair"], sass.get(n, {}).get("per_pair"))
                       for n, v in old_sass.items()},
             per_pair_columns=["earlier", "current"])

    if opts.only == "ptv1":
        rows = []
        ptv1_phase(dev, smi, rows, ptxas)
        print(json.dumps({"kernels": rows}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

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
        # (name, wrapper, rows level, cols level, k, replaces); k = 64 is
        # Net(k=64)'s (phase forward_k64), not the main path's
        ("knn_topk SA1", knn_topk, 1, 0, k, f"{pk}:572"),
        ("knn_topk SA2", knn_topk, 2, 1, k, f"{pk}:572"),
        ("knn_topk SA3", knn_topk, 3, 2, k, f"{pk}:399"),
        ("knn_topk SA1 k=64", knn_topk, 1, 0, 64, f"{pk}:572"),
        ("knn_topk SA2 k=64", knn_topk, 2, 1, 64, f"{pk}:572"),
        ("knn_topk SA3 k=64", knn_topk, 3, 2, 64, f"{pk}:399"),
        # Net(k=128)'s (phase forward_k128): two passes of K = 64
        ("knn_topk SA1 k=128", knn_topk, 1, 0, 128, f"{pk}:572"),
        ("knn_topk SA2 k=128", knn_topk, 2, 1, 128, f"{pk}:572"),
        ("knn_topk SA3 k=128", knn_topk, 3, 2, 128, f"{pk}:399"),
        ("knn_top2 SA1 transpose", knn_top2, 0, 1, 2, f"{pk}:572"),
        ("knn_top2 SA2 transpose", knn_top2, 1, 2, 2, f"{pk}:572"),
        ("knn_top2 FP3", knn_top2, 2, 3, 2, f"{pk}:836"),
    ]
    selected = {}
    for name, fn, ri, ci, kk, replaces in select_cases:
        r, (c, cm) = lv[ri][0], lv[ci]
        b, nr, nc = r.shape[0], r.shape[1], c.shape[1]
        call = ((lambda: fn(r, c, cm, kk)) if fn is knn_topk
                else (lambda: fn(r, c, cm)))
        d_k, i_k = call()
        torch.cuda.synchronize()
        d_p, i_p = select_plain(r, c, cm, kk)
        err = check_exact(name, d_k, i_k, d_p, i_p)
        selected[name] = (i_k, d_k)
        extra = {}
        if kk == 64:
            # k of 33-64 runs the K = 64 instance and keeps k slots
            d_48, i_48 = knn_topk(r, c, cm, 48)
            torch.cuda.synchronize()
            check_exact(f"{name.removesuffix(' k=64')} k=48", d_48, i_48,
                        *select_plain(r, c, cm, 48))
            extra["also_checked"] = "k=48, bit for bit"
        if kk > 64:
            check_second_pass(name, r, c, cm)
            extra["passes"] = topk_plan(kk)[1]
            extra["also_checked"] = ("pass 2 alone against "
                                     "select_plain_above, bit for bit")
        if fn is knn_top2:
            extra["lanes"] = top2_lanes(b, nr)
        # the earlier tree has no passes past K = 64: k = 128 is timed alone
        ms, compared_ms, turns = timed(
            call, compare_with if kk <= 64 else None,
            (functools.partial(earlier_knn_top2, r, c, cm)
             if fn is knn_top2 and earlier_knn_top2 else None))
        if fn is knn_top2:
            # the warp selection at K = 2 on the same inputs
            def warp_select():
                return knn_topk(r, c, cm, 2)
            d_w, i_w = warp_select()
            torch.cuda.synchronize()
            check_exact(f"{name} (knn_topk, k=2)", d_w, i_w, d_p, i_p)
            top2_ms, warp_ms, route_turns = in_turns(
                lambda: cuda_ms(call), lambda: cuda_ms(warp_select))
            emit("top2_route", name=name, shape=[b, nr, nc, 2],
                 knn_top2_ms=top2_ms, knn_topk_k2_ms=warp_ms,
                 turns_ms=route_turns)
        plain_ms = cuda_ms(lambda: select_plain(r, c, cm, kk), reps=3,
                           warmup=1)
        lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(r, c), kk, dim=-1,
                                            largest=False), reps=5)
        pairs = float(b * nr * nc)
        bms, by = bound(8.0 * pairs,
                        12 * b * (nr + nc) + b * nc + 8 * b * nr * kk,
                        LANE_OPS_PER_S)
        rows.append({
            "name": name, "check": "ok", "route": "cuda", "source": knn_src,
            "replaces": replaces, "wrapper": fn.__name__,
            "shape": [b, nr, nc, kk], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "distance_pairs": pairs, "bracketed_ms": bracketed_ms(call),
            **extra,
            "compared_ms": compared_ms, "turns_ms": turns,
            "library_ms": lib_ms,
            "library_call": "torch.topk(torch.cdist(rows, cols)), no mask",
        })
        emit("kernel", **rows[-1])
    topk_passes_rows(lv, rows)
    top2_lanes_phase(lv, selected)
    adversarial_phase(dev)
    ptv1_phase(dev, smi, rows, ptxas)

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
        bit_equal = bool(torch.equal(y_k, y_p))
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
            "max_abs_err": err, "bit_equal": bit_equal, "ms": ms,
            "bracketed_ms": bracketed_ms(
                lambda: interp_blend(x, idx, d2, tmask)),
            "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "library_call": "torch.nn.functional.embedding_bag(mode='sum', "
                            "per_sample_weights)",
        })
        emit("kernel", **rows[-1])

    blend_k16_row(lv, rows, g, c_fp)

    # ---- 4. the main path: run_inference over the plot. Every kernel's
    # launches are counted (each row's launches_forward); the forward
    # kernels must launch
    wrappers = {"knn_topk": knn_topk, "knn_top2": knn_top2,
                "interp_blend": interp_blend}
    every_wrapper = {**wrappers, "pair_select": pair_select,
                     "group_min": group_min, "knn_topk_dim": knn_topk_dim,
                     "blend_bwd_lists": blend_bwd_lists,
                     "interp_blend_bwd": interp_blend_bwd}
    for fn in every_wrapper.values():
        fn.launches = 0
    predict_cfg = PredictConfig(batch_size=8)
    tiling_cfg = TilingConfig(grid_size=(4.0,), min_pts=128, max_pts=16384)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_inference(tiles, net, predict_cfg, tiling_cfg, device=dev)
    run_s = time.perf_counter() - t0
    fwd_launches = {name: fn.launches for name, fn in every_wrapper.items()}
    launches = {name: fwd_launches[name] for name in wrappers}
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
         run_inference_s=run_s, launches=fwd_launches,
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

    # ---- 4b. Net(k=64): every SA stage's kNN on knn_topk's K = 64 instance
    net64 = build_net(ModelConfig(k=64), device=dev)
    net64.load_state_dict(
        state_dict_from_flax(seeded_flax_variables(net64, SEED)))
    for fn in every_wrapper.values():
        fn.launches = 0
    torch.cuda.synchronize()
    p64 = forward_probs(net64, pos, refl, mask, sf)
    torch.cuda.synchronize()
    k64_launches = {name: fn.launches for name, fn in every_wrapper.items()}
    live64 = p64.float()[mask]
    if tuple(p64.shape) != tuple(mask.shape) \
            or not bool(torch.isfinite(live64).all()):
        raise AssertionError("Net(k=64): non-finite or misshapen output")
    if k64_launches["knn_topk"] != 3:
        raise AssertionError(f"Net(k=64): {k64_launches['knn_topk']} "
                             f"knn_topk launches, not 3 (SA1-SA3)")
    fwd64 = []
    for i in range(7):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        forward_probs(net64, pos, refl, mask, sf)
        torch.cuda.synchronize()
        if i >= 2:
            fwd64.append((time.perf_counter() - t1) * 1e3)
    emit("forward_k64", batch=[8, 16384], k=64,
         stage_routes=net64.stage_routes(16384), launches=k64_launches,
         forward_ms_b8x16384=statistics.median(fwd64),
         mean_prob=float(live64.mean()))
    del net64, p64

    # ---- 4c. Net(k=128): every SA kNN in two passes of K = 64
    net128 = build_net(ModelConfig(k=128), device=dev)
    net128.load_state_dict(
        state_dict_from_flax(seeded_flax_variables(net128, SEED)))
    for fn in every_wrapper.values():
        fn.launches = 0
    torch.cuda.synchronize()
    p128 = forward_probs(net128, pos, refl, mask, sf)
    torch.cuda.synchronize()
    k128_launches = {name: fn.launches for name, fn in every_wrapper.items()}
    live128 = p128.float()[mask]
    if tuple(p128.shape) != tuple(mask.shape) \
            or not bool(torch.isfinite(live128).all()):
        raise AssertionError("Net(k=128): non-finite or misshapen output")
    if k128_launches["knn_topk"] != 6:
        raise AssertionError(f"Net(k=128): {k128_launches['knn_topk']} "
                             f"knn_topk launches, not 6 (SA1-SA3, two "
                             f"passes each)")
    fwd128 = []
    for i in range(7):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        forward_probs(net128, pos, refl, mask, sf)
        torch.cuda.synchronize()
        if i >= 2:
            fwd128.append((time.perf_counter() - t1) * 1e3)
    emit("forward_k128", batch=[8, 16384], k=128,
         stage_routes=net128.stage_routes(16384), launches=k128_launches,
         forward_ms_b8x16384=statistics.median(fwd128),
         mean_prob=float(live128.mean()))
    del net128, p128

    # ---- 4d. the attention variants (Net(attention_knn=True),
    # Net(attention_conv=True)): knn_topk_dim and their main paths
    attention_phase(dev, smi, tiles, rows, every_wrapper, ptxas, sass,
                    compare_with)

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

    eval_ply, eval_wood, model_path = serving_phases(
        net, dev, smi, rows, wrappers, compare_with)
    ckpt_phase(net, dev, smi, eval_ply,
               eval_ply.removesuffix(".ply") + "_ours.ply")
    las_phase(dev, smi, synthetic_plot(SEED)[0], model_path)

    # ---- 9-12. large tiles, on a denser plot whose 4 m cells fill the
    # 24576 and 32768 buckets: group_min on its main path's inputs, one
    # 32768-point tile CPU vs card, the CLI at max_pts 32768 on one grid
    # scale (index fusion path)
    large = large_tile_plot(SEED)
    group_min_rows(net, dev, rows, large, compare_with)
    fwd32_launches = crosscheck_large(net, dev, large, every_wrapper)
    predict_large_phases(dev, smi, rows, {**wrappers, "group_min": group_min},
                         large, model_path)

    # ---- 13-16. training
    n_fwd = len(rows)
    blend_bwd_rows(dev, rows, SEED, ptxas, compare_with)
    adversarial_bwd_phase(dev)
    for row in rows:
        row.setdefault("launches_forward", fwd_launches[row["wrapper"]])
        row["launches_forward_32768"] = fwd32_launches.get(row["wrapper"], 0)
    train_crosscheck(dev, SEED)
    train_wrappers = {"knn_topk": knn_topk, "knn_top2": knn_top2,
                      "interp_blend": interp_blend,
                      "blend_bwd_lists": blend_bwd_lists,
                      "interp_blend_bwd": interp_blend_bwd}
    _, step_launches = train_step_phase(dev, smi, every_wrapper, SEED,
                                        required=train_wrappers)
    for row in rows:
        row.setdefault("launches_train_step", step_launches[row["wrapper"]])
    for row in rows[n_fwd:]:
        row["launches"] = step_launches[row["wrapper"]]
    for row in rows:
        if row["wrapper"] != "knn_topk" or "launches_path" in row:
            continue
        if row["shape"][-1] == 64:
            row["launches"] = k64_launches["knn_topk"]
            row["launches_path"] = "Net(k=64) forward (phase forward_k64)"
        elif row["shape"][-1] == 128:
            row["launches"] = k128_launches["knn_topk"]
            row["launches_path"] = "Net(k=128) forward (phase forward_k128)"
    train_cli_phase(dev, smi, train_wrappers, eval_ply, eval_wood)
    accuracy, ckpt, exact_labels = accuracy_phase(
        dev, smi, train_wrappers, opts.accuracy_epochs)
    tools_phase(dev, smi, every_wrapper, accuracy, ckpt, exact_labels)
    ddp_steps_launches, ddp_predict_launches = ddp_phase(smi, eval_ply, ckpt)
    for row in rows:
        # each rank's launches on the sharded paths (phase ddp)
        row["launches_ddp_train_step_per_rank"] = [
            n.get(row["wrapper"], 0) for n in ddp_steps_launches]
        row["launches_ddp_predict_per_rank"] = [
            n.get(row["wrapper"], 0) for n in ddp_predict_launches]

    floors_phase(rows, sass)

    # ---- 18. results
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
