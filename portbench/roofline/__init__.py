"""Operations, bytes and FLOPs of the work a window ran, and the chip's
peaks (``peaks.json``).

The roofline counts operations, not kernels: the work an operation needs
for these inputs, whatever implements it, read once and written once.
Its least time is the larger of operations at the published rate and
bytes at the memory bandwidth (the arithmetic of the port's smoke test:
FMA-free selections at 33.5 T operations a second, HBM at 3.35 TB/s).

* ``search``: a 3-D k-nearest search, counted as the exact search over
  every (query, source) pair of valid points: 8 FMA-free operations a
  pair (3 differences, 3 squares, 2 sums); bytes: both point sets and
  their masks in, (k indices + k distances) a query out. Every SA stage
  (its centres against its points), every FP stage (its points against
  the next level's centres), and the fusion index path's tile-local
  searches. Its time: the single-pass kernels by name, and the two-stage
  route (``group_min``, the top-k over the group minima, the gather, the
  index arithmetic) whole, from the benchmark's span around it.
* ``search_dim``: the D-dimensional search of the attention variant:
  2 D operations a pair at the TF32 tensor-core rate (the fastest
  product its certified filter may use).
* ``blend``, ``blend_bwd``: the FP interpolation of C = 16 x channels
  bfloat16 features at k = 2 and its gradient: bytes only.
* ``pair_select``: the fusion pair path's selection, 8 operations a
  (query, union point) pair; bytes: the queries, the union's points and
  payloads, k (distance, payload) a query.

``forward_ops`` and ``net_flops`` follow the PointsToWood ``Net``'s
stages and are called by ``arch/ptw.py`` alone; another architecture
counts its own operations and FLOPs in its ``arch/<name>.py`` (with
``op`` and the rates of ``peaks.json``) and names their kernels in its
``KERNELS``, merged into ``KERNELS`` here when it is loaded.

``net_flops`` counts the network's products (2 FLOPs a multiply-add) at
the valid points, the valid centres and k neighbours a centre; the
backward counts twice the forward.
"""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
PEAKS = json.loads((HERE / "peaks.json").read_text())
KERNELS = json.loads((HERE / "kernels.json").read_text())
BF16_BYTES = 2


def op(name: str, ops: float, nbytes: float, rate: str) -> dict:
    return {"op": name, "ops": float(ops), "bytes": float(nbytes),
            "rate": rate}


def search(pairs, rows, cols, k) -> dict:
    return op("search", 8 * pairs, 13 * (rows + cols) + 8 * k * rows,
              "fma_free_ops")


def search_dim(pairs, rows, cols, k, dim) -> dict:
    return op("search_dim", 2 * dim * pairs,
              4 * dim * (rows + cols) + cols + 8 * k * rows, "tf32_flops")


def blend(targets, sources, channels, k=2) -> dict:
    nbytes = (sources * channels * BF16_BYTES
              + targets * (channels * BF16_BYTES + 8 * k + 1))
    return op("blend", 2 * k * channels * targets, nbytes, "fp32_flops")


def blend_bwd(targets, sources, channels, k=2) -> dict:
    nbytes = (targets * (channels * BF16_BYTES + 8 * k + 1)
              + sources * channels * BF16_BYTES)
    return op("blend_bwd", 2 * k * channels * targets, nbytes, "fp32_flops")


def pair_select(pairs, queries, union_rows, k) -> dict:
    return op("pair_select", 8 * pairs,
              16 * queries + 16 * union_rows + 8 * k * queries,
              "fma_free_ops")


def bound_s(o: dict) -> float:
    return max(o["ops"] / PEAKS[o["rate"]],
               o["bytes"] / PEAKS["hbm_bytes_per_s"])


def forward_ops(counts: dict, model: dict, training: bool) -> list:
    """The operations of one forward (and its backward in training) from
    the valid counts of its samples: ``n`` points and ``s1``..``s3``
    centres (lists over the batch)."""
    c, k, fk = model["channels"], model["k"], model["fp_k"]
    n, s1, s2, s3 = (counts[x] for x in ("n", "s1", "s2", "s3"))
    att = model.get("attention_knn", False)
    out = [search(_dot(s1, n), sum(s1), sum(n), k)]
    for i, (q, p) in enumerate(((s2, s1), (s3, s2)), start=2):
        if att:
            a = ((4 if i == 2 else 8) * c + 4) // 2
            dim = 3 + 2 * a + (4 if i == 2 else 8) * c
            out.append(search_dim(_dot(q, p), sum(q), sum(p), k, dim))
        else:
            out.append(search(_dot(q, p), sum(q), sum(p), k))
    for t, s in ((s2, s3), (s1, s2), (n, s1)):
        out.append(search(_dot(t, s), sum(t), sum(s), fk))
        out.append(blend(sum(t), sum(s), 16 * c, fk))
        if training:
            out.append(blend_bwd(sum(t), sum(s), 16 * c, fk))
    return out


def _dot(a, b) -> float:
    return float(sum(x * y for x, y in zip(a, b)))


def net_macs(n: int, s1: int, s2: int, s3: int, model: dict) -> float:
    """Multiply-adds of the network's products for one sample."""
    c, k = model["channels"], model["k"]
    m = n * 3 * c + s1 * k * 3 * c  # stem on points and on SA1's edges
    specs = [(c + 4, 2 * c, 4 * c), (4 * c + 4, 6 * c, 8 * c),
             (8 * c + 4, 12 * c, 16 * c)]
    for s, (a, b, d) in zip((s1, s2, s3), specs):
        e = 4 * d
        m += s * k * (a * b + b * d) + s * (2 * d * e + 2 * e * e)
    if model.get("attention_knn", False):
        for p, (a, _, _) in zip((s1, s2), specs[1:]):
            att, cin = a // 2, a - 4
            m += p * ((cin + att) * att + att + (3 + att) * att + att)
    w = 16 * c
    m += s3 * ((w + 3) * w + w * w)                   # SA4
    m += s3 * (2 * w * 24 * c + 24 * c * w)           # FP4
    m += s2 * (24 * c * 20 * c + 20 * c * w)          # FP3
    m += s1 * (20 * c * w + w * w)                    # FP2
    m += n * (17 * c * w + w * w)                     # FP1
    m += n * (w * w + w * model["num_classes"])       # head
    return float(m)


def net_flops(counts: dict, model: dict, training: bool) -> float:
    macs = sum(net_macs(*v, model) for v in zip(
        counts["n"], counts["s1"], counts["s2"], counts["s3"]))
    return 2 * macs * (3 if training else 1)


def roofline_share(ops: list, kernel_s: dict, op_s: dict | None = None
                   ) -> float | None:
    """Sum of the operations' least times over the device time spent on
    them, in %, over the operations that ran; None where none did. An
    operation's time is that of its spans, timed whole (``op_s``), and of
    the kernels that bear one of its names (``kernel_s``)."""
    import re

    op_s = op_s or {}
    bound, spent = 0.0, 0.0
    for name, patterns in KERNELS.items():
        t = op_s.get(name, 0.0) + sum(
            s for kname, s in kernel_s.items()
            if any(re.search(rf"\b{p}\b", kname) for p in patterns))
        b = sum(bound_s(o) for o in ops if o["op"] == name)
        if t > 0 and b > 0:
            bound += b
            spent += t
    return 100.0 * bound / spent if spent else None
