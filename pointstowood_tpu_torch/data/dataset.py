"""Padded static-shape tile batching (copy of
pointstowood_tpu/data/dataset.py, numpy only).

Tiles are bucketed by point count into a small set of capacities, padded
with validity masks and batched within a bucket. Each tile is centred by
its valid-point mean and carries the shift and the max-norm scale factor,
as the reference datasets do (trainer.py:54-56, predicter.py:84-93).

One difference from the JAX package: it chooses the half-step eval
capacities from an environment variable or a probe of its TPU host; the
port reads no environment and always takes the local-host default
(half-step capacities on for bucketed iteration).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

import numpy as np

from pointstowood_tpu_torch.data.tiling import Tile
from pointstowood_tpu_torch.utils import trace


def bucket_capacities(min_pts: int, max_pts: int, step: int = 8,
                      half_steps: bool = False) -> List[int]:
    """Geometric capacities covering [min_pts, max_pts]: powers of
    ``step`` from 256, plus max_pts. ``half_steps`` inserts the 1.5x
    capacities that are multiples of 1024 (3072/6144/12288 at the
    canonical 128..16384 config), which cut padding on big tiles while
    keeping every stage's shape on the JAX package's kernel routes (the
    port routes stages the same way, see model/network.py).
    """
    caps = []
    c = 256
    while c < max_pts:
        if c >= min_pts:
            caps.append(c)
        c *= step
    caps.append(max_pts)
    if half_steps:
        extra = [
            h for c in caps
            for h in ((c * 3) // 2,)
            if h % 1024 == 0 and min_pts <= h < max_pts
        ]
        caps = sorted(set(caps) | set(extra))
    return caps


@dataclasses.dataclass
class TileBatch:
    """One padded batch: everything the model consumes plus undo metadata."""

    pos: np.ndarray         # (B, N, 3) float32, centered per tile
    reflectance: np.ndarray  # (B, N) float32
    mask: np.ndarray        # (B, N) bool
    sf: np.ndarray          # (B,) float32 max point norm per tile
    shift: np.ndarray       # (B, 3) float32 per-tile centering shift
    labels: np.ndarray | None = None  # (B, N) float32 when training


def pad_tiles(tiles: Sequence[np.ndarray], capacity: int,
              with_labels: bool = False) -> TileBatch:
    """Pad a list of (n_i, 4|5) tile arrays into one (B, capacity, ...) batch.

    Centering and scale factor follow the reference datasets: shift = mean
    of xyz, sf = max ||p - shift|| (trainer.py:54-56). Tiles longer than
    ``capacity`` are truncated (callers bucket so this does not happen).
    """
    b = len(tiles)
    pos = np.zeros((b, capacity, 3), np.float32)
    refl = np.zeros((b, capacity), np.float32)
    mask = np.zeros((b, capacity), bool)
    sf = np.ones(b, np.float32)
    shift = np.zeros((b, 3), np.float32)
    labels = np.zeros((b, capacity), np.float32) if with_labels else None
    for i, t in enumerate(tiles):
        n = min(t.shape[0], capacity)
        if n == 0:  # all-invalid padding row (static batch dim)
            continue
        xyz = t[:n, :3].astype(np.float32)
        s = xyz.mean(axis=0)
        xyz = xyz - s
        pos[i, :n] = xyz
        refl[i, :n] = t[:n, 3]
        mask[i, :n] = True
        sf[i] = max(float(np.sqrt((xyz**2).sum(axis=1)).max()), 1e-12)
        shift[i] = s
        if with_labels:
            labels[i, :n] = t[:n, 4]
    return TileBatch(pos=pos, reflectance=refl, mask=mask, sf=sf, shift=shift,
                     labels=labels)


class TileBatcher:
    """Groups tiles into padded batches with static shapes.

    Iteration yields (capacity, TileBatch, tile_indices). The final batch
    is padded with all-invalid rows up to ``batch_size`` so the batch
    dimension is static too.

    Replaces the reference's BalancedBatchSampler (predicter.py:23-63),
    which pairs short+long tiles to keep total points per dynamic batch
    "consistent" (an OOM guard). Static padded batches bound device
    memory by construction (batch x capacity) and drop no tiles, where
    the reference's pairing loop drops up to batch_size/2 - 1 per half
    and still spans a ~10x points-per-batch spread on realistic tile
    distributions (measured: scripts/batch_balance_note.py, BASELINE.md).

    Two modes:
      * ``bucket=True`` (inference): tiles grouped by size bucket — minimal
        padding, one compiled shape per bucket. Safe at eval because
        BatchNorm is a fixed affine there.
      * ``bucket=False`` (training): random mixed-size batches, padded to
        the largest member's bucket — the reference's shuffled DataLoader
        semantics (trainer.py:110). Size-segregated batches give each
        bucket its own activation statistics, which poisons BatchNorm's
        running averages (eval collapsed from BA 0.86 to 0.56 on the same
        data before this fix).
    """

    # Buckets holding less than this fraction of the run's padded points
    # merge into the next larger bucket: one fewer compiled shape always
    # beats a sliver of padding (a compile is worth millions of points of
    # forward; see bucket_capacities).
    MERGE_FRACTION = 0.08

    def __init__(self, tiles: Sequence[Tile], batch_size: int,
                 min_pts: int, max_pts: int, with_labels: bool = False,
                 shuffle: bool = False, seed: int = 0,
                 augment=None, bucket: bool = True,
                 capacity_step: int | None = None,
                 scale_batch: bool | None = None,
                 half_caps: bool | None = None):
        """``capacity_step``/``scale_batch`` default per mode: bucketed
        (inference) iteration uses pow2 buckets (step=2) with the batch
        dim scaled to hold ~batch_size * max_cap points per dispatch —
        fine buckets cut the padding overhead from ~57% to ~24% of the
        padded forward points on realistic plots
        (scripts/batch_balance_note.py), and constant-points batches keep
        every bucket's forward MXU-shaped instead of tiny. Mixed-batch
        (training) iteration keeps coarse step=8 buckets and the fixed
        batch dim: mixed batches pad to the largest member, so fine
        buckets would only multiply the costly train-step compiles.
        External callers that pair ``tile_order()`` with engine outputs
        must use the same mode the engine used (the defaults agree)."""
        if capacity_step is None:
            capacity_step = 2 if bucket else 8
        if scale_batch is None:
            scale_batch = bucket
        if half_caps is None:
            half_caps = bucket
        self.tiles = list(tiles)
        self.batch_size = batch_size
        self.with_labels = with_labels
        self.capacities = bucket_capacities(min_pts, max_pts,
                                            step=capacity_step,
                                            half_steps=half_caps)
        self.shuffle = shuffle
        self.seed = seed
        self.augment = augment
        self.bucket = bucket
        self.scale_batch = scale_batch
        self._epoch = 0
        self._tile_cap = None
        if bucket and self.tiles:
            caps = [self._capacity_for(len(t)) for t in self.tiles]
            self._tile_cap = self._merge_sparse_buckets(caps)

    def batch_size_for(self, cap: int) -> int:
        """Batch dim for a bucket: constant ~batch_size * max_cap points
        per dispatch when scale_batch (always a multiple of batch_size,
        so mesh divisibility is preserved)."""
        if not (self.bucket and self.scale_batch):
            return self.batch_size
        return self.batch_size * max(1, self.capacities[-1] // cap)

    def _merge_sparse_buckets(self, caps: List[int]) -> List[int]:
        """Promote tiles out of buckets that hold a sliver of the padded
        points (deterministic from the tile set, so tile_order() and
        iteration agree)."""
        from collections import Counter

        counts = Counter(caps)
        present = sorted(counts)
        total = sum(c * counts[c] for c in present)
        while len(present) > 1:
            smallest_ok = True
            for i, c in enumerate(present[:-1]):
                if c * counts[c] < self.MERGE_FRACTION * total:
                    nxt = present[i + 1]
                    counts[nxt] += counts.pop(c)
                    present = sorted(counts)
                    smallest_ok = False
                    break
            if smallest_ok:
                break
        kept = sorted(counts)
        out = []
        for c in caps:
            bigger = [k for k in kept if k >= c]
            out.append(bigger[0] if bigger else kept[-1])
        return out

    def _capacity_for(self, n: int) -> int:
        for c in self.capacities:
            if n <= c:
                return c
        return self.capacities[-1]

    def __len__(self):
        if not self.bucket:
            return -(-len(self.tiles) // self.batch_size)
        from collections import Counter

        counts = Counter(self._tile_cap or [])
        return sum(-(-n // self.batch_size_for(c))
                   for c, n in counts.items())

    def _emit(self, chunk, rng, cap=None, b_size=None):
        """One padded batch; traced as ``batch.pad`` with the counters
        ``batch.points`` (valid rows) and ``batch.slots`` (rows x
        capacity, empty rows included)."""
        with trace.entry(), trace.span("batch.pad"):
            arrays = []
            for ti in chunk:
                pts = self.tiles[ti].points
                if self.augment is not None:
                    pts = self.augment(pts, rng)
                arrays.append(pts)
            if cap is None:  # mixed mode: pad to the largest member's bucket
                cap = self._capacity_for(max(a.shape[0] for a in arrays))
            # pad batch dim with empty tiles for a static B
            n_pad = (b_size or self.batch_size) - len(arrays)
            width = arrays[0].shape[1]
            arrays += [np.zeros((0, width), np.float32)] * n_pad
            batch = pad_tiles(arrays, cap, with_labels=self.with_labels)
            if trace.active():
                trace.count("batch.points",
                            sum(min(len(a), cap) for a in arrays))
                trace.count("batch.slots", len(arrays) * cap)
        return cap, batch, list(chunk)

    def batch_plan(self) -> List[tuple]:
        """The (capacity, tile_indices) sequence of deterministic bucketed
        iteration, without building any padded arrays. Defines the
        device-resident flat layout the zero-upload fusion path writes
        into during the model phase: batch b occupies
        ``batch_size * cap_b`` consecutive flat rows (including trailing
        empty-tile padding), tile j of batch b the j-th cap-sized region.
        Only defined for shuffle=False bucketed iteration."""
        assert self.bucket and not self.shuffle
        buckets: dict = {}
        for ti in range(len(self.tiles)):
            buckets.setdefault(self._tile_cap[ti], []).append(ti)
        return [
            (cap, idxs[s : s + self.batch_size_for(cap)])
            for cap, idxs in sorted(buckets.items())
            for s in range(0, len(idxs), self.batch_size_for(cap))
        ]

    def tile_order(self) -> List[int]:
        """The tile visit order of (deterministic) iteration, without
        building any padded arrays. The vstacked run_inference output rows
        are exactly the tiles' valid points concatenated in this order —
        which lets the fusion kNN index build start before the model runs
        (classified *positions* don't depend on the model). Only defined
        for shuffle=False; independent of batch_size (chunking changes
        batch boundaries, never order)."""
        assert not self.shuffle, "tile_order is only stable without shuffle"
        if not self.bucket:
            return list(range(len(self.tiles)))
        buckets: dict = {}
        for ti in range(len(self.tiles)):
            buckets.setdefault(self._tile_cap[ti], []).append(ti)
        return [ti for cap in sorted(buckets) for ti in buckets[cap]]

    def __iter__(self) -> Iterator[tuple]:
        order = np.arange(len(self.tiles))
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        if self.shuffle:
            rng.shuffle(order)
        if not self.bucket:
            for start in range(0, len(order), self.batch_size):
                yield self._emit(order[start : start + self.batch_size], rng)
            return
        buckets: dict = {}
        for ti in order:
            buckets.setdefault(self._tile_cap[ti], []).append(ti)
        for cap, idxs in sorted(buckets.items()):
            b = self.batch_size_for(cap)
            for start in range(0, len(idxs), b):
                yield self._emit(idxs[start : start + b], rng, cap=cap,
                                 b_size=b)
