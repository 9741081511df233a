"""Plain PyTorch reference of the PointsToWood segmentation network.

The network of pointstowood/src/model.py:204-245 (``Net(num_classes=1)``)
in the dense padded layout the port runs it in: a stem MLP, three
set-abstraction stages (voxel or random 50% centres, k nearest
neighbours, a PointNet conv, an inverted residual block), a global
max-pooled stage, four feature-propagation stages with k=2
inverse-distance interpolation and a Conv1d-BN-ReLU-Conv1d head. With
``attention_knn`` the SA2/SA3 neighbourhoods are the k nearest points in
the learned (3 + 2A + C_in)-dimensional embedding of
pointstowood/archive/attknnv3.py.

Everything is written as plain tensor operations over a dict of weights
keyed as the reference's ``state_dict`` (so one checkpoint serves both
sides), in float32 unless a ``Products`` precision says otherwise. The
neighbour searches are brute force over every pair: the exact k nearest
by the squared distance ((dx*dx + dy*dy) + dz*dz), ties to the lower
index; where the configuration's fast kNN takes the two-stage route
(3-D sources past 16384 at k = 32: one source per block-local group of
g, the k groups of smallest minimum) the search is that route's function,
computed exactly. The D-dimensional search ranks by the float64 squared
distance.

Departures from the published model, all shared with the program:
fixed-capacity centre slots with validity masks, the hash-ordered voxel
representative, and BatchNorm statistics over valid elements only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
PAD_CELL = (1 << 31) - 1
_U32 = 0xFFFFFFFF
_AXIS_BITS = 10
_AXIS_SIZE = 1 << _AXIS_BITS
FP8_MAX = 448.0


class Products:
    """Precision of the network's products (Linear / 1x1 Conv1d layers).
    ``float32``: exact float32 products (TF32 off). ``fp8``: both
    operands rounded to float8 e4m3 with a per-tensor scale, products
    accumulated in float32 (the control: the precision below the
    configuration's bfloat16)."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def round(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return t
        scale = torch.clamp(t.detach().abs().amax(), min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).to(F32) * scale

    def linear(self, x, w, b=None):
        if w.dim() == 3:
            w = w[..., 0]
        y = torch.matmul(self.round(x), self.round(w).t())
        return y if b is None else y + b


# ------------------------------------------------------------ searches


def pair_d2(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(B, R, 3) x (B, C, 3) -> (B, R, C): ((dx*dx + dy*dy) + dz*dz)."""
    sq = []
    for a in range(3):
        d = q[:, :, None, a] - s[:, None, :, a]
        sq.append(d * d)
    return (sq[0] + sq[1]) + sq[2]


def _rows_step(b: int, n_cols: int, elems: int = 1 << 26) -> int:
    return max(1, elems // max(1, b * n_cols))


def knn_exact(q, s, smask, k, dist=pair_d2):
    """The exact k nearest valid sources of each query row: (idx (B, R, k)
    int64, d2 (B, R, k)), ascending, ties to the lower source index, +inf
    and index 0 past the valid sources."""
    b, n_q = q.shape[:2]
    n = s.shape[1]
    kk = min(k, n)
    out_d = torch.full((b, n_q, k), math.inf, dtype=q.dtype, device=q.device)
    out_i = torch.zeros((b, n_q, k), dtype=torch.int64, device=q.device)
    step = _rows_step(b, n)
    for lo in range(0, n_q, step):
        d = dist(q[:, lo:lo + step], s)
        d = torch.where(smask[:, None, :] & ~torch.isnan(d), d, math.inf)
        vals, order = torch.sort(d, dim=-1, stable=True)
        out_d[:, lo:lo + step, :kk] = vals[..., :kk]
        out_i[:, lo:lo + step, :kk] = order[..., :kk]
    out_i = torch.where(torch.isfinite(out_d), out_i, 0)
    return out_i, out_d


def d2_dim(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(B, R, D) x (B, C, D) -> (B, R, C) float64 squared distances."""
    q64, s64 = q.double(), s.double()
    d = ((q64 * q64).sum(-1)[..., None] - 2.0 * torch.matmul(
        q64, s64.transpose(1, 2)) + (s64 * s64).sum(-1)[:, None, :])
    return torch.clamp(d, min=0.0)


# The fast kNN's route gates (pointstowood_tpu/ops/pallas_knn.py), which
# decide where the configuration's search is the two-stage function.
_G_MAX, _N_BLOCK_MAX, _HALVES, _SLICE_BITS = 8, 16384, 2, 3


def group_count(n: int, k: int) -> int:
    g = _G_MAX
    while g > 1 and (n % (g * 128) or (n // g) < k):
        g //= 2
    if g <= 1 or n < 2048 or g % _HALVES:
        return 0
    return g


def _in_kernel_topk(n: int, k: int) -> bool:
    g = group_count(n, k)
    if not g or n > _N_BLOCK_MAX:
        return False
    npg = n // g
    for fold in (256, 128):
        if npg % fold == 0 and npg // fold <= (1 << _SLICE_BITS):
            return k <= 2 * fold
    return False


def _top2_folded(n: int) -> bool:
    return n >= 512 and n % 512 == 0 and n // 256 <= 64


def two_stage(n: int, k: int) -> bool:
    """Whether the fast kNN of k among n 3-D sources is the two-stage
    route (its other routes select exactly)."""
    if k == 2 and _top2_folded(n):
        return False
    return not _in_kernel_topk(n, k) and group_count(n, k) > 0


def n_block(n: int) -> int:
    for blk in (_N_BLOCK_MAX, 8192, 4096, 2048):
        if n % blk == 0 and blk <= n:
            return blk
    return n


def knn_two_stage(q, s, smask, k):
    """The two-stage route's function: sources in block-local groups of
    g (group j of block bk holds columns bk*nb + a*nb/g + j % (nb/g),
    a < g); each group's minimum distance (its lowest slot on ties); the
    k groups of smallest minimum (the lower group on ties), each giving
    its minimum's source."""
    b, n_q = q.shape[:2]
    n = s.shape[1]
    g = group_count(n, k)
    nb = n_block(n)
    npg = nb // g
    out_d = torch.empty((b, n_q, k), dtype=q.dtype, device=q.device)
    out_i = torch.empty((b, n_q, k), dtype=torch.int64, device=q.device)
    step = _rows_step(b, n)
    for lo in range(0, n_q, step):
        d = pair_d2(q[:, lo:lo + step], s)
        d = torch.where(smask[:, None, :] & ~torch.isnan(d), d, math.inf)
        r = d.shape[1]
        d = d.view(b, r, n // nb, g, npg)
        gmin, slot = torch.min(d, dim=3)  # first slot of the minimum
        gmin = gmin.reshape(b, r, n // g)
        slot = slot.reshape(b, r, n // g)
        vals, gidx = torch.sort(gmin, dim=-1, stable=True)
        vals, gidx = vals[..., :k], gidx[..., :k]
        sl = torch.gather(slot, -1, gidx)
        out_d[:, lo:lo + step] = vals
        out_i[:, lo:lo + step] = (gidx // npg) * nb + sl * npg + gidx % npg
    out_i = torch.where(torch.isfinite(out_d), out_i, 0)
    return out_i, out_d


def knn(q, s, k, qmask, smask):
    """The configuration's 3-D search: (idx, d2, valid), invalid slots
    (+inf, 0)."""
    q, s = q.float(), s.float()
    if two_stage(s.shape[1], k):
        idx, d2 = knn_two_stage(q, s, smask, k)
    else:
        idx, d2 = knn_exact(q, s, smask, k)
    valid = torch.isfinite(d2) & qmask[..., None]
    return torch.where(valid, idx, 0), torch.where(valid, d2, math.inf), valid


# ------------------------------------------------------------ sampling


def gather_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr (B, N, C), idx (B, ...) -> (B, ..., C)."""
    b = arr.shape[0]
    flat = idx.reshape(b, -1)
    out = torch.gather(arr, 1, flat[..., None].expand(-1, -1, arr.shape[-1]))
    return out.reshape(idx.shape + (arr.shape[-1],))


def voxel_cell_ids(pos, size: float, mask):
    """Packed (z, y, x) cell id of each valid point on a grid from the
    sample's minimum valid corner; padding gets PAD_CELL."""
    origin = torch.where(mask[..., None], pos, math.inf).amin(1, keepdim=True)
    step = torch.tensor(size, dtype=F32, device=pos.device)
    cells = torch.floor((pos - origin) / step).to(torch.int64)
    cells = cells.clamp(0, _AXIS_SIZE - 1)
    ids = ((cells[..., 2] << (2 * _AXIS_BITS)) | (cells[..., 1] << _AXIS_BITS)
           | cells[..., 0])
    return torch.where(mask, ids, PAD_CELL)


def _mix_bits(x):
    """murmur3's 32-bit finaliser on int64 holding uint32 values."""
    x = x & _U32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _U32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _U32
    return x ^ (x >> 16)


def voxel_representatives(ids, capacity: int):
    """One representative per occupied cell: the point of lowest hash of
    its index; when cells outnumber ``capacity``, the cells whose
    representatives have the lowest hashes. Returns (idx, valid)."""
    b, n = ids.shape
    ar = torch.arange(n, device=ids.device, dtype=torch.int64).expand(b, n)
    prio = _mix_bits(ar)
    order = torch.sort((ids << 32) | prio, dim=1, stable=True).indices
    sids = torch.gather(ids, 1, order)
    sprio = torch.gather(prio, 1, order)
    first = torch.ones_like(sids, dtype=torch.bool)
    first[:, 1:] = sids[:, 1:] != sids[:, :-1]
    key = torch.where(first & (sids != PAD_CELL), sprio, _U32)
    perm = torch.sort(key, dim=1, stable=True).indices[:, :capacity]
    valid = torch.gather(key, 1, perm) != _U32
    idx = torch.gather(order, 1, perm)
    return torch.where(valid, idx, 0), valid


def random_sample(mask, capacity: int, generator, fraction: float = 0.5):
    """floor(n_valid * fraction) valid points of each row, uniformly
    without replacement from one uniform score a point drawn from
    ``generator``; ascending indices in ``capacity`` slots."""
    b, n = mask.shape
    n_take = torch.clamp((mask.sum(-1) * fraction).to(torch.int64),
                         max=capacity)
    score = torch.rand((b, n), generator=generator, device=mask.device)
    score = torch.where(mask, score, torch.inf)
    order = torch.argsort(score, dim=-1)
    chosen = torch.arange(n, device=mask.device) < n_take[:, None]
    select = torch.zeros_like(mask).scatter(1, order, chosen)
    ar = torch.arange(n, device=mask.device).expand(b, n)
    key = torch.sort(torch.where(select, ar, n), dim=-1).values[:, :capacity]
    valid = key < n
    return torch.where(valid, key, 0), valid


# ------------------------------------------------------------ the network


MAX_FREQ, NUM_BANDS = 10.0, 64


def band_frequencies() -> torch.Tensor:
    """linspace(1, MAX_FREQ, NUM_BANDS) as start*(1 - t) + stop*t in
    float32 (the JAX package's bands)."""
    f32 = np.float32
    step = np.arange(NUM_BANDS - 1, dtype=f32) / f32(NUM_BANDS - 1)
    out = f32(1.0) * (f32(1.0) - step) + f32(MAX_FREQ) * step
    return torch.from_numpy(np.concatenate([out, [f32(MAX_FREQ)]]).astype(f32))


class RefNet:
    """The network over a weight dict ``w`` (state_dict keys) and a
    configuration dict (``model`` of a config file).

    forward(pos3, refl, mask, sf, training, generator, batch_stats) ->
    (B, N) float32 logits. ``training`` samples centres at random from
    ``generator``, else voxel representatives; ``batch_stats`` normalises
    with the valid elements' batch statistics (recorded in
    ``self.stats`` as name -> (mean, biased var, count)), else with the
    running statistics."""

    def __init__(self, w: dict, model: dict, products: Products | None = None):
        self.w = w
        self.c = model["channels"]
        self.k = model["k"]
        self.res = tuple(model["sa_resolutions"])
        self.fractions = tuple(model["stage_fractions"])
        self.fp_k = model["fp_k"]
        self.attention_knn = model.get("attention_knn", False)
        self.p = products or Products()
        self.stats: dict = {}

    # -- blocks
    def lin(self, name, x, bias=True):
        return self.p.linear(x, self.w[name + ".weight"],
                             self.w[name + ".bias"] if bias else None)

    def bn(self, name, x, m):
        w, b = self.w[name + ".weight"], self.w[name + ".bias"]
        if not self.batch_stats:
            rm, rv = self.w[name + ".running_mean"], self.w[name + ".running_var"]
            return (x - rm) * torch.rsqrt(rv + BN_EPS) * w + b
        mm = m.reshape(m.shape + (1,) * (x.dim() - m.dim()))
        dims = tuple(range(x.dim() - 1))
        n = torch.clamp(mm.sum(dtype=F32), min=1.0)
        mean = torch.where(mm, x, 0.0).sum(dims) / n
        d = x - mean
        var = torch.where(mm, d * d, 0.0).sum(dims) / n
        self.stats[name] = (mean.detach(), var.detach(), n.detach())
        return d * torch.rsqrt(var + BN_EPS) * w + b

    def mlp(self, name, x, m, blocks):
        for i in range(blocks):
            x = torch.relu(self.lin(f"{name}.{i}.0", x))
            if i:
                x = self.bn(f"{name}.{i}.2", x, m)
        return x

    def separable(self, name, x, m):
        dw = self.w[f"{name}.depthwise_conv.weight"].reshape(-1)
        x = x * dw + self.w[f"{name}.depthwise_conv.bias"]
        x = torch.relu(self.bn(f"{name}.depthwise_bn", x, m))
        x = self.lin(f"{name}.pointwise_conv", x)
        return torch.relu(self.bn(f"{name}.pointwise_bn", x, m))

    def residual(self, name, x, m):
        h = torch.relu(self.bn(f"{name}.expand.1",
                               self.lin(f"{name}.expand.0", x), m))
        h = torch.relu(self.bn(f"{name}.conv.1",
                               self.separable(f"{name}.conv.0", h, m), m))
        h = self.bn(f"{name}.conv.4", self.separable(f"{name}.conv.3", h, m), m)
        h = self.bn(f"{name}.project.1", self.lin(f"{name}.project.0", h), m)
        return torch.relu(h + x)

    def point_conv(self, name, x, pos4, cidx, nidx, nvalid, cvalid, radius,
                   sf):
        pos_j = gather_rows(pos4, nidx)
        pos_i = gather_rows(pos4, cidx)
        rel = pos_j[..., :3] - pos_i[:, :, None, :3]
        dist = torch.sqrt((rel * rel).sum(-1) + 1e-24)
        if radius is not None:
            nvalid = nvalid & (dist <= radius)
        max_dist = torch.where(nvalid, dist, 0.0).amax(-1, keepdim=True)
        geo = rel / (max_dist[..., None] + 1e-8)
        refl_j = pos_j[..., 3:4]
        if x is None:  # SA1: the stem on the neighbours' unscaled positions
            stem = torch.relu(self.lin("stem_mlp.0.0",
                                       pos_j[..., :3] * sf[:, None, None, None]))
            parts = [stem, geo, refl_j]
        else:
            parts = [gather_rows(x, nidx), geo, refl_j]
        msg = self.mlp(name, torch.cat(parts, -1), nvalid, 2)
        out = torch.where(nvalid[..., None], msg, -math.inf).amax(-2)
        return torch.where((nvalid.any(-1) & cvalid)[..., None], out, 0.0)

    def embedding(self, name, x, pos3, mask):
        """ATSearchKNN's standardised embedding (attknnv3.py:52-83)."""
        a = self.w[f"{name}.blending.pos1.weight"].shape[1] - 3
        xf = pos3[..., None] * band_frequencies().to(pos3.device)
        enc = torch.stack([torch.sin(xf), torch.cos(xf)], -1)
        enc = enc.reshape(pos3.shape[:-1] + (-1,))[..., :a]
        feats = torch.cat([x, enc], -1)
        pos_enc = torch.cat([pos3, enc], -1)

        def two(pre, v):
            h = torch.relu(self.lin(f"{name}.blending.{pre}1", v))
            return self.lin(f"{name}.blending.{pre}2", h)

        soft = torch.softmax(torch.cat([two("feat", feats),
                                        two("pos", pos_enc)], -1), -1)
        comb = torch.cat([pos_enc * soft[..., 1:2], feats * soft[..., :1]], -1)
        m = mask[..., None].to(F32)
        cnt = torch.clamp(m.sum(1, keepdim=True), min=1.0)
        mean = (comb * m).sum(1, keepdim=True) / cnt
        var = ((comb - mean) ** 2 * m).sum(1, keepdim=True) / cnt
        return (comb - mean) / (torch.sqrt(var) + 1e-8)

    def capacities(self, n):
        caps, cap = [], n
        for f in self.fractions:
            cap = max(int(cap * f), 1)
            caps.append(cap)
        return caps

    def forward(self, pos3, refl, mask, sf, training=False, generator=None,
                batch_stats=None):
        self.batch_stats = training if batch_stats is None else batch_stats
        self.stats = {}
        pos3, refl, sf = pos3.float(), refl.float(), sf.float()
        caps = self.capacities(pos3.shape[1])
        x = torch.relu(self.lin("stem_mlp.0.0", pos3))
        xs, poss, masks = [x], [pos3], [mask]
        p, r, m = pos3, refl, mask
        for i in range(3):
            name = f"sa{i + 1}_module"
            if training:
                cidx, cval = random_sample(m, caps[i], generator)
            else:
                cidx, cval = voxel_representatives(
                    voxel_cell_ids(p, self.res[i], m), caps[i])
            pos4 = torch.cat([p / sf[:, None, None], r[..., None]], -1)
            centres = gather_rows(p, cidx)
            if self.attention_knn and i > 0:
                with torch.no_grad():
                    emb = self.embedding(f"{name}.atsearch", x.detach(), p, m)
                    idx, d2 = knn_exact(gather_rows(emb, cidx), emb, m,
                                        self.k, dist=d2_dim)
                    nvalid = torch.isfinite(d2) & cval[..., None]
                    nidx = torch.where(nvalid, idx, 0)
            else:
                nidx, _, nvalid = knn(centres, p, self.k, cval, m)
            radius = None
            if i == 0:
                radius = (torch.full_like(sf, self.res[0] * 2) / sf)[:, None, None]
            x = self.point_conv(f"{name}.conv.local_nn",
                                None if i == 0 else x, pos4, cidx, nidx,
                                nvalid, cval, radius, sf)
            x = self.residual(f"{name}.residual_block", x, cval)
            p, r, m = centres, torch.gather(r, 1, cidx), cval
            xs.append(x)
            poss.append(p)
            masks.append(m)

        g = self.mlp("sa4_module.NN", torch.cat([x, p], -1), m, 2)
        g = torch.where(m[..., None], g, -math.inf).amax(1)
        g = torch.where(m.any(1)[:, None], g, 0.0)
        y = g[:, None, :].expand(g.shape[0], caps[2], g.shape[-1])
        y = self.mlp("fp4_module.NN", torch.cat([y, xs[3]], -1), masks[3], 2)
        for lvl in (2, 1, 0):
            idx, d2, _ = knn(poss[lvl], poss[lvl + 1], self.fp_k, masks[lvl],
                             masks[lvl + 1])
            y = blend(y, idx, d2, masks[lvl])
            y = self.mlp(f"fp{lvl + 1}_module.NN",
                         torch.cat([y, xs[lvl]], -1), masks[lvl], 2)
        y = torch.relu(self.bn("norm", self.lin("conv1", y), mask))
        return self.lin("conv2", y)[..., 0]


def blend(x, idx, d2, tmask):
    """Inverse squared distance average of each target's neighbours."""
    w = torch.reciprocal(torch.clamp(d2, min=1e-16))
    f = gather_rows(x, idx)
    acc = torch.where(w[..., None] > 0, w[..., None] * f, 0.0).sum(-2)
    y = acc / torch.clamp(w.sum(-1), min=1e-16)[..., None]
    return torch.where(tmask[..., None], y, 0.0)
