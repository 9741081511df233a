"""Plain PyTorch reference of Point Transformer for segmentation,
``pointtransformer_seg50`` (Zhao et al., arXiv:2012.09164;
POSTECH-CVLab/point-transformer model/pointtransformer/pointtransformer_seg.py
with lib/pointops/functions/pointops.py's furthestsampling, knnquery,
queryandgroup and interpolation).

Everything is plain tensor operations over a dict of weights keyed as the
published ``state_dict`` (``enc2.1.transformer2.linear_q.weight``,
``dec5.0.linear2.0.bias``, ``cls.3.weight``, ...), in float32 unless a
``Products`` precision says otherwise (TF32 is for the caller to switch
off, as the harness does). For a point i with neighbours j and
r = p_j - p_i, each PointTransformerLayer computes
q = W_q x_i, k_j = W_k x_j, v_j = W_v x_j,
delta = Lin(3->C)(ReLU(BN(Lin(3->3)(r)))),
w = Lin(C/8->C/8)(ReLU(BN(Lin(C->C/8)(ReLU(BN(k_j - q + delta)))))),
a = softmax over j of w, and y_c = sum_j a[j, c mod C/8] (v_j + delta)_c.

Farthest-point sampling is its own loop: a point's distance starts at
+inf (valid) or -1 (invalid), a pick is the arg-max (the lowest index on
ties, so the first pick is the row's first valid point), then each
distance takes the squared distance to the pick where that is smaller,
computed as ((dx*dx + dy*dy) + dz*dz). The searches are ``net.knn_exact``:
the exact k nearest by the same squared distance, sorted with ties to
the lower index, in blocks of queries. Interpolation weights are
1 / (d + 1e-8), d = sqrt(d2), normalised, as ``pointops.interpolation``.

Departures from the published code, all shared with the program:

* padded (B, N) batches with validity masks: each level has static
  slots, N / 4 of the level above's (at least 1), of which
  floor(n_valid / 4) hold centres; BatchNorm statistics are taken over
  the valid points or the valid (point, neighbour) pairs, and the
  softmax, the TransitionDown max and the head's mean leave the invalid
  ones out (the published kNN fills a short neighbourhood with repeats);
* C_in = 4, the input features (pos3 / sf, reflectance); S3DIS's are 6;
* num_classes 1 (one wood logit); S3DIS has 13;
* one kNN a level serves all of its layers (the published code searches
  again in every layer, on the same points, with the same result);
* the arg-max of the sampling takes the lowest index on ties (the
  published kernel's tie depends on its thread layout).
"""

from __future__ import annotations

import math

import torch

from portbench.reference.net import (
    BN_EPS,
    F32,
    Products,
    gather_rows,
    knn_exact,
)

INTERP_K = 3
INTERP_EPS = 1e-8


def knn(q, s, k, qmask, smask):
    """The exact k nearest valid sources: (idx, d2, valid), invalid slots
    (+inf, 0)."""
    idx, d2 = knn_exact(q, s, smask, k)
    valid = torch.isfinite(d2) & qmask[..., None]
    return torch.where(valid, idx, 0), torch.where(valid, d2, math.inf), valid


def fps(pos, mask, counts, m):
    """Farthest-point sampling: (idx (B, m) int64, valid (B, m)), the
    first counts[b] slots of row b its picks, 0 after them."""
    b = pos.shape[0]
    dist = torch.where(mask, math.inf, -1.0).to(F32)
    idx = torch.zeros((b, m), dtype=torch.int64, device=pos.device)
    rows = torch.arange(b, device=pos.device)
    for t in range(min(m, int(counts.max())) if b else 0):
        pick = torch.argmax(dist, dim=1)
        idx[:, t] = pick
        d = pos - pos[rows, pick][:, None, :]
        sq = d * d
        d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        dist = torch.where(d2 < dist, d2, dist)
    valid = torch.arange(m, device=pos.device) < counts[:, None]
    return torch.where(valid, idx, 0), valid


class RefPointTransformer:
    """``pointtransformer_seg50`` over a weights dict; the configuration
    gives ``channels`` (planes channels x (1, 2, 4, 8, 16)), ``blocks``,
    ``stride``, ``nsample`` and ``share_planes``.

    forward(pos3, refl, mask, sf, training, generator, batch_stats) ->
    (B, N) logits. ``batch_stats`` (default ``training``) normalises with
    the masked batch statistics and records them in ``self.stats`` (name
    -> (mean, biased var, count)), else with the running ones. The
    sampling is the same in both modes and ``generator`` is unused."""

    def __init__(self, w: dict, model: dict, products: Products | None = None):
        self.w = w
        self.planes = [model["channels"] * f for f in (1, 2, 4, 8, 16)]
        self.blocks = tuple(model["blocks"])
        self.stride = tuple(model["stride"])
        self.nsample = tuple(model["nsample"])
        self.share = model["share_planes"]
        self.p = products or Products()
        self.stats: dict = {}
        self.batch_stats = False

    def lin(self, name, x, bias=True):
        return self.p.linear(x, self.w[name + ".weight"],
                             self.w[name + ".bias"] if bias else None)

    def bn(self, name, x, m):
        w, b = self.w[name + ".weight"], self.w[name + ".bias"]
        if not self.batch_stats:
            rm = self.w[name + ".running_mean"]
            rv = self.w[name + ".running_var"]
            return (x - rm) * torch.rsqrt(rv + BN_EPS) * w + b
        mm = m.reshape(m.shape + (1,) * (x.dim() - m.dim()))
        dims = tuple(range(x.dim() - 1))
        n = torch.clamp(mm.sum(dtype=F32), min=1.0)
        mean = torch.where(mm, x, 0.0).sum(dims) / n
        d = x - mean
        var = torch.where(mm, d * d, 0.0).sum(dims) / n
        self.stats[name] = (mean.detach(), var.detach(), n.detach())
        return d * torch.rsqrt(var + BN_EPS) * w + b

    def neighbours(self, q, qm, s, sm, k):
        idx, _, valid = knn(q, s, k, qm, sm)
        return idx, valid, gather_rows(s, idx) - q[:, :, None]

    def layer(self, name, x, nb):
        idx, valid, rel = nb
        q = self.lin(f"{name}.linear_q", x)
        k = gather_rows(self.lin(f"{name}.linear_k", x), idx)
        v = gather_rows(self.lin(f"{name}.linear_v", x), idx)
        delta = torch.relu(self.bn(f"{name}.linear_p.1",
                                   self.lin(f"{name}.linear_p.0", rel), valid))
        delta = self.lin(f"{name}.linear_p.3", delta)
        w = torch.relu(self.bn(f"{name}.linear_w.0", k - q[:, :, None] + delta,
                               valid))
        w = torch.relu(self.bn(f"{name}.linear_w.3",
                               self.lin(f"{name}.linear_w.2", w), valid))
        w = self.lin(f"{name}.linear_w.5", w)
        vm = valid[..., None]
        a = torch.softmax(torch.where(vm, w, torch.finfo(F32).min), dim=2)
        a = torch.where(vm, a, 0.0)
        b, n, kk, c = v.shape
        y = (v + delta).view(b, n, kk, self.share, c // self.share)
        return (y * a[:, :, :, None, :]).sum(2).view(b, n, c)

    def block(self, name, x, m, nb):
        h = torch.relu(self.bn(f"{name}.bn1",
                               self.lin(f"{name}.linear1", x, False), m))
        h = torch.relu(self.bn(f"{name}.bn2",
                               self.layer(f"{name}.transformer2", h, nb), m))
        h = self.bn(f"{name}.bn3", self.lin(f"{name}.linear3", h, False), m)
        return torch.relu(h + x)

    def down(self, name, x, m, nb):
        if nb is None:
            return torch.relu(self.bn(f"{name}.bn",
                                      self.lin(f"{name}.linear", x, False), m))
        idx, valid, rel = nb
        h = torch.cat([rel, gather_rows(x, idx)], -1)
        h = torch.relu(self.bn(f"{name}.bn",
                               self.lin(f"{name}.linear", h, False), valid))
        h = torch.where(valid[..., None], h, -math.inf).amax(2)
        return torch.where(m[..., None], h, 0.0)

    def lbr(self, name, x, m):
        return torch.relu(self.bn(f"{name}.1", self.lin(f"{name}.0", x), m))

    def up(self, name, x, m, coarse):
        if coarse is None:
            n = torch.clamp(m.sum(1, keepdim=True).to(F32), min=1.0)
            mean = torch.where(m[..., None], x, 0.0).sum(1) / n
            g = torch.relu(self.lin(f"{name}.linear2.0", mean))
            return self.lbr(f"{name}.linear1",
                            torch.cat([x, g[:, None].expand_as(x)], -1), m)
        x2, m2, idx, d2 = coarse
        f = gather_rows(self.lbr(f"{name}.linear2", x2, m2), idx)
        recip = 1.0 / (torch.sqrt(d2) + INTERP_EPS)
        weight = recip / torch.clamp(recip.sum(-1, keepdim=True), min=1e-16)
        y = (f * weight[..., None]).sum(2)
        return self.lbr(f"{name}.linear1", x, m) + torch.where(
            m[..., None], y, 0.0)

    def forward(self, pos3, refl, mask, sf, training=False, generator=None,
                batch_stats=None):
        self.batch_stats = training if batch_stats is None else batch_stats
        self.stats = {}
        p = pos3.to(F32)
        x = torch.cat([p / sf.to(F32)[:, None, None],
                       refl.to(F32)[..., None]], -1)
        ps, ms, selfs, ups, xs = [p], [mask], [], [], []
        for i in range(5):
            centres = None
            if i:
                n = max(ps[-1].shape[1] // self.stride[i], 1)
                counts = ms[-1].sum(1) // self.stride[i]
                cidx, cm = fps(ps[-1], ms[-1], counts, n)
                pc = gather_rows(ps[-1], cidx)
                centres = self.neighbours(pc, cm, ps[-1], ms[-1],
                                          self.nsample[i])
                idx, d2, _ = knn(ps[-1], pc, INTERP_K, ms[-1], cm)
                ups.append((idx, d2))
                ps.append(pc)
                ms.append(cm)
            selfs.append(self.neighbours(ps[-1], ms[-1], ps[-1], ms[-1],
                                         self.nsample[i]))
            x = self.down(f"enc{i + 1}.0", x, ms[-1], centres)
            for j in range(1, self.blocks[i]):
                x = self.block(f"enc{i + 1}.{j}", x, ms[-1], selfs[-1])
            xs.append(x)
        for i in reversed(range(5)):
            coarse = None if i == 4 else (x, ms[i + 1], *ups[i])
            x = self.up(f"dec{i + 1}.0", xs[i], ms[i], coarse)
            x = self.block(f"dec{i + 1}.1", x, ms[i], selfs[i])
        y = torch.relu(self.bn("cls.1", self.lin("cls.0", x), mask))
        return self.lin("cls.3", y)[..., 0]
