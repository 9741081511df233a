"""Point Transformer for semantic segmentation (Zhao, Jiang, Jia, Torr,
Koltun, arXiv:2012.09164), ``pointtransformer_seg50``, over the port's
padded (B, N) tile batches.

The published model (POSTECH-CVLab/point-transformer
model/pointtransformer/pointtransformer_seg.py) is a five-level U-Net of
vector-attention blocks: planes C x (1, 2, 4, 8, 16), blocks (2, 3, 4, 6,
3), strides (1, 4, 4, 4, 4), neighbourhoods of (8, 16, 16, 16, 16) points
and weight groups of ``share_planes`` = 8 channels. For a point i with
neighbours j in kNN(i) (itself included) and r = p_j - p_i, a
PointTransformerLayer computes

    q = W_q x_i, k_j = W_k x_j, v_j = W_v x_j
    delta = Lin(3->C)(ReLU(BN(Lin(3->3)(r))))
    w = Lin(C/8->C/8)(ReLU(BN(Lin(C->C/8)(ReLU(BN(k_j - q + delta))))))
    a = softmax over j of w
    y_c = sum_j a[j, c mod C/8] * (v_j + delta)_c

inside a bottleneck (Lin, BN, ReLU, the layer, BN, ReLU, Lin, BN, + x,
ReLU). A stride-4 TransitionDown samples floor(n / 4) centres by
farthest-point sampling (``ops/fps_kernels.fps``), groups the 16
nearest points of the stage to each as [r, x_j] and takes
Lin-BN-ReLU and a max over them; a TransitionUp adds Lin-BN-ReLU of the
skip to the 3-nearest inverse-distance interpolation (weights
1 / (d + 1e-8), d the Euclidean distance; ``interp_blend``) of
Lin-BN-ReLU of the coarser level; the head's ``dec5.0`` concatenates
Lin-ReLU of the tile's mean instead. Module and parameter names are the
published ones (``enc2.1.transformer2.linear_q``, ``dec1.0.linear1.0``,
``cls.3``), so a published ``state_dict`` of the same widths loads by
key.

In the port:

* the input features are (pos3 / sf, reflectance): C_in = 4 (the
  published S3DIS input is xyz + rgb, 6);
* each level has static slots, N / 4 of the level above's (at least 1),
  with a validity mask; a level holds floor(n_valid / 4) valid centres;
* every BatchNorm is ``MaskedBatchNorm``: over the valid points, or over
  the valid (point, neighbour) pairs; the softmax and the max leave out
  the invalid neighbour slots (a level with fewer points than K gives
  fewer valid slots), the head's mean is over the valid points;
* one kNN a level serves all of that level's layers (the published code
  searches again in every layer, on the same points, with the same
  result); the searches are ``knn_masked``'s exact selection
  (``method="topk"``: ``knn_topk`` at every shape) under
  ``knn_method="fast"``, its plain expansion-form path under "exact";
* products run in the compute dtype (``dense``), the softmax and the
  BatchNorm statistics in float32; positions stay float32.

``forward(pos3, refl, mask, sf, training=False, use_running_average=None,
generator=None)`` takes the ``Net``'s arguments (``generator`` is unused:
the sampling is deterministic), so ``make_train_step`` and
``run_inference`` drive it unchanged.

Traced (``utils/trace.py``): ``pt.fps`` around each farthest-point
sampling, ``pt.knn`` around each level's searches, ``pt.attention``
around each PointTransformerLayer's forward, all with device marks, and
the counter ``pt.pairs``: the valid (point, neighbour) pairs the layers
attend, counted without a synchronisation. A replayed training forward
records them through the stamps of graphs captured after
``trace_graphs()``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from pointstowood_tpu_torch.model.layers import MaskedBatchNorm, dense
from pointstowood_tpu_torch.model.pointconv import gather_rows
from pointstowood_tpu_torch.ops.fps_kernels import fps
from pointstowood_tpu_torch.ops.interp_kernels import interp_blend
from pointstowood_tpu_torch.ops.knn import knn_masked
from pointstowood_tpu_torch.utils import trace

INTERP_K = 3
INTERP_EPS = 1e-8


@dataclasses.dataclass
class Neighbours:
    """One search's neighbour slots: idx (B, Q, K) int64 (0 where
    invalid), valid (B, Q, K) bool and rel (B, Q, K, 3) f32, each
    neighbour's position less its query's."""

    idx: torch.Tensor
    valid: torch.Tensor
    rel: torch.Tensor


def _masked_softmax(w: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softmax over the neighbour axis (2) of float32 w (B, N, K, G),
    invalid slots 0. They enter as float32's lowest number, not -inf, so
    a row with no valid slot stays finite (and then gets 0), forward and
    backward."""
    v = valid[..., None]
    low = torch.finfo(torch.float32).min
    a = torch.softmax(torch.where(v, w, low), dim=2)
    return torch.where(v, a, 0.0)


class PointTransformerLayer(nn.Module):
    def __init__(self, planes: int, share_planes: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.share_planes = share_planes
        self.dtype = dtype
        g = planes // share_planes
        self.linear_q = nn.Linear(planes, planes)
        self.linear_k = nn.Linear(planes, planes)
        self.linear_v = nn.Linear(planes, planes)
        self.linear_p = nn.Sequential(nn.Linear(3, 3), MaskedBatchNorm(3),
                                      nn.ReLU(), nn.Linear(3, planes))
        self.linear_w = nn.Sequential(MaskedBatchNorm(planes), nn.ReLU(),
                                      nn.Linear(planes, g),
                                      MaskedBatchNorm(g), nn.ReLU(),
                                      nn.Linear(g, g))

    def forward(self, x, nbrs: Neighbours, ura: bool):
        dt, valid = self.dtype, nbrs.valid
        if trace.active():
            trace.count("pt.pairs", valid.sum())
        q = dense(x, self.linear_q.weight, self.linear_q.bias, dt)
        k = dense(x, self.linear_k.weight, self.linear_k.bias, dt)
        v = dense(x, self.linear_v.weight, self.linear_v.bias, dt)
        lp, lw = self.linear_p, self.linear_w
        delta = dense(nbrs.rel, lp[0].weight, lp[0].bias, dt)
        delta = torch.relu(lp[1](delta, valid, ura))
        delta = dense(delta, lp[3].weight, lp[3].bias, dt)
        w = gather_rows(k, nbrs.idx) - q[:, :, None] + delta
        w = torch.relu(lw[0](w, valid, ura))
        w = dense(w, lw[2].weight, lw[2].bias, dt)
        w = torch.relu(lw[3](w, valid, ura))
        w = dense(w, lw[5].weight, lw[5].bias, dt)
        a = _masked_softmax(w.float(), valid)
        vd = gather_rows(v, nbrs.idx) + delta
        b, n, kk, c = vd.shape
        s = self.share_planes
        y = (vd.float().view(b, n, kk, s, c // s) * a[:, :, :, None, :])
        return y.sum(2).view(b, n, c).to(dt)


class PointTransformerBlock(nn.Module):
    """The bottleneck around a PointTransformerLayer."""

    def __init__(self, planes: int, share_planes: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear1 = nn.Linear(planes, planes, bias=False)
        self.bn1 = MaskedBatchNorm(planes)
        self.transformer2 = PointTransformerLayer(planes, share_planes, dtype)
        self.bn2 = MaskedBatchNorm(planes)
        self.linear3 = nn.Linear(planes, planes, bias=False)
        self.bn3 = MaskedBatchNorm(planes)

    def forward(self, x, mask, nbrs: Neighbours, ura: bool):
        dt = self.dtype
        h = torch.relu(self.bn1(dense(x, self.linear1.weight, None, dt),
                                mask, ura))
        with trace.span("pt.attention", marks=x.device):
            h = self.transformer2(h, nbrs, ura)
        h = torch.relu(self.bn2(h, mask, ura))
        h = self.bn3(dense(h, self.linear3.weight, None, dt), mask, ura)
        return torch.relu(h + x)


class TransitionDown(nn.Module):
    """Stride 1: Lin-BN-ReLU of each point. Stride > 1: over each centre's
    neighbours (``forward``'s ``nbrs``), Lin([r, x_j])-BN-ReLU, then the
    max over the valid ones."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        width = in_planes + 3 if stride != 1 else in_planes
        self.linear = nn.Linear(width, out_planes, bias=False)
        self.bn = MaskedBatchNorm(out_planes)

    def forward(self, x, mask, ura: bool, nbrs: Neighbours | None = None):
        dt = self.dtype
        if self.stride == 1:
            return torch.relu(self.bn(dense(x, self.linear.weight, None, dt),
                                      mask, ura))
        h = torch.cat([nbrs.rel.to(dt), gather_rows(x, nbrs.idx)], dim=-1)
        h = torch.relu(self.bn(dense(h, self.linear.weight, None, dt),
                               nbrs.valid, ura))
        low = torch.finfo(h.dtype).min
        h = torch.where(nbrs.valid[..., None], h, low).amax(2)
        return torch.where(mask[..., None], h, 0.0)


class TransitionUp(nn.Module):
    """``out_planes`` None: the head (``dec5.0``), Lin-BN-ReLU of [x, Lin-
    ReLU of the tile's mean of x]; else Lin-BN-ReLU of the skip x plus the
    interpolation onto it of Lin-BN-ReLU of the coarser level's x2."""

    def __init__(self, in_planes: int, out_planes: int | None = None,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        if out_planes is None:
            self.linear1 = nn.Sequential(
                nn.Linear(2 * in_planes, in_planes), MaskedBatchNorm(in_planes),
                nn.ReLU())
            self.linear2 = nn.Sequential(nn.Linear(in_planes, in_planes),
                                         nn.ReLU())
        else:
            self.linear1 = nn.Sequential(
                nn.Linear(out_planes, out_planes), MaskedBatchNorm(out_planes),
                nn.ReLU())
            self.linear2 = nn.Sequential(
                nn.Linear(in_planes, out_planes), MaskedBatchNorm(out_planes),
                nn.ReLU())

    def _lbr(self, seq, x, mask, ura):
        return torch.relu(seq[1](dense(x, seq[0].weight, seq[0].bias,
                                       self.dtype), mask, ura))

    def forward(self, x, mask, ura: bool, coarse=None):
        """``coarse``: None for the head, else (x2, mask2, idx, dist):
        the coarser level's features and mask, and each point's
        ``INTERP_K`` nearest coarser points with their distance + 1e-8
        (+inf where invalid)."""
        dt = self.dtype
        if coarse is None:
            n = mask.sum(1, keepdim=True).clamp(min=1).float()
            mean = torch.where(mask[..., None], x.float(), 0.0).sum(1) / n
            l2 = self.linear2[0]
            g = torch.relu(dense(mean.to(dt), l2.weight, l2.bias, dt))
            h = torch.cat([x, g[:, None, :].expand_as(x)], dim=-1)
            return self._lbr(self.linear1, h, mask, ura)
        x2, mask2, idx, dist = coarse
        up = interp_blend(self._lbr(self.linear2, x2, mask2, ura), idx, dist,
                          mask)
        return self._lbr(self.linear1, x, mask, ura) + up


class _TrainForward(nn.Module):
    """The network's forward with batch statistics, as a module of four
    tensors (``torch.cuda.make_graphed_callables`` takes no flags); with
    ``marks``, each pass records its spans and counter into them."""

    def __init__(self, net, marks: trace.GraphMarks | None):
        super().__init__()
        self.net = net
        self.marks = marks

    def forward(self, pos3, refl, mask, sf):
        if self.marks is None:
            return self.net.layers(pos3, refl, mask, sf, False)
        with self.marks.recording():
            return self.net.layers(pos3, refl, mask, sf, False)


class PointTransformerSeg(nn.Module):
    """``pointtransformer_seg50`` at width ``channels`` (planes channels x
    (1, 2, 4, 8, 16)) over padded batches; see the module docstring.

    A training forward on a CUDA device (batch statistics, gradients on)
    replays CUDA graphs of the forward and of its backward, captured on
    the first call of each input shape
    (``torch.cuda.make_graphed_callables``; the BatchNorm running
    statistics its warm-up passes move are put back). A forward and its
    backward launch some 14000 kernels, most of them small (the
    BatchNorms over (point, neighbour) pairs), more than the host can
    enqueue in the device's time; the replay runs the same kernels on the
    same buffers. Eval, no-grad forwards and the CPU run eagerly. After
    ``trace_graphs()`` the graphs are captured with device stamps at
    the ends of the spans, so a traced replay records them
    (``trace.GraphMarks``)."""

    def __init__(self, num_classes: int = 1, channels: int = 32,
                 blocks: Sequence[int] = (2, 3, 4, 6, 3),
                 stride: Sequence[int] = (1, 4, 4, 4, 4),
                 nsample: Sequence[int] = (8, 16, 16, 16, 16),
                 share_planes: int = 8, in_channels: int = 4,
                 knn_method: str = "fast", dtype=torch.float32):
        super().__init__()
        # input shapes -> (graphed training forward, its GraphMarks)
        self._graphs: dict = {}
        self._marked = False
        if stride[0] != 1:
            raise ValueError("PointTransformerSeg: the first level has "
                             "stride 1")
        self.num_classes = num_classes
        self.channels = channels
        self.planes = [channels * f for f in (1, 2, 4, 8, 16)]
        self.blocks = tuple(blocks)
        self.stride = tuple(stride)
        self.nsample = tuple(nsample)
        self.knn_method = knn_method
        self.dtype = dtype
        cin = in_channels
        for i, planes in enumerate(self.planes):
            setattr(self, f"enc{i + 1}", nn.Sequential(
                TransitionDown(cin, planes, stride[i], dtype),
                *[PointTransformerBlock(planes, share_planes, dtype)
                  for _ in range(blocks[i] - 1)]))
            cin = planes
        for i in reversed(range(5)):
            setattr(self, f"dec{i + 1}", nn.Sequential(
                TransitionUp(cin, None if i == 4 else self.planes[i], dtype),
                PointTransformerBlock(self.planes[i], share_planes, dtype)))
            cin = self.planes[i]
        c = self.planes[0]
        self.cls = nn.Sequential(nn.Linear(c, c), MaskedBatchNorm(c),
                                 nn.ReLU(), nn.Linear(c, num_classes))

    def slots(self, n: int) -> list[int]:
        """Static slots of each level for n input slots."""
        out = [n]
        for s in self.stride[1:]:
            out.append(max(out[-1] // s, 1))
        return out

    def _knn(self, q, qm, s, sm, k):
        return knn_masked(q, s, k, query_mask=qm, source_mask=sm,
                          method="topk" if self.knn_method == "fast"
                          else self.knn_method)

    def _search(self, q, qm, s, sm, k) -> Neighbours:
        idx, _, valid = self._knn(q, qm, s, sm, k)
        return Neighbours(idx, valid, gather_rows(s, idx) - q[:, :, None])

    def forward(self, pos3, refl, mask, sf, training: bool = False,
                use_running_average: bool | None = None,
                generator: torch.Generator | None = None):
        ura = (not training) if use_running_average is None \
            else use_running_average
        if pos3.is_cuda and not ura and torch.is_grad_enabled():
            return self._graphed(pos3, refl, mask, sf)
        return self.layers(pos3, refl, mask, sf, ura)

    def trace_graphs(self) -> None:
        """Capture the training graphs with device stamps from the next
        call on (graphs captured without them are dropped), so that a
        replay while tracing is on records the ``pt.*`` spans and the
        ``pt.pairs`` counter; a replay with tracing off records nothing."""
        if not self._marked:
            self._marked = True
            self._graphs.clear()

    def _graphed(self, *args):
        key = tuple((tuple(t.shape), t.dtype) for t in args) + (
            args[0].device,)
        entry = self._graphs.get(key)
        if entry is None:
            marks = (trace.GraphMarks(args[0].device) if self._marked
                     else None)
            saved = [b.detach().clone() for b in self.buffers()]
            sample = tuple(t.detach().clone() for t in args)
            fn = torch.cuda.make_graphed_callables(
                _TrainForward(self, marks), sample, allow_unused_input=True)
            with torch.no_grad():
                for b, s in zip(self.buffers(), saved):
                    b.copy_(s)
            entry = self._graphs[key] = (fn, marks)
        fn, marks = entry
        # the graph's backward hands back its own buffers: a parameter
        # without a gradient would take one as its .grad, which the next
        # replay overwrites
        for p in self.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if marks is None:
            return fn(*args)
        before = marks.before()
        out = fn(*args)
        marks.replayed(before)
        return out

    def layers(self, pos3, refl, mask, sf, ura: bool):
        """The forward, launched kernel by kernel."""
        dev = pos3.device
        p = pos3.float()
        x = torch.cat([p / sf.float()[:, None, None],
                       refl.float()[..., None]], dim=-1).to(self.dtype)
        slots = self.slots(p.shape[1])
        ps, ms, selfs, ups, xs = [p], [mask], [], [], []
        for i in range(5):
            enc = getattr(self, f"enc{i + 1}")
            centres = None
            if i:
                with trace.span("pt.fps", marks=dev):
                    counts = ms[-1].sum(1) // self.stride[i]
                    cidx, cmask = fps(ps[-1], ms[-1], counts, slots[i])
                pc = gather_rows(ps[-1], cidx)
            with trace.span("pt.knn", marks=dev):
                if i:
                    centres = self._search(pc, cmask, ps[-1], ms[-1],
                                           self.nsample[i])
                    # the level above's INTERP_K nearest of these centres
                    idx, d2, _ = self._knn(ps[-1], ms[-1], pc, cmask,
                                           INTERP_K)
                    ups.append((idx, torch.sqrt(d2) + INTERP_EPS))
                    ps.append(pc)
                    ms.append(cmask)
                selfs.append(self._search(ps[-1], ms[-1], ps[-1], ms[-1],
                                          self.nsample[i]))
            x = enc[0](x, ms[-1], ura, centres)
            for blk in enc[1:]:
                x = blk(x, ms[-1], selfs[-1], ura)
            xs.append(x)
        for i in reversed(range(5)):
            dec = getattr(self, f"dec{i + 1}")
            coarse = None if i == 4 else (x, ms[i + 1], *ups[i])
            x = dec[0](xs[i], ms[i], ura, coarse)
            x = dec[1](x, ms[i], selfs[i], ura)
        cls = self.cls
        y = torch.relu(cls[1](dense(x, cls[0].weight, cls[0].bias,
                                    self.dtype), mask, ura))
        y = dense(y, cls[3].weight, cls[3].bias, self.dtype).float()
        return y[..., 0] if self.num_classes == 1 else y
