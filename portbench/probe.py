"""The benchmark's hooks into the program: attribute patches that record
what the timed path produced and, in a traced window, the shapes of the
work it ran. Every patch is undone when its ``Patches`` closes.
"""

from __future__ import annotations

import contextlib
import functools

from portbench import arch, roofline


class Patches(contextlib.ExitStack):
    """Replace ``module.name`` by ``make(original)`` until closed."""

    def put(self, owner, name: str, make) -> None:
        original = getattr(owner, name)
        setattr(owner, name, make(original))
        self.callback(setattr, owner, name, original)


def spanned(tracer, label: str):
    """A wrapper factory: the call inside the tracer's span ``label``."""

    def make(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with tracer.span(label):
                return fn(*args, **kwargs)

        return wrapper

    return make


def operation(tracer, op: str):
    """A wrapper factory: the call's device work timed whole as the
    roofline's operation ``op`` (``Tracer.operation``)."""

    def make(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with tracer.operation(op):
                return fn(*args, **kwargs)

        return wrapper

    return make


def claim_operations(p: Patches, tracer) -> None:
    """The program's calls whose device work is one operation of the
    roofline, timed whole: the two-stage search (``group_min``, then a
    top-k over the group minima, a gather and the members' indices), a
    ``search``; its kernels are then left out of the name list."""
    from pointstowood_tpu_torch.ops import knn

    p.put(knn, "_two_stage_knn", operation(tracer, "search"))


class Work:
    """What the network's forwards in a traced window ran (one record a
    forward, by its architecture's hooks, ``arch/<name>.py``) and the
    fusion's selections; turned into operations and FLOPs after the
    window."""

    def __init__(self, tracer, model: dict):
        self.tracer = tracer
        self.model = model
        self.arch = arch.load(model)
        self.forwards = []  # (the architecture's counts, grad enabled)
        self.fusion = []  # pending (kind, tensors...)
        self._hooked = set()

    def hook(self, net) -> None:
        if id(net) in self._hooked:
            return
        self._hooked.add(id(net))
        self.arch.hook(self, net)

    def pair_select(self, fn):
        @functools.wraps(fn)
        def wrapper(queries, q_len, src_xyz, src_pay, regions, k):
            if self.tracer.active:
                self.fusion.append(("pair", q_len, regions, k))
            return fn(queries, q_len, src_xyz, src_pay, regions, k)

        return wrapper

    def tile_knn(self, fn):
        @functools.wraps(fn)
        def wrapper(q, s, k, query_mask=None, source_mask=None, **kw):
            if self.tracer.active:
                self.fusion.append(("tile_knn", query_mask.sum(1),
                                    source_mask.sum(1), k))
            return fn(q, s, k, query_mask=query_mask,
                      source_mask=source_mask, **kw)

        return wrapper

    def ops_and_flops(self) -> tuple[list, float]:
        ops, flops = [], 0.0
        for counts, grad in self.forwards:
            o, f = self.arch.forward_work(counts, self.model, grad)
            ops += o
            flops += f
        for kind, a, b, k in self.fusion:
            if kind == "pair":
                q = a.long().cpu()
                reg = b.long().cpu()
                union = reg[:, 1] + reg[:, 3]
                ops.append(roofline.pair_select(
                    float((q * union).sum()), float(q.sum()),
                    float(union.sum()), k))
            else:
                q, s = a.double().cpu(), b.double().cpu()
                ops.append(roofline.search(float((q * s).sum()),
                                           float(q.sum()), float(s.sum()), k))
        return ops, flops
