"""Share of the batch-statistic BatchNorm's elements in the traced train
steps that ran the fused CUDA passes: 100 x ``bn.fused_elems`` /
(``bn.fused_elems`` + ``bn.plain_elems``), the program's counters in
``model/layers.py`` ``MaskedBatchNorm`` (x's elements, by path; in a
replayed training graph, the capture's counts each replay). None where
the program counts neither."""

from portbench.layers import _program


def read(view):
    rec = _program.collected()
    if rec is None:
        return None
    fused = rec["counters"].get("bn.fused_elems", 0)
    plain = rec["counters"].get("bn.plain_elems", 0)
    if not fused + plain:
        return None
    return 100.0 * fused / (fused + plain)
