"""Rows the fusion searched on the host per million points of the traced
call: the program's ``fusion.host_rows`` counter."""

from portbench.layers import _program


def read(view):
    rec, mpt = _program.collected(), _program.traced_mpt(view)
    if rec is None or not mpt:
        return None
    return rec["counters"].get("fusion.host_rows", 0) / mpt
