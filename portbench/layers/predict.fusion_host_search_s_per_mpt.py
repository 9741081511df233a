"""Seconds of the fusion's host neighbour search (scipy ``cKDTree``) per
million points of the traced call: the program's ``fusion.host_search``
spans (the index path's uncovered rows, or the host path); 0 where the
call searched nothing on the host."""

from portbench.layers import _program


def read(view):
    return _program.per_mpt(view, "fusion.host_search")
