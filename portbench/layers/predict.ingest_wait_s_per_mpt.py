"""Seconds a million points of the traced call wait for their ingest
(read and tiling in the CLI's worker thread): the program's
``ingest.wait`` spans, the main thread blocked on the next plot. The
part of ingest the call pays for; the rest overlaps the plot before."""

from portbench.layers import _program


def read(view):
    return _program.per_mpt(view, "ingest.wait")
