"""Host seconds a million points of the traced call spend around the
model's batches: the program's ``model.batch`` (padding), ``model.upload``
and ``model.drain`` (readback) spans of ``run_inference``."""

from portbench.layers import _program


def read(view):
    return _program.per_mpt(view, "model.batch", "model.upload",
                            "model.drain")
