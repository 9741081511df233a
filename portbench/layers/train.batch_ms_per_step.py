"""Host milliseconds a traced step spends batching, from the program's
own spans: ``batch.pad`` (``TileBatcher``) and ``batch.upload``
(``trainer._batch_arrays``), over the traced steps. The in-program twin
of ``train.host_ms_per_step``."""

from portbench.layers import _program


def read(view):
    rec = _program.collected()
    if rec is None:
        return None
    n = len(_program.steps(rec))
    if not n:
        return None
    return _program.seconds(rec, "batch.pad", "batch.upload") * 1e3 / n
