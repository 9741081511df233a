"""Host milliseconds a traced step waits in its read of the finite flag
(the program's ``step.guard`` span), mean over the steps. Near 0, the
host, not the device, paces the forward and backward."""

from portbench.layers import _program


def read(view):
    rec = _program.collected()
    if rec is None:
        return None
    ms = [(st["step.guard"]["end_ns"] - st["step.guard"]["start_ns"]) * 1e-6
          for st in _program.steps(rec) if "step.guard" in st]
    return sum(ms) / len(ms) if ms else None
