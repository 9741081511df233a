"""Device milliseconds from the end of a traced step's backward to the
end of its update: the program's marks after ``step.backward`` and after
``step.update``. Holds the guard's round trip to the host, the clip and
AdamW, idle included; mean over the steps."""

from portbench.layers import _program


def read(view):
    rec = _program.collected()
    if rec is None:
        return None
    ms = [st["step.update"]["device_ms"][1]
          - st["step.backward"]["device_ms"][1]
          for st in _program.steps(rec)
          if "step.update" in st and "step.backward" in st]
    return sum(ms) / len(ms) if ms else None
