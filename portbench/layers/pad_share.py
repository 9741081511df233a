"""Share of the traced window's batch slots (rows x capacity, empty rows
included) that hold no point: 100 x (1 - ``batch.points`` /
``batch.slots``), the program's counters in ``TileBatcher``. Serves
``pad_share.predict`` and ``pad_share.train``."""

from portbench.layers import _program


def read(view):
    rec = _program.collected()
    if rec is None or not rec["counters"].get("batch.slots"):
        return None
    c = rec["counters"]
    return 100.0 * (1.0 - c.get("batch.points", 0) / c["batch.slots"])
