"""What the readers of Point Transformer's spans share: the device
milliseconds a traced train step spends inside the program's spans of one
name (``model/point_transformer.py``: ``pt.fps``, ``pt.attention``)."""

from portbench.layers import _program


def ms_per_step(name: str):
    """Device ms between the marks of the spans ``name``, summed a traced
    train step (the spans' request: the step's number) and averaged over
    the traced steps; None where the program recorded no such span."""
    rec = _program.collected()
    if rec is None:
        return None
    steps = {s["request"] for s in rec["spans"] if s["name"] == "step"}
    spans = [s for s in rec["spans"] if s["name"] == name
             and s["request"] in steps and s["device_ms"] is not None]
    if not spans:
        return None
    return sum(s["device_ms"][1] - s["device_ms"][0] for s in spans) / len(
        steps)
