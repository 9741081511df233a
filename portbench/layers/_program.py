"""What the per-layer readers of the program's own spans and counters
share: ``pointstowood_tpu_torch.utils.trace.collected()`` after a traced
window (None where the program has no tracer, or it recorded nothing),
and the traced predict call's points."""


def collected():
    try:
        from pointstowood_tpu_torch.utils import trace
    except ImportError:
        return None
    rec = trace.collected()
    return rec if rec["spans"] else None


def traced_mpt(view) -> float:
    """Millions of points of the traced call's records (the last call's
    where none is marked: a window of one call traces one more of the
    same folder)."""
    calls = view.get("calls") or []
    traced = [c for c in calls if c.get("traced")] or calls[-1:]
    return sum(r["points"] for c in traced for r in c["records"]) / 1e6


def seconds(rec, *names) -> float:
    """Summed host seconds of the spans of these names."""
    return sum(s["end_ns"] - s["start_ns"] for s in rec["spans"]
               if s["name"] in names) * 1e-9


def per_mpt(view, *names):
    """Seconds of these spans per million points of the traced call."""
    rec, mpt = collected(), traced_mpt(view)
    if rec is None or not mpt:
        return None
    return seconds(rec, *names) / mpt


def steps(rec) -> list:
    """The traced train steps' spans, by step: {name: span}."""
    by_id = {s["id"]: {} for s in rec["spans"] if s["name"] == "step"}
    for s in rec["spans"]:
        if s["parent"] in by_id:
            by_id[s["parent"]][s["name"]] = s
    return list(by_id.values())


def device_ms(view, name):
    """Mean device milliseconds between the marks of the step's span
    ``name``."""
    rec = collected()
    if rec is None:
        return None
    ms = [st[name]["device_ms"][1] - st[name]["device_ms"][0]
          for st in steps(rec) if name in st]
    return sum(ms) / len(ms) if ms else None
