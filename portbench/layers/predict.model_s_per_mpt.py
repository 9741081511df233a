"""Seconds of the CLI's ``model`` phase (``run_inference`` over every
tile, ending in a device synchronisation) per million points."""


def read(view):
    recs = [r for c in view.get("calls", []) for r in c["records"]]
    pts = sum(r["points"] for r in recs)
    if not pts:
        return None
    return sum(r["seconds"]["model"] for r in recs) / pts * 1e6
