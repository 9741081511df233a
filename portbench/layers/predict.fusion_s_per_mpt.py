"""Seconds of fusion after the model per million points: the CLI's
``fusion_wait`` (the exposed part of the fusion plan) and ``fusion``
(the device pair path, or the index path with its host search)."""


def read(view):
    recs = [r for c in view.get("calls", []) for r in c["records"]]
    pts = sum(r["points"] for r in recs)
    if not pts:
        return None
    return sum(r["seconds"].get("fusion_wait", 0.0) + r["seconds"]["fusion"]
               for r in recs) / pts * 1e6
