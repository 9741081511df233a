"""Host seconds of reading and tiling a million points: the CLI's
``read`` + ``preprocess`` phases (busy time of its ingest thread, which
overlaps the device work of the plot before)."""


def read(view):
    recs = [r for c in view.get("calls", []) for r in c["records"]]
    pts = sum(r["points"] for r in recs)
    if not pts:
        return None
    return sum(r["seconds"]["read"] + r["seconds"]["preprocess"]
               for r in recs) / pts * 1e6
