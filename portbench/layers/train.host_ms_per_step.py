"""Host milliseconds a step spends batching: the ``TileBatcher``'s
padded batch and its upload call (``trainer._batch_arrays``), outside
the step; mean over the window."""


def read(view):
    steps = view.get("steps", [])
    return sum(s["host_ms"] for s in steps) / len(steps) if steps else None
