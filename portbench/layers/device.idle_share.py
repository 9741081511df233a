"""Share of the traced window in which no kernel, copy or set ran on
the device."""


def read(view):
    trace = view.get("trace")
    if not trace or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
