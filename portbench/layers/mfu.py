"""The network's FLOPs in the traced window (its architecture's
``forward_work``; for the ``Net`` ``roofline.net_flops``: valid points
only, the backward twice the forward) over the window's wall time, as a
share of the chip's dense bfloat16 peak."""

from portbench import roofline


def read(view):
    trace = view.get("trace")
    if not trace or not view.get("flops"):
        return None
    return 100.0 * view["flops"] / trace["window_s"] / roofline.PEAKS[
        "bf16_flops"]
