"""Share of their rooflines that the operations served by the port's
hand-written kernels reach in the traced window: the sum of the
operations' least times (``roofline``) over the device time spent on
them: the two-stage search timed whole by the benchmark's operation span
(``group_min``, the top-k over its minima, the gather and the members'
indices), every other operation by the kernels of
``roofline/kernels.json``, found by name."""

from portbench import roofline


def read(view):
    trace = view.get("trace")
    if not trace:
        return None
    return roofline.roofline_share(view["ops"], trace["kernel_s"],
                                   trace["op_s"])
