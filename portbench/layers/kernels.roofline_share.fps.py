"""Share of its roofline that farthest-point sampling reaches in the
traced window: the ``fps`` operations' least time (``arch/ptv1.py``: 10
FMA-free operations a (pick, valid point) pair at the published rate,
or the points in and picks out at the memory bandwidth) over the device
time of the kernels named for it (``fps_kernel``)."""

from portbench import roofline


def read(view):
    trace = view.get("trace")
    if not trace:
        return None
    ops = [o for o in view["ops"] if o["op"] == "fps"]
    return roofline.roofline_share(ops, trace["kernel_s"], trace["op_s"])
