"""Device milliseconds a traced train step spends in farthest-point
sampling: between the device marks of the program's ``pt.fps`` spans
(four a forward of Point Transformer; in the replayed training graph,
its stamps of the device's clock), summed a step, mean over the steps."""

from portbench.layers import _pt


def read(view):
    return _pt.ms_per_step("pt.fps")
