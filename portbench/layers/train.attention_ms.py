"""Device milliseconds a traced train step spends in the forward of
Point Transformer's vector-attention layers: between the device marks of
the program's ``pt.attention`` spans (18 a forward; in the replayed
training graph, its stamps of the device's clock), summed a step, mean
over the steps."""

from portbench.layers import _pt


def read(view):
    return _pt.ms_per_step("pt.attention")
