"""Device milliseconds of a traced step's forward: between the CUDA
events of the program's ``step.forward`` span, mean over the steps."""

from portbench.layers import _program


def read(view):
    return _program.device_ms(view, "step.forward")
