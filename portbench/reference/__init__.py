"""Plain float32 reference of what the benchmark judges: the tiling, the
network, the fusion and the train step, in numpy and plain PyTorch. It
imports nothing of the program under test."""
