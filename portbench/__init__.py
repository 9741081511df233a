"""Benchmark of the PyTorch/CUDA port ``pointstowood_tpu_torch`` (see
run.py)."""
