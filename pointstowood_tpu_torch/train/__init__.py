"""Training engine of the port (counterpart of pointstowood_tpu/train)."""
