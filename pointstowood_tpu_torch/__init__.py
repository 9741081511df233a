"""pointstowood_tpu_torch — PyTorch/CUDA port of pointstowood_tpu.

The JAX package ``pointstowood_tpu`` stays the reference; this package
mirrors its module names (``ops/knn.py`` <-> ``ops/knn.py``, ...) so each
counterpart is easy to find. It imports ``torch`` and never ``jax`` or
anything of ``pointstowood_tpu``.

The hot path is the batched eval forward of ``model.Net`` over padded tile
batches, driven by ``predict.run_inference``. The four Pallas kernels on
that path are replaced by hand-written CUDA kernels for Hopper (sm_90a)
in ``csrc/``, built with nvcc on first use (``ops/build.py``). Every
kernel wrapper runs its plain PyTorch version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises.

Entry points (``predict.build_net``, ``predict.run_inference``) run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
