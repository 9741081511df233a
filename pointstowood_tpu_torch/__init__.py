"""pointstowood_tpu_torch — PyTorch/CUDA port of pointstowood_tpu.

The JAX package ``pointstowood_tpu`` stays the reference; this package
mirrors its module names (``ops/knn.py`` <-> ``ops/knn.py``, ...) so each
counterpart is easy to find. It imports ``torch``, numpy and scipy, and
never ``jax``, pandas or anything of ``pointstowood_tpu``.

The serving path is ``cli/predict.py``: a PLY/PCD/LAS cloud is read into a
column table (``io/``), tiled on the dual grid (``data/tiling.py``),
classified by the eval forward of ``model.Net`` over padded tile batches
(``predict.run_inference``), and fused onto every original point on the
device (``predict/device_fusion.py``) before the labelled PLY is
written. The Pallas kernels on that path are replaced by hand-written
CUDA kernels for Hopper (sm_90a) in ``csrc/``, built with nvcc on first
use (``ops/build.py``). Every kernel wrapper runs its plain PyTorch
version only for CPU tensors; for a CUDA tensor it launches the kernel
or raises.

The training path is ``cli/train.py``: labelled PLYs are tiled the same
way and ``train.trainer.semantic_training`` trains the Net (random 50%
centres, masked batch-statistic BatchNorm, Poly1 focal loss, AdamW behind
global-norm clipping) into a reference-layout ``.pth``, or the JAX
package's flax msgpack ``.ckpt`` (``utils/msgpack.py``, no flax needed),
that the predict CLI serves. Its one extra kernel is the backward of the interpolation
blend (``ops/interp_kernels.interp_blend_bwd``).

Data parallelism (``parallel/``, the JAX package's data mesh) runs
either CLI as one process per card under torchrun or the JAX package's
``PTW_*`` launch variables over ``torch.distributed``: a run split over
W processes computes what one process computes with the whole batch.

Entry points (``cli.predict.main``, ``cli.train.main``,
``predict.semantic_segmentation``, ``predict.build_net``,
``predict.run_inference``, ``fuse_on_device``,
``train.trainer.semantic_training``) run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
