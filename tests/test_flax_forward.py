"""Guard for tests/flax_forward.py: the shared flax forward hands the cloud
to jit as arguments.

Closed over, the cloud is compiled into the program as constants, and a
full-Net parity compile on the CPU takes minutes instead of seconds. The
program is lowered only, not compiled, at the small parity configuration
(C=8, N=512, as tests/test_full_net_parity.py builds it).
"""

import functools
import re

import numpy as np

import jax
import jax.numpy as jnp

from flax_forward import flax_probs
from pointstowood_tpu.model import Net

C = 8
N = 512
K = 32


def test_forward_takes_the_cloud_as_arguments():
    rng = np.random.default_rng(3)
    xyz = rng.uniform(0, 0.6, size=(N, 3)).astype(np.float32)
    xyz -= xyz.mean(axis=0)
    refl = rng.normal(size=N).astype(np.float32)
    sf = float(np.linalg.norm(xyz, axis=1).max())
    inputs = (jnp.asarray(xyz[None]), jnp.asarray(refl[None]),
              jnp.ones((1, N), bool), jnp.asarray([sf], dtype=jnp.float32))
    net = Net(
        channels=C, k=K, knn_method="exact", voxel_priority="last",
        stage_fractions=(1.0, 1.0, 1.0), dtype=jnp.float32,
    )
    variables = jax.eval_shape(
        functools.partial(net.init, training=False),
        {"params": jax.random.key(0)}, *inputs,
    )
    text = flax_probs.lower(net, variables, *inputs).as_text()

    # A splat (`dense<0.0>`) is one value whatever its shape; a constant
    # that spells out its elements and has as many as the cloud is data.
    big = []
    for value, shape in re.findall(r"dense<([^>]*)> : tensor<([^>]*)>", text):
        size = np.prod([int(d) for d in shape.split("x")[:-1]], dtype=int)
        if value[:1] in ('"', "[") and size >= N:
            big.append(f"tensor<{shape}>")
    assert not big, f"cloud-sized constants in the program: {big}"
    main = next(line for line in text.splitlines() if "@main(" in line)
    for shape in (f"1x{N}x3xf32", f"1x{N}xf32", f"1x{N}xi1"):
        assert f"tensor<{shape}>" in main, f"no {shape} parameter"
