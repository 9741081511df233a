"""The flax Net's inference forward for tests, every array an argument of jit.

``jax.jit`` compiles an array that the traced function closes over into
the program as a constant. With the cloud fixed at compile time, XLA's CPU
compiler works through the data-dependent half of the Net (the kNN, the
voxel grouping, the sampling) while it compiles: at C=32, N=1024, on an
8-core CPU host, the closure form's compile took about 1100 s, against
about 14 s for the same forward with the cloud passed as arguments.
tests/test_flax_forward.py guards this helper against the closure form.
"""

import functools

import jax


@functools.partial(jax.jit, static_argnums=0)
def flax_probs(net, variables, pos, refl, mask, sf):
    """Per-point probabilities of ``net`` in inference mode, (B, N)."""
    return jax.nn.sigmoid(net.apply(variables, pos, refl, mask, sf,
                                    training=False))
