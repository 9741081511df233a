"""Architectures: one file a network, ``arch/<name>.py``, named by a
configuration's ``model["arch"]`` (``ptw`` where it names none), found
by name as ``manifest.reader`` finds ``layers/<metric>.py``.

A module holds what the harness knows of its network:

* ``build(model)``: the program's network (an ``nn.Module``), built
  from the configuration, the port imported inside the function;
* ``cli_args(model)``: the predict CLI's flags that select and size it;
* ``param_shapes(model)``: name -> shape of every tensor of its
  ``state_dict``, in the order ``weights.make_weights`` draws them;
* ``Reference``: its plain float32 network, ``Reference(weights, model,
  products)``, whose ``forward(pos, refl, mask, sf, training=False,
  generator=None, batch_stats=False)`` gives the logits and leaves each
  BatchNorm's batch statistics in ``stats`` (name -> mean, variance,
  count);
* ``HEAD``: the last layer, which ``weights.calibrate`` centres and
  scales;
* ``hook(work, net)``: forward hooks that append, while the tracer is
  active, one record a forward to ``work.forwards``;
  ``forward_work(counts, model, grad)``: that record's roofline
  operations and product FLOPs;
* ``KERNELS``: operation -> kernel names of its own, merged into
  ``roofline.KERNELS`` when it is loaded.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

from portbench import roofline

HERE = Path(__file__).resolve().parent
DEFAULT = "ptw"


def load(model: dict):
    """The module ``arch/<model["arch"]>.py``; ``KeyError`` naming the
    file looked for and those there are where it does not exist."""
    name = model.get("arch", DEFAULT)
    path = HERE / f"{name}.py"
    if not path.is_file():
        have = sorted(p.name for p in HERE.glob("*.py")
                      if not p.name.startswith("_"))
        raise KeyError(f"no architecture {name!r}: {path} does not exist; "
                       f"{HERE} holds {have}")
    return _load(path)


@functools.cache
def _load(path: Path):
    """Executes an architecture's file once a process, and merges its
    kernel names."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_arch_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for op, names in mod.KERNELS.items():
        known = roofline.KERNELS.setdefault(op, [])
        known += [n for n in names if n not in known]
    return mod
