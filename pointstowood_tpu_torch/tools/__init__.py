"""Analysis tools of the port (counterparts of pointstowood_tpu/tools/),
on column tables (``dict[str, np.ndarray]``, see ``io/ply.py``).

Each tool keeps its JAX counterpart's functions, arguments and CLI
flags, and runs as ``python -m pointstowood_tpu_torch.tools.<name>``:

* ``threshold_sweep``: classify a cloud once, re-fuse at each is-wood
  threshold on the device, print wood fraction, BA and F1;
* ``compare``: precision / recall / BA / F1 (path-length weighted BA
  where a ``pathlength`` column is there) of ``*_ours.ply`` and
  ``*_fsct.ply`` pairs, ``results.csv``;
* ``pathlength``: graph distance from the lowest point;
* ``priors``: max(linearity, planarity) of each point's neighbourhood,
  in torch on the device;
* ``instance``: tree instances from a labelled cloud, with the port's
  own HDBSCAN (``hdbscan.py``);
* ``clustering``, ``height_normalisation``, ``collect_attribute``,
  ``split_ply``: column-table utilities.

``scores.py`` holds the binary metrics that the JAX tools take from
sklearn. At run time the tools import torch, numpy and scipy only
(matplotlib optionally, inside ``compare.main``).
"""
