"""1-NN attribute transfer between clouds with a distance cutoff (port of
pointstowood_tpu/tools/collect_attribute.py on column tables).

Reimplements the reference utility
(reference: pointstowood/utils/collect_attribute.py:23-34): for every point
of the target cloud, copy the requested attribute columns from its nearest
source-cloud point, blanking transfers farther than ``--distance``. The
search is the port's exact host kNN (``predict/fusion.knn_indices``).

Run: python -m pointstowood_tpu_torch.tools.collect_attribute target.ply
     source.ply --attributes label pwood --distance 0.1
"""

from __future__ import annotations

import argparse

import numpy as np

from pointstowood_tpu_torch.data.tiling import xyz_of
from pointstowood_tpu_torch.io import extra_columns, load_file, save_file
from pointstowood_tpu_torch.predict.fusion import knn_indices


def collect_attributes(target: dict, source: dict, attributes,
                       max_distance=None) -> dict:
    """Set ``attributes`` on ``target`` (in place, and returned) from the
    nearest ``source`` point of each target point."""
    t_xyz, s_xyz = xyz_of(target), xyz_of(source)
    idx = knn_indices(s_xyz, t_xyz, 1)[:, 0]
    d = np.linalg.norm(t_xyz - s_xyz[idx], axis=1)
    for attr in attributes:
        vals = np.asarray(source[attr])[idx].astype(float)
        if max_distance is not None:
            vals = np.where(d <= max_distance, vals, 0.0)
        target[attr] = vals
    return target


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("target", help="cloud receiving the attributes")
    p.add_argument("source", help="cloud providing the attributes")
    p.add_argument("--attributes", nargs="+", required=True)
    p.add_argument("--distance", type=float, default=None,
                   help="max transfer distance; farther points get 0")
    p.add_argument("--odir", type=str, default=None)
    args = p.parse_args(argv)

    target = load_file(args.target)
    source = load_file(args.source)
    target = collect_attributes(target, source, args.attributes, args.distance)
    out = args.odir or args.target.replace(".ply", "_attr.ply")
    save_file(out, target, additional_fields=extra_columns(target))
    print(f"Saved {out}")


if __name__ == "__main__":
    main()
