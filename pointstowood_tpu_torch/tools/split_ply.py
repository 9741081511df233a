"""Split a PLY at the 80th percentile of x into train/test parts (port of
pointstowood_tpu/tools/split_ply.py on column tables).

Reimplements the reference utility
(reference: pointstowood/utils/split_ply.py:6-41).

Run: python -m pointstowood_tpu_torch.tools.split_ply cloud.ply
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pointstowood_tpu_torch.io import (
    extra_columns,
    load_file,
    save_file,
    select_rows,
)


def split_and_save_ply(path: str, percentile: float = 80.0):
    pc = load_file(path)
    cut = np.percentile(pc["x"], percentile)
    first = select_rows(pc, pc["x"] <= cut)
    second = select_rows(pc, pc["x"] > cut)
    base = os.path.splitext(path)[0]
    p1, p2 = base + "_train.ply", base + "_test.ply"
    save_file(p1, first, additional_fields=extra_columns(pc))
    save_file(p2, second, additional_fields=extra_columns(pc))
    return p1, p2


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("point_cloud")
    p.add_argument("--percentile", type=float, default=80.0)
    args = p.parse_args(argv)
    p1, p2 = split_and_save_ply(args.point_cloud, args.percentile)
    print(f"Saved {p1} and {p2}")


if __name__ == "__main__":
    main()
