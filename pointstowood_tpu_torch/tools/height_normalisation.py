"""DTM-based height normalization from ground-classified points (port of
pointstowood_tpu/tools/height_normalisation.py on column tables).

Rebuilds the archived NormaliseHeight
(reference: pointstowood/archive/height_normalisation.py:18-43): build a
0.5 m digital terrain model from the median z of ground-labeled points
(label == 2) per cell, in-fill empty DTM cells with a growing-window
median, and normalize every point's height against it. The live path
uses the coarse per-cell minimum (``ops.normalization.ground_normalize_np``);
this tool is kept for capability parity.

Run: python -m pointstowood_tpu_torch.tools.height_normalisation cloud.ply
"""

from __future__ import annotations

import argparse
import warnings

import numpy as np

from pointstowood_tpu_torch.io import extra_columns, load_file, save_file


def normalise_height(pc: dict, cell: float = 0.5,
                     ground_label: float = 2.0) -> dict:
    """A new column table: ``pc``'s columns plus ``n_z``, z minus the
    in-filled ground model. ``pc`` itself is left as it is."""
    from scipy import ndimage

    x, y, z = (np.asarray(pc[c]) for c in ("x", "y", "z"))
    xi = np.floor(x / cell).astype(np.int64)
    yi = np.floor(y / cell).astype(np.int64)
    xi -= xi.min()
    yi -= yi.min()
    nx, ny = xi.max() + 1, yi.max() + 1

    dtm = np.full((nx, ny), np.nan)
    is_ground = np.asarray(pc["label"]) == ground_label
    if is_ground.any():
        gz = z[is_ground]
        gcell = xi[is_ground] * ny + yi[is_ground]
        order = np.argsort(gcell, kind="stable")
        gcell, gz = gcell[order], gz[order]
        bounds = np.flatnonzero(np.diff(gcell)) + 1
        cells = gcell[np.concatenate([[0], bounds])]
        for c, zs in zip(cells, np.split(gz, bounds)):
            dtm[c // ny, c % ny] = np.median(zs)

    # growing-window median in-fill (height_normalisation.py:36-40)
    size = 3
    filled = dtm.copy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while np.any(np.isnan(filled)) and size <= 2 * max(nx, ny) + 1:
            filled = ndimage.generic_filter(dtm, np.nanmedian, size=size)
            size += 2
    if np.any(np.isnan(filled)):  # no ground points at all
        filled = np.where(np.isnan(filled), np.nanmin(z), filled)

    out = dict(pc)
    out["n_z"] = z - filled[xi, yi]
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("point_cloud")
    p.add_argument("--cell", type=float, default=0.5)
    p.add_argument("--ground-label", type=float, default=2.0)
    args = p.parse_args(argv)
    pc = load_file(args.point_cloud)
    pc = normalise_height(pc, cell=args.cell, ground_label=args.ground_label)
    out = args.point_cloud.replace(".ply", "_nz.ply")
    save_file(out, pc, additional_fields=extra_columns(pc))
    print(f"Saved {out}")


if __name__ == "__main__":
    main()
