"""Format-dispatching point-cloud load/save and column canonicalization
on column tables (port of pointstowood_tpu/io/loader.py without pandas).

``load_file``/``save_file`` mirror the reference entry points
(reference: pointstowood/src/io.py:149-225); ``canonicalize_columns``
implements the column normalization both reference CLIs perform before
preprocessing (reference: pointstowood/predict.py:36-52,
train.py:36-49). LAS goes through the port's own reader and writer
(``io/las.py``, no laspy): a LAS file gives x, y, z only, quantised to
the file's scale (1 mm as the JAX package writes it), so only PLY keeps
x/y/z bit for bit. LAZ needs a decompressor and raises.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from pointstowood_tpu_torch.io.las import read_las, write_las
from pointstowood_tpu_torch.io.pcd import read_pcd
from pointstowood_tpu_torch.io.ply import (
    extra_columns,
    n_rows,
    read_ply,
    write_ply,
)

_PREDICTION_COLUMNS = ("label", "pwood", "pleaf")


def load_file(filename: str, additional_headers: bool = False,
              verbose: bool = False):
    """Load a .ply/.pcd/.las cloud into a column table (a LAS file gives
    x, y, z only). With ``additional_headers=True`` also returns the
    non-xyz column names (reference io.py:175-177)."""
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".laz":
        raise RuntimeError(
            f"{filename}: LAZ is compressed LAS and needs a LASzip "
            "decompressor, which pointstowood_tpu_torch does not have; "
            "decompress it to .las (or convert it to .ply) first")
    if ext == ".las":
        pc = read_las(filename)
    elif ext == ".ply":
        pc = read_ply(filename)
    elif ext == ".pcd":
        pc = read_pcd(filename)
    else:
        raise ValueError(f"point cloud format not recognised: {filename}")
    if verbose:
        print(f"read in {filename} with {n_rows(pc)} points")
    if additional_headers:
        return pc, extra_columns(pc)
    return pc


def save_file(filename: str, pointcloud, additional_fields: Sequence[str] = (),
              verbose: bool = False) -> None:
    """Save a column table or (n, m) array to .ply, .las or .csv
    (reference io.py:180-225). PLY and LAS keep x, y, z and
    ``additional_fields`` (LAS: 1.4, point format 7, x/y/z to 1 mm, see
    ``io/las.py``); CSV writes every column, space-separated, without a
    header."""
    if verbose:
        print("Saving file:", filename)
    cols = ["x", "y", "z"] + [c for c in additional_fields
                              if c not in ("x", "y", "z")]
    if filename.endswith(".las"):
        if isinstance(pointcloud, dict):
            cols = [c for c in cols if c in pointcloud]
            arr = np.stack([np.asarray(pointcloud[c], np.float64)
                            for c in cols], 1)
        else:
            arr = np.asarray(pointcloud)
        write_las(filename, arr, additional_fields=cols)
    elif filename.endswith(".csv"):
        if isinstance(pointcloud, dict):
            columns = list(pointcloud.values())
        else:
            arr = np.asarray(pointcloud)
            columns = [arr[:, i] for i in range(arr.shape[1])]
        with open(filename, "w") as f:
            for row in zip(*columns):
                f.write(" ".join(map(str, row)) + "\n")
    elif filename.endswith(".ply"):
        if not isinstance(pointcloud, dict):
            arr = np.asarray(pointcloud)
            pointcloud = {c: arr[:, i] for i, c in enumerate(cols)}
        write_ply(filename, {c: pointcloud[c] for c in cols
                             if c in pointcloud})
    else:
        raise ValueError(f"unsupported output format: {filename}")
    if verbose:
        print("Saved to:", filename)


def canonicalize_columns(
    pc: dict, mode: str = "predict"
) -> Tuple[dict, List[str], bool]:
    """Normalize column names and put a reflectance column at position 3.

    Steps (matching reference predict.py:36-52 / train.py:36-49):
      * lower-case all column names,
      * in predict mode drop stale prediction columns (label/pwood/pleaf),
      * strip a ``scalar_`` prefix,
      * rename refl/intensity -> reflectance (and truth -> label when
        training),
      * keep the first of any duplicated names,
      * inject an all-zeros reflectance column if absent,
      * move reflectance to column index 3 (right after x, y, z).

    Returns (table, extra_headers, had_reflectance); ``had_reflectance``
    says whether a real (pre-existing) reflectance column was found. The
    columns of the input table are shared, not copied.
    """
    # (name, column) pairs: renaming can create duplicate names, which a
    # dict cannot hold until the keep-first step
    cols = [(c.lower(), v) for c, v in pc.items()]
    if mode == "predict":
        cols = [(c, v) for c, v in cols if c not in _PREDICTION_COLUMNS]
    cols = [(c.replace("scalar_", ""), v) for c, v in cols]
    renames = {"refl": "reflectance", "intensity": "reflectance"}
    if mode != "predict":
        renames["truth"] = "label"
    cols = [(renames.get(c, c), v) for c, v in cols]
    table: dict = {}
    for c, v in cols:
        table.setdefault(c, v)
    # extra headers are recorded before reflectance injection so an
    # injected all-zeros column is not echoed into outputs (reference
    # predict.py:42-44)
    headers = [c for c in list(table)[3:] if c not in _PREDICTION_COLUMNS]
    had_reflectance = "reflectance" in table
    if not had_reflectance:
        table["reflectance"] = np.zeros(n_rows(table))
    names = list(table)
    names.insert(3, names.pop(names.index("reflectance")))
    return {c: table[c] for c in names}, headers, had_reflectance
