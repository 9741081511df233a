"""PCD point-cloud reading/writing on column tables (port of
pointstowood_tpu/io/pcd.py; reference: pointstowood/src/io.py:90-142).

Reads binary (float32 fields) and ascii PCD; writes PCD v0.7 with binary
float32 data and the x/y/z[/intensity] field layout the reference emits.
"""

from __future__ import annotations

import numpy as np

from pointstowood_tpu_torch.io.ply import n_rows


def read_pcd(fp) -> dict:
    fields = None
    n_points = None
    fmt = None
    offset = 0
    with open(fp, "rb") as f:
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{fp}: unexpected EOF in PCD header")
            offset += len(line)
            tokens = line.decode("ISO-8859-1").split()
            if not tokens:
                continue
            key = tokens[0].upper()
            if key == "FIELDS":
                fields = tokens[1:]
            elif key == "POINTS":
                n_points = int(tokens[1])
            elif key == "WIDTH" and n_points is None:
                n_points = int(tokens[1])
            elif key == "DATA":
                fmt = tokens[1]
                break
    if fields is None or fmt is None:
        raise ValueError(f"{fp}: malformed PCD header")
    if fmt == "binary":
        with open(fp, "rb") as f:
            f.seek(offset)
            arr = np.fromfile(f, dtype="<f4")
        arr = arr[: n_points * len(fields)].reshape(-1, len(fields))
        arr = arr.astype(np.float32)
    elif fmt == "ascii":
        with open(fp, "r", encoding="ISO-8859-1") as f:
            f.seek(offset)
            arr = np.loadtxt(f, dtype=np.float64, ndmin=2)[:n_points]
    else:
        raise ValueError(f"{fp}: unsupported PCD data format {fmt!r}")
    return {name: np.ascontiguousarray(arr[:, i])
            for i, name in enumerate(fields)}


def write_pcd(pc: dict, path: str, binary: bool = True) -> None:
    pc = {("intensity" if c == "scalar_intensity" else c): v
          for c, v in pc.items()}
    columns = ["x", "y", "z"]
    if "intensity" in pc:
        columns.append("intensity")
    n = n_rows(pc)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(columns)}\n"
        f"SIZE {' '.join(['4'] * len(columns))}\n"
        f"TYPE {' '.join(['F'] * len(columns))}\n"
        f"COUNT {' '.join(['1'] * len(columns))}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
    )
    data = np.stack([np.asarray(pc[c]) for c in columns], axis=1)
    data = data.astype("<f4")
    if binary:
        with open(path, "wb") as pcd:
            pcd.write((header + "DATA binary\n").encode("ascii"))
            data.tofile(pcd)
    else:
        with open(path, "w") as pcd:
            pcd.write(header + "DATA ascii\n")
            np.savetxt(pcd, data, fmt="%.8g")
