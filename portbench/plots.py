"""Traffic generators: synthetic forest plots from a seed, and the PLY
files they are served in.

``synthetic_plot`` is frozen from the port's smoke test: an n x n grid of
trees (a trunk cylinder, bright, labelled wood; a crown blob, dark) on a
jittered 4 m grid over a ground layer. At density 1 a tree has 9 000
trunk and 20 000 crown points and the ground 130 000 points per 24 m x
24 m. Every size and count is fixed by the traffic file.
"""

from __future__ import annotations

import numpy as np


def synthetic_plot(layout_seed: int, n_side: int = 6, density: float = 1.0,
                   seed: int | None = None):
    """(table {x, y, z, intensity} float64, wood (n,) bool). The
    positions come from ``layout_seed``; the reflectances and the order
    of the rows from ``seed`` (default: ``layout_seed``). A fixed layout
    gives every seed the same tiles, so the same work, in another order
    and with other values."""
    rng = np.random.default_rng(layout_seed)
    vals = np.random.default_rng(layout_seed if seed is None else seed)
    cols, refl, wood = [], [], []
    side = 4.0 * n_side
    for i in range(n_side * n_side):
        cx = 2.0 + 4.0 * (i % n_side) + rng.uniform(-0.8, 0.8)
        cy = 2.0 + 4.0 * (i // n_side) + rng.uniform(-0.8, 0.8)
        h = rng.uniform(8.0, 14.0)
        r0 = rng.uniform(0.1, 0.25)
        n_trunk, n_crown = int(9000 * density), int(20000 * density)
        theta = rng.uniform(0, 2 * np.pi, n_trunk)
        r = r0 + rng.normal(0, 0.01, n_trunk)
        cols.append(np.stack([cx + r * np.cos(theta), cy + r * np.sin(theta),
                              rng.uniform(0, h, n_trunk)], 1))
        refl.append(vals.normal(2, 0.3, n_trunk))
        wood.append(np.ones(n_trunk, bool))
        cols.append(np.stack([cx + rng.normal(0, 1.4, n_crown),
                              cy + rng.normal(0, 1.4, n_crown),
                              h - 2 + rng.normal(0, 1.2, n_crown)], 1))
        refl.append(vals.normal(-1, 0.5, n_crown))
        wood.append(np.zeros(n_crown, bool))
    n_ground = int(130000 * density * (n_side / 6) ** 2)
    cols.append(np.stack([rng.uniform(0, side, n_ground),
                          rng.uniform(0, side, n_ground),
                          rng.normal(0, 0.05, n_ground)], 1))
    refl.append(vals.normal(0.5, 0.5, n_ground))
    wood.append(np.zeros(n_ground, bool))
    xyz = np.concatenate(cols)
    perm = vals.permutation(len(xyz))
    xyz, refl = xyz[perm], np.concatenate(refl)[perm]
    table = {"x": xyz[:, 0] + 500.0, "y": xyz[:, 1] + 300.0,
             "z": xyz[:, 2] + 20.0, "intensity": refl}
    return table, np.concatenate(wood)[perm]


def write_ply(path: str, table: dict) -> None:
    """Binary little-endian PLY, every column float64."""
    names = list(table)
    n = len(table[names[0]])
    rec = np.empty(n, dtype=[(c, "<f8") for c in names])
    for c in names:
        rec[c] = table[c]
    head = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    head += [f"property double {c}" for c in names] + ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode("ascii"))
        rec.tofile(f)


_TYPES = {"char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
          "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
          "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
          "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8"}


def read_ply(path: str) -> dict:
    """The vertex columns of a binary little-endian PLY."""
    names, types, n = [], [], 0
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        while True:
            tok = f.readline().decode("ascii").split()
            if not tok:
                continue
            if tok[0] == "format" and tok[1] != "binary_little_endian":
                raise ValueError(f"{path}: {tok[1]} PLY")
            if tok[0] == "element":
                n = int(tok[2])
            elif tok[0] == "property":
                types.append("<" + _TYPES[tok[1]])
                names.append(tok[2])
            elif tok[0] == "end_header":
                break
        rec = np.fromfile(f, dtype=list(zip(names, types)), count=n)
    return {c: rec[c] for c in names}
