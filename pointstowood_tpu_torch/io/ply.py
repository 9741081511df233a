"""PLY point-cloud reading/writing on column tables (port of
pointstowood_tpu/io/ply.py without pandas).

A *column table* is an insertion-ordered ``dict[str, np.ndarray]`` of
1-D columns of equal length: the port's stand-in for the DataFrame.

Reads binary little/big endian and ascii vertex-only PLY (reference:
pointstowood/src/io.py:11-83); writes binary little endian with float64
x/y/z first, int32 red/green/blue if present, then every other numeric
column as float64. Meshes (any ``element face``) and list properties are
rejected.
"""

from __future__ import annotations

import numpy as np

# PLY property type -> numpy dtype string.
_PLY_TO_NUMPY = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}


def n_rows(table: dict) -> int:
    """Row count of a column table (0 for a table without columns)."""
    return len(next(iter(table.values()))) if table else 0


def select_rows(table: dict, keep) -> dict:
    """A new column table of the rows that ``keep`` (a boolean mask or an
    index array) selects, every column in its order."""
    return {c: np.asarray(v)[keep] for c, v in table.items()}


def extra_columns(table: dict) -> list:
    """Every column name but x, y, z: the ``additional_fields`` of a save
    that keeps them all."""
    return [c for c in table if c not in ("x", "y", "z")]


def _parse_header(fp):
    """Parse a PLY header: (fmt, n_vertices, names, dtypes, data_offset)."""
    names, dtypes = [], []
    fmt = None
    n_vertices = None
    offset = 0
    in_vertex_element = True
    with open(fp, "rb") as f:
        first = f.readline()
        offset += len(first)
        if first.strip() != b"ply":
            raise ValueError(f"{fp} is not a PLY file (missing magic)")
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{fp}: unexpected EOF in PLY header")
            offset += len(line)
            tokens = line.decode("ISO-8859-1").split()
            if not tokens:
                continue
            key = tokens[0]
            if key == "format":
                fmt = tokens[1]
            elif key == "element":
                if tokens[1] == "vertex":
                    n_vertices = int(tokens[2])
                    in_vertex_element = True
                elif tokens[1] == "face":
                    raise ValueError(f"{fp} appears to be a mesh (has faces)")
                else:
                    in_vertex_element = False
            elif key == "property" and in_vertex_element:
                if tokens[1] == "list":
                    raise ValueError(f"{fp}: list properties not supported")
                dtypes.append(_PLY_TO_NUMPY[tokens[1]])
                names.append(tokens[2])
            elif key == "end_header":
                break
    if fmt is None or n_vertices is None:
        raise ValueError(f"{fp}: malformed PLY header")
    return fmt, n_vertices, names, dtypes, offset


def read_ply(fp) -> dict:
    """Read a vertex-only PLY file into a column table, one column per
    property (ascii: float64; binary: the property's type, native byte
    order)."""
    fmt, n, names, dtypes, offset = _parse_header(fp)
    if fmt == "ascii":
        with open(fp, "r", encoding="ISO-8859-1") as f:
            f.seek(offset)
            arr = np.loadtxt(f, dtype=np.float64, ndmin=2)
        arr = arr[:n]
        return {name: np.ascontiguousarray(arr[:, i])
                for i, name in enumerate(names)}
    if fmt == "binary_little_endian":
        endian = "<"
    elif fmt == "binary_big_endian":
        endian = ">"
    else:
        raise ValueError(f"{fp}: unknown PLY format {fmt!r}")
    dtype = np.dtype([(name, endian + dt) for name, dt in zip(names, dtypes)])
    with open(fp, "rb") as f:
        f.seek(offset)
        arr = np.fromfile(f, dtype=dtype, count=n)
    return {name: arr[name].astype(np.dtype(dt), copy=True)
            for name, dt in zip(names, dtypes)}


def write_ply(output_name: str, pc: dict, comments=()) -> None:
    """Write a binary_little_endian PLY in the reference writer's layout
    (io.py:49-83): x/y/z as float64 first, then red/green/blue as int32 if
    present, then every remaining numeric column as float64. Non-numeric
    columns are dropped."""
    fields = []
    arrays = []
    for c in ("x", "y", "z"):
        arrays.append(np.asarray(pc[c], np.float64))
        fields.append((c, "<f8", "float64"))
    if "red" in pc:
        for c in ("red", "green", "blue"):
            arrays.append(np.asarray(pc[c], np.int32))
            fields.append((c, "<i4", "int"))
    for c, col in pc.items():
        if any(c == name for name, _, _ in fields):
            continue
        try:
            arrays.append(np.asarray(col, np.float64))
        except (ValueError, TypeError):
            continue
        fields.append((c, "<f8", "float64"))

    n = n_rows(pc)
    header = ["ply", "format binary_little_endian 1.0"]
    header += [f"comment {c}" for c in comments]
    header.append(f"element vertex {n}")
    header += [f"property {ply_t} {name}" for name, _, ply_t in fields]
    header.append("end_header")

    rec = np.empty(n, dtype=[(name, np_t) for name, np_t, _ in fields])
    for (name, _, _), arr in zip(fields, arrays):
        rec[name] = arr

    with open(output_name, "wb") as ply:
        ply.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(ply)
