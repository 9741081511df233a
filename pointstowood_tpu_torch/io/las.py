"""LAS reading and writing in numpy, without laspy (port of
pointstowood_tpu/io/las.py).

``read_las`` reads any uncompressed LAS 1.0-1.4 file of point formats
0-10 and returns x, y, z only, as the JAX package's ``read_las`` does. It
needs these header fields of the ASPRS LAS 1.4 R15 specification: the
offset to the point data (uint32 at byte 96), the point data format
(uint8 at 104), the record length (uint16 at 105), the legacy point count
(uint32 at 107), the x/y/z scales (doubles at 131) and offsets (doubles
at 155), and, for version 1.4 where the legacy count is 0, the 64-bit
count at 247. X, Y and Z are the first three int32 values of every point
format's record: x = X * scale + offset, in float64.

``write_las`` writes what the JAX package's ``write_las`` writes through
laspy: LAS 1.4, point format 7, scales 0.001 and offsets at the xyz
minimum; red/green/blue go into the format's own fields and every other
column into an ``f8`` extra dimension, described in an Extra Bytes VLR.
The coordinates are stored as integers of the scale, so a LAS round trip
quantises x/y/z to 1 mm: that is the format's, and only a PLY keeps them
bit for bit.

Compressed clouds (``.laz``, or a point format byte with a compression
bit set) raise: they need a LASzip decompressor.
"""

from __future__ import annotations

import struct

import numpy as np

# record length of each point data format 0-10 (LAS 1.4 R15, table 6)
RECORD_LENGTHS = (20, 28, 26, 34, 57, 63, 30, 36, 38, 59, 67)
HEADER_SIZE_14 = 375
EXTRA_BYTES_RECORD_ID = 4
EXTRA_BYTES_DESCRIPTOR_SIZE = 192
EXTRA_BYTES_DOUBLE = 10  # data_type of an f8 extra dimension
SCALE = 0.001
_COMPRESSED_BITS = 0xC0  # set in the format byte by LASzip writers
_WKT_BIT = 1 << 4  # global encoding: CRS as WKT, required for formats 6-10
# the fields of point format 7 (LAS 1.4 R15, table 16)
_FORMAT7 = [("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"),
            ("intensity", "<u2"), ("returns", "u1"), ("flags", "u1"),
            ("classification", "u1"), ("user_data", "u1"),
            ("scan_angle", "<i2"), ("point_source_id", "<u2"),
            ("gps_time", "<f8"), ("red", "<u2"), ("green", "<u2"),
            ("blue", "<u2")]
_COLOURS = ("red", "green", "blue")
_SOFTWARE = b"pointstowood_tpu_torch"  # generating software, 32 bytes max


class LasError(ValueError):
    """A file this reader cannot read: not LAS, compressed, or cut short."""


def read_las(filename: str) -> dict:
    """{"x", "y", "z"} float64 columns of an uncompressed LAS file."""
    with open(filename, "rb") as f:
        data = f.read()
    if data[:4] != b"LASF":
        raise LasError(f"{filename}: not a LAS file (no LASF signature)")
    if len(data) < 227:
        raise LasError(f"{filename}: header cut short")
    major, minor = data[24], data[25]
    (offset,) = struct.unpack_from("<I", data, 96)
    fmt = data[104]
    (record_len, legacy_count) = struct.unpack_from("<HI", data, 105)
    scales = np.array(struct.unpack_from("<3d", data, 131))
    offsets = np.array(struct.unpack_from("<3d", data, 155))
    if fmt & _COMPRESSED_BITS:
        raise LasError(f"{filename}: compressed point data (format byte "
                       f"{fmt:#04x}, LAZ); it needs a LASzip decompressor")
    if fmt >= len(RECORD_LENGTHS):
        raise LasError(f"{filename}: unknown point data format {fmt}")
    if record_len < RECORD_LENGTHS[fmt]:
        raise LasError(f"{filename}: record length {record_len} is shorter "
                       f"than point format {fmt}'s {RECORD_LENGTHS[fmt]}")
    count = legacy_count
    if (major, minor) >= (1, 4) and legacy_count == 0:
        if len(data) < 255:
            raise LasError(f"{filename}: LAS 1.4 header cut short")
        (count,) = struct.unpack_from("<Q", data, 247)
    if offset + count * record_len > len(data):
        raise LasError(f"{filename}: {count} points of {record_len} bytes "
                       f"from byte {offset} run past the file's end")
    xyz = np.frombuffer(data, np.dtype({
        "names": ["X", "Y", "Z"], "formats": ["<i4"] * 3,
        "offsets": [0, 4, 8], "itemsize": record_len}),
        count=count, offset=offset)
    return {c: xyz[c.upper()].astype(np.float64) * scales[i] + offsets[i]
            for i, c in enumerate("xyz")}


def extra_bytes_descriptor(name: str) -> bytes:
    """One 192-byte Extra Bytes descriptor (LAS 1.4 R15, table 24) of an
    f8 column: data type 10, no options, the name null-padded to 32
    bytes, every no-data/min/max/scale/offset slot zero, no description."""
    raw = name.encode("ascii")
    if len(raw) > 32:
        raise ValueError(f"extra dimension name {name!r} is over 32 bytes")
    out = bytearray(EXTRA_BYTES_DESCRIPTOR_SIZE)
    out[2] = EXTRA_BYTES_DOUBLE
    out[4:4 + len(raw)] = raw
    return bytes(out)


def _vlr(user_id: str, record_id: int, payload: bytes,
         description: str = "") -> bytes:
    return (struct.pack("<H16sHH32s", 0, user_id.encode("ascii"), record_id,
                        len(payload), description.encode("ascii"))
            + payload)


def write_las(filename: str, pointcloud: np.ndarray,
              additional_fields=()) -> None:
    """Write an (n, m) array as LAS 1.4 point format 7, as the JAX
    package's ``write_las`` does: columns 0-2 are x/y/z, and
    ``additional_fields`` names every column from the first, so its
    entries from the fourth on name columns 3 and up (red/green/blue to
    the format's fields, cast to uint16; others to f8 extra dimensions)."""
    arr = np.asarray(pointcloud, dtype=np.float64)
    n = arr.shape[0]
    xyz = arr[:, :3]
    offsets = xyz.min(axis=0) if n else np.zeros(3)
    extra = list(additional_fields)[3:]
    dims = [h for h in extra if h not in _COLOURS]
    dtype = np.dtype(_FORMAT7 + [(f"extra_{i}", "<f8")
                                 for i in range(len(dims))])
    records = np.zeros(n, dtype)
    for i, c in enumerate("XYZ"):
        records[c] = np.round((xyz[:, i] - offsets[i]) / SCALE)
    for i, header in enumerate(extra):
        column = arr[:, 3 + i]
        if header in _COLOURS:
            records[header] = column.astype(np.uint16)
        else:
            records[f"extra_{dims.index(header)}"] = column
    stored = np.stack([records[c].astype(np.float64) * SCALE + offsets[i]
                       for i, c in enumerate("XYZ")], 1)
    maxs = stored.max(axis=0) if n else np.zeros(3)
    mins = stored.min(axis=0) if n else np.zeros(3)

    vlrs = b""
    if dims:
        vlrs = _vlr("LASF_Spec", EXTRA_BYTES_RECORD_ID,
                    b"".join(extra_bytes_descriptor(h) for h in dims))
    offset = HEADER_SIZE_14 + len(vlrs)
    header = bytearray(HEADER_SIZE_14)
    header[0:4] = b"LASF"
    struct.pack_into("<H", header, 6, _WKT_BIT)
    header[24], header[25] = 1, 4
    header[58:58 + len(_SOFTWARE)] = _SOFTWARE
    struct.pack_into("<HIIBHI", header, 94, HEADER_SIZE_14, offset,
                     1 if dims else 0, 7, dtype.itemsize, 0)
    struct.pack_into("<3d3d", header, 131, SCALE, SCALE, SCALE, *offsets)
    struct.pack_into("<6d", header, 179, maxs[0], mins[0], maxs[1], mins[1],
                     maxs[2], mins[2])
    struct.pack_into("<QQIQ", header, 227, 0, 0, 0, n)
    with open(filename, "wb") as f:
        f.write(bytes(header))
        f.write(vlrs)
        f.write(records.tobytes())
