"""LAS in the PyTorch port without laspy (``io/las.py``): the writer's
bytes against the ASPRS LAS 1.4 R15 layout that the JAX package's
``write_las`` produces through laspy, the reader on hand-built files of
every point format 0-10 and LAS version 1.0-1.4, and the refusal of
compressed data."""

import struct

import numpy as np
import pytest

from pointstowood_tpu_torch.io import las, load_file, save_file

# LAS version a point format first appeared in
VERSION = {0: 0, 1: 0, 2: 2, 3: 2, 4: 3, 5: 3, 6: 4, 7: 4, 8: 4, 9: 4, 10: 4}
HEADER_SIZE = {0: 227, 1: 227, 2: 227, 3: 235, 4: 375}


def _hand_built(path, fmt, minor, xyz_int, scale, offset, legacy=True,
                pad=0, vlr=b"", flag_bits=0):
    """A LAS 1.<minor> file of point format ``fmt`` built from the
    specification: a header, one VLR, ``pad`` bytes of user data before
    the points, and records of the format's length plus 5 extra bytes,
    random after X/Y/Z."""
    rng = np.random.default_rng(fmt)
    n = len(xyz_int)
    size = HEADER_SIZE[minor]
    rec_len = las.RECORD_LENGTHS[fmt] + 5
    vlrs = (struct.pack("<H16sHH32s", 0, b"someone", 7, len(vlr), b"")
            + vlr)
    offset_to_points = size + len(vlrs) + pad
    header = bytearray(size)
    header[0:4] = b"LASF"
    header[24], header[25] = 1, minor
    struct.pack_into("<HIIBHI", header, 94, size, offset_to_points, 1,
                     fmt | flag_bits, rec_len, n if legacy else 0)
    struct.pack_into("<3d3d", header, 131, *scale, *offset)
    if minor == 4:
        struct.pack_into("<Q", header, 247, n)
    records = rng.integers(0, 256, (n, rec_len), dtype=np.uint8)
    records[:, :12] = np.ascontiguousarray(
        np.asarray(xyz_int, "<i4")).view(np.uint8).reshape(n, 12)
    with open(path, "wb") as f:
        f.write(bytes(header) + vlrs + bytes(pad) + records.tobytes())


@pytest.mark.parametrize("fmt", range(11))
def test_reads_every_point_format(tmp_path, fmt):
    minor = VERSION[fmt]
    rng = np.random.default_rng(100 + fmt)
    xyz_int = rng.integers(-2**31, 2**31, (257, 3))
    scale, offset = (0.01, 0.001, 0.0025), (5e5, -4e6, 12.5)
    path = str(tmp_path / f"f{fmt}.las")
    _hand_built(path, fmt, minor, xyz_int, scale, offset, pad=3,
                vlr=b"payload")
    got = las.read_las(path)
    for i, c in enumerate("xyz"):
        want = xyz_int[:, i].astype(np.float64) * scale[i] + offset[i]
        assert got[c].dtype == np.float64
        assert np.array_equal(got[c], want), c


def test_las12_format3(tmp_path):
    """LAS 1.2, point format 3 (34-byte records: GPS time and RGB)."""
    xyz_int = np.array([[0, 0, 0], [1000, -2000, 3000], [2**31 - 1, -2**31,
                                                          7]])
    path = str(tmp_path / "a.las")
    _hand_built(path, 3, 2, xyz_int, (0.001,) * 3, (100.0, 200.0, 0.0))
    got = load_file(path)
    assert sorted(got) == ["x", "y", "z"]
    np.testing.assert_array_equal(
        np.stack([got[c] for c in "xyz"], 1),
        xyz_int * 0.001 + np.array([100.0, 200.0, 0.0]))


@pytest.mark.parametrize("fmt", [1, 6])
def test_las14_with_legacy_count_zero(tmp_path, fmt):
    """A 1.4 file whose legacy count is 0 (as every format 6-10 file must
    be) gives its points from the 64-bit count at byte 247."""
    xyz_int = np.arange(3 * 50).reshape(50, 3) - 70
    path = str(tmp_path / "b.las")
    _hand_built(path, fmt, 4, xyz_int, (0.5, 0.25, 0.125), (1.0, 2.0, 3.0),
                legacy=False)
    got = las.read_las(path)
    assert len(got["x"]) == 50
    np.testing.assert_array_equal(got["z"], xyz_int[:, 2] * 0.125 + 3.0)


def _table(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(500, 530, n), "y": rng.uniform(300, 330, n),
            "z": rng.uniform(20, 40, n), "red": rng.integers(0, 65536, n)
            .astype(np.float64), "intensity": rng.normal(size=n),
            "green": rng.integers(0, 65536, n).astype(np.float64),
            "label": (rng.uniform(size=n) < 0.3).astype(np.float64),
            "pwood": rng.uniform(size=n)}


def test_write_read_round_trip(tmp_path):
    """save_file -> LAS 1.4 format 7 with the colours in the format's
    fields and every other column an f8 extra dimension; load_file gives
    x/y/z within half a millimetre (the stored integers of 0.001 m)."""
    table = _table(1000)
    fields = ["intensity", "red", "green", "label", "pwood"]
    path = str(tmp_path / "t.las")
    save_file(path, table, additional_fields=fields)
    data = open(path, "rb").read()
    extra = ["intensity", "label", "pwood"]
    n = 1000
    # header
    assert data[:4] == b"LASF" and data[24:26] == bytes([1, 4])
    size, offset, n_vlr, fmt, rec_len, legacy = struct.unpack_from(
        "<HIIBHI", data, 94)
    assert (size, n_vlr, fmt, legacy) == (375, 1, 7, 0)
    assert rec_len == 36 + 8 * len(extra)
    assert offset == 375 + 54 + 192 * len(extra)
    assert struct.unpack_from("<Q", data, 247)[0] == n
    assert struct.unpack_from("<H", data, 6)[0] & 16  # WKT bit, formats 6-10
    scales = struct.unpack_from("<3d", data, 131)
    offsets = np.array(struct.unpack_from("<3d", data, 155))
    assert scales == (0.001, 0.001, 0.001)
    xyz = np.stack([table[c] for c in "xyz"], 1)
    np.testing.assert_array_equal(offsets, xyz.min(axis=0))
    assert len(data) == offset + n * rec_len
    # records
    rec = np.frombuffer(data, np.dtype(las._FORMAT7 + [
        (f"extra_{e}", "<f8") for e in extra]), count=n, offset=offset)
    stored = np.stack([rec[c] * 0.001 + offsets[i]
                       for i, c in enumerate("XYZ")], 1)
    np.testing.assert_array_equal(
        np.stack([rec[c] for c in "XYZ"], 1),
        np.round((xyz - offsets) / 0.001).astype(np.int32))
    for c in ("red", "green"):
        np.testing.assert_array_equal(rec[c], table[c].astype(np.uint16))
    assert not rec["blue"].any()
    assert not rec["intensity"].any()  # intensity is an extra dimension
    for e in extra:
        np.testing.assert_array_equal(rec[f"extra_{e}"], table[e])
    # header bounds: max/min of the stored coordinates
    bounds = struct.unpack_from("<6d", data, 179)
    np.testing.assert_array_equal(bounds[0::2], stored.max(axis=0))
    np.testing.assert_array_equal(bounds[1::2], stored.min(axis=0))
    # read back
    got = load_file(path)
    back = np.stack([got[c] for c in "xyz"], 1)
    np.testing.assert_array_equal(back, stored)
    assert np.abs(back - xyz).max() <= 0.0005 + 1e-9
    # the writer's integers are the reader's: a second trip is exact
    save_file(str(tmp_path / "u.las"), got)
    again = load_file(str(tmp_path / "u.las"))
    for c in "xyz":
        np.testing.assert_allclose(again[c], got[c], rtol=0, atol=1e-9)


def test_write_las_takes_arrays_as_the_jax_package_does(tmp_path):
    """write_las(path, array, fields): ``fields`` names every column from
    the first, so its entries from the fourth on name columns 3 and up."""
    table = _table(50, seed=3)
    cols = ["x", "y", "z", "pwood", "red"]
    arr = np.stack([table[c] for c in cols], 1)
    las.write_las(str(tmp_path / "a.las"), arr, additional_fields=cols)
    save_file(str(tmp_path / "b.las"), table, additional_fields=cols[3:])
    assert (tmp_path / "a.las").read_bytes() == \
        (tmp_path / "b.las").read_bytes()


def test_extra_bytes_vlr_against_the_spec(tmp_path):
    """The Extra Bytes VLR (LAS 1.4 R15, section 2.5.2): a 54-byte VLR
    header (reserved 0, user id LASF_Spec, record id 4, length 192 per
    dimension) and one 192-byte descriptor a dimension: data type 10
    (double) at byte 2, options 0 at byte 3, the name at 4-35, zeros
    elsewhere."""
    path = str(tmp_path / "v.las")
    names = ["n_z", "a_name_of_thirty_two_bytes_long"[:32], "pwood"]
    table = {c: np.arange(4, dtype=np.float64) for c in ["x", "y", "z"]
             + names}
    save_file(path, table, additional_fields=names)
    data = open(path, "rb").read()
    vlr = data[375:375 + 54]
    assert vlr[0:2] == b"\x00\x00"
    assert vlr[2:18] == b"LASF_Spec" + bytes(7)
    assert struct.unpack_from("<HH", vlr, 18) == (4, 192 * len(names))
    assert vlr[22:54] == bytes(32)
    for i, name in enumerate(names):
        d = data[375 + 54 + 192 * i:375 + 54 + 192 * (i + 1)]
        assert d == las.extra_bytes_descriptor(name)
        assert d[0:2] == b"\x00\x00" and d[2] == 10 and d[3] == 0
        assert d[4:36] == name.encode() + bytes(32 - len(name))
        assert d[36:] == bytes(192 - 36)
    with pytest.raises(ValueError, match="32 bytes"):
        las.extra_bytes_descriptor("x" * 33)


def test_no_extra_dimension_writes_no_vlr(tmp_path):
    path = str(tmp_path / "plain.las")
    save_file(path, {"x": np.zeros(2), "y": np.ones(2), "z": np.ones(2)})
    data = open(path, "rb").read()
    assert struct.unpack_from("<HIIBH", data, 94) == (375, 375, 0, 7, 36)
    assert len(data) == 375 + 2 * 36
    assert np.array_equal(load_file(path)["y"], np.ones(2))


def test_laz_raises(tmp_path):
    with pytest.raises(RuntimeError, match="LASzip"):
        load_file(str(tmp_path / "c.laz"))


@pytest.mark.parametrize("bits", [0x80, 0x40, 0xC0])
def test_compressed_bit_raises(tmp_path, bits):
    """LAZ written with a .las name: the format byte carries a compression
    bit."""
    path = str(tmp_path / "z.las")
    _hand_built(path, 3, 2, np.zeros((4, 3), int), (1.0,) * 3, (0.0,) * 3,
                flag_bits=bits)
    with pytest.raises(las.LasError, match="compressed"):
        load_file(path)


def test_malformed_files_raise(tmp_path):
    path = str(tmp_path / "m.las")
    _hand_built(path, 2, 2, np.zeros((10, 3), int), (1.0,) * 3, (0.0,) * 3)
    data = bytearray(open(path, "rb").read())
    cases = {
        "no LASF": b"LASG" + bytes(data[4:]),
        "run past": bytes(data[:-1]),
        "header cut short": bytes(data[:100]),
        "unknown point data format": bytes(data[:104]) + b"\x0b"
        + bytes(data[105:]),
        "shorter than point format": bytes(data[:105])
        + struct.pack("<H", 25) + bytes(data[107:]),
    }
    for match, raw in cases.items():
        with open(path, "wb") as f:
            f.write(raw)
        with pytest.raises(las.LasError, match=match):
            las.read_las(path)
