"""The port's pandas-free I/O (pointstowood_tpu_torch.io) against the JAX
package's pandas I/O, on the CPU: PLY and PCD round trips both ways with
bit-identical columns, and ``canonicalize_columns`` giving the same
names, order, headers and values."""

import numpy as np
import pandas as pd
import pytest

from pointstowood_tpu.io import loader as j_loader
from pointstowood_tpu.io import pcd as j_pcd
from pointstowood_tpu.io import ply as j_ply
from pointstowood_tpu_torch.io import loader as t_loader
from pointstowood_tpu_torch.io import pcd as t_pcd
from pointstowood_tpu_torch.io import ply as t_ply


def _table(n=257, rgb=True, seed=0):
    rng = np.random.default_rng(seed)
    t = {
        "x": rng.normal(100, 5, n),
        "y": rng.normal(50, 5, n),
        "z": rng.uniform(0, 20, n),
        "scalar_Refl": rng.normal(0, 1, n).astype(np.float32),
    }
    if rgb:
        t["red"] = rng.integers(0, 255, n)
        t["green"] = rng.integers(0, 255, n)
        t["blue"] = rng.integers(0, 255, n)
    t["truth"] = rng.integers(0, 2, n).astype(np.float64)
    return t


def _assert_same(table: dict, df: pd.DataFrame):
    assert list(table) == list(df.columns)
    for c in df.columns:
        want = df[c].to_numpy()
        got = table[c]
        assert got.dtype == want.dtype, c
        assert np.array_equal(got, want), c


@pytest.mark.parametrize("rgb", [True, False])
def test_ply_written_by_port_reads_identically_in_both(tmp_path, rgb):
    table = _table(rgb=rgb)
    path = str(tmp_path / "a.ply")
    t_ply.write_ply(path, table)
    _assert_same(t_ply.read_ply(path), j_ply.read_ply(path))
    back = t_ply.read_ply(path)
    for c, v in table.items():
        assert np.array_equal(back[c], np.asarray(v, back[c].dtype)), c


@pytest.mark.parametrize("rgb", [True, False])
def test_ply_written_by_jax_reads_identically_and_rewrites_same_bytes(
        tmp_path, rgb):
    df = pd.DataFrame(_table(rgb=rgb))
    jpath, tpath = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    j_ply.write_ply(jpath, df)
    table = t_ply.read_ply(jpath)
    _assert_same(table, j_ply.read_ply(jpath))
    t_ply.write_ply(tpath, table)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()


def _write_raw_ply(path, fmt, names, types, rows):
    header = ["ply", f"format {fmt} 1.0", f"element vertex {len(rows)}"]
    header += [f"property {t} {n}" for n, t in zip(names, types)]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if fmt == "ascii":
            for r in rows:
                f.write((" ".join(repr(float(v)) for v in r) + "\n").encode())
        else:
            endian = ">" if fmt == "binary_big_endian" else "<"
            np_t = {"float": "f4", "double": "f8", "uchar": "u1",
                    "int": "i4", "ushort": "u2"}
            rec = np.empty(len(rows), dtype=[
                (n, endian + np_t[t]) for n, t in zip(names, types)])
            for i, n in enumerate(names):
                rec[n] = [r[i] for r in rows]
            rec.tofile(f)


@pytest.mark.parametrize(
    "fmt", ["ascii", "binary_little_endian", "binary_big_endian"])
def test_ply_formats_read_as_the_jax_package_reads_them(tmp_path, fmt):
    rng = np.random.default_rng(3)
    names = ["x", "y", "z", "intensity", "red", "class"]
    types = ["double", "double", "float", "ushort", "uchar", "int"]
    rows = [[rng.normal(), rng.normal(), float(np.float32(rng.normal())),
             int(rng.integers(0, 60000)), int(rng.integers(0, 255)),
             int(rng.integers(-5, 5))] for _ in range(40)]
    path = str(tmp_path / "f.ply")
    _write_raw_ply(path, fmt, names, types, rows)
    got, want = t_ply.read_ply(path), j_ply.read_ply(path)
    assert list(got) == list(want.columns)
    for c in want.columns:
        assert np.array_equal(got[c], want[c].to_numpy()), c
        assert got[c].dtype.isnative


def test_ply_meshes_and_list_properties_are_rejected(tmp_path):
    mesh = tmp_path / "mesh.ply"
    mesh.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 1\n"
                     b"property float x\nelement face 1\n"
                     b"property list uchar int vertex_indices\nend_header\n")
    with pytest.raises(ValueError, match="mesh"):
        t_ply.read_ply(str(mesh))
    lst = tmp_path / "list.ply"
    lst.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 1\n"
                    b"property list uchar int idx\nend_header\n")
    with pytest.raises(ValueError, match="list"):
        t_ply.read_ply(str(lst))


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_round_trips_both_ways(tmp_path, binary):
    rng = np.random.default_rng(5)
    n = 100
    table = {"x": rng.normal(size=n), "y": rng.normal(size=n),
             "z": rng.normal(size=n), "scalar_intensity": rng.normal(size=n)}
    tpath, jpath = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    t_pcd.write_pcd(table, tpath, binary=binary)
    j_pcd.write_pcd(pd.DataFrame(table), jpath, binary=binary)
    with open(tpath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    _assert_same(t_pcd.read_pcd(tpath), j_pcd.read_pcd(tpath))


def test_load_file_matches_and_rejects_las(tmp_path):
    path = str(tmp_path / "c.ply")
    t_ply.write_ply(path, _table())
    got, got_h = t_loader.load_file(path, additional_headers=True)
    want, want_h = j_loader.load_file(path, additional_headers=True)
    assert got_h == want_h
    _assert_same(got, want)
    # .las is read now (tests/test_torch_las.py); compressed LAZ is not
    with pytest.raises(RuntimeError, match="LASzip"):
        t_loader.load_file(str(tmp_path / "c.laz"))
    with pytest.raises(ValueError, match="not recognised"):
        t_loader.load_file(str(tmp_path / "c.xyz"))


def test_save_file_ply_and_csv_match_the_jax_package(tmp_path):
    table = _table(rgb=False)
    table["reflectance"] = table.pop("scalar_Refl").astype(np.float64)
    fields = ["reflectance", "truth"]
    t_loader.save_file(str(tmp_path / "t.ply"), table, additional_fields=fields)
    j_loader.save_file(str(tmp_path / "j.ply"), pd.DataFrame(table),
                       additional_fields=fields)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    t_loader.save_file(str(tmp_path / "t.csv"), table)
    j_loader.save_file(str(tmp_path / "j.csv"), pd.DataFrame(table))
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "t.csv"),
                                  np.loadtxt(tmp_path / "j.csv"))


# the verify skill's probes: scalar_ prefixes, refl/intensity renames,
# stale prediction columns, injected reflectance, duplicates
_PROBES = {
    "scalar_refl": {"X": 0, "Y": 1, "Z": 2, "scalar_Refl": 3, "scalar_extra": 4},
    "intensity": {"x": 0, "y": 1, "z": 2, "Intensity": 3},
    "stale_predictions": {"x": 0, "y": 1, "z": 2, "scalar_Refl": 3, "n_z": 4,
                          "label": 5, "pwood": 6, "pleaf": 7},
    "injected": {"x": 0, "y": 1, "z": 2, "other": 3},
    "duplicates": {"x": 0, "y": 1, "z": 2, "refl": 3, "intensity": 4,
                   "truth": 5},
    "reflectance_late": {"x": 0, "y": 1, "z": 2, "a": 3, "b": 4,
                         "Reflectance": 5},
}


@pytest.mark.parametrize("mode", ["predict", "train"])
@pytest.mark.parametrize("probe", sorted(_PROBES))
def test_canonicalize_columns_matches_the_jax_package(probe, mode):
    rng = np.random.default_rng(11)
    table = {name: rng.normal(size=20) + 10 * i
             for name, i in _PROBES[probe].items()}
    got, got_h, got_r = t_loader.canonicalize_columns(dict(table), mode=mode)
    want, want_h, want_r = j_loader.canonicalize_columns(
        pd.DataFrame(table), mode=mode)
    assert got_h == want_h
    assert got_r == want_r
    _assert_same(got, want)
