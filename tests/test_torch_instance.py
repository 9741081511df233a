"""The port's instance segmentation (pointstowood_tpu_torch.tools.instance,
with its own HDBSCAN) against the JAX tool (sklearn's HDBSCAN) on the CPU:
tests/test_instance.py's three scenes, the fallback without a DBH band
(HDBSCAN over centroids with ``allow_single_cluster``), and the per-tree
filters. The port's instance ids equal JAX's up to a permutation (the
HDBSCAN labels are sklearn's, so in fact the same ids)."""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from pointstowood_tpu.tools.instance import instance_segment as j_instance
from pointstowood_tpu_torch.io import read_ply, write_ply
from pointstowood_tpu_torch.tools import instance


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _trees(rng, centres, n_wood, n_leaf, height, crown_z, spread, depth):
    """tests/test_instance.py's trunk-and-crown trees, one frame each."""
    frames, truth = [], []
    for ti, (cx, cy) in enumerate(centres):
        theta = rng.uniform(0, 2 * np.pi, n_wood)
        r = rng.uniform(0, 0.15, n_wood)
        trunk = np.stack([cx + r * np.cos(theta), cy + r * np.sin(theta),
                          rng.uniform(0, height, n_wood)], 1)
        crown = np.stack([cx + rng.normal(0, spread, n_leaf),
                          cy + rng.normal(0, spread, n_leaf),
                          crown_z + rng.normal(0, depth, n_leaf)], 1)
        xyz = np.concatenate([trunk, crown])
        label = np.concatenate([np.ones(n_wood), np.zeros(n_leaf)])
        frames.append(pd.DataFrame(
            {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2], "label": label,
             "n_z": xyz[:, 2]}))
        truth.append(np.full(len(xyz), ti))
    return pd.concat(frames, ignore_index=True), np.concatenate(truth)


def _scene(name):
    rng = np.random.default_rng(141190)
    if name == "two_trees":
        return _trees(rng, [(0.0, 0.0), (8.0, 0.0)], 1200, 800, 8, 6, 1.0,
                      0.8)
    if name == "nine_trees":
        return _trees(rng, [((t % 3) * 6.0, (t // 3) * 6.0) for t in range(9)],
                      700, 500, 7, 5.5, 0.9, 0.7)
    if name == "no_wood":
        pc = pd.DataFrame(
            {"x": rng.uniform(0, 5, 100), "y": rng.uniform(0, 5, 100),
             "z": rng.uniform(0, 5, 100), "label": np.zeros(100),
             "n_z": rng.uniform(0, 5, 100)})
        return pc, np.zeros(100, int)
    if name == "pwood_and_no_n_z":
        pc, truth = _trees(rng, [(0.0, 0.0), (5.0, 1.0), (1.0, 6.0)], 600,
                           400, 6, 4.5, 0.8, 0.6)
        pc["pwood"] = np.clip(pc["label"] * 0.8 + rng.normal(0, 0.15,
                                                             len(pc)), 0, 1)
        return pc.drop(columns="n_z"), truth
    raise ValueError(name)


def _same_up_to_permutation(a, b):
    """One-to-one map between the ids of a and of b, -1 to -1."""
    pairs = set(zip(a.tolist(), b.tolist()))
    one_to_one = (len({p[0] for p in pairs}) == len(pairs)
                  == len({p[1] for p in pairs}))
    return one_to_one and all((x == -1) == (y == -1) for x, y in pairs)


def _both(pc, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn's `copy` FutureWarning
        want = j_instance(pc, **kw)
    got = instance.instance_segment({c: pc[c].to_numpy() for c in pc.columns},
                                    **kw)
    return got, want


@pytest.mark.parametrize("name, kw", [
    ("two_trees", {}),
    ("nine_trees", {}),
    ("no_wood", {}),
    ("pwood_and_no_n_z", {}),
    # no point in the DBH band: the lowest clusters seed, grouped by an
    # HDBSCAN(min_cluster_size=2, allow_single_cluster=True) of centroids
    ("two_trees", dict(find_stems_height=50.0)),
    ("nine_trees", dict(find_stems_height=50.0, slice_thickness=0.3)),
])
def test_instances_equal_jax(name, kw):
    pc, _ = _scene(name)
    got, want = _both(pc, **kw)
    assert got.dtype == want.dtype == np.int64
    assert _same_up_to_permutation(got, want)
    assert np.array_equal(got, want)


def test_two_trees_separate_instances():
    pc, _ = _scene("two_trees")
    inst, _ = _both(pc)
    per_tree = len(pc) // 2
    wood = pc["label"].to_numpy() > 0
    w0, w1 = inst[:per_tree][wood[:per_tree]], inst[per_tree:][wood[per_tree:]]
    m0 = np.bincount(w0[w0 >= 0]).argmax()
    m1 = np.bincount(w1[w1 >= 0]).argmax()
    assert m0 != m1
    assert (w0 == m0).mean() > 0.9 and (w1 == m1).mean() > 0.9
    l0 = inst[:per_tree][~wood[:per_tree]]
    assert (l0[l0 >= 0] == m0).mean() > 0.9


def test_nine_tree_plot_counts_and_assignment():
    pc, truth = _scene("nine_trees")
    inst, _ = _both(pc)
    wood = pc["label"].to_numpy() > 0
    assigned = inst >= 0
    assert len(np.unique(inst[assigned])) == 9
    seen = set()
    for ti in range(9):
        vals, cnts = np.unique(inst[wood & (truth == ti) & assigned],
                               return_counts=True)
        assert cnts.max() / cnts.sum() > 0.95
        assert vals[cnts.argmax()] not in seen
        seen.add(vals[cnts.argmax()])


def test_no_wood_is_unassigned():
    pc, _ = _scene("no_wood")
    inst, _ = _both(pc)
    assert (inst == -1).all()


def test_per_tree_filters():
    """The JAX tool's filter loop names an undefined ``tree_ids`` and
    raises NameError; the port filters each tree as its docstring says.
    The filter runs on the wood points, before the leaves attach: the wood
    of a tree with at most ``min_points_per_tree`` wood points, or no
    higher than ``min_height_per_tree``, is unassigned (below 2 m; wood
    above joins the leaf pool, as unreached wood does), the other trees'
    wood is kept."""
    pc, _ = _scene("nine_trees")
    table = {c: pc[c].to_numpy() for c in pc.columns}
    wood = table["label"] > 0
    low = wood & (table["n_z"] < 2.0)
    plain = instance.instance_segment(table)
    counts = np.bincount(plain[wood & (plain >= 0)])
    cut = int(np.sort(counts)[3])  # the four smallest trees go
    small = np.isin(plain, np.flatnonzero(counts <= cut))
    filtered = instance.instance_segment(table, min_points_per_tree=cut)
    assert np.unique(plain[small & wood]).size >= 4
    assert (filtered[small & low] == -1).all()
    keep = wood & (plain >= 0) & ~small
    assert np.array_equal(filtered[keep], plain[keep])
    tall = instance.instance_segment(table, min_height_per_tree=100.0)
    assert (tall[low] == -1).all()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(NameError):
            j_instance(pc, min_points_per_tree=cut)


def test_instance_cli_writes_the_column_and_trees(tmp_path, capsys):
    pc, _ = _scene("two_trees")
    path = str(tmp_path / "seg.ply")
    write_ply(path, {c: pc[c].to_numpy() for c in pc.columns})
    instance.main([path, "--per-tree"])
    out = read_ply(str(tmp_path / "seg_instance.ply"))
    assert list(out) == ["x", "y", "z", "label", "n_z", "instance"]
    got, _ = _both(pc)
    assert np.array_equal(out["instance"], got.astype(float))
    assert "2 trees" in capsys.readouterr().out
    for t in range(2):
        tree = read_ply(str(tmp_path / f"seg_instance_T{t}.ply"))
        assert len(tree["x"]) == int((got == t).sum())
