"""Post-segmentation tree instance extraction (port of
pointstowood_tpu/tools/instance.py on column tables, with the port's own
HDBSCAN, ``tools/hdbscan.py``, in place of sklearn's: the same labels, so
the same instances).

Faithful rebuild of the archived instance pipeline
(reference: pointstowood/archive/instance_all.py, 507 LoC):

1. voxel-downsample the wood-classified points (``resolution``), slice
   into ``slice_thickness`` height bands and HDBSCAN(min_cluster_size=3)
   each band in 3-D (instance_all.py:256-275; an HDBSCAN with sklearn's
   labels replaces fast_hdbscan — same algorithm, different
   implementation);
2. reduce each cluster to its CONVEX-HULL vertices — the reference's
   ``cube()`` skeletonisation (instance_all.py:87-95) — and summarise each
   cluster by its member median (the skeleton, :287-289);
3. find stem (DBH) clusters: points inside the
   [find_stems_height, +find_stems_thickness) band with pwood > 0.66,
   HDBSCAN over x/y (:293-303). The reference then compares the xy-group
   ordinals against skeleton cluster ids (``cclstr`` vs ``clstr``,
   :302-303) — an index-space mix-up that marks arbitrary clusters; here
   the evident intent is implemented instead: the slice-clusters that
   CONTAIN the DBH-band points become the stem seeds (deviation
   documented, not replicated);
4. build the wood path graph over HULL points (kNN k=128), keep the
   minimum inter-cluster distance per (source, target) pair, drop edges
   longer than ``graph_edge_length``, and run multi-source Dijkstra from
   the stem clusters (generate_path, :48-85, :321-324). Every cluster is
   assigned the stem that reaches it first; nodes on no other cluster's
   shortest path are "tips";
5. leaf attachment via the voxel-face graph (:379-477): leaves (label 0,
   n_z >= 0.5) plus unlabelled wood (unreached clusters, n_z >= 2) are
   voxelised at ``add_leaves_voxel_length`` and each voxel contributes its
   six face points; tip hull points above ``find_stems_height`` anchor a
   second kNN graph (k=64, edges <= 1.0 m as hard-coded at :456) and
   multi-source Dijkstra assigns every reachable leaf voxel to its tip's
   tree.

Run: python -m pointstowood_tpu_torch.tools.instance segmented.ply --add-leaves
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pointstowood_tpu_torch.data.tiling import xyz_of
from pointstowood_tpu_torch.io import (
    extra_columns,
    load_file,
    n_rows,
    save_file,
    select_rows,
)
from pointstowood_tpu_torch.predict.fusion import knn_indices
from pointstowood_tpu_torch.tools.hdbscan import HDBSCAN


def _voxel_downsample(xyz: np.ndarray, length: float, rng) -> np.ndarray:
    """Random representative per occupied voxel (reference
    PointCloudDownsampler.random, instance_all.py:34-45). Returns indices."""
    cells = np.floor(xyz / length).astype(np.int64)
    # lexicographic cell key
    mins = cells.min(axis=0)
    cells = cells - mins
    extent = cells.max(axis=0) + 1
    key = (cells[:, 0] * extent[1] + cells[:, 1]) * extent[2] + cells[:, 2]
    order = np.argsort(key + rng.random(len(key)), kind="stable")
    sk = key[order]
    first = np.concatenate([[True], sk[1:] != sk[:-1]])
    return order[first]


def _hull_vertices(points: np.ndarray) -> np.ndarray:
    """Convex-hull vertex row indices; all rows for degenerate/small sets
    (reference cube(), instance_all.py:87-95)."""
    if len(points) > 5:
        try:
            from scipy.spatial import ConvexHull

            return np.asarray(ConvexHull(points).vertices, np.int64)
        except Exception:
            pass
    return np.arange(len(points), dtype=np.int64)


def _cluster_graph_paths(node_xyz, node_cluster, n_clusters, seeds,
                         n_neighbours, max_length):
    """generate_path (instance_all.py:48-85): kNN over skeleton points,
    minimum inter-cluster edge length, multi-source Dijkstra from seed
    clusters. Returns (distance, base_seed_cluster, is_tip) per cluster;
    base = -1 where unreachable."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra

    k = min(n_neighbours, len(node_xyz))
    nbr = knn_indices(node_xyz, node_xyz, k)
    src = np.repeat(node_cluster, k)
    tgt = node_cluster[nbr.ravel()]
    d = np.linalg.norm(
        node_xyz[np.repeat(np.arange(len(node_xyz)), k)]
        - node_xyz[nbr.ravel()],
        axis=1,
    )
    keep = (src != tgt) & (d <= max_length)
    src, tgt, d = src[keep], tgt[keep], d[keep]
    # min length per (source, target) pair — coo duplicate entries are
    # summed by scipy, so dedupe to the minimum explicitly
    pair = src * n_clusters + tgt
    # within equal pairs keep the minimum: sort by (pair, d)
    order2 = np.lexsort((d, pair))
    pair_s, d_s = pair[order2], d[order2]
    first = np.concatenate([[True], pair_s[1:] != pair_s[:-1]])
    pair_u, d_u = pair_s[first], d_s[first]
    rows, cols = pair_u // n_clusters, pair_u % n_clusters
    graph = coo_matrix((d_u, (rows, cols)), shape=(n_clusters, n_clusters))

    seeds = np.asarray([s for s in seeds if 0 <= s < n_clusters], np.int64)
    if len(seeds) == 0:
        return (np.full(n_clusters, np.inf),
                np.full(n_clusters, -1, np.int64),
                np.zeros(n_clusters, bool))
    dist, pred, sources = dijkstra(
        graph, directed=False, indices=seeds, min_only=True,
        return_predecessors=True,
    )
    base = np.where(np.isfinite(dist), sources, -1)
    # tips: reachable clusters that are nobody else's predecessor
    # (reference node_occurance == 1, instance_all.py:75-85)
    is_pred = np.zeros(n_clusters, bool)
    valid_pred = pred[pred >= 0]
    is_pred[valid_pred] = True
    is_tip = np.isfinite(dist) & ~is_pred
    return dist, base, is_tip


def instance_segment(
    pc: dict,
    resolution: float = 0.05,
    slice_thickness: float = 0.2,
    min_cluster_size: int = 3,
    find_stems_height: float = 1.3,
    find_stems_thickness: float = 0.5,
    graph_edge_length: float = 0.4,
    n_neighbours: int = 128,
    add_leaves_voxel_length: float = 0.5,
    leaf_edge_length: float = 1.0,
    min_points_per_tree: int = 0,
    min_height_per_tree: float = 0.0,
    seed: int = 141190,
) -> np.ndarray:
    """Per-point tree instance ids (-1 = unassigned).

    Requires ``label`` (1 = wood) and a height column (``n_z`` preferred,
    else z - min z); uses ``pwood`` for the DBH stem filter when present.
    Defaults are tuned for plot-scale TLS like the reference's
    (slice_thickness 0.1-0.2, graph_edge_length 0.2-0.4).
    """
    rng = np.random.default_rng(seed)
    n = n_rows(pc)
    instance = np.full(n, -1, np.int64)
    xyz = xyz_of(pc).astype(np.float64)
    height = (
        np.asarray(pc["n_z"], np.float64)
        if "n_z" in pc else xyz[:, 2] - xyz[:, 2].min()
    )
    pwood = (
        np.asarray(pc["pwood"], np.float64)
        if "pwood" in pc else np.ones(n)
    )
    wood_mask = np.asarray(pc["label"]) > 0
    if wood_mask.sum() < min_cluster_size:
        return instance

    # ---- 1. downsample wood + slice + HDBSCAN per band (:256-275)
    wood_idx = np.flatnonzero(wood_mask)
    ds = _voxel_downsample(xyz[wood_idx], resolution, rng)
    stem_rows = wood_idx[ds]  # rows of pc in the downsampled stem cloud
    sx = xyz[stem_rows]
    sh = height[stem_rows]
    bands = np.floor(sh / slice_thickness).astype(np.int64)

    point_cluster = np.full(len(stem_rows), -1, np.int64)
    next_cluster = 0
    for b in np.unique(bands):
        sel = np.flatnonzero(bands == b)
        if len(sel) <= 3:
            continue
        labels = HDBSCAN(
            min_cluster_size=min_cluster_size).fit_predict(sx[sel])
        pos = labels >= 0
        point_cluster[sel[pos]] = labels[pos] + next_cluster
        if pos.any():
            next_cluster += labels[pos].max() + 1
    if next_cluster == 0:
        return instance

    # ---- 2. convex-hull skeleton per cluster (:87-95, :279-286)
    hull_rows, hull_cluster = [], []
    cluster_members = [[] for _ in range(next_cluster)]
    for i, c in enumerate(point_cluster):
        if c >= 0:
            cluster_members[c].append(i)
    cluster_h = np.zeros(next_cluster)
    for c, members in enumerate(cluster_members):
        members = np.asarray(members, np.int64)
        hv = members[_hull_vertices(sx[members])]
        hull_rows.append(hv)
        hull_cluster.append(np.full(len(hv), c, np.int64))
        cluster_h[c] = np.median(sh[members])
    hull_rows = np.concatenate(hull_rows)
    hull_cluster = np.concatenate(hull_cluster)
    hull_xyz = sx[hull_rows]

    # ---- 3. DBH stem seeds (:293-303); see module docstring for the
    # deliberate fix of the reference's cclstr/clstr index mix-up
    in_band = (
        (sh >= find_stems_height)
        & (sh < find_stems_height + find_stems_thickness)
        & (pwood[stem_rows] > 0.66)
        & (point_cluster >= 0)
    )
    seed_group = np.full(next_cluster, -1, np.int64)
    if in_band.any():
        rows_band = np.flatnonzero(in_band)
        db = HDBSCAN(min_cluster_size=min_cluster_size).fit_predict(
            sx[in_band][:, :2]
        )
        ok = db >= 0
        # HDBSCAN at min_cluster_size=3 can fragment one trunk's xy ring
        # into several groups; merge groups whose centroids fall within a
        # stem diameter of each other (single-link components) so one
        # trunk yields exactly one stem
        n_g = int(db[ok].max()) + 1 if ok.any() else 0
        cents_xy = np.stack([
            np.median(sx[rows_band[ok]][db[ok] == g][:, :2], axis=0)
            for g in range(n_g)
        ]) if n_g else np.zeros((0, 2))
        merged = np.arange(n_g)

        def _root(a):
            while merged[a] != a:
                merged[a] = merged[merged[a]]
                a = merged[a]
            return a

        for gi in range(n_g):
            for gj in range(gi + 1, n_g):
                if np.linalg.norm(cents_xy[gi] - cents_xy[gj]) < 0.5:
                    merged[_root(gj)] = _root(gi)
        db_m = np.array([_root(g) for g in range(n_g)], np.int64)
        # one TREE per merged xy-group: each seed slice-cluster joins the
        # group holding most of its points
        for c in np.unique(point_cluster[rows_band[ok]]):
            gs = db_m[db[ok][point_cluster[rows_band[ok]] == c]]
            seed_group[c] = np.bincount(gs).argmax()
        seeds = np.flatnonzero(seed_group >= 0)
    else:
        # no DBH band (short trees / clipped clouds): lowest clusters
        # seed, grouped by xy proximity of their centroids
        low = np.flatnonzero(cluster_h <= np.quantile(cluster_h, 0.1))
        cents = np.stack([
            np.median(sx[np.asarray(cluster_members[c], np.int64)], axis=0)
            for c in low
        ])
        if len(low) >= 2:
            db = HDBSCAN(
                min_cluster_size=2, allow_single_cluster=True
            ).fit_predict(cents[:, :2])
            db = np.where(db >= 0, db,
                          db.max(initial=-1) + 1 + np.arange(len(db)))
        else:
            db = np.zeros(len(low), np.int64)
        seed_group[low] = db
        seeds = low
    if len(seeds) == 0:
        return instance

    # ---- 4. wood path graph + multi-source Dijkstra (:48-85, :321-332)
    dist, base, is_tip = _cluster_graph_paths(
        hull_xyz, hull_cluster, next_cluster, seeds,
        n_neighbours=n_neighbours, max_length=graph_edge_length,
    )
    # tree id = the xy-group of the seed that reached the cluster first
    groups_used = sorted({
        int(seed_group[b]) for b in base if b >= 0 and seed_group[b] >= 0
    })
    gmap = {g: t for t, g in enumerate(groups_used)}
    cluster_tree = np.array([
        gmap.get(int(seed_group[b]), -1) if b >= 0 else -1 for b in base
    ], np.int64)

    # point-level assignment for ALL wood points: each original wood point
    # takes the cluster of its nearest downsampled stem point
    clustered = point_cluster >= 0
    stem_tree = np.where(clustered, cluster_tree[point_cluster], -1)
    nn = knn_indices(sx, xyz[wood_idx], 1)[:, 0]
    wood_instance = stem_tree[nn]
    instance[wood_idx] = wood_instance

    # per-tree filters (:352-355), over the tree ids 0 .. len(gmap) - 1
    # (the JAX tool names an undefined ``tree_ids`` here and raises)
    if min_points_per_tree > 0 or min_height_per_tree > 0:
        for t in range(len(gmap)):
            rows = np.flatnonzero(instance == t)
            if (len(rows) <= min_points_per_tree
                    or (len(rows)
                        and height[rows].max() <= min_height_per_tree)):
                instance[rows] = -1

    # ---- 5. leaf attachment via the voxel-face graph (:379-477)
    leaf_sel = (~wood_mask) & (height >= 0.5)
    # unlabelled wood (clusters no stem reached) joins the leaf pool (:389-392)
    unreached = instance < 0
    leaf_sel |= wood_mask & unreached & (height >= 2.0)
    leaf_idx = np.flatnonzero(leaf_sel)
    tip_sel = is_tip[hull_cluster] & (sh[hull_rows] > find_stems_height) & (
        cluster_tree[hull_cluster] >= 0
    )
    if len(leaf_idx) and tip_sel.any():
        ds_l = _voxel_downsample(xyz[leaf_idx], resolution, rng)
        lv_rows = leaf_idx[ds_l]
        lx = xyz[lv_rows]
        # voxelise + six face points per voxel (:415-436)
        cells = np.floor(lx / add_leaves_voxel_length).astype(np.int64)
        cells -= cells.min(axis=0)
        ext = cells.max(axis=0) + 1
        vx = (cells[:, 0] * ext[1] + cells[:, 1]) * ext[2] + cells[:, 2]
        uniq, inv = np.unique(vx, return_inverse=True)
        n_vox = len(uniq)
        vmin = np.full((n_vox, 3), np.inf)
        vmax = np.full((n_vox, 3), -np.inf)
        np.minimum.at(vmin, inv, lx)
        np.maximum.at(vmax, inv, lx)
        vmed = (vmin + vmax) / 2  # median proxy over axis extents
        faces = []
        for axis in range(3):
            lo = vmed.copy(); lo[:, axis] = vmin[:, axis]
            hi = vmed.copy(); hi[:, axis] = vmax[:, axis]
            faces += [lo, hi]
        face_xyz = np.concatenate(faces)              # (6*n_vox, 3)
        face_vox = np.tile(np.arange(n_vox), 6)

        tips_xyz = hull_xyz[tip_sel]
        tips_tree = cluster_tree[hull_cluster[tip_sel]]
        # combined node set: voxel ids [0, n_vox), tips as single-node
        # clusters [n_vox, n_vox + n_tips)
        node_xyz = np.concatenate([face_xyz, tips_xyz])
        node_cluster = np.concatenate(
            [face_vox, n_vox + np.arange(len(tips_xyz))]
        )
        _, lbase, _ = _cluster_graph_paths(
            node_xyz, node_cluster, n_vox + len(tips_xyz),
            seeds=n_vox + np.arange(len(tips_xyz)),
            n_neighbours=min(64, len(node_xyz)),
            max_length=leaf_edge_length,
        )
        vox_tree = np.full(n_vox, -1, np.int64)
        reached = lbase[:n_vox] >= n_vox
        vox_tree[reached] = tips_tree[lbase[:n_vox][reached] - n_vox]
        # voxel assignment back to every pooled leaf point via its voxel,
        # then to the full-resolution pool by nearest downsampled point
        lv_tree = vox_tree[inv]
        nn_l = knn_indices(lx, xyz[leaf_idx], 1)[:, 0]
        instance[leaf_idx] = np.where(
            lv_tree[nn_l] >= 0, lv_tree[nn_l], instance[leaf_idx]
        )
    return instance


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("point_cloud", help="segmented cloud with a label column")
    p.add_argument("--resolution", type=float, default=0.05)
    p.add_argument("--slice_thickness", type=float, default=0.2)
    p.add_argument("--min_cluster_size", type=int, default=3)
    p.add_argument("--find_stems_height", type=float, default=1.3)
    p.add_argument("--find_stems_thickness", type=float, default=0.5)
    p.add_argument("--graph_edge_length", type=float, default=0.4)
    p.add_argument("--add_leaves_voxel_length", type=float, default=0.5)
    p.add_argument("--min_points_per_tree", type=int, default=0)
    p.add_argument("--min_height_per_tree", type=float, default=0.0)
    p.add_argument("--per-tree", action="store_true",
                   help="also write one PLY per extracted tree")
    args = p.parse_args(argv)

    pc = load_file(args.point_cloud)
    instance = instance_segment(
        pc, resolution=args.resolution,
        slice_thickness=args.slice_thickness,
        min_cluster_size=args.min_cluster_size,
        find_stems_height=args.find_stems_height,
        find_stems_thickness=args.find_stems_thickness,
        graph_edge_length=args.graph_edge_length,
        add_leaves_voxel_length=args.add_leaves_voxel_length,
        min_points_per_tree=args.min_points_per_tree,
        min_height_per_tree=args.min_height_per_tree,
    )
    pc["instance"] = instance.astype(float)
    out = args.point_cloud.replace(".ply", "_instance.ply")
    extras = extra_columns(pc)
    save_file(out, pc, additional_fields=extras)
    n_trees = int(instance.max()) + 1
    print(f"{n_trees} trees -> {out}")
    if getattr(args, "per_tree"):
        base = os.path.splitext(out)[0]
        for t in range(n_trees):
            tree_pc = select_rows(pc, pc["instance"] == t)
            save_file(f"{base}_T{t}.ply", tree_pc, additional_fields=extras)
        print(f"wrote {n_trees} per-tree files")


if __name__ == "__main__":
    main()
