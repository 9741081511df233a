"""Path-length computation: graph distance from the lowest (root) point
(port of pointstowood_tpu/tools/pathlength.py on column tables; the same
numpy/scipy arithmetic, so the same distances bit for bit).

Reimplements the reference's shortest-path tooling
(reference: pointstowood/utils/shortest_path.py:6-265 and
utils/pathlength-batch.py): build a graph over the cloud rooted at the
lowest point, run single-source shortest paths, and attach the distance as
a ``pathlength`` attribute used for path-length-weighted accuracy
(comparetofsct.py:105-106).

Two graph constructions:

* ``method='knn'`` (default): plain symmetric kNN graph + scipy Dijkstra —
  orders of magnitude faster than the reference's networkx at plot scale,
  with denser connectivity (a strict superset of grown-graph edges when
  knn covers the same neighbors).
* ``method='grown'``: the reference's exact grown-graph semantics
  (utils/shortest_path.py:6-192 array_to_graph + :241-266 add_nodes): BFS
  growth from the root adding kpairs+1 unprocessed neighbors per frontier
  point, with the gap-bridging reconnect phase (threshold grows by
  nbrs_threshold_step until every point joins). Shortest paths still run
  on scipy (same distances as networkx Dijkstra, reference
  extract_path_info :195-239).

The reference batch script (utils/pathlength-batch.py — not runnable as
shipped: it imports ``downsample``/``inout`` modules absent from the repo)
voxel-downsamples to 5 cm before growing the graph and broadcasts each
representative's distance to its cell members; ``--downsample`` reproduces
that flow (representative = first point per cell; the reference's exact
representative rule lives in the missing module).

Run: python -m pointstowood_tpu_torch.tools.pathlength cloud.ply --knn 8
     python -m pointstowood_tpu_torch.tools.pathlength cloud.ply \
         --method grown --downsample 0.05
"""

from __future__ import annotations

import argparse

import numpy as np

from pointstowood_tpu_torch.data.tiling import xyz_of
from pointstowood_tpu_torch.io import extra_columns, load_file, save_file
from pointstowood_tpu_torch.ops.voxel import voxel_cell_ids_np


def grow_graph_edges(
    arr: np.ndarray,
    base_id: int,
    kpairs: int = 3,
    knn: int = 100,
    nbrs_threshold: float = 0.15,
    nbrs_threshold_step: float = 0.05,
    graph_threshold: float = np.inf,
):
    """Reference array_to_graph (utils/shortest_path.py:6-192), returning
    edge arrays (src, dst, weight) instead of a networkx object.

    Growth loop semantics preserved exactly: per frontier point, the first
    kpairs+1 not-yet-processed neighbors become edges and the next
    frontier; when the frontier dies with points left, remaining points
    whose neighborhoods touch the graph within nbrs_threshold are attached
    (both to processed neighbors and to kpairs+1 fresh ones,
    shortest_path.py:159-170), and the threshold grows by
    nbrs_threshold_step whenever that fails (:175-176). Edges longer than
    graph_threshold are dropped (add_nodes, :262-266) without affecting
    frontier membership.
    """
    from scipy.spatial import cKDTree

    n = arr.shape[0]
    k = min(knn, n)
    distances, indices = cKDTree(arr).query(arr, k=k)
    if k == 1:
        distances, indices = distances[:, None], indices[:, None]

    processed = np.zeros(n, bool)
    processed[base_id] = True
    current_idx = np.array([base_id], dtype=int)
    src_list, dst_list, w_list = [], [], []

    def add_edges(g, nn_idx, dd_idx):
        keep = dd_idx <= graph_threshold
        if keep.any():
            src_list.append(np.full(int(keep.sum()), g, dtype=np.int64))
            dst_list.append(nn_idx[keep].astype(np.int64))
            w_list.append(dd_idx[keep])

    while not processed.all():
        if len(current_idx) > 0:
            nn = indices[current_idx]
            dd = distances[current_idx]
            unproc = ~processed[nn]
            nxt = []
            for i, g in enumerate(current_idx):
                nn_idx = nn[i][unproc[i]][: kpairs + 1]
                dd_idx = dd[i][unproc[i]][: kpairs + 1]
                add_edges(g, nn_idx, dd_idx)
                nxt.append(nn_idx)
            current_idx = (
                np.unique(np.concatenate(nxt)) if nxt else
                np.array([], dtype=int)
            )
        else:
            idx = np.flatnonzero(~processed)
            idx2 = indices[idx]
            dist2 = distances[idx]
            attachable = processed[idx2] & (dist2 < nbrs_threshold)
            current_idx = idx[np.unique(np.where(attachable)[0])]
            nn = indices[current_idx]
            dd = distances[current_idx]
            unproc = ~processed[nn]
            for i, g in enumerate(current_idx):
                add_edges(g, nn[i][unproc[i]][: kpairs + 1],
                          dd[i][unproc[i]][: kpairs + 1])
                add_edges(g, nn[i][~unproc[i]][: kpairs + 1],
                          dd[i][~unproc[i]][: kpairs + 1])
            if len(current_idx) == 0:
                nbrs_threshold += nbrs_threshold_step
        processed[current_idx] = True

    if not src_list:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))
    src = np.concatenate(src_list)
    dst = np.concatenate(dst_list)
    w = np.concatenate(w_list)
    # The growth loop can re-add an edge (networkx overwrites; a sparse COO
    # matrix would SUM duplicates and corrupt the weights) — dedupe. Equal
    # pairs always carry the same distance, so keeping the first is exact.
    _, first = np.unique(src * np.int64(n) + dst, return_index=True)
    return src[first], dst[first], w[first]


def _dijkstra_from(edges, n, base_id):
    """Single-source shortest-path distances over undirected weighted edges
    (reference extract_path_info, utils/shortest_path.py:195-239 — scipy
    instead of networkx, identical distances)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra

    src, dst, w = edges
    graph = coo_matrix((w, (src, dst)), shape=(n, n))
    return dijkstra(graph, directed=False, indices=base_id)


def pathlengths(
    xyz: np.ndarray,
    knn: int = 8,
    base_location: int | None = None,
    method: str = "knn",
    kpairs: int = 3,
    nbrs_threshold: float = 0.15,
    nbrs_threshold_step: float = 0.05,
) -> np.ndarray:
    from scipy.spatial import cKDTree

    n = xyz.shape[0]
    if base_location is None:
        base_location = int(np.argmin(xyz[:, 2]))

    if method == "grown":
        edges = grow_graph_edges(
            xyz, base_location, kpairs=kpairs, knn=max(knn, 2),
            nbrs_threshold=nbrs_threshold,
            nbrs_threshold_step=nbrs_threshold_step,
        )
        d = _dijkstra_from(edges, n, base_location)
    else:
        k = min(knn, n)
        tree = cKDTree(xyz)
        dist, idx = tree.query(xyz, k=k)
        if k == 1:
            dist, idx = dist[:, None], idx[:, None]
        rows = np.repeat(np.arange(n), k)
        d = _dijkstra_from((rows, idx.ravel(), dist.ravel()), n, base_location)
    finite = np.isfinite(d)
    if not finite.all():
        # disconnected components: assign the max finite path length (the
        # grown graph attaches everything by construction; the plain kNN
        # graph may not)
        fill = d[finite].max() if finite.any() else 0.0
        d = np.where(finite, d, fill)
    return d


def pathlengths_downsampled(
    xyz: np.ndarray, voxel: float, **kwargs
) -> np.ndarray:
    """The reference batch script's flow (utils/pathlength-batch.py:36-100):
    voxel-downsample, compute path lengths on the representatives, and
    broadcast each representative's distance to its cell members."""
    ids = voxel_cell_ids_np(xyz, voxel)
    # np.unique returns (values, first_indices, inverse) in that order
    _, reps, rep_of = np.unique(ids, return_index=True, return_inverse=True)
    d_reps = pathlengths(xyz[reps], **kwargs)
    return d_reps[rep_of]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("point_cloud", nargs="+")
    p.add_argument("--knn", type=int, default=8)
    p.add_argument("--method", choices=["knn", "grown"], default="knn")
    p.add_argument("--kpairs", type=int, default=3,
                   help="grown-graph growth factor (reference: 3)")
    p.add_argument("--nbrs_threshold", type=float, default=0.15)
    p.add_argument("--nbrs_threshold_step", type=float, default=0.05)
    p.add_argument("--downsample", type=float, default=0.0,
                   help="voxel size for the reference batch script's "
                        "downsample flow (0 = off; reference used 0.05)")
    args = p.parse_args(argv)
    kwargs = dict(
        knn=args.knn if args.method == "knn" else max(args.knn, 100),
        method=args.method, kpairs=args.kpairs,
        nbrs_threshold=args.nbrs_threshold,
        nbrs_threshold_step=args.nbrs_threshold_step,
    )
    for path in args.point_cloud:
        pc = load_file(path)
        xyz = xyz_of(pc)
        if args.downsample > 0:
            pc["pathlength"] = pathlengths_downsampled(
                xyz, args.downsample, **kwargs
            )
        else:
            pc["pathlength"] = pathlengths(xyz, **kwargs)
        out = path.replace(".ply", "_pathlength.ply")
        save_file(out, pc, additional_fields=extra_columns(pc))
        print(f"Saved {out}")


if __name__ == "__main__":
    main()
