"""Euclidean clustering (connected components under a distance tolerance),
port of pointstowood_tpu/tools/clustering.py on column tables.

Reimplements the reference EuclideanCluster
(reference: pointstowood/src/euclidean_clustering.py:7-47 and the
multiprocessing variant utils/euclidean_clustering_optim.py): BFS region
growing over fixed-radius neighborhoods, keeping clusters whose size falls
in [min_size, max_size], as one connected-components pass over the radius
graph (scipy sparse), which is exact.

Run: python -m pointstowood_tpu_torch.tools.clustering cloud.ply
     --tolerance 0.05
"""

from __future__ import annotations

import argparse

import numpy as np

from pointstowood_tpu_torch.data.tiling import xyz_of
from pointstowood_tpu_torch.io import extra_columns, load_file, save_file


def euclidean_cluster(
    xyz: np.ndarray,
    tolerance: float,
    min_size: int = 1,
    max_size: int | None = None,
) -> np.ndarray:
    """Cluster ids per point (-1 for points in out-of-range clusters),
    numbered in order of first appearance.

    Equivalent to BFS region growing with ``tolerance``: two points are in
    the same cluster iff connected by a chain of hops each <= tolerance.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    n = xyz.shape[0]
    pairs = cKDTree(xyz).query_pairs(tolerance, output_type="ndarray")
    graph = coo_matrix((np.ones(len(pairs), np.int8),
                        (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    _, labels = connected_components(graph, directed=False)
    sizes = np.bincount(labels)
    ok = sizes >= min_size
    if max_size is not None:
        ok &= sizes <= max_size
    # compact ids, kept components numbered by their first point
    _, first = np.unique(labels, return_index=True)
    kept = np.flatnonzero(ok)
    new_id = np.full(len(sizes), -1, np.int64)
    new_id[kept[np.argsort(first[kept])]] = np.arange(len(kept))
    return new_id[labels]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("point_cloud")
    p.add_argument("--tolerance", type=float, default=0.05)
    p.add_argument("--min_size", type=int, default=1)
    p.add_argument("--max_size", type=int, default=None)
    p.add_argument("--odir", type=str, default=None, help="output file path")
    args = p.parse_args(argv)

    pc = load_file(args.point_cloud)
    labels = euclidean_cluster(
        xyz_of(pc), args.tolerance, args.min_size, args.max_size
    )
    pc["cluster"] = labels.astype(float)
    out = args.odir or args.point_cloud.replace(".ply", "_clustered.ply")
    save_file(out, pc, additional_fields=extra_columns(pc))
    print(f"{labels.max() + 1} clusters -> {out}")


if __name__ == "__main__":
    main()
