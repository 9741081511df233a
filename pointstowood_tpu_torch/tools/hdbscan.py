"""HDBSCAN in numpy, for ``tools/instance.py`` (the JAX tool calls
``sklearn.cluster.HDBSCAN``; the card's machine has no sklearn).

It follows sklearn's algorithm step by step (``sklearn/cluster/_hdbscan``:
``hdbscan.py``, ``_linkage.pyx``, ``_tree.pyx``), so that
``HDBSCAN(min_cluster_size=m, allow_single_cluster=a).fit_predict(X)``
gives sklearn's labels, numbering included, for the Euclidean metric with
the default EOM selection:

1. core distance: the distance to the ``min_samples``-th nearest point,
   the point itself included (``min_samples`` defaults to
   ``min_cluster_size``);
2. the minimum spanning tree of the mutual reachability distance
   max(core_a, core_b, d(a, b)) by Prim's algorithm from point 0, with
   sklearn's order of visits and choice among equal edges
   (``mst_from_data_matrix``);
3. the edges sorted by ``np.argsort`` (as ``_process_mst``; that order
   decides merges at equal weights), then the single-linkage tree;
4. the condensed tree at ``min_cluster_size``, the clusters' stabilities,
   and the excess-of-mass selection, the root allowed where
   ``allow_single_cluster``;
5. labels: the selected clusters numbered in ascending order of their
   condensed-tree ids, -1 for noise.

Distances are computed as sklearn's: the squared coordinate differences
summed in feature order, then the square root, in float64. Prim's
algorithm takes O(n^2) time and O(n) memory.
"""

from __future__ import annotations

import numpy as np


def _distances(x: np.ndarray, row: np.ndarray) -> np.ndarray:
    """Euclidean distance of each row of ``x`` from ``row``, summed in
    feature order."""
    diff = x - row
    total = diff[:, 0] * diff[:, 0]
    for f in range(1, x.shape[1]):
        total = total + diff[:, f] * diff[:, f]
    return np.sqrt(total)


def core_distances(x: np.ndarray, min_samples: int,
                   block: int = 256) -> np.ndarray:
    """Distance of each point to its ``min_samples``-th nearest point,
    itself included (brute force, ``block`` rows at a time)."""
    n = x.shape[0]
    out = np.empty(n)
    for start in range(0, n, block):
        rows = x[start:start + block]
        diff = rows[:, None, :] - x[None, :, :]
        total = diff[..., 0] * diff[..., 0]
        for f in range(1, x.shape[1]):
            total = total + diff[..., f] * diff[..., f]
        d = np.sqrt(total)
        out[start:start + len(rows)] = np.partition(
            d, min_samples - 1, axis=1)[:, min_samples - 1]
    return out


def minimum_spanning_tree(x: np.ndarray, core: np.ndarray):
    """(source, target, weight) of the mutual-reachability MST in the
    order Prim's algorithm adds the edges: from point 0, each step joins
    the outside point of least reachability, the lowest index among
    equals, by the edge that last lowered that reachability."""
    n = x.shape[0]
    in_tree = np.zeros(n, bool)
    reach = np.full(n, np.inf)
    source = np.ones(n, np.int64)
    src = np.empty(n - 1, np.int64)
    dst = np.empty(n - 1, np.int64)
    weight = np.empty(n - 1)
    current = 0
    for i in range(n - 1):
        in_tree[current] = True
        rest = np.flatnonzero(~in_tree)
        mutual = np.maximum(np.maximum(core[current], core[rest]),
                            _distances(x[rest], x[current]))
        lower = mutual < reach[rest]
        reach[rest[lower]] = mutual[lower]
        source[rest[lower]] = current
        j = int(np.argmin(reach[rest]))
        current = int(rest[j])
        src[i], dst[i], weight[i] = source[current], current, reach[current]
    return src, dst, weight


def single_linkage(src, dst, weight):
    """scipy-style linkage rows (left, right, distance, size) of the MST
    edges in order of ``np.argsort`` of their weights (sklearn's
    ``_process_mst`` and ``make_single_linkage``). Clusters are numbered
    n, n + 1, ... in merge order."""
    order = np.argsort(weight)
    n = len(src) + 1
    parent = np.full(2 * n - 1, -1, np.int64)
    size = np.concatenate([np.ones(n, np.int64), np.zeros(n - 1, np.int64)])

    def find(a):
        root = a
        while parent[root] != -1:
            root = parent[root]
        while parent[a] != -1 and parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    rows = []
    for i, e in enumerate(order):
        a, b = find(int(src[e])), find(int(dst[e]))
        rows.append((a, b, float(weight[e]), int(size[a] + size[b])))
        parent[a] = parent[b] = n + i
        size[n + i] = size[a] + size[b]
    return rows


def _bfs(hierarchy, root: int, n: int) -> list:
    """Nodes of the linkage subtree under ``root``, breadth first
    (sklearn's ``bfs_from_hierarchy``)."""
    out, queue = [], [root]
    while queue:
        out.extend(queue)
        queue = [c for x in queue if x >= n
                 for c in hierarchy[x - n][:2]]
    return out


def condense_tree(hierarchy, min_cluster_size: int) -> list:
    """(parent, child, lambda, size) rows of the condensed tree (sklearn's
    ``_condense_tree``): a split is kept where both sides hold at least
    ``min_cluster_size`` points, else the smaller side's points leave
    their cluster at lambda = 1 / distance."""
    n = len(hierarchy) + 1
    root = 2 * len(hierarchy)
    relabel = np.empty(root + 1, np.int64)
    relabel[root] = n
    next_label = n + 1
    ignore = np.zeros(root + 1, bool)
    out = []

    def size(node):
        return hierarchy[node - n][3] if node >= n else 1

    def leave(parent, node, lam):
        for sub in _bfs(hierarchy, node, n):
            if sub < n:
                out.append((parent, sub, lam, 1))
            ignore[sub] = True

    for node in _bfs(hierarchy, root, n):
        if ignore[node] or node < n:
            continue
        left, right, distance, _ = hierarchy[node - n]
        lam = 1.0 / distance if distance > 0.0 else np.inf
        big_left = size(left) >= min_cluster_size
        big_right = size(right) >= min_cluster_size
        here = int(relabel[node])
        if big_left and big_right:
            for child in (left, right):
                relabel[child] = next_label
                next_label += 1
                out.append((here, int(relabel[child]), lam, size(child)))
        elif not big_left and not big_right:
            leave(here, left, lam)
            leave(here, right, lam)
        elif not big_left:
            relabel[right] = here
            leave(here, left, lam)
        else:
            relabel[left] = here
            leave(here, right, lam)
    return out


def _stability(tree: list) -> dict:
    """Each cluster's sum of (lambda - its birth lambda) * size over its
    rows, accumulated in row order (sklearn's ``_compute_stability``)."""
    root = min(r[0] for r in tree)
    births = {r[1]: r[2] for r in tree}
    births[root] = 0.0
    stability = {c: 0.0 for c in range(root, max(r[0] for r in tree) + 1)}
    for parent, _, lam, size in tree:
        stability[parent] += (lam - births[parent]) * size
    return stability


class _TreeUnionFind:
    """sklearn's ``TreeUnionFind``: union by rank, path compression."""

    def __init__(self, size):
        self.parent = list(range(size))
        self.rank = [0] * size

    def union(self, x, y):
        x, y = self.find(x), self.find(y)
        if self.rank[x] < self.rank[y]:
            self.parent[x] = y
        elif self.rank[x] > self.rank[y]:
            self.parent[y] = x
        else:
            self.parent[y] = x
            self.rank[x] += 1

    def find(self, x):
        path = []
        while self.parent[x] != x:
            path.append(x)
            x = self.parent[x]
        for p in path:
            self.parent[p] = x
        return x


def select_labels(tree: list, allow_single_cluster: bool) -> np.ndarray:
    """Excess-of-mass selection and point labels (sklearn's
    ``_get_clusters`` and ``_do_labelling`` without an epsilon or a size
    cap)."""
    stability = _stability(tree)
    nodes = sorted(stability, reverse=True)
    if not allow_single_cluster:
        nodes = nodes[:-1]
    cluster_rows = [r for r in tree if r[3] > 1]
    children = {}
    for parent, child, _, _ in cluster_rows:
        children.setdefault(parent, []).append(child)
    is_cluster = {c: True for c in nodes}
    for node in nodes:
        subtree = float(np.sum([stability[c] for c in children.get(node, [])]))
        if subtree > stability[node]:
            is_cluster[node] = False
            stability[node] = subtree
        else:
            queue = list(children.get(node, []))
            while queue:
                is_cluster[queue[0]] = False
                queue = queue[1:] + children.get(queue[0], [])
    clusters = sorted(c for c in is_cluster if is_cluster[c])
    number = {c: i for i, c in enumerate(clusters)}

    root = min(r[0] for r in tree)
    uf = _TreeUnionFind(max(r[0] for r in tree) + 1)
    for parent, child, _, _ in tree:
        if child not in number:
            uf.union(parent, child)
    labels = np.full(root, -1, np.int64)
    if allow_single_cluster and len(clusters) == 1:
        lam_of = {child: lam for _, child, lam, _ in tree}
        threshold = max(lam for parent, _, lam, _ in tree if parent == root)
    for point in range(root):
        cluster = uf.find(point)
        if cluster != root:
            labels[point] = number[cluster]
        elif allow_single_cluster and len(clusters) == 1:
            if lam_of[point] >= threshold:
                labels[point] = number[cluster]
    return labels


class HDBSCAN:
    """``sklearn.cluster.HDBSCAN``'s labels for Euclidean data (see the
    module docstring); ``fit_predict`` as sklearn's."""

    def __init__(self, min_cluster_size: int = 5, min_samples=None,
                 allow_single_cluster: bool = False):
        self.min_cluster_size = min_cluster_size
        self.min_samples = min_samples
        self.allow_single_cluster = allow_single_cluster

    def fit_predict(self, x) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float64)
        if x.shape[0] == 1:
            raise ValueError(
                "n_samples=1 while HDBSCAN requires more than one sample")
        min_samples = (self.min_cluster_size if self.min_samples is None
                       else self.min_samples)
        if min_samples > x.shape[0]:
            raise ValueError(
                f"min_samples ({min_samples}) must be at most the number of"
                f" samples in X ({x.shape[0]})")
        mst = minimum_spanning_tree(x, core_distances(x, min_samples))
        tree = condense_tree(single_linkage(*mst), self.min_cluster_size)
        self.labels_ = select_labels(tree, self.allow_single_cluster)
        return self.labels_
