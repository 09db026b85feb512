"""HDBSCAN on the host in numpy: the algorithm of scikit-learn's
``sklearn.cluster.HDBSCAN`` (the JAX package's ``cluster/density.py``
calls it), written out so that the port needs no scikit-learn.

Steps, as scikit-learn runs them for ``alpha=1``, no ``max_cluster_size``
and no ``cluster_selection_epsilon``:

1. core distances: each point's distance to its ``min_samples``-th nearest
   point, itself included;
2. the mutual-reachability graph ``max(core_i, core_j, d_ij)`` and its
   minimum spanning tree by Prim's algorithm from point 0: for a
   precomputed distance matrix scikit-learn's dense ``_hdbscan_brute``
   walk, which records each edge from the last point added; for points the
   ``_hdbscan_prims`` walk over Euclidean distances, which records each
   edge from its true source;
3. the edges sorted by weight (``np.argsort``, as there), a single-linkage
   tree by union-find, condensed at ``min_cluster_size``;
4. the stability of each condensed cluster and the selection of the flat
   clustering (excess of mass or leaves), labels numbered in the order of
   the selected clusters' node ids, ``-1`` for noise.

Every step keeps scikit-learn's order of operations and tie-breaking
(first index of a minimum, strict comparisons), so equal inputs give equal
labels, not only an equal partition (tests hold this against scikit-learn
on the CPU).  Euclidean distances are summed over the features in order,
as its C loop sums them.
"""
from __future__ import annotations

import numpy as np


def _euclidean(x: np.ndarray) -> np.ndarray:
    """[N, D] float64 -> [N, N] Euclidean distances, each summed over the
    features in order (the rounding of scikit-learn's distance loop)."""
    acc = np.zeros((x.shape[0], x.shape[0]))
    for f in range(x.shape[1]):
        diff = x[:, None, f] - x[None, :, f]
        acc += diff * diff
    return np.sqrt(acc)


def _core_distances(dist: np.ndarray, min_samples: int) -> np.ndarray:
    return np.partition(dist, min_samples - 1, axis=1)[:, min_samples - 1]


def _mst_precomputed(mreach: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Prim's walk of a dense mutual-reachability matrix; an edge is
    recorded from the point added last."""
    n = mreach.shape[0]
    src, dst, wt = (np.empty(n - 1, np.int64), np.empty(n - 1, np.int64),
                    np.empty(n - 1))
    labels = np.arange(n)
    current = 0
    min_reach = np.full(n, np.inf)
    for i in range(n - 1):
        keep = labels != current
        labels = labels[keep]
        min_reach = np.minimum(min_reach[keep], mreach[current][labels])
        k = int(np.argmin(min_reach))
        src[i], dst[i], wt[i] = current, labels[k], min_reach[k]
        current = int(labels[k])
    return src, dst, wt


def _mst_points(dist: np.ndarray, core: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Prim's walk over points; an edge is recorded from its source."""
    n = dist.shape[0]
    src, dst, wt = (np.empty(n - 1, np.int64), np.empty(n - 1, np.int64),
                    np.empty(n - 1))
    in_tree = np.zeros(n, bool)
    min_reach = np.full(n, np.inf)
    sources = np.ones(n, np.int64)
    current = 0
    for i in range(n - 1):
        in_tree[current] = True
        mrd = np.maximum(np.maximum(core[current], core), dist[current])
        better = ~in_tree & (mrd < min_reach)
        min_reach[better] = mrd[better]
        sources[better] = current
        cand = np.where(in_tree, np.inf, min_reach)
        k = int(np.argmin(cand))
        src[i], dst[i], wt[i] = sources[k], k, cand[k]
        current = k
    return src, dst, wt


def _single_linkage(src, dst, wt) -> np.ndarray:
    """Sorted MST edges -> [N-1, 4] rows (left, right, distance, size); new
    clusters are numbered N, N+1, ... in edge order."""
    n = len(src) + 1
    parent = np.full(2 * n - 1, -1, np.int64)
    size = np.concatenate([np.ones(n, np.int64), np.zeros(n - 1, np.int64)])

    def find(p: int) -> int:
        root = p
        while parent[root] != -1:
            root = parent[root]
        while parent[p] != -1 and parent[p] != root:
            parent[p], p = root, parent[p]
        return root

    out = np.zeros((n - 1, 4))
    for i in range(n - 1):
        a, b = find(int(src[i])), find(int(dst[i]))
        out[i] = (a, b, wt[i], size[a] + size[b])
        parent[a] = parent[b] = n + i
        size[n + i] = size[a] + size[b]
    return out


def _bfs(hierarchy: np.ndarray, root: int) -> list[int]:
    n = hierarchy.shape[0] + 1
    out, queue = [], [root]
    while queue:
        out.extend(queue)
        queue = [int(c) for x in queue if x >= n
                 for c in hierarchy[x - n, :2]]
    return out


def _condense(hierarchy: np.ndarray, min_cluster_size: int) -> np.ndarray:
    """Single-linkage tree -> condensed rows (parent, child, lambda, size)
    in breadth-first order; clusters smaller than ``min_cluster_size``
    shed their points."""
    n = hierarchy.shape[0] + 1
    root = 2 * hierarchy.shape[0]
    relabel = np.empty(root + 1, np.int64)
    relabel[root] = n
    next_label = n + 1
    nodes = _bfs(hierarchy, root)
    ignore = np.zeros(len(nodes), bool)
    rows = []
    for node in nodes:
        if ignore[node] or node < n:
            continue
        left, right, dist = int(hierarchy[node - n, 0]), int(hierarchy[node - n, 1]), \
            hierarchy[node - n, 2]
        lam = 1.0 / dist if dist > 0.0 else np.inf
        lc = int(hierarchy[left - n, 3]) if left >= n else 1
        rc = int(hierarchy[right - n, 3]) if right >= n else 1
        if lc >= min_cluster_size and rc >= min_cluster_size:
            relabel[left] = next_label
            rows.append((relabel[node], next_label, lam, lc))
            relabel[right] = next_label + 1
            rows.append((relabel[node], next_label + 1, lam, rc))
            next_label += 2
            continue
        shed = []
        if lc < min_cluster_size:
            shed.append(left)
        else:
            relabel[left] = relabel[node]
        if rc < min_cluster_size:
            shed.append(right)
        else:
            relabel[right] = relabel[node]
        for side in shed:
            for sub in _bfs(hierarchy, side):
                if sub < n:
                    rows.append((relabel[node], sub, lam, 1))
                ignore[sub] = True
    return np.array(rows, dtype=[("parent", np.int64), ("child", np.int64),
                                 ("value", np.float64), ("size", np.int64)])


def _stability(tree: np.ndarray) -> dict[int, float]:
    smallest = int(tree["parent"].min())
    n_clusters = int(tree["parent"].max()) - smallest + 1
    births = np.full(max(int(tree["child"].max()), smallest) + 1, np.nan)
    births[tree["child"]] = tree["value"]
    births[smallest] = 0.0
    result = np.zeros(n_clusters)
    for parent, lam, size in zip(tree["parent"], tree["value"], tree["size"]):
        result[parent - smallest] += (lam - births[parent]) * size
    return {smallest + i: float(result[i]) for i in range(n_clusters)}


def _leaves(cluster_tree: np.ndarray, node: int) -> list[int]:
    children = cluster_tree["child"][cluster_tree["parent"] == node]
    if len(children) == 0:
        return [node]
    return sum((_leaves(cluster_tree, int(c)) for c in children), [])


def _select(tree: np.ndarray, method: str, allow_single_cluster: bool) -> np.ndarray:
    """Condensed tree -> labels of its points."""
    stability = _stability(tree)
    nodes = sorted(stability, reverse=True)
    if not allow_single_cluster:
        nodes = nodes[:-1]
    cluster_tree = tree[tree["size"] > 1]
    is_cluster = {c: True for c in nodes}
    if method == "eom":
        for node in nodes:
            children = cluster_tree["child"][cluster_tree["parent"] == node]
            sub = np.sum([stability[int(c)] for c in children])
            if sub > stability[node]:
                is_cluster[node] = False
                stability[node] = sub
            else:
                queue = np.array([node])
                while len(queue):
                    for c in queue.tolist():
                        if c != node:
                            is_cluster[c] = False
                    queue = cluster_tree["child"][np.isin(cluster_tree["parent"], queue)]
    elif method == "leaf":
        leaves = (set(_leaves(cluster_tree, int(cluster_tree["parent"].min())))
                  if len(cluster_tree) else set())
        for c in is_cluster:
            is_cluster[c] = c in leaves
    else:
        raise ValueError(f"unknown cluster selection method {method!r}")
    clusters = {c for c, on in is_cluster.items() if on}
    label_of = {c: i for i, c in enumerate(sorted(clusters))}
    root = int(tree["parent"].min())
    # each point's topmost ancestor below a selected cluster (rows are in
    # breadth-first order: a parent's representative is final first)
    rep = np.arange(int(tree["parent"].max()) + 1)
    for parent, child in zip(tree["parent"], tree["child"]):
        if child not in clusters:
            rep[child] = rep[parent]
    labels = np.full(root, -1, np.int64)
    for p in range(root):
        c = int(rep[p])
        if c != root:
            labels[p] = label_of[c]
        elif len(clusters) == 1 and allow_single_cluster:
            lam = tree["value"][tree["child"] == p]
            if lam >= tree["value"][tree["parent"] == c].max():
                labels[p] = label_of[c]
    return labels


def hdbscan_labels(x: np.ndarray, min_cluster_size: int = 5,
                   min_samples: int | None = None, precomputed: bool = False,
                   allow_single_cluster: bool = False,
                   cluster_selection_method: str = "eom") -> np.ndarray:
    """HDBSCAN labels (``-1`` noise) of points ``x`` [N, D] under the
    Euclidean metric, or of a symmetric distance matrix ``x`` [N, N] with
    ``precomputed``: ``sklearn.cluster.HDBSCAN(min_cluster_size,
    min_samples, metric, allow_single_cluster=...,
    cluster_selection_method=...).fit_predict(x)``."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    min_samples = min_cluster_size if min_samples is None else min_samples
    if n < 2 or min_samples > n:
        raise ValueError(f"HDBSCAN needs more than one sample and at least "
                         f"min_samples={min_samples}, got {n}")
    if precomputed:
        core = _core_distances(x, min_samples)
        mreach = np.maximum(np.maximum(core[:, None], core[None, :]), x)
        src, dst, wt = _mst_precomputed(mreach)
    else:
        dist = _euclidean(x)
        src, dst, wt = _mst_points(dist, _core_distances(dist, min_samples))
    # the edges in scikit-learn's record layout: its argsort of the weight
    # field (a strided view) takes the same path, so equal weights keep its
    # order
    mst = np.empty(n - 1, dtype=[("current_node", np.int64),
                                 ("next_node", np.int64), ("distance", np.float64)])
    mst["current_node"], mst["next_node"], mst["distance"] = src, dst, wt
    mst = mst[np.argsort(mst["distance"])]
    hierarchy = _single_linkage(mst["current_node"], mst["next_node"],
                                mst["distance"])
    return _select(_condense(hierarchy, min_cluster_size),
                   cluster_selection_method, allow_single_cluster)
