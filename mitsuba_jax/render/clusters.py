"""Triangle clusters: contiguous BVH-subtree ranges of a bounded size.

Instancing (render/intersect.py::_build_instances) gives each cluster of
an instanced group a fixed-size block of attribute slots, so a virtual
prim id decodes to (cluster, slot) with one division.
"""
from __future__ import annotations

import numpy as np

CLUSTER_K = 128        # default max triangles per cluster


def cut_clusters(first: np.ndarray, count: np.ndarray, skip: np.ndarray,
                 n_tris: int, max_k: int = CLUSTER_K):
    """Cut the flattened skip-link BVH into contiguous triangle ranges of
    <= max_k triangles, preferring subtree boundaries (tight AABBs).

    In DFS preorder with skip links, node i's subtree covers nodes
    [i, skip[i]) and a CONTIGUOUS triangle range. Greedy walk: emit a
    node's range as one cluster when it fits, else descend into i+1.
    Returns list of (start, count) covering [0, n_tris)."""
    m = first.shape[0]
    # subtree triangle ranges: lo = first tri of first leaf in subtree;
    # hi = lo of the node at skip[i] (or n_tris). Leaves carry their own
    # range. Compute lo by back-propagating in reverse DFS order.
    lo = np.zeros(m + 1, np.int64)
    lo[m] = n_tris
    for i in range(m - 1, -1, -1):
        lo[i] = first[i] if count[i] > 0 else lo[i + 1]
    out = []
    i = 0
    while i < m:
        hi = lo[skip[i]] if skip[i] <= m else n_tris
        n = hi - lo[i]
        if n <= max_k or count[i] > 0:
            if n > 0:
                start = lo[i]
                # an oversized leaf (shouldn't happen, MAX_LEAF=4) still
                # gets split into max_k chunks
                while n > max_k:
                    out.append((int(start), int(max_k)))
                    start += max_k
                    n -= max_k
                out.append((int(start), int(n)))
            i = skip[i]
        else:
            i += 1
    return out
