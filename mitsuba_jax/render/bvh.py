"""BVH construction — binned SAH, flattened skip-link layout.

Wavefront replacement for the reference's SAH kd-tree
(include/mitsuba/render/gkdtree.h:913 buildInternal, min-max binning at
gkdtree.h:2350).  Instead of a stack-based Havran traversal
(sahkdtree3.h:171), nodes are emitted in DFS preorder with *skip links*, so
traversal is stackless: from node i, a hit on an inner node goes to i+1, any
miss (or finished leaf) goes to skip[i].  That turns per-ray traversal into a
uniform gather loop that vectorizes over the whole wavefront — no per-ray
stacks, no divergence beyond masking.

Build runs host-side in numpy (the C++ builder in native/ is a drop-in for
big scenes); the flattened arrays live in device memory at render time.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_LEAF = 4          # triangles per leaf (static unroll bound in traversal)
N_BINS = 16


@dataclass
class BVH:
    bounds_min: np.ndarray   # (M, 3)
    bounds_max: np.ndarray   # (M, 3)
    first: np.ndarray        # (M,) leaf: first triangle (in permuted order)
    count: np.ndarray        # (M,) leaf: #triangles; 0 for inner nodes
    skip: np.ndarray         # (M,) node to visit on miss / after leaf; M = done
    perm: np.ndarray         # (T,) triangle permutation old->new order is perm

    @property
    def n_nodes(self):
        return self.bounds_min.shape[0]


def build_bvh(vertices: np.ndarray, faces: np.ndarray, max_leaf: int = MAX_LEAF) -> BVH:
    """Binned-SAH BVH over a triangle soup. Returns flattened skip-link BVH.

    Uses the native C++ builder (mitsuba_jax/native/bvh_builder.cpp) when
    available — the Python recursion below is the reference implementation
    and fallback."""
    try:
        from mitsuba_jax.native import build_bvh_native

        out = build_bvh_native(vertices, faces, max_leaf)
        if out is not None:
            bmin, bmax, first, count, skip, perm = out
            return BVH(
                bounds_min=bmin, bounds_max=bmax, first=first, count=count,
                skip=skip, perm=perm,
            )
    except Exception:
        pass
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    t = f.shape[0]
    tri = v[f]                              # (T, 3, 3)
    tmin = tri.min(axis=1)
    tmax = tri.max(axis=1)
    cent = (tmin + tmax) * 0.5

    # Build tree in (node list, children indices) form first.
    nodes = []  # dicts: bmin,bmax,first,count,left,right

    def leaf_node(idx):
        nodes.append(
            dict(
                bmin=tmin[idx].min(0), bmax=tmax[idx].max(0),
                tris=idx, left=-1, right=-1,
            )
        )
        return len(nodes) - 1

    def build(idx):
        bmin = tmin[idx].min(0)
        bmax = tmax[idx].max(0)
        n = idx.shape[0]
        if n <= max_leaf:
            return leaf_node(idx)
        # binned SAH over the centroid extent, all 3 axes
        cmin = cent[idx].min(0)
        cmax = cent[idx].max(0)
        ext = cmax - cmin
        best = None  # (cost, axis, bin_split)
        for axis in range(3):
            if ext[axis] <= 1e-12:
                continue
            rel = (cent[idx, axis] - cmin[axis]) / ext[axis]
            b = np.minimum((rel * N_BINS).astype(np.int64), N_BINS - 1)
            counts = np.bincount(b, minlength=N_BINS)
            # bin bounds
            bin_min = np.full((N_BINS, 3), np.inf)
            bin_max = np.full((N_BINS, 3), -np.inf)
            for k in range(N_BINS):
                sel = b == k
                if counts[k]:
                    bin_min[k] = tmin[idx][sel].min(0)
                    bin_max[k] = tmax[idx][sel].max(0)
            # sweep
            lmin = np.minimum.accumulate(bin_min, 0)
            lmax = np.maximum.accumulate(bin_max, 0)
            rmin = np.minimum.accumulate(bin_min[::-1], 0)[::-1]
            rmax = np.maximum.accumulate(bin_max[::-1], 0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = np.cumsum(counts[::-1])[::-1]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 0] * d[:, 2]

            for split in range(1, N_BINS):
                nl, nr = lcnt[split - 1], rcnt[split]
                if nl == 0 or nr == 0:
                    continue
                cost = area(lmin[split - 1 : split], lmax[split - 1 : split])[0] * nl + \
                    area(rmin[split : split + 1], rmax[split : split + 1])[0] * nr
                if best is None or cost < best[0]:
                    best = (cost, axis, split, b)
        if best is None:
            # degenerate: median split on largest axis
            axis = int(np.argmax(bmax - bmin))
            order = np.argsort(cent[idx, axis], kind="stable")
            half = n // 2
            li, ri = idx[order[:half]], idx[order[half:]]
        else:
            _, axis, split, b = best
            sel = b < split
            li, ri = idx[sel], idx[~sel]
            if li.size == 0 or ri.size == 0:  # safety
                order = np.argsort(cent[idx, axis], kind="stable")
                half = n // 2
                li, ri = idx[order[:half]], idx[order[half:]]
        me = len(nodes)
        nodes.append(dict(bmin=bmin, bmax=bmax, tris=None, left=-1, right=-1))
        nodes[me]["left"] = build(li)
        nodes[me]["right"] = build(ri)
        return me

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        if t == 0:
            return BVH(
                bounds_min=np.zeros((1, 3), np.float32),
                bounds_max=np.zeros((1, 3), np.float32),
                first=np.zeros(1, np.int32),
                count=np.zeros(1, np.int32),
                skip=np.ones(1, np.int32),
                perm=np.zeros(0, np.int64),
            )
        root = build(np.arange(t))
    finally:
        sys.setrecursionlimit(old_limit)
    assert root == 0

    # Flatten to DFS preorder with skip links + triangle permutation.
    m = len(nodes)
    bmin = np.zeros((m, 3), np.float32)
    bmax = np.zeros((m, 3), np.float32)
    first = np.zeros(m, np.int32)
    count = np.zeros(m, np.int32)
    skip = np.zeros(m, np.int32)
    perm = []
    out_idx = {}
    order = []

    def dfs(i):
        out_idx[i] = len(order)
        order.append(i)
        nd = nodes[i]
        if nd["left"] >= 0:
            dfs(nd["left"])
            dfs(nd["right"])

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))
    dfs(root)

    def dfs2(i, skip_to):
        j = out_idx[i]
        nd = nodes[i]
        bmin[j] = nd["bmin"]
        bmax[j] = nd["bmax"]
        skip[j] = skip_to
        if nd["left"] < 0:
            first[j] = len(perm)
            count[j] = len(nd["tris"])
            perm.extend(nd["tris"].tolist())
        else:
            dfs2(nd["left"], out_idx[nd["right"]])
            dfs2(nd["right"], skip_to)

    dfs2(root, m)
    return BVH(
        bounds_min=bmin, bounds_max=bmax, first=first, count=count, skip=skip,
        perm=np.asarray(perm, np.int64),
    )


def build_bvh_boxes(pmin: np.ndarray, pmax: np.ndarray,
                    max_leaf: int = MAX_LEAF) -> BVH:
    """Binned-SAH skip-link BVH over arbitrary per-primitive AABBs
    (hair fiber segments, analytic prims). Reuses build_bvh — and thus
    the native builder — by synthesizing one triangle per box whose
    vertex AABB and centroid equal the box's: (pmin, pmax, center).
    The returned perm/first/count index the boxes."""
    pmin = np.asarray(pmin, np.float64)
    pmax = np.asarray(pmax, np.float64)
    n = pmin.shape[0]
    center = (pmin + pmax) * 0.5
    verts = np.stack([pmin, pmax, center], axis=1).reshape(n * 3, 3)
    faces = np.arange(n * 3, dtype=np.int64).reshape(n, 3)
    return build_bvh(verts, faces, max_leaf=max_leaf)
