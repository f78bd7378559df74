"""Ray–scene intersection: SoA triangle tables + closest/any-hit kernels.

Wavefront replacement for the reference's kd-tree traversal + TriAccel
records (include/mitsuba/render/sahkdtree3.h:171 Havran traversal,
triaccel.h:98 Wald test).  Two backends:

  * `brute`  — all-pairs Möller–Trumbore over (rays × triangles). On CUDA
    a Pallas Triton kernel (ops/brute_triton.py); elsewhere plain XLA,
    which is also its reference. For small scenes (Cornell box class)
    and the correctness oracle for everything.
  * `bvh`    — stackless skip-link BVH walk (see render/bvh.py): each step
    gathers one node per ray, tests MAX_LEAF triangles when in a leaf and
    advances via hit/skip links. No stacks, no recursion — one
    `lax.while_loop` over the whole wavefront.

Geometry lives in `GeometryTables`, a pytree of SoA arrays (triangles stored
in BVH order so leaf ranges are contiguous).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core import math as m
from mitsuba_jax.core.types import pytree_dataclass, replace, static_field
from mitsuba_jax.render.bvh import BVH, MAX_LEAF, build_bvh
from mitsuba_jax.render.records import Intersection, Ray


@pytree_dataclass
class GeometryTables:
    # triangle soup (BVH-permuted order)
    v0: jnp.ndarray        # (T, 3)
    e1: jnp.ndarray        # (T, 3) v1 - v0
    e2: jnp.ndarray        # (T, 3) v2 - v0
    n0: jnp.ndarray        # (T, 3) per-corner shading normals
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray       # (T, 2)
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    material_id: jnp.ndarray  # (T,) int32
    emitter_id: jnp.ndarray   # (T,) int32, -1 = not emissive
    shape_id: jnp.ndarray     # (T,) int32
    # flattened BVH
    bvh_min: jnp.ndarray   # (M, 3)
    bvh_max: jnp.ndarray   # (M, 3)
    bvh_first: jnp.ndarray  # (M,)
    bvh_count: jnp.ndarray  # (M,)
    bvh_skip: jnp.ndarray   # (M,)
    # packed single-gather layouts (ints stored as exact f32 < 2^24):
    bvh_packed: jnp.ndarray = None   # (M, 9) bmin|bmax|first|count|skip
    tri_packed: jnp.ndarray = None   # (T, 9) v0|e1|e2
    # ONE row-gather for the whole shading record instead of ~11
    # per-prim attribute gathers. Columns: e1|e2|n0|n1|n2|uv0|uv1|uv2|
    # mid(bitcast)|eid(bitcast)|sid(bitcast)
    shade_pack: jnp.ndarray = None   # (T, 24)
    # TRUE instancing (reference src/shapes/instance.cpp — nested trees;
    # here every instance of a group walks the group's one object-space
    # copy). Instanced prims get virtual ids >= n_tris: instance cluster
    # vp // mt_k, slot vp % mt_k (clusters: render/clusters.py), shaded
    # through the obj_* tables below.
    mt_block_id: jnp.ndarray = None  # (Ci,) instanced cluster -> obj block
    mt_xform: jnp.ndarray = None     # (Ci, 12) world->object 3x4 rows
    mt_xform_fwd: jnp.ndarray = None  # (Ci, 12) object->world 3x4 rows
    obj_e1: jnp.ndarray = None       # (B*K, 3) block-aligned object tris
    obj_e2: jnp.ndarray = None
    obj_n0: jnp.ndarray = None
    obj_n1: jnp.ndarray = None
    obj_n2: jnp.ndarray = None
    obj_uv0: jnp.ndarray = None      # (B*K, 2)
    obj_uv1: jnp.ndarray = None
    obj_uv2: jnp.ndarray = None
    obj_mid: jnp.ndarray = None      # (B*K,) material ids
    obj_sid: jnp.ndarray = None      # (B*K,) shape ids
    # per-instance walks: object-space sub-geometries per GROUP +
    # per-instance transforms
    inst_groups: tuple = None        # tuple of GeometryTables (pytrees)
    inst_tri2virt: tuple = None      # per group: (T_g,) tri -> cid*K + slot
    inst_xf_inv: jnp.ndarray = None  # (I, 12) world->object rows
    inst_gid: tuple = static_field(default=())   # group index per instance
    inst_vp_base: tuple = static_field(default=())  # virtual prim bases
    mt_k: int = static_field(default=32)
    # analytic primitives (reference src/shapes/sphere.cpp:359 analytic
    # intersection, cylinder.cpp — NOT tessellated). Prim-id space:
    # triangles [0,T), spheres [T,T+S), cylinders [T+S,T+S+C).
    sph_c: jnp.ndarray = None        # (S, 3) centers
    sph_r: jnp.ndarray = None        # (S,)  radii
    sph_mid: jnp.ndarray = None      # (S,) material ids
    sph_eid: jnp.ndarray = None      # (S,) emitter ids (-1 none)
    sph_sid: jnp.ndarray = None      # (S,) shape ids
    cyl_a: jnp.ndarray = None        # (C, 3) axis start
    cyl_b: jnp.ndarray = None        # (C, 3) axis end
    cyl_r: jnp.ndarray = None        # (C,)
    cyl_mid: jnp.ndarray = None
    cyl_eid: jnp.ndarray = None
    cyl_sid: jnp.ndarray = None
    # hair fiber segments (reference src/shapes/hair.cpp:132 — exact
    # per-segment cylinders in a dedicated kd-tree; here a skip-link
    # segment BVH walked by _hair_walk). Prim-id space continues after
    # cylinders: [T+S+C, T+S+C+H).
    hair_nodes: jnp.ndarray = None   # (Mh, 9) packed skip-link nodes
    hair_segs: jnp.ndarray = None    # (H, 16): a3 b3 r u0 u1 mid eid sid pad
    backend: str = static_field(default="brute")

    @property
    def has_instances(self):
        return self.mt_block_id is not None

    @property
    def n_tris(self):
        return self.v0.shape[0]

    @property
    def n_spheres(self):
        return 0 if self.sph_r is None else self.sph_r.shape[0]

    @property
    def n_cylinders(self):
        return 0 if self.cyl_r is None else self.cyl_r.shape[0]

    @property
    def n_hair(self):
        return 0 if self.hair_segs is None else self.hair_segs.shape[0]

    @property
    def has_analytic(self):
        return self.n_spheres + self.n_cylinders > 0


def build_geometry(meshes_with_ids, backend: str = "auto",
                   analytic=None, instanced=None, hair=None) -> GeometryTables:
    """Assemble GeometryTables from [(TriMesh, material_id, emitter_id
    [, shape_id]), ...].

    backend: 'brute' | 'bvh' | 'cluster' | 'auto' (cluster above 64
    triangles, else brute). 'bvh' and 'cluster' both walk the skip-link
    BVH; 'cluster' also orders the wavefront (Morton pixels, per-bounce
    ray sort) and is the one that takes instances.
    analytic: optional dict(spheres=[(c, r, mid, eid, sid)],
    cylinders=[(a, b, r, mid, eid, sid)]) of analytic primitives.
    instanced: optional (groups, instances) for TRUE instancing
    (cluster backend only): groups = list of [(TriMesh, material_id,
    shape_id), ...] in OBJECT space; instances = [(group_idx, 4x4
    to_world), ...]. Instance triangles share one object-space copy;
    they cannot be emitters or carry interior media.
    """
    vs, fs, ns, uvs, mids, eids, sids = [], [], [], [], [], [], []
    voff = 0
    for k, item in enumerate(meshes_with_ids):
        mesh, mat, emit = item[:3]
        sid = item[3] if len(item) > 3 else k
        vs.append(np.asarray(mesh.vertices, np.float32))
        fs.append(np.asarray(mesh.faces, np.int64) + voff)
        n = mesh.normals
        if n is None:
            fn = mesh.face_normals()
            # expand to per-vertex by duplicating flat normals at gather time:
            # store None sentinel -> use face normal below
            n = np.zeros_like(mesh.vertices)
            ncount = np.zeros((mesh.vertices.shape[0], 1))
            for k in range(3):
                np.add.at(n, mesh.faces[:, k], fn)
                np.add.at(ncount, mesh.faces[:, k], 1.0)
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        ns.append(np.asarray(n, np.float32))
        uv = mesh.uvs if mesh.uvs is not None else np.zeros((mesh.vertices.shape[0], 2), np.float32)
        uvs.append(np.asarray(uv, np.float32))
        t = mesh.faces.shape[0]
        mids.append(np.full(t, mat, np.int32))
        eids.append(np.full(t, emit, np.int32))
        sids.append(np.full(t, sid, np.int32))
        voff += mesh.vertices.shape[0]
    v = np.concatenate(vs)
    f = np.concatenate(fs)
    n = np.concatenate(ns)
    uv = np.concatenate(uvs)
    mid = np.concatenate(mids)
    eid = np.concatenate(eids)
    sid = np.concatenate(sids)

    if backend == "auto":
        backend = "cluster" if f.shape[0] > 64 else "brute"
    if backend in ("bvh", "cluster"):
        bvh = build_bvh(v, f)
    else:
        # brute force needs no tree: single leaf covering everything
        t = f.shape[0]
        bvh = BVH(
            bounds_min=np.min(v, axis=0, keepdims=True).astype(np.float32),
            bounds_max=np.max(v, axis=0, keepdims=True).astype(np.float32),
            first=np.zeros(1, np.int32),
            count=np.asarray([t], np.int32),
            skip=np.ones(1, np.int32),
            perm=np.arange(t, dtype=np.int64),
        )
    p = bvh.perm
    f = f[p]
    mid, eid, sid = mid[p], eid[p], sid[p]

    tri = v[f]  # (T,3,3)
    inst = {}
    if instanced and instanced[1]:
        inst = _build_instances(*instanced, n_static_tris=f.shape[0])
    ana = {}
    if analytic:
        sph = analytic.get("spheres") or []
        cyl = analytic.get("cylinders") or []
        if sph:
            ana.update(
                sph_c=jnp.asarray(np.asarray([x[0] for x in sph],
                                             np.float32)),
                sph_r=jnp.asarray(np.asarray([x[1] for x in sph],
                                             np.float32)),
                sph_mid=jnp.asarray(np.asarray([x[2] for x in sph],
                                               np.int32)),
                sph_eid=jnp.asarray(np.asarray([x[3] for x in sph],
                                               np.int32)),
                sph_sid=jnp.asarray(np.asarray([x[4] for x in sph],
                                               np.int32)),
            )
        if cyl:
            ana.update(
                cyl_a=jnp.asarray(np.asarray([x[0] for x in cyl],
                                             np.float32)),
                cyl_b=jnp.asarray(np.asarray([x[1] for x in cyl],
                                             np.float32)),
                cyl_r=jnp.asarray(np.asarray([x[2] for x in cyl],
                                             np.float32)),
                cyl_mid=jnp.asarray(np.asarray([x[3] for x in cyl],
                                               np.int32)),
                cyl_eid=jnp.asarray(np.asarray([x[4] for x in cyl],
                                               np.int32)),
                cyl_sid=jnp.asarray(np.asarray([x[5] for x in cyl],
                                               np.int32)),
            )
    if hair is not None and hair["a"].shape[0] > 0:
        ana.update(_pack_hair(hair))
    return GeometryTables(
        **inst,
        **ana,
        v0=jnp.asarray(tri[:, 0]),
        e1=jnp.asarray(tri[:, 1] - tri[:, 0]),
        e2=jnp.asarray(tri[:, 2] - tri[:, 0]),
        n0=jnp.asarray(n[f[:, 0]]),
        n1=jnp.asarray(n[f[:, 1]]),
        n2=jnp.asarray(n[f[:, 2]]),
        uv0=jnp.asarray(uv[f[:, 0]]),
        uv1=jnp.asarray(uv[f[:, 1]]),
        uv2=jnp.asarray(uv[f[:, 2]]),
        material_id=jnp.asarray(mid),
        emitter_id=jnp.asarray(eid),
        shape_id=jnp.asarray(sid),
        bvh_min=jnp.asarray(bvh.bounds_min),
        bvh_max=jnp.asarray(bvh.bounds_max),
        bvh_first=jnp.asarray(bvh.first),
        bvh_count=jnp.asarray(bvh.count),
        bvh_skip=jnp.asarray(bvh.skip),
        bvh_packed=jnp.asarray(np.concatenate(
            [bvh.bounds_min, bvh.bounds_max,
             bvh.first[:, None].astype(np.float32),
             bvh.count[:, None].astype(np.float32),
             bvh.skip[:, None].astype(np.float32)], axis=1
        )),
        tri_packed=jnp.asarray(np.concatenate(
            [tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]],
            axis=1,
        ).astype(np.float32)),
        shade_pack=jnp.asarray(np.concatenate(
            [(tri[:, 1] - tri[:, 0]).astype(np.float32),
             (tri[:, 2] - tri[:, 0]).astype(np.float32),
             n[f[:, 0]].astype(np.float32),
             n[f[:, 1]].astype(np.float32),
             n[f[:, 2]].astype(np.float32),
             uv[f[:, 0]].astype(np.float32),
             uv[f[:, 1]].astype(np.float32),
             uv[f[:, 2]].astype(np.float32),
             mid.astype(np.int32).view(np.float32)[:, None],
             eid.astype(np.int32).view(np.float32)[:, None],
             sid.astype(np.int32).view(np.float32)[:, None]], axis=1)),
        backend=backend,
    )


def _build_instances(groups, instances, n_static_tris: int,
                     k: int = 32) -> dict:
    """GeometryTables fields for TRUE instancing.

    groups: [[(TriMesh, material_id, shape_id), ...], ...] in OBJECT
    space; instances: [(group_index, 4x4 to_world), ...]. Each group is
    built once (its own BVH, walked per instance in object space) and cut
    into clusters of <= k triangles; a group's clusters own consecutive
    k-slot blocks of the obj_* attribute tables. Instance i's prims get
    the virtual ids inst_vp_base[i] + cluster * k + slot."""
    from mitsuba_jax.render.clusters import cut_clusters

    subs, ranges, tri2virt = [], [], []
    for gitems in groups:
        gsub = build_geometry([(msh, mi, -1, si) for msh, mi, si in gitems],
                              backend="bvh")
        rg = cut_clusters(np.asarray(gsub.bvh_first),
                          np.asarray(gsub.bvh_count),
                          np.asarray(gsub.bvh_skip), gsub.n_tris, max_k=k)
        t2v = np.zeros(gsub.n_tris, np.int32)
        for ci, (s, cnt) in enumerate(rg):
            t2v[s:s + cnt] = ci * k + np.arange(cnt)
        subs.append(gsub)
        ranges.append(rg)
        tri2virt.append(jnp.asarray(t2v))
    block_base = np.cumsum([0] + [len(rg) for rg in ranges])

    def blk(field, width):
        shape = (block_base[-1] * k, width) if width > 1 \
            else (block_base[-1] * k,)
        out = np.zeros(shape, np.float32 if width > 1 else np.int32)
        for gsub, rg, base in zip(subs, ranges, block_base):
            src = np.asarray(getattr(gsub, field))
            for ci, (s, cnt) in enumerate(rg):
                row = (base + ci) * k
                out[row:row + cnt] = src[s:s + cnt]
        return out

    block_id, xf_c, fwd_c, xf_inv, vp_base = [], [], [], [], []
    vp = n_static_tris
    for gi, m4 in instances:
        m4 = np.asarray(m4, np.float64)
        inv = np.linalg.inv(m4)[:3, :4].reshape(-1)
        n_cl = len(ranges[gi])
        vp_base.append(vp)
        vp += n_cl * k
        block_id.append(block_base[gi] + np.arange(n_cl))
        xf_c.append(np.tile(inv, (n_cl, 1)))
        fwd_c.append(np.tile(m4[:3, :4].reshape(-1), (n_cl, 1)))
        xf_inv.append(inv)

    def f32(x):
        return jnp.asarray(np.asarray(x, np.float32))

    return dict(
        mt_block_id=jnp.asarray(np.concatenate(block_id).astype(np.int32)),
        mt_xform=f32(np.concatenate(xf_c)),
        mt_xform_fwd=f32(np.concatenate(fwd_c)),
        obj_e1=f32(blk("e1", 3)), obj_e2=f32(blk("e2", 3)),
        obj_n0=f32(blk("n0", 3)),
        obj_n1=f32(blk("n1", 3)), obj_n2=f32(blk("n2", 3)),
        obj_uv0=f32(blk("uv0", 2)), obj_uv1=f32(blk("uv1", 2)),
        obj_uv2=f32(blk("uv2", 2)),
        obj_mid=jnp.asarray(blk("material_id", 1)),
        obj_sid=jnp.asarray(blk("shape_id", 1)),
        inst_groups=tuple(subs),
        inst_tri2virt=tuple(tri2virt),
        inst_xf_inv=f32(np.asarray(xf_inv)),
        inst_gid=tuple(int(g) for g, _ in instances),
        inst_vp_base=tuple(int(x) for x in vp_base),
        mt_k=k,
    )


# ---------------------------------------------------------------------------
# Möller–Trumbore, batched
# ---------------------------------------------------------------------------

_DET_EPS = 1e-9


def _mt_hit(o, d, v0, e1, e2, mint, maxt):
    """Batched Möller–Trumbore. All inputs broadcast to (..., 3).

    Returns (t, u, v, hit_mask)."""
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > _DET_EPS, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > _DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > mint)
        & (t < maxt)
    )
    return t, u, v, hit


def predicted_hit_bound(geom: GeometryTables, ray: Ray, pred_prim):
    """Exact MT test of each ray against ONE predicted triangle
    (hash-based ray-path prediction, arXiv:1910.01304: rays from the same
    spatial cell + direction octant tend to hit the same primitive).

    Any hit yields an exact UPPER BOUND on the nearest-hit distance —
    feeding it back as maxt tightens the work-list cull's conservative
    row intervals and the kernel's early-exit, without changing results
    (traversal still resolves the true nearest within the bound). For
    shadow rays the hit itself answers the any-hit query (the classic
    shadow cache). Returns (t, hit) — only static prims (< n_tris)
    participate; others report miss."""
    ok = (pred_prim >= 0) & (pred_prim < geom.n_tris)
    prim = jnp.clip(pred_prim, 0, geom.n_tris - 1)
    t, _u, _v, hit = _mt_hit(ray.o, ray.d, geom.v0[prim], geom.e1[prim],
                             geom.e2[prim], ray.mint, ray.maxt)
    return t, hit & ok


def _closest_brute(geom: GeometryTables, ray: Ray):
    """All-pairs closest hit: (N rays) x (T tris)."""
    o = ray.o[:, None, :]
    d = ray.d[:, None, :]
    t, u, v, hit = _mt_hit(
        o, d, geom.v0[None], geom.e1[None], geom.e2[None],
        ray.mint[:, None], ray.maxt[:, None],
    )
    t_masked = jnp.where(hit, t, jnp.inf)
    best = jnp.argmin(t_masked, axis=1)
    n = ray.o.shape[0]
    rows = jnp.arange(n)
    t_best = t_masked[rows, best]
    valid = jnp.isfinite(t_best)
    return t_best, u[rows, best], v[rows, best], best, valid


def _any_brute(geom: GeometryTables, ray: Ray):
    o = ray.o[:, None, :]
    d = ray.d[:, None, :]
    _, _, _, hit = _mt_hit(
        o, d, geom.v0[None], geom.e1[None], geom.e2[None],
        ray.mint[:, None], ray.maxt[:, None],
    )
    return jnp.any(hit, axis=1)


# ---------------------------------------------------------------------------
# Stackless skip-link BVH traversal
# ---------------------------------------------------------------------------

def _slab_test(bmin, bmax, o, inv_d, mint, tmax):
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    t_near = jnp.maximum(jnp.max(tn, axis=-1), mint)
    t_far = jnp.minimum(jnp.min(tf, axis=-1), tmax)
    return t_near <= t_far


def _closest_bvh(geom: GeometryTables, ray: Ray):
    return bvh_walk(geom, ray)[:5]


def bvh_walk(geom: GeometryTables, ray: Ray):
    """Closest-hit skip-link walk of the whole wavefront: each step makes
    ONE (N, 9) node gather and MAX_LEAF (N, 9) triangle gathers; the loop
    runs until the slowest lane leaves the tree. Returns (t, u, v, prim,
    valid, steps) with steps the loop's trip count."""
    n = ray.o.shape[0]
    m_nodes = geom.bvh_min.shape[0]
    inv_d = m.safe_rcp(ray.d)
    nodes = geom.bvh_packed
    tris = geom.tri_packed

    def cond(state):
        return jnp.any(state[0] < m_nodes)

    def body(state):
        node, t_best, uv_best, prim_best, valid, steps = state
        nd = jnp.minimum(node, m_nodes - 1)
        row = nodes[nd]                       # (N, 9): one gather
        bmin, bmax = row[:, 0:3], row[:, 3:6]
        first = row[:, 6].astype(jnp.int32)
        count = row[:, 7].astype(jnp.int32)
        skip = row[:, 8].astype(jnp.int32)
        active = node < m_nodes
        box_hit = active & _slab_test(bmin, bmax, ray.o, inv_d, ray.mint, t_best)
        is_leaf = count > 0
        do_tris = box_hit & is_leaf
        for k in range(MAX_LEAF):
            ti = jnp.minimum(first + k, geom.n_tris - 1)
            trow = tris[ti]                   # (N, 9): one gather
            t, u, v, hit = _mt_hit(
                ray.o, ray.d, trow[:, 0:3], trow[:, 3:6], trow[:, 6:9],
                ray.mint, jnp.minimum(ray.maxt, t_best),
            )
            hit = hit & do_tris & (k < count)
            closer = hit & (t < t_best)
            t_best = jnp.where(closer, t, t_best)
            uv_best = jnp.where(closer[:, None], jnp.stack([u, v], -1), uv_best)
            prim_best = jnp.where(closer, ti, prim_best)
            valid = valid | closer
        next_node = jnp.where(box_hit & ~is_leaf, nd + 1, skip)
        next_node = jnp.where(active, next_node, node)
        return next_node, t_best, uv_best, prim_best, valid, steps + 1

    init = (
        jnp.zeros(n, jnp.int32),
        jnp.full(n, jnp.inf),
        jnp.zeros((n, 2)),
        jnp.zeros(n, jnp.int32),
        jnp.zeros(n, bool),
        jnp.zeros((), jnp.int32),
    )
    _, t_best, uv_best, prim_best, valid, steps = jax.lax.while_loop(
        cond, body, init)
    return t_best, uv_best[:, 0], uv_best[:, 1], prim_best, valid, steps


def _xf_ray(ray: Ray, xf_row):
    """Transform a ray by a (12,) world->object 3x4 row (t is invariant:
    the direction transforms linearly, no renormalization)."""
    M = xf_row.reshape(3, 4)
    o = ray.o @ M[:, :3].T + M[:, 3]
    d = ray.d @ M[:, :3].T
    return Ray(o=o, d=d, mint=ray.mint, maxt=ray.maxt)


def _instances_closest(geom: GeometryTables, ray: Ray, t_best, uv_b,
                       prim_b, valid_b):
    """Exact closest-hit against every instance via the per-group walk
    (trace-time loop over instances; groups shared). Merges into the
    incoming best record; instanced prims are virtual ids >= n_tris."""
    u_b, v_b = uv_b
    for ii, gi in enumerate(geom.inst_gid):
        sub = geom.inst_groups[gi]
        r2 = _xf_ray(ray, geom.inst_xf_inv[ii])
        r2 = replace(r2, maxt=jnp.minimum(r2.maxt, t_best))
        t, u, v, p, ok = _closest_bvh(sub, r2)
        closer = ok & (t < t_best)
        vp = geom.inst_vp_base[ii] + geom.inst_tri2virt[gi][
            jnp.clip(p, 0, sub.n_tris - 1)]
        t_best = jnp.where(closer, t, t_best)
        u_b = jnp.where(closer, u, u_b)
        v_b = jnp.where(closer, v, v_b)
        prim_b = jnp.where(closer, vp, prim_b)
        valid_b = valid_b | closer
    return t_best, u_b, v_b, prim_b, valid_b


def _instances_any(geom: GeometryTables, ray: Ray):
    occ = jnp.zeros(ray.o.shape[0], bool)
    for ii, gi in enumerate(geom.inst_gid):
        sub = geom.inst_groups[gi]
        r2 = _xf_ray(ray, geom.inst_xf_inv[ii])
        occ = occ | _any_bvh(sub, r2)
    return occ


def _any_bvh(geom: GeometryTables, ray: Ray):
    n = ray.o.shape[0]
    m_nodes = geom.bvh_min.shape[0]
    inv_d = m.safe_rcp(ray.d)
    nodes = geom.bvh_packed
    tris = geom.tri_packed

    def cond(state):
        node, occluded = state
        return jnp.any((node < m_nodes) & ~occluded)

    def body(state):
        node, occluded = state
        nd = jnp.minimum(node, m_nodes - 1)
        row = nodes[nd]
        bmin, bmax = row[:, 0:3], row[:, 3:6]
        first = row[:, 6].astype(jnp.int32)
        count = row[:, 7].astype(jnp.int32)
        skip = row[:, 8].astype(jnp.int32)
        active = (node < m_nodes) & ~occluded
        box_hit = active & _slab_test(bmin, bmax, ray.o, inv_d, ray.mint, ray.maxt)
        is_leaf = count > 0
        do_tris = box_hit & is_leaf
        hit_any = jnp.zeros_like(occluded)
        for k in range(MAX_LEAF):
            ti = jnp.minimum(first + k, geom.n_tris - 1)
            trow = tris[ti]
            _, _, _, hit = _mt_hit(
                ray.o, ray.d, trow[:, 0:3], trow[:, 3:6], trow[:, 6:9],
                ray.mint, ray.maxt,
            )
            hit_any = hit_any | (hit & do_tris & (k < count))
        occluded = occluded | hit_any
        next_node = jnp.where(box_hit & ~is_leaf, nd + 1, skip)
        next_node = jnp.where(active, next_node, node)
        return next_node, occluded

    init = (jnp.zeros(n, jnp.int32), jnp.zeros(n, bool))
    _, occluded = jax.lax.while_loop(cond, body, init)
    return occluded


# ---------------------------------------------------------------------------
# Triangle queries: shading record, brute-force dispatch
# ---------------------------------------------------------------------------

def _make_intersection(ray: Ray, t, valid, prim, geo_n, sh_n, uv, dp_du,
                       material_id, emitter_id, shape_id) -> Intersection:
    """Intersection record from a hit and its shading attributes; lanes
    that missed carry t = inf and ids -1."""
    # finite position on miss: inf positions NaN downstream VJPs (NEE
    # directions at escaped lanes), even though masked
    p = ray.at(jnp.where(valid, t, 1.0))
    frame = m.Frame.from_normal_tangent(sh_n, dp_du)
    return Intersection(
        valid=valid,
        t=jnp.where(valid, t, jnp.inf),
        p=p,
        geo_n=geo_n,
        sh_n=sh_n,
        uv=uv,
        dp_du=dp_du,
        wi=frame.to_local(-ray.d),
        prim_id=jnp.where(valid, prim, -1),
        shape_id=jnp.where(valid, shape_id, -1),
        material_id=jnp.where(valid, material_id, -1),
        emitter_id=jnp.where(valid, emitter_id, -1),
    )


def _shade(geom: GeometryTables, ray: Ray, t, u, v, prim,
           valid) -> Intersection:
    """Full Intersection record of a triangle hit (reference skdtree.h:352
    fillIntersectionRecord equivalent)."""
    prim_raw = jnp.where(valid, prim, 0)
    is_inst = jnp.zeros_like(valid)
    if geom.has_instances:
        is_inst = valid & (prim_raw >= geom.n_tris)
    prim = jnp.where(is_inst, 0, prim_raw)
    w = 1.0 - u - v
    # the whole shading record in ONE (N, 24) row-gather (field layout:
    # GeometryTables.shade_pack)
    sp_row = geom.shade_pack[prim]
    e1g, e2g = sp_row[:, 0:3], sp_row[:, 3:6]
    n0g, n1g, n2g = sp_row[:, 6:9], sp_row[:, 9:12], sp_row[:, 12:15]
    uv0g, uv1g, uv2g = (sp_row[:, 15:17], sp_row[:, 17:19],
                        sp_row[:, 19:21])
    material_id = jax.lax.bitcast_convert_type(sp_row[:, 21], jnp.int32)
    emitter_id = jax.lax.bitcast_convert_type(sp_row[:, 22], jnp.int32)
    shape_id = jax.lax.bitcast_convert_type(sp_row[:, 23], jnp.int32)
    geo_n = m.normalize(jnp.cross(e1g, e2g))
    sh_n = m.normalize(
        w[:, None] * n0g + u[:, None] * n1g + v[:, None] * n2g
    )
    uv = (
        w[:, None] * uv0g + u[:, None] * uv1g + v[:, None] * uv2g
    )
    if geom.has_instances:
        # virtual prims: decode (cluster, slot) and shade from the shared
        # object-space block tables, rotating directions to world space
        # (contravariant via the forward 3x3, normals via the inverse
        # transpose = the stored world->object rows transposed)
        K = geom.mt_k
        vp = jnp.maximum(prim_raw - geom.n_tris, 0)
        vcid = jnp.clip(vp // K, 0, geom.mt_block_id.shape[0] - 1)
        oid = geom.mt_block_id[vcid] * K + vp % K
        fwd = geom.mt_xform_fwd[vcid]            # (N, 12) object->world
        inv = geom.mt_xform[vcid]                # (N, 12) world->object

        def rot_fwd(vec):
            return jnp.stack(
                [fwd[:, 0] * vec[:, 0] + fwd[:, 1] * vec[:, 1]
                 + fwd[:, 2] * vec[:, 2],
                 fwd[:, 4] * vec[:, 0] + fwd[:, 5] * vec[:, 1]
                 + fwd[:, 6] * vec[:, 2],
                 fwd[:, 8] * vec[:, 0] + fwd[:, 9] * vec[:, 1]
                 + fwd[:, 10] * vec[:, 2]], axis=-1)

        def rot_normal(nvec):
            # world normal ∝ M_wo^T n_obj  (M_wo = inverse linear part)
            return jnp.stack(
                [inv[:, 0] * nvec[:, 0] + inv[:, 4] * nvec[:, 1]
                 + inv[:, 8] * nvec[:, 2],
                 inv[:, 1] * nvec[:, 0] + inv[:, 5] * nvec[:, 1]
                 + inv[:, 9] * nvec[:, 2],
                 inv[:, 2] * nvec[:, 0] + inv[:, 6] * nvec[:, 1]
                 + inv[:, 10] * nvec[:, 2]], axis=-1)

        e1w = rot_fwd(geom.obj_e1[oid])
        e2w = rot_fwd(geom.obj_e2[oid])
        geo_n_i = m.normalize(jnp.cross(e1w, e2w))
        n_obj = (w[:, None] * geom.obj_n0[oid]
                 + u[:, None] * geom.obj_n1[oid]
                 + v[:, None] * geom.obj_n2[oid])
        sh_n_i = m.normalize(rot_normal(n_obj))
        uv_i = (w[:, None] * geom.obj_uv0[oid]
                + u[:, None] * geom.obj_uv1[oid]
                + v[:, None] * geom.obj_uv2[oid])
        mask = is_inst[:, None]
        geo_n = jnp.where(mask, geo_n_i, geo_n)
        sh_n = jnp.where(mask, sh_n_i, sh_n)
        uv = jnp.where(mask, uv_i, uv)
        material_id = jnp.where(is_inst, geom.obj_mid[oid], material_id)
        emitter_id = jnp.where(is_inst, -1, emitter_id)
        shape_id = jnp.where(is_inst, geom.obj_sid[oid], shape_id)
    # true parametric dp_du from the uv parameterization (reference
    # trimesh.cpp fillIntersectionRecord): solve [e1 e2] = [dp_du dp_dv]
    # * [duv1 duv2]; falls back to e1 for degenerate uv charts
    duv1 = uv1g - uv0g
    duv2 = uv2g - uv0g
    det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    ok_uv = jnp.abs(det_uv) > 1e-12
    inv_det = 1.0 / jnp.where(ok_uv, det_uv, 1.0)
    dp_du = jnp.where(
        ok_uv[:, None],
        (duv2[:, 1:2] * e1g - duv1[:, 1:2] * e2g)
        * inv_det[:, None],
        e1g)
    if geom.has_instances:
        duv1i = geom.obj_uv1[oid] - geom.obj_uv0[oid]
        duv2i = geom.obj_uv2[oid] - geom.obj_uv0[oid]
        det_i = duv1i[:, 0] * duv2i[:, 1] - duv1i[:, 1] * duv2i[:, 0]
        ok_i = jnp.abs(det_i) > 1e-12
        inv_i = 1.0 / jnp.where(ok_i, det_i, 1.0)
        dp_du_i = jnp.where(
            ok_i[:, None],
            (duv2i[:, 1:2] * e1w - duv1i[:, 1:2] * e2w) * inv_i[:, None],
            e1w)
        dp_du = jnp.where(is_inst[:, None], dp_du_i, dp_du)
    return _make_intersection(ray, t, valid, prim_raw, geo_n, sh_n, uv,
                              dp_du, material_id, emitter_id, shape_id)


def _brute_plain(geom: GeometryTables, ray, sray):
    """XLA brute-force queries: closest-hit record of `ray` and occlusion
    of `sray` (either may be None). The reference for _brute_kernel."""
    its = None if ray is None else _shade(geom, ray,
                                          *_closest_brute(geom, ray))
    occ = None if sray is None else _any_brute(geom, sray)
    return its, occ


def _brute_kernel(geom: GeometryTables, ray, sray, interpret: bool = False):
    """_brute_plain through the Pallas Triton kernel (ops/brute_triton.py):
    one launch, one triangle loop for both queries, shading in-kernel.

    Under the detached estimator the kernel's inputs carry no tangent (the
    rays and the geometry are not parameters); stop_gradient states that,
    so differentiation never reaches the kernel."""
    from mitsuba_jax.ops import brute_triton as bt

    sg = jax.lax.stop_gradient

    def rows(r):
        return None if r is None else sg(bt.pack_rays(r.o, r.d, r.mint,
                                                      r.maxt))

    rec_f, rec_i, occ = bt.brute_hits(
        sg(geom.tri_packed), sg(geom.shade_pack), rows(ray), rows(sray),
        interpret=interpret)
    if ray is None:
        return None, occ
    prim = rec_i[0]
    valid = prim >= 0
    its = _make_intersection(
        ray, rec_f[0], valid, jnp.maximum(prim, 0),
        geo_n=rec_f[3:6].T, sh_n=rec_f[6:9].T, uv=rec_f[9:11].T,
        dp_du=rec_f[11:14].T, material_id=rec_i[1], emitter_id=rec_i[2],
        shape_id=rec_i[3])
    return its, occ


def _brute(geom: GeometryTables, ray, sray):
    """Brute-force queries, by the platform being lowered for: the Triton
    kernel on CUDA, the plain XLA version elsewhere."""
    return jax.lax.platform_dependent(geom, ray, sray, cuda=_brute_kernel,
                                      default=_brute_plain)


def _ray_intersect_tri(geom: GeometryTables, ray: Ray) -> Intersection:
    """Triangle-only closest-hit query → full Intersection record."""
    if geom.backend == "brute":
        return _brute(geom, ray, None)[0]
    t, u, v, prim, valid = _closest_bvh(geom, ray)
    if geom.has_instances:
        t, u, v, prim, valid = _instances_closest(
            geom, ray, t, (u, v), prim, valid)
    return _shade(geom, ray, t, u, v, prim, valid)


def _ray_test_tri(geom: GeometryTables, ray: Ray) -> jnp.ndarray:
    if geom.backend == "brute":
        return _brute(geom, None, ray)[1]
    occ = _any_bvh(geom, ray)
    if geom.has_instances:
        occ = occ | _instances_any(geom, ray)
    return occ


def _ray_intersect_and_test_tri(geom: GeometryTables, ray: Ray,
                                sray: Ray):
    """Closest hit (ray) + shadow any-hit (sray); one fused launch on the
    brute path. Returns (Intersection, occluded)."""
    if geom.backend == "brute":
        return _brute(geom, ray, sray)
    return _ray_intersect_tri(geom, ray), _ray_test_tri(geom, sray)


# ---------------------------------------------------------------------------
# Analytic primitives (reference src/shapes/sphere.cpp, cylinder.cpp):
# intersected in plain XLA against every ray (S and C are small) and merged
# with the triangle result — no prim-type switch inside the triangle kernel.
# ---------------------------------------------------------------------------

def _sphere_closest(geom: GeometryTables, ray: Ray):
    """(t, sphere_index, valid) of the nearest analytic sphere hit.

    Static Python loop over the (few) spheres with flat (N,) math, ~20
    elementwise (N,) ops per sphere."""
    S = geom.sph_c.shape[0]
    t_best = jnp.full(ray.o.shape[0], jnp.inf)
    idx = jnp.zeros(ray.o.shape[0], jnp.int32)
    for si in range(S):
        c = geom.sph_c[si]
        r = geom.sph_r[si]
        oc = ray.o - c[None]
        b = jnp.sum(oc * ray.d, axis=-1)
        cq = jnp.sum(oc * oc, axis=-1) - r * r
        disc = b * b - cq
        ok = disc >= 0.0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = -b - sq
        t1 = -b + sq
        t = jnp.where(ok & (t0 > ray.mint), t0,
                      jnp.where(ok & (t1 > ray.mint), t1, jnp.inf))
        t = jnp.where(t < ray.maxt, t, jnp.inf)
        better = t < t_best
        t_best = jnp.where(better, t, t_best)
        idx = jnp.where(better, si, idx)
    return t_best, idx, jnp.isfinite(t_best)


def _cylinder_closest(geom: GeometryTables, ray: Ray):
    """(t, cyl_index, valid): finite open cylinder (no end caps —
    reference cylinder.cpp). Flat static loop — see _sphere_closest."""
    C = geom.cyl_a.shape[0]
    t_best = jnp.full(ray.o.shape[0], jnp.inf)
    idx = jnp.zeros(ray.o.shape[0], jnp.int32)
    for ci in range(C):
        a = geom.cyl_a[ci]
        ax = geom.cyl_b[ci] - a
        r = geom.cyl_r[ci]
        ln = jnp.maximum(jnp.linalg.norm(ax), 1e-12)
        u = ax / ln
        oc = ray.o - a[None]
        du = jnp.sum(ray.d * u[None], axis=-1)
        ou = jnp.sum(oc * u[None], axis=-1)
        dp = ray.d - du[:, None] * u[None]
        op = oc - ou[:, None] * u[None]
        A = jnp.maximum(jnp.sum(dp * dp, axis=-1), 1e-12)
        B = jnp.sum(dp * op, axis=-1)
        Cq = jnp.sum(op * op, axis=-1) - r * r
        disc = B * B - A * Cq
        ok = disc >= 0.0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = (-B - sq) / A
        t1 = (-B + sq) / A

        def axial_ok(t):
            s_ax = ou + t * du
            return (s_ax >= 0.0) & (s_ax <= ln)

        ok0 = ok & (t0 > ray.mint) & axial_ok(t0)
        ok1 = ok & (t1 > ray.mint) & axial_ok(t1)
        t = jnp.where(ok0, t0, jnp.where(ok1, t1, jnp.inf))
        t = jnp.where(t < ray.maxt, t, jnp.inf)
        better = t < t_best
        t_best = jnp.where(better, t, t_best)
        idx = jnp.where(better, ci, idx)
    return t_best, idx, jnp.isfinite(t_best)


def _pack_hair(hair):
    """Pack hair segments + their skip-link BVH into GeometryTables
    fields. hair: dict(a, b, r, u0, u1, mid, eid, sid) arrays."""
    from mitsuba_jax.render.bvh import build_bvh_boxes

    a = np.asarray(hair["a"], np.float32)
    b = np.asarray(hair["b"], np.float32)
    r = np.asarray(hair["r"], np.float32)
    pmin = np.minimum(a, b) - r[:, None]
    pmax = np.maximum(a, b) + r[:, None]
    bvh = build_bvh_boxes(pmin, pmax)
    perm = bvh.perm
    segs = np.zeros((a.shape[0], 16), np.float32)
    segs[:, 0:3] = a[perm]
    segs[:, 3:6] = b[perm]
    segs[:, 6] = r[perm]
    segs[:, 7] = np.asarray(hair["u0"], np.float32)[perm]
    segs[:, 8] = np.asarray(hair["u1"], np.float32)[perm]
    segs[:, 9] = np.asarray(hair["mid"], np.float32)[perm]
    segs[:, 10] = np.asarray(hair["eid"], np.float32)[perm]
    segs[:, 11] = np.asarray(hair["sid"], np.float32)[perm]
    nodes = np.concatenate(
        [bvh.bounds_min, bvh.bounds_max,
         bvh.first[:, None].astype(np.float32),
         bvh.count[:, None].astype(np.float32),
         bvh.skip[:, None].astype(np.float32)], axis=1)
    return dict(hair_nodes=jnp.asarray(nodes), hair_segs=jnp.asarray(segs))


def _cyl_seg_hit(o, d, rows, mint, tcap):
    """Finite open-cylinder test of gathered segment rows (N, 16)
    against per-lane rays. Returns (t, axial_frac, valid)."""
    a = rows[:, 0:3]
    ax = rows[:, 3:6] - a
    r = rows[:, 6]
    ln = jnp.maximum(jnp.linalg.norm(ax, axis=-1), 1e-12)
    u = ax / ln[:, None]
    oc = o - a
    du = jnp.sum(d * u, axis=-1)
    ou = jnp.sum(oc * u, axis=-1)
    dp = d - du[:, None] * u
    op = oc - ou[:, None] * u
    A = jnp.maximum(jnp.sum(dp * dp, axis=-1), 1e-12)
    B = jnp.sum(dp * op, axis=-1)
    Cq = jnp.sum(op * op, axis=-1) - r * r
    disc = B * B - A * Cq
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = (-B - sq) / A
    t1 = (-B + sq) / A

    def axial_ok(t):
        s_ax = ou + t * du
        return (s_ax >= 0.0) & (s_ax <= ln)

    ok0 = ok & (t0 > mint) & axial_ok(t0)
    ok1 = ok & (t1 > mint) & axial_ok(t1)
    t = jnp.where(ok0, t0, jnp.where(ok1, t1, jnp.inf))
    valid = (ok0 | ok1) & (t < tcap)
    frac = jnp.clip((ou + t * du) / ln, 0.0, 1.0)
    return t, frac, valid


def _hair_walk(geom: GeometryTables, ray: Ray, any_hit: bool):
    """Phased skip-link walk over the hair segment BVH: each iteration
    makes one node gather and one segment gather (lanes inside a leaf
    test one segment), with the cylinder test in place of
    Moeller-Trumbore."""
    n = ray.o.shape[0]
    m_nodes = geom.hair_nodes.shape[0]
    n_segs = geom.hair_segs.shape[0]
    inv_d = m.safe_rcp(ray.d)
    nodes = geom.hair_nodes
    segs = geom.hair_segs
    cap = (MAX_LEAF + 1) * m_nodes + 8

    def cond(st):
        node, lf, lc, lk, steps, t_best, frac, prim, valid = st
        live = (node < m_nodes) | (lk < lc)
        if any_hit:
            live = live & ~valid
        return jnp.any(live) & (steps < cap)

    def body(st):
        node, lf, lc, lk, steps, t_best, frac_b, prim_b, valid = st
        in_leaf = lk < lc
        if any_hit:
            in_leaf = in_leaf & ~valid
        si = jnp.minimum(lf + jnp.minimum(lk, MAX_LEAF - 1), n_segs - 1)
        rows = segs[si]                         # one gather
        t, frac, hit = _cyl_seg_hit(ray.o, ray.d, rows, ray.mint,
                                    jnp.minimum(ray.maxt, t_best))
        closer = in_leaf & hit & (t < t_best)
        t_best = jnp.where(closer, t, t_best)
        frac_b = jnp.where(closer, frac, frac_b)
        prim_b = jnp.where(closer, si, prim_b)
        valid = valid | closer
        lk = jnp.where(in_leaf, lk + 1, lk)
        do_node = ~in_leaf & (node < m_nodes)
        if any_hit:
            do_node = do_node & ~valid
        nd = jnp.minimum(node, m_nodes - 1)
        row = nodes[nd]                         # one gather
        first = row[:, 6].astype(jnp.int32)
        count = row[:, 7].astype(jnp.int32)
        skip = row[:, 8].astype(jnp.int32)
        box_hit = do_node & _slab_test(row[:, 0:3], row[:, 3:6], ray.o,
                                       inv_d, ray.mint,
                                       jnp.minimum(ray.maxt, t_best))
        is_leaf = count > 0
        enter = box_hit & is_leaf
        lf = jnp.where(enter, first, lf)
        lc = jnp.where(enter, jnp.minimum(count, MAX_LEAF), lc)
        lk = jnp.where(enter, 0, lk)
        node = jnp.where(
            do_node, jnp.where(box_hit & ~is_leaf, nd + 1, skip), node)
        return (node, lf, lc, lk, steps + 1, t_best, frac_b, prim_b,
                valid)

    z = jnp.zeros(n, jnp.int32)
    st = (z, z, z, z, jnp.zeros((), jnp.int32),
          jnp.where(jnp.isfinite(ray.maxt), ray.maxt, jnp.inf),
          jnp.zeros(n), z, jnp.zeros(n, bool))
    st = jax.lax.while_loop(cond, body, st)
    return st[5], st[6], st[7], st[8]


def _hair_any(geom: GeometryTables, ray: Ray):
    _, _, _, valid = _hair_walk(geom, ray, any_hit=True)
    return valid


def _merge_hair(geom: GeometryTables, ray: Ray, its: Intersection):
    """Override the Intersection where a hair segment is nearer.
    uv: u = phi around the fiber, v = arclength along the fiber."""
    t, frac, si, valid = _hair_walk(geom, ray, any_hit=False)
    closer = valid & (t < its.t)
    rows = geom.hair_segs[si]
    a = rows[:, 0:3]
    ax = rows[:, 3:6] - a
    ln = jnp.maximum(jnp.linalg.norm(ax, axis=-1), 1e-12)
    u_ax = ax / ln[:, None]
    p = ray.at(jnp.where(closer, t, 1.0))
    s_ax = jnp.sum((p - a) * u_ax, axis=-1)
    nrm = m.normalize(p - a - s_ax[:, None] * u_ax)
    frame_phi = m.Frame.from_normal(u_ax)
    lp = frame_phi.to_local(nrm)
    phi = jnp.arctan2(lp[:, 1], lp[:, 0])
    v_par = rows[:, 7] + frac * (rows[:, 8] - rows[:, 7])
    uv = jnp.stack([phi * (0.5 / jnp.pi) + 0.5, v_par], -1)
    dpdu = m.normalize(jnp.cross(u_ax, nrm))
    frame = m.Frame.from_normal_tangent(nrm, dpdu)
    wi = frame.to_local(-ray.d)
    base = geom.n_tris + geom.n_spheres + geom.n_cylinders
    c2 = closer[:, None]
    return Intersection(
        valid=its.valid | closer,
        t=jnp.where(closer, t, its.t),
        p=jnp.where(c2, p, its.p),
        geo_n=jnp.where(c2, nrm, its.geo_n),
        sh_n=jnp.where(c2, nrm, its.sh_n),
        uv=jnp.where(c2, uv, its.uv),
        dp_du=jnp.where(c2, dpdu, its.dp_du),
        wi=jnp.where(c2, wi, its.wi),
        prim_id=jnp.where(closer, base + si, its.prim_id),
        shape_id=jnp.where(closer, rows[:, 11].astype(jnp.int32),
                           its.shape_id),
        material_id=jnp.where(closer, rows[:, 9].astype(jnp.int32),
                              its.material_id),
        emitter_id=jnp.where(closer, rows[:, 10].astype(jnp.int32),
                             its.emitter_id),
    )


def _analytic_any(geom: GeometryTables, ray: Ray):
    occ = jnp.zeros(ray.o.shape[0], bool)
    if geom.n_spheres > 0:
        _, _, v = _sphere_closest(geom, ray)
        occ = occ | v
    if geom.n_cylinders > 0:
        _, _, v = _cylinder_closest(geom, ray)
        occ = occ | v
    return occ


def _merge_analytic(geom: GeometryTables, ray: Ray, its: Intersection):
    """Override the triangle Intersection where an analytic primitive is
    nearer. Prim-id space: spheres [T, T+S), cylinders [T+S, T+S+C)."""
    T = geom.n_tris
    best = its
    if geom.n_spheres > 0:
        t, i, v = _sphere_closest(geom, ray)
        closer = v & (t < best.t)
        p = ray.at(jnp.where(closer, t, 1.0))
        n = m.normalize(p - geom.sph_c[i])
        # reference sphere.cpp uv: phi/theta spherical parameterisation
        phi = jnp.arctan2(n[:, 1], n[:, 0])
        theta = jnp.arccos(jnp.clip(n[:, 2], -1.0, 1.0))
        uv = jnp.stack([phi * (0.5 / jnp.pi) + 0.5, theta / jnp.pi], -1)
        dpdu = m.normalize(jnp.stack(
            [-n[:, 1], n[:, 0], jnp.zeros_like(n[:, 0])], -1)
            + 1e-12 * jnp.ones((1, 3)))
        # same frame construction as Intersection.frame() (wi/to_world
        # consistency)
        frame = m.Frame.from_normal_tangent(n, dpdu)
        wi = frame.to_local(-ray.d)
        best = Intersection(
            valid=best.valid | closer,
            t=jnp.where(closer, t, best.t),
            p=jnp.where(closer[:, None], p, best.p),
            geo_n=jnp.where(closer[:, None], n, best.geo_n),
            sh_n=jnp.where(closer[:, None], n, best.sh_n),
            uv=jnp.where(closer[:, None], uv, best.uv),
            dp_du=jnp.where(closer[:, None], dpdu, best.dp_du),
            wi=jnp.where(closer[:, None], wi, best.wi),
            prim_id=jnp.where(closer, T + i, best.prim_id),
            shape_id=jnp.where(closer, geom.sph_sid[i], best.shape_id),
            material_id=jnp.where(closer, geom.sph_mid[i],
                                  best.material_id),
            emitter_id=jnp.where(closer, geom.sph_eid[i], best.emitter_id),
        )
    if geom.n_cylinders > 0:
        t, i, v = _cylinder_closest(geom, ray)
        closer = v & (t < best.t)
        a = geom.cyl_a[i]
        ax = geom.cyl_b[i] - a
        ln = jnp.maximum(jnp.linalg.norm(ax, axis=-1), 1e-12)
        u_ax = ax / ln[:, None]
        p = ray.at(jnp.where(closer, t, 1.0))
        s_ax = jnp.sum((p - a) * u_ax, axis=-1)
        n = m.normalize(p - a - s_ax[:, None] * u_ax)
        frame_phi = m.Frame.from_normal(u_ax)
        lp = frame_phi.to_local(n)
        phi = jnp.arctan2(lp[:, 1], lp[:, 0])
        uv = jnp.stack([phi * (0.5 / jnp.pi) + 0.5, s_ax / ln], -1)
        dpdu = m.normalize(jnp.cross(u_ax, n))
        frame = m.Frame.from_normal_tangent(n, dpdu)
        wi = frame.to_local(-ray.d)
        S = geom.n_spheres
        best = Intersection(
            valid=best.valid | closer,
            t=jnp.where(closer, t, best.t),
            p=jnp.where(closer[:, None], p, best.p),
            geo_n=jnp.where(closer[:, None], n, best.geo_n),
            sh_n=jnp.where(closer[:, None], n, best.sh_n),
            uv=jnp.where(closer[:, None], uv, best.uv),
            dp_du=jnp.where(closer[:, None], dpdu, best.dp_du),
            wi=jnp.where(closer[:, None], wi, best.wi),
            prim_id=jnp.where(closer, T + S + i, best.prim_id),
            shape_id=jnp.where(closer, geom.cyl_sid[i], best.shape_id),
            material_id=jnp.where(closer, geom.cyl_mid[i],
                                  best.material_id),
            emitter_id=jnp.where(closer, geom.cyl_eid[i], best.emitter_id),
        )
    return best


def ray_intersect(geom: GeometryTables, ray: Ray) -> Intersection:
    """Closest-hit query → full Intersection record; triangles via the
    backend, analytic primitives merged in XLA."""
    its = _ray_intersect_tri(geom, ray)
    if geom.has_analytic:
        its = _merge_analytic(geom, ray, its)
    if geom.n_hair > 0:
        its = _merge_hair(geom, ray, its)
    return its


def ray_test(geom: GeometryTables, ray: Ray) -> jnp.ndarray:
    """Any-hit (shadow ray) query → bool occlusion mask (reference
    scene.h:241 isOccluded equivalent)."""
    occ = _ray_test_tri(geom, ray)
    if geom.has_analytic:
        occ = occ | _analytic_any(geom, ray)
    if geom.n_hair > 0:
        occ = occ | _hair_any(geom, ray)
    return occ


def ray_intersect_and_test(geom: GeometryTables, ray: Ray, sray: Ray):
    """Closest-hit (ray) + shadow any-hit (sray) — one kernel launch with
    a shared triangle loop on the CUDA brute path; separate queries
    elsewhere.  Returns (Intersection, occluded)."""
    its, occ = _ray_intersect_and_test_tri(geom, ray, sray)
    if geom.has_analytic:
        its = _merge_analytic(geom, ray, its)
        occ = occ | _analytic_any(geom, sray)
    if geom.n_hair > 0:
        its = _merge_hair(geom, ray, its)
        occ = occ | _hair_any(geom, sray)
    return its, occ
