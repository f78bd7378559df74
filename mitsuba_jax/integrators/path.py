"""Wavefront MIS path tracer — the flagship integrator.

Functional parity with the reference `MIPathTracer::Li`
(src/integrators/path/path.cpp:47): next-event estimation + BSDF sampling
combined with the power heuristic (path.cpp:218 miWeight), Russian roulette
after `rr_depth` exempting transmission events (path.cpp:196), one-sided
area emitters, background luminaire on miss.

Architecture is entirely different: instead of a recursive `Li` per ray on
a thread pool, ALL rays advance in lockstep through a statically unrolled
bounce loop over SoA buffers (the wavefront). Terminated lanes are masked,
never compacted — divergence is just a mask.
Each bounce is optionally wrapped in `jax.checkpoint` so reverse-mode AD
memory stays O(1) in depth.

Differentiability: every sampling decision (NEE record choice, BSDF lobe +
direction, RR) is wrapped in stop_gradient ("detached sampling"); radiance
values, BSDF evals and pdf ratios stay differentiable, so
grad(render) flows to material/emitter parameters unbiasedly for
continuous integrands.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from mitsuba_jax.bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_jax.core import math as m
from mitsuba_jax.core.types import replace
from mitsuba_jax.emitters import (
    eval_and_pdf_environment,
    eval_emitter_hit,
    eval_environment,
    pdf_direct_area,
    pdf_environment,
    sample_direct,
)
from mitsuba_jax.render.intersect import (
    ray_intersect, ray_intersect_and_test, ray_test,
)
from mitsuba_jax.render.records import Ray
from mitsuba_jax.render.sampler import Sampler, sample_position


@dataclass(frozen=True)
class PathConfig:
    max_depth: int = 5          # reference maxDepth (bounces incl. first hit)
    rr_depth: int = 10          # start Russian roulette after this depth
    spp: int = 16
    pattern: str = "independent"
    remat: bool = True          # checkpoint each bounce for reverse-mode AD
    strict_normals: bool = False
    rfilter: str = "box"        # reconstruction filter (render/rfilter.py)
    sort_rays: bool = False     # Morton-sort rays per bounce (packet-BVH
                                # coherence for large scenes)
    sort_mode: str = "full"     # 'full' octant-major Morton argsort |
                                # 'octant' stable linear counting-sort
                                # (lanes already arrive pixel-Morton)
    hit_prediction: bool = False  # hash-based ray-path prediction
                                # (arXiv:1910.01304): a (cell, octant)
                                # table of recently-hit prims gives exact
                                # maxt bounds for closest hits and a
                                # shadow cache for NEE rays
    mip_filter: bool = False    # ray-cone texture lod (needs
                                # SceneBuilder(build_mips=True) pyramids)
    aniso_filter: bool = False  # EWA anisotropic filtering in the render
                                # path (implies mip_filter; reference
                                # mipmap.h:110 EWA)
    skip_direct_emission: bool = False  # zero the depth-0 emitter-hit and
                                # env-escape terms: the SSS irradiance
                                # cache adds its own NEE direct estimate
                                # and uses path_trace for INDIRECT-only
                                # incident radiance (dipole.cpp splits
                                # direct/indirect samples the same way)


def mi_weight(pdf_a, pdf_b):
    """Power heuristic, beta=2 (reference path.cpp:218)."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return jnp.where(pdf_a > 0, a2 / jnp.maximum(a2 + b2, 1e-20), 0.0)


def _detach(x):
    return jax.lax.stop_gradient(x)


def _morton_keys(o, d, bmin, bmax):
    """Sort key: direction OCTANT in the top bits, then a 3x10-bit Morton
    code of the origin within the scene bbox: neighbouring lanes then
    share direction signs and nearby origins, so they walk similar
    parts of the tree."""
    q = jnp.clip((o - bmin) / jnp.maximum(bmax - bmin, 1e-6) * 1023.0, 0, 1023)
    q = q.astype(jnp.int32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    morton = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    octant = (
        (d[:, 0] > 0).astype(jnp.int32)
        + 2 * (d[:, 1] > 0).astype(jnp.int32)
        + 4 * (d[:, 2] > 0).astype(jnp.int32)
    )
    # octant << 30 overflows int32 (4 << 30 wraps to 0), which aliased
    # octants 4-7 onto 0-3 and silently mixed d_z signs within rows —
    # exactly the degenerate-interval case octant-major exists to avoid.
    # Drop 3 low Morton bits so the key fits 30 bits (the finest Morton
    # level is far below a 128-lane row's spatial footprint anyway).
    return (octant << 27) | (morton >> 3)


def pixel_morton_perm(w: int, h: int) -> "np.ndarray":
    """Host-side static permutation: wavefront slot i -> pixel index in
    Morton (Z-curve) order. A 128-lane ray row then covers a compact
    pixel tile instead of a 128x1 scanline strip — the work-list cluster
    cull's per-row frusta shrink ~3x (scanline rows touched 13.9
    clusters/row on the bunny, Morton tiles 4.5)."""
    import numpy as np

    ix = np.arange(w * h, dtype=np.uint64) % np.uint64(w)
    iy = np.arange(w * h, dtype=np.uint64) // np.uint64(w)

    def spread(x):
        x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
        x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
        x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
        return x

    code = spread(ix) | (spread(iy) << np.uint64(1))
    return np.argsort(code, kind="stable")


def _inverse_perm(order):
    """Invert a permutation with one scatter (a second argsort would be
    another full O(n log n) device sort; the scatter is one linear pass)."""
    n = order.shape[0]
    return jnp.zeros(n, order.dtype).at[order].set(
        jnp.arange(n, dtype=order.dtype), unique_indices=True,
        indices_are_sorted=False)


def _octant_partition(keys):
    """Stable counting-sort permutation over small keys (octant 0-7 +
    dead bucket 8). Lanes arrive in pixel-Morton camera order and hit
    points inherit that spatial coherence, so partitioning bounce rays
    by direction octant alone (keeping the stable spatial order within
    each bucket) approximates the full octant-major Morton re-sort at
    the cost of a few linear passes instead of an O(n log n) device
    sort."""
    nb = 9
    onehot = (keys[:, None] == jnp.arange(nb, dtype=keys.dtype)[None, :])
    counts = jnp.sum(onehot, axis=0)
    offsets = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    rank = jnp.cumsum(onehot.astype(jnp.int32), axis=0) - 1
    pos = offsets[keys] + jnp.take_along_axis(
        rank, keys[:, None].astype(jnp.int32), axis=1)[:, 0]
    n = keys.shape[0]
    order = jnp.zeros(n, jnp.int32).at[pos].set(
        jnp.arange(n, dtype=jnp.int32), unique_indices=True)
    return order, pos


_PRED_BITS = 21          # 2^21-entry prediction table (8 MB int32)


def _pred_keys(o, d, bmin, bmax):
    """Prediction-table key: 6 bits/axis origin cell + direction octant
    (arXiv:1910.01304 hashes origin/direction into a table of recent
    hits; a 64^3 cell grid keeps collisions spatially plausible)."""
    q = jnp.clip((o - bmin) / jnp.maximum(bmax - bmin, 1e-6) * 63.0,
                 0, 63).astype(jnp.int32)
    cell = (q[:, 0] << 12) | (q[:, 1] << 6) | q[:, 2]
    octant = ((d[:, 0] > 0).astype(jnp.int32)
              + 2 * (d[:, 1] > 0).astype(jnp.int32)
              + 4 * (d[:, 2] > 0).astype(jnp.int32))
    return (octant << 18) | cell


def _bounce_order(ray, bmin, bmax, mode: str, need_inv: bool = True):
    """Per-bounce ray ordering: 'full' = octant-major Morton argsort,
    'octant' = stable octant counting-sort (linear). Returns
    (order, inv); need_inv=False skips the inverse-permutation scatter
    (callers that un-permute by SCATTERING through `order` — see
    _unperm_pytree — never need it) and returns (order, None)."""
    d = _detach(ray.d)
    dead = ray.maxt < ray.mint
    if mode == "octant":
        oct_ = ((d[:, 0] > 0).astype(jnp.int32)
                + 2 * (d[:, 1] > 0).astype(jnp.int32)
                + 4 * (d[:, 2] > 0).astype(jnp.int32))
        keys = jnp.where(dead, 8, oct_)
        return _octant_partition(keys)
    keys = _morton_keys(_detach(ray.o), d, bmin, bmax)
    keys = jnp.where(dead, jnp.int32(0x7FFFFFFF), keys)
    order = jnp.argsort(keys)
    return order, (_inverse_perm(order) if need_inv else None)


def _perm_pytree(tree, order):
    """Permute every leaf of a pytree by `order` with ONE row-gather.

    tree_map(lambda x: x[order], tree) issues one (N,)-gather per
    channel. Packing all float channels into a single (N, C) matrix
    turns that into ONE row-gather whose per-index cost amortizes over C
    fields. Integer/bool leaves are bitcast into the same matrix."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    cols = []
    specs = []          # (ndim, width, dtype)
    for x in leaves:
        x2 = x[:, None] if x.ndim == 1 else x
        w = x2.shape[1]
        if x2.dtype == jnp.bool_:
            x2 = x2.astype(jnp.int32)
        if jnp.issubdtype(x2.dtype, jnp.integer):
            x2 = jax.lax.bitcast_convert_type(x2.astype(jnp.int32),
                                              jnp.float32)
        specs.append((x.ndim, w, x.dtype))
        cols.append(x2)
    packed = jnp.concatenate(cols, axis=1)
    g = packed[order]
    out = []
    c = 0
    for (ndim, w, dt) in specs:
        sl = g[:, c:c + w]
        c += w
        if dt == jnp.bool_:
            sl = jax.lax.bitcast_convert_type(sl, jnp.int32) != 0
        elif jnp.issubdtype(dt, jnp.integer):
            sl = jax.lax.bitcast_convert_type(sl, jnp.int32).astype(dt)
        out.append(sl[:, 0] if ndim == 1 else sl)
    return jax.tree_util.tree_unflatten(treedef, out)


def _unperm_pytree(tree, order):
    """Inverse of _perm_pytree WITHOUT materializing the inverse
    permutation: one packed row-SCATTER through the forward order
    (out[order[j]] = packed[j]). Used for the SINGLE-channel case (the
    shadow-occlusion bit in _sorted_test, where a scatter replaces a
    one-channel gather plus the inverse-perm build); a multi-channel
    row-scatter does not amortize like a row-gather does."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    cols = []
    specs = []
    for x in leaves:
        x2 = x[:, None] if x.ndim == 1 else x
        w = x2.shape[1]
        if x2.dtype == jnp.bool_:
            x2 = x2.astype(jnp.int32)
        if jnp.issubdtype(x2.dtype, jnp.integer):
            x2 = jax.lax.bitcast_convert_type(x2.astype(jnp.int32),
                                              jnp.float32)
        specs.append((x.ndim, w, x.dtype))
        cols.append(x2)
    packed = jnp.concatenate(cols, axis=1)
    g = jnp.zeros_like(packed).at[order].set(packed,
                                             unique_indices=True)
    out = []
    c = 0
    for (ndim, w, dt) in specs:
        sl = g[:, c:c + w]
        c += w
        if dt == jnp.bool_:
            sl = jax.lax.bitcast_convert_type(sl, jnp.int32) != 0
        elif jnp.issubdtype(dt, jnp.integer):
            sl = jax.lax.bitcast_convert_type(sl, jnp.int32).astype(dt)
        out.append(sl[:, 0] if ndim == 1 else sl)
    return jax.tree_util.tree_unflatten(treedef, out)


def _sorted_intersect(scene, ray, mode: str = "full",
                      presorted: bool = False):
    """Sort rays (dead lanes last — they'd otherwise widen live rows'
    conservative intervals with stale origins/directions), intersect,
    un-permute the record. presorted skips the sort (camera wavefronts
    already arrive in pixel-Morton order)."""
    if presorted:
        return ray_intersect(scene.geom, ray)
    bmin = scene.geom.bvh_min[0]
    bmax = scene.geom.bvh_max[0]
    order, inv = _bounce_order(ray, bmin, bmax, mode)
    ray_s = _perm_pytree(ray, order)
    its_s = ray_intersect(scene.geom, ray_s)
    return _perm_pytree(its_s, inv)


def _sorted_intersect_and_test(scene, ray, sray, mode: str = "full"):
    """One sort serves both queries of a bounce: the closest ray and the
    pending NEE shadow ray originate at the SAME hit points, so ray's
    octant-Morton order clusters sray nearly as well. One packed gather
    carries both ray sets; one packed un-permute returns the hit record
    and the occlusion bit (one sort and gather fewer than separate
    _sorted_intersect + _sorted_test)."""
    bmin = scene.geom.bvh_min[0]
    bmax = scene.geom.bvh_max[0]
    order, inv = _bounce_order(ray, bmin, bmax, mode)
    ray_s, sray_s = _perm_pytree((ray, sray), order)
    its_s = ray_intersect(scene.geom, ray_s)
    occ_s = ray_test(scene.geom, sray_s)
    its, occ = _perm_pytree((its_s, occ_s), inv)
    return its, occ


def _sorted_test(scene, ray, mode: str = "full"):
    """Sorted shadow-ray occlusion query. The single-bit result returns
    to lane space by SCATTERING through the forward order — occ[inv]
    would cost a full (N,)-gather plus the inverse-permutation build it
    is the only consumer of."""
    bmin = scene.geom.bvh_min[0]
    bmax = scene.geom.bvh_max[0]
    order, _inv = _bounce_order(ray, bmin, bmax, mode, need_inv=False)
    ray_s = _perm_pytree(ray, order)
    occ_s = ray_test(scene.geom, ray_s)
    return jnp.zeros(order.shape[0], bool).at[order].set(
        occ_s, unique_indices=True)


def _cone_duv_aniso(geom, its, d, width):
    """Anisotropic uv footprint of the ray cone at the hit (Akenine-Möller
    ray cones → the reference's RayDifferential::computeUVPartials,
    shape.cpp). The cone's disc (diameter `width`, ⊥ d) lands on the
    surface as an ellipse: major axis along d's tangent-plane projection
    stretched by 1/cosθ, minor axis perpendicular. World-space axes map to
    uv through the triangle chart with a 2×2 Gram solve on (e1, e2);
    analytic primitives fall back to an isotropic footprint via |dp_du|."""
    n = its.sh_n
    ndotd = jnp.sum(n * d, axis=-1)
    cos_v = jnp.abs(ndotd)
    d_proj = d - ndotd[:, None] * n
    lp2 = jnp.sum(d_proj * d_proj, axis=-1, keepdims=True)
    fr = its.frame()
    t_major = jnp.where(lp2 > 1e-12,
                        d_proj / jnp.sqrt(jnp.maximum(lp2, 1e-24)), fr.s)
    t_minor = jnp.cross(n, t_major)
    stretch = (width / jnp.maximum(cos_v, 0.05))[:, None]
    a_major = t_major * stretch
    a_minor = t_minor * width[:, None]

    prim_ok = (its.prim_id >= 0) & (its.prim_id < geom.n_tris)
    prim = jnp.clip(its.prim_id, 0, geom.n_tris - 1)
    e1, e2 = geom.e1[prim], geom.e2[prim]
    duv1 = geom.uv1[prim] - geom.uv0[prim]
    duv2 = geom.uv2[prim] - geom.uv0[prim]
    c11 = jnp.sum(e1 * e1, axis=-1)
    c12 = jnp.sum(e1 * e2, axis=-1)
    c22 = jnp.sum(e2 * e2, axis=-1)
    det = c11 * c22 - c12 * c12
    ok = prim_ok & (jnp.abs(det) > 1e-20)
    inv_det = 1.0 / jnp.where(ok, det, 1.0)

    def to_uv(a):
        a1 = jnp.sum(a * e1, axis=-1)
        a2 = jnp.sum(a * e2, axis=-1)
        b1 = (c22 * a1 - c12 * a2) * inv_det
        b2 = (c11 * a2 - c12 * a1) * inv_det
        return b1[:, None] * duv1 + b2[:, None] * duv2

    # isotropic fallback (analytic prims / degenerate charts)
    dens = jnp.maximum(m.length(its.dp_du), 1e-6)
    f = (width / (dens * jnp.maximum(cos_v, 0.1)))[:, None]
    iso_x = jnp.concatenate([f, jnp.zeros_like(f)], axis=-1)
    duv_dx = jnp.where(ok[:, None], to_uv(a_major), iso_x)
    duv_dy = jnp.where(ok[:, None], to_uv(a_minor), iso_x[:, ::-1])
    return duv_dx, duv_dy


def _glue_chunks() -> int:
    """MTS_GLUE_CHUNKS (default 1 = OFF): the bounce's post-intersection
    glue (pend resolve, escape env, emitter hit, albedo, NEE, BSDF
    sample, RR) runs as this many sequential lax.map chunks with a
    per-chunk all-dead skip. lax.map lowers to a scan whose per-chunk
    dynamic-slice/update moves the whole ~26-channel working set through
    device memory once per bounce, which can cost more than the chunks
    (sky regions) that skip their glue save; not measured on a GPU.
    Kept behind the knob for scenes with high dead-chunk fractions (deep
    depths, mostly-sky frames). Applies only to the plain sorted config
    (no guide/SSS/prediction/mip)."""
    try:
        return max(1, int(os.environ.get("MTS_GLUE_CHUNKS", "1")))
    except ValueError:
        return 1


def path_trace(scene, ray: Ray, sampler: Sampler, cfg: PathConfig,
               guide=None, learn_guide: bool = False,
               guide_alpha: float = 0.5, guide_sampling: bool = None):
    """Trace radiance along the given camera rays. Returns (L, aux dict).

    The bounce loop is a `lax.scan` over depth: ONE traced/compiled bounce
    body regardless of max_depth.  (A Python-unrolled loop multiplies the
    XLA graph by max_depth — compile time matters.)  Per-depth
    control flow (last-bounce cutoff, RR activation) is turned into scanned
    boolean inputs.
    """
    if cfg.aniso_filter and not cfg.mip_filter:
        import dataclasses
        cfg = dataclasses.replace(cfg, mip_filter=True)
    if scene.geom.backend == "cluster" and not cfg.sort_rays:
        # the work-list cull needs direction/position-coherent 128-lane
        # rows: bounce rays MUST be re-sorted per bounce (octant-major
        # Morton) or nearly every row overflows the cull beams
        import dataclasses
        cfg = dataclasses.replace(cfg, sort_rays=True)
    n = ray.o.shape[0]
    d_max = cfg.max_depth

    # pre-drawn per-depth random fields (scanned xs)
    u_nee_sel = sampler.next_stacked_1d(d_max)       # (D, N)
    u_nee_pos = sampler.next_stacked_2d(d_max)       # (D, N, 2)
    u_bsdf_2d = sampler.next_stacked_2d(d_max)
    u_lobe = sampler.next_stacked_1d(d_max)
    u_rr = sampler.next_stacked_1d(d_max)
    # guided sampling consumes two extra fields (mixture pick + bin CDF);
    # guide_sampling defaults to "whenever a guide is given and we're not
    # in a pure learning pass" — progressive renders pass both (sample
    # from the accumulated guide while depositing new learning)
    if guide_sampling is None:
        guide_sampling = guide is not None and not learn_guide
    guide_sampling = guide_sampling and guide is not None
    if guide_sampling:
        u_gpick = sampler.next_stacked_1d(d_max)
        u_gbin = sampler.next_stacked_1d(d_max)
    else:
        u_gpick = u_gbin = jnp.zeros((d_max, 1))
    is_last = (jnp.arange(d_max) + 1) >= d_max       # (D,)
    do_rr = jnp.arange(d_max) >= cfg.rr_depth        # (D,)
    # depth-0 emission gate (see PathConfig.skip_direct_emission)
    em_w = jnp.ones(d_max)
    if cfg.skip_direct_emission:
        em_w = em_w.at[0].set(0.0)

    n_ch = scene.materials.reflectance.shape[-1]   # SPECTRUM_SAMPLES
    init = (
        jnp.zeros((n, n_ch)),         # L
        jnp.ones((n, n_ch)),          # throughput
        ray,
        jnp.ones(n, bool),            # active
        jnp.zeros(n),                 # prev_pdf (BSDF pdf that made this ray)
        jnp.ones(n, bool),            # prev_delta (camera ray: full Le)
        jnp.zeros(n, jnp.int32),      # depth_count
        jnp.zeros((), jnp.float32),   # rays_traced
        # path_len only when ray-cone lod is on (scalar placeholder keeps
        # the carry structure static without the (N,) state cost)
        jnp.zeros(n) if cfg.mip_filter else jnp.zeros(()),
        # deferred NEE: the shadow ray fires fused with the NEXT bounce's
        # closest hit (one Pallas launch, shared triangle loop); its
        # contribution lands one scan step later
        Ray.make(ray.o, ray.d, maxt=jnp.full(n, -1.0)),   # pending shadow
        jnp.zeros((n, n_ch)),         # pending NEE contribution
        jnp.zeros(n, bool),           # pending valid
        # hash-based ray-path prediction table (scalar placeholder when
        # off — same pattern as path_len) + bound/shortcut hit counter
        jnp.full(1 << _PRED_BITS, -1, jnp.int32) if cfg.hit_prediction
        else jnp.zeros((), jnp.int32),
        jnp.zeros(()),                # pred_hits
        # guide histogram mass while learning (scalar placeholder else)
        guide.mass if learn_guide and guide is not None
        else jnp.zeros(()),
    )
    # ray-cone spread: one pixel's angular size (Akenine-Moller ray cones;
    # replaces the reference's RayDifferential transfer, which would need
    # per-lane dp/dx state through the scan)
    cone_alpha = 2.0 * scene.camera.tan_half_fov_y / scene.height

    def make_bounce(first: bool):
      def bounce(carry, xs):
        (L, throughput, ray, active, prev_pdf, prev_delta, depth_count,
         rays_traced, path_len, pend_ray, pend_contrib, pend_ok,
         pred_table, pred_hits, guide_mass) = carry
        (u_nee_sel, u_nee_pos, u_bsdf_2d, u_lobe, u_rr, u_gpick, u_gbin,
         is_last, do_rr, em_w) = xs
        act_in = active                 # lanes tracing at bounce entry
        rays_traced = rays_traced + jnp.sum(active.astype(jnp.float32)) \
            + jnp.sum(pend_ok.astype(jnp.float32))
        ray_q, pend_q = ray, pend_ray
        occ_pred = jnp.zeros(n, bool)
        if cfg.hit_prediction:
            from mitsuba_jax.render.intersect import predicted_hit_bound

            pbmin = scene.geom.bvh_min[0]
            pbmax = scene.geom.bvh_max[0]
            kc = _pred_keys(_detach(ray.o), _detach(ray.d), pbmin, pbmax)
            pred = pred_table[kc]
            t_pred, hitp = predicted_hit_bound(scene.geom, ray, pred)
            # an exact hit of the cached prim caps the nearest-hit search;
            # the margin absorbs fp differences vs the kernels' MT order
            ray_q = replace(ray, maxt=jnp.where(
                hitp, _detach(t_pred) * (1.0 + 1e-4), ray.maxt))
            # shadow cache (Haines): a cached prim blocking the segment
            # answers the any-hit query outright
            ks = _pred_keys(_detach(pend_ray.o), _detach(pend_ray.d),
                            pbmin, pbmax)
            _ts, occ_pred = predicted_hit_bound(scene.geom, pend_ray,
                                                pred_table[ks])
            pend_q = replace(pend_ray, maxt=jnp.where(
                occ_pred, -1.0, pend_ray.maxt))
            pred_hits = pred_hits \
                + jnp.sum((hitp & active).astype(jnp.float32)) \
                + jnp.sum((occ_pred & pend_ok).astype(jnp.float32))
        if cfg.sort_rays:
            # first (peeled) bounce: camera rays arrive pixel-Morton
            # sorted (skip the argsort), are coherent (small cull caps),
            # and carry NO pending NEE (skip the shadow query outright)
            if first:
                its = _sorted_intersect(scene, ray_q, cfg.sort_mode,
                                        presorted=True)
                s_occ = jnp.zeros(n, bool)
            elif os.environ.get("MTS_FUSESORT", "0") == "1":
                # shadow rays inherit ray_q's order, so their octants
                # mix; not measured on a GPU
                its, s_occ = _sorted_intersect_and_test(
                    scene, ray_q, pend_q, cfg.sort_mode)
            else:
                its = _sorted_intersect(scene, ray_q, cfg.sort_mode)
                # shadow rays may use a cheaper ordering: env-NEE
                # directions concentrate in few octants and origins
                # already carry the hit-point coherence, so the linear
                # octant counting-sort can replace the full argsort
                # (MTS_SHADOWSORT=octant; default = cfg.sort_mode)
                s_occ = _sorted_test(
                    scene, pend_q,
                    os.environ.get("MTS_SHADOWSORT", cfg.sort_mode))
        else:
            its, s_occ = ray_intersect_and_test(scene.geom, ray_q, pend_q)
        if cfg.hit_prediction:
            s_occ = s_occ | occ_pred
            # learn this bounce's hits (static prims only — instanced
            # virtual ids can't be re-tested without their transforms)
            ok_upd = its.valid & (its.prim_id >= 0) \
                & (its.prim_id < scene.geom.n_tris)
            pred_table = pred_table.at[kc].set(
                jnp.where(ok_upd, its.prim_id, pred))
        # --- chunked glue (plain config): everything below is per-lane
        # elementwise + small-table gathers; lanes keep pixel-Morton
        # order, so deaths cluster spatially and whole chunks skip via
        # cond at deep bounces (see _glue_chunks) -------------------------
        plain = (cfg.sort_rays
                 and not cfg.hit_prediction and not cfg.mip_filter
                 and scene.subsurface is None and guide is None
                 and not learn_guide and not guide_sampling
                 and not cfg.strict_normals)
        n_gc = _glue_chunks()
        if plain and not first and n_gc > 1 and n % n_gc == 0:
            def live_body(sl):
                (L, throughput, ray, active, prev_pdf, prev_delta,
                 depth_count, pend_contrib, pend_ok, s_occ, its,
                 u_nee_sel, u_nee_pos, u_bsdf_2d, u_lobe, u_rr) = sl
                L = L + jnp.where((pend_ok & ~s_occ)[:, None],
                                  pend_contrib, 0.0)
                esc = active & ~its.valid
                env, env_pdf = eval_and_pdf_environment(scene.emitters,
                                                        ray.d)
                w_env = jnp.where(prev_delta, 1.0,
                                  mi_weight(prev_pdf, env_pdf))
                L = L + em_w * jnp.where(
                    esc[:, None], throughput * env * w_env[:, None], 0.0)
                active = active & its.valid
                depth_count = depth_count + active.astype(jnp.int32)
                if scene.emitters.has_surface_emitters:
                    le = eval_emitter_hit(scene.emitters,
                                          its.emitter_id, -ray.d,
                                          its.geo_n)
                    lum_pdf = pdf_direct_area(
                        scene.emitters, its.prim_id, ray.o, its.p,
                        its.geo_n, emitter_id=its.emitter_id)
                    w_bsdf = jnp.where(prev_delta, 1.0,
                                       mi_weight(prev_pdf, lum_pdf))
                    L = L + em_w * jnp.where(
                        active[:, None],
                        throughput * le * w_bsdf[:, None], 0.0)
                cont = active & ~is_last
                mclip = jnp.clip(its.material_id, 0,
                                 scene.materials.n_materials - 1)
                tex_id = scene.materials.tex_id[mclip]
                albedo = scene.materials.reflectance[mclip]
                if scene.textures.n_textures > 0:
                    from mitsuba_jax.render.texture import eval_texture
                    tex_val = eval_texture(scene.textures, tex_id,
                                           its.uv)
                    albedo = jnp.where((tex_id >= 0)[:, None], tex_val,
                                       albedo)
                ds = sample_direct(scene.emitters, scene.geom, its.p,
                                   _detach(u_nee_sel),
                                   _detach(u_nee_pos))
                wo_local = its.to_local(ds.d)
                fcos = bsdf_eval(scene.materials, its.material_id,
                                 its.wi, wo_local, albedo=albedo,
                                 uv=its.uv)
                b_pdf = bsdf_pdf(scene.materials, its.material_id,
                                 its.wi, wo_local)
                nee_ok = cont & ds.valid & (ds.pdf > 0)
                eps = m.EPSILON * jnp.maximum(1.0,
                                              jnp.abs(its.p).max(-1))
                pend_ray = Ray.make(
                    its.p, ds.d, mint=eps,
                    maxt=jnp.where(nee_ok, ds.dist * (1.0 - 1e-3),
                                   -1.0))
                w_nee = jnp.where(ds.delta, 1.0,
                                  mi_weight(ds.pdf, b_pdf))
                pend_contrib = throughput * fcos * ds.value * \
                    (w_nee / jnp.maximum(ds.pdf, 1e-20))[:, None]
                pend_ok = nee_ok
                bs = bsdf_sample(scene.materials, its.material_id,
                                 its.wi, _detach(u_bsdf_2d),
                                 _detach(u_lobe), albedo=albedo,
                                 uv=its.uv)
                wo_world = its.to_world(bs["wo"])
                active = cont & bs["valid"]
                alb_rr = jnp.minimum(0.9, jnp.max(_detach(bs["weight"]),
                                                  axis=-1))
                kill = do_rr & (u_rr > alb_rr) & ~bs["transmission"]
                rr_scale = jnp.where(
                    do_rr & ~bs["transmission"],
                    1.0 / jnp.maximum(alb_rr, 1e-3), 1.0)
                active = active & ~kill
                throughput = throughput * jnp.where(active, rr_scale,
                                                    1.0)[:, None]
                throughput = throughput * jnp.where(
                    active[:, None], bs["weight"], 1.0)
                new_ray = Ray.make(its.p, wo_world, mint=eps)
                ray = replace(
                    new_ray,
                    o=jnp.where(active[:, None], new_ray.o, ray.o),
                    d=jnp.where(active[:, None], new_ray.d, ray.d),
                    maxt=jnp.where(active, new_ray.maxt, -1.0),
                )
                return (L, throughput, ray, active, _detach(bs["pdf"]),
                        bs["delta"], depth_count, pend_ray,
                        pend_contrib, pend_ok)

            def dead_body(sl):
                (L, throughput, ray, active, prev_pdf, prev_delta,
                 depth_count, pend_contrib, pend_ok, s_occ, its,
                 *_rest) = sl
                # exactly what live_body computes when every lane is
                # dead: masked accumulations vanish, mint picks up the
                # hit-scaled epsilon, maxt collapses to -1
                eps = m.EPSILON * jnp.maximum(1.0,
                                              jnp.abs(its.p).max(-1))
                dead_t = jnp.full(ray.maxt.shape, -1.0)
                ray2 = Ray(o=ray.o, d=ray.d, mint=eps, maxt=dead_t)
                pend2 = Ray(o=its.p, d=ray.d, mint=eps, maxt=dead_t)
                return (L, throughput, ray2, jnp.zeros_like(active),
                        jnp.zeros_like(prev_pdf),
                        jnp.zeros_like(prev_delta), depth_count, pend2,
                        jnp.zeros_like(pend_contrib),
                        jnp.zeros_like(pend_ok))

            def chunk_fn(sl):
                live = jnp.any(sl[3] | sl[8])
                return jax.lax.cond(live, live_body, dead_body, sl)

            sl = jax.tree_util.tree_map(
                lambda a: a.reshape((n_gc, a.shape[0] // n_gc)
                                    + a.shape[1:]),
                (L, throughput, ray, active, prev_pdf, prev_delta,
                 depth_count, pend_contrib, pend_ok, s_occ, its,
                 u_nee_sel, u_nee_pos, u_bsdf_2d, u_lobe, u_rr))
            out = jax.lax.map(chunk_fn, sl)
            (L, throughput, ray, active, prev_pdf, prev_delta,
             depth_count, pend_ray, pend_contrib, pend_ok) = \
                jax.tree_util.tree_map(
                    lambda a: a.reshape((-1,) + a.shape[2:]), out)
            carry = (L, throughput, ray, active, prev_pdf, prev_delta,
                     depth_count, rays_traced, path_len, pend_ray,
                     pend_contrib, pend_ok, pred_table, pred_hits,
                     guide_mass)
            return carry, None

        # resolve the previous bounce's NEE shadow ray
        L = L + jnp.where((pend_ok & ~s_occ)[:, None], pend_contrib, 0.0)
        if cfg.mip_filter:
            path_len = path_len + jnp.where(active & its.valid, its.t, 0.0)

        # --- escaped rays: background luminaire with MIS ----------------
        esc = active & ~its.valid
        env, env_pdf = eval_and_pdf_environment(scene.emitters, ray.d)
        w_env = jnp.where(prev_delta, 1.0, mi_weight(prev_pdf, env_pdf))
        L = L + em_w * jnp.where(esc[:, None],
                                 throughput * env * w_env[:, None], 0.0)

        active = active & its.valid
        if cfg.strict_normals:
            # reference path.cpp:100-104: kill paths where shading and
            # geometric normals disagree about the viewing side
            wi_geo = -jnp.sum(its.geo_n * ray.d, axis=-1)
            wi_sh = its.wi[..., 2]
            active = active & (wi_geo * wi_sh > 0)
        depth_count = depth_count + active.astype(jnp.int32)

        # --- emitter hit (BSDF-sampling MIS side); identically zero
        # when no surface emitter exists — skip its gathers at trace
        # time (EmitterTable.has_surface_emitters) -----------------------
        if scene.emitters.has_surface_emitters:
            le = eval_emitter_hit(scene.emitters, its.emitter_id, -ray.d,
                                  its.geo_n)
        else:
            le = jnp.zeros_like(throughput)
        if learn_guide and guide is not None:
            # guide learning: radiance arriving at the ray's origin along
            # its direction (emitter hits + environment); unweighted by
            # MIS/throughput — the guide targets incident radiance
            from mitsuba_jax.core.types import replace as _replace
            from mitsuba_jax.integrators.guiding import guide_update

            inc = jnp.where(active[:, None], le, 0.0) \
                + jnp.where(esc[:, None], env, 0.0)
            lum = (0.2126 * inc[:, 0] + 0.7152 * inc[:, 1]
                   + 0.0722 * inc[:, 2])
            g_tmp = guide_update(_replace(guide, mass=guide_mass),
                                 _detach(ray.o), _detach(ray.d),
                                 _detach(lum), act_in & (lum > 0))
            guide_mass = g_tmp.mass
        if guide_sampling:
            # guided mixture: sample the guide's directional histogram up
            # front so its pdf can enter every MIS weight consistently
            from mitsuba_jax.integrators.guiding import (
                guide_pdf as _guide_pdf, guide_sample as _guide_sample,
            )

            g_dir, g_pdf_s, g_ok = _guide_sample(
                guide, _detach(its.p), _detach(u_bsdf_2d),
                _detach(u_gbin), normal=_detach(its.sh_n))
            alpha_l = jnp.where(g_ok, guide_alpha, 1.0)
        if scene.emitters.has_surface_emitters:
            lum_pdf = pdf_direct_area(
                scene.emitters, its.prim_id, ray.o, its.p, its.geo_n,
                emitter_id=its.emitter_id,
            )
            w_bsdf = jnp.where(prev_delta, 1.0,
                               mi_weight(prev_pdf, lum_pdf))
            L = L + em_w * jnp.where(active[:, None],
                                     throughput * le * w_bsdf[:, None],
                                     0.0)

        # --- subsurface scattering (reference: integrators call
        # Subsurface::Lo at every surface interaction, path.cpp via
        # its.hasSubsurface(); here a masked dipole gather per entry) ---
        if scene.subsurface is not None:
            from mitsuba_jax.subsurface.dipole import scene_ss_lo

            ss = scene.subsurface
            mclip_ss = jnp.clip(its.material_id, 0,
                                ss.mat_ss.shape[0] - 1)
            ssid = ss.mat_ss[mclip_ss]
            wo_cos = jnp.abs(its.wi[..., 2])
            for s_i in range(ss.n_entries):
                lo = scene_ss_lo(ss, s_i, its.p, wo_cos)
                sel = active & (ssid == s_i)
                L = L + jnp.where(sel[:, None], throughput * lo, 0.0)

        # beyond here only matters when this is not the final depth
        cont = active & ~is_last

        # --- texture-resolved albedo (reference: its.getBSDF evaluates
        # textures at the hit's uv) ------------------------------------
        mclip = jnp.clip(its.material_id, 0, scene.materials.n_materials - 1)
        tex_id = scene.materials.tex_id[mclip]
        albedo = scene.materials.reflectance[mclip]
        if scene.textures.n_textures > 0:
            from mitsuba_jax.render.texture import eval_texture
            if cfg.aniso_filter and len(scene.textures.mips) > 0:
                # ray-cone footprint -> anisotropic (EWA) uv derivatives
                width = cone_alpha * path_len
                duv_dx, duv_dy = _cone_duv_aniso(scene.geom, its, ray.d,
                                                 width)
                tex_val = eval_texture(scene.textures, tex_id, its.uv,
                                       duv_dx=duv_dx, duv_dy=duv_dy,
                                       aniso=True)
            elif cfg.mip_filter and len(scene.textures.mips) > 0:
                # ray-cone footprint -> isotropic uv derivative
                width = cone_alpha * path_len
                dens = jnp.maximum(m.length(its.dp_du), 1e-6)
                cos_v = jnp.maximum(jnp.abs(its.wi[..., 2]), 0.1)
                f = (width / (dens * cos_v))[:, None]
                duv = jnp.concatenate([f, jnp.zeros_like(f)], axis=-1)
                tex_val = eval_texture(scene.textures, tex_id, its.uv,
                                       duv_dx=duv, duv_dy=duv[:, ::-1])
            else:
                tex_val = eval_texture(scene.textures, tex_id, its.uv)
            albedo = jnp.where((tex_id >= 0)[:, None], tex_val, albedo)

        # --- next-event estimation (luminaire sampling) -----------------
        ds = sample_direct(
            scene.emitters, scene.geom, its.p, _detach(u_nee_sel), _detach(u_nee_pos)
        )
        wo_local = its.to_local(ds.d)
        fcos = bsdf_eval(scene.materials, its.material_id, its.wi, wo_local,
                         albedo=albedo, uv=its.uv)
        b_pdf = bsdf_pdf(scene.materials, its.material_id, its.wi, wo_local)
        if guide_sampling:
            # MIS counterweight = pdf the ACTUAL scatter strategy (the
            # α·BSDF + (1-α)·guide mixture) assigns to the NEE direction
            b_pdf = alpha_l * b_pdf + (1.0 - alpha_l) * _guide_pdf(
                guide, _detach(its.p), _detach(ds.d),
                normal=_detach(its.sh_n))
        nee_ok = cont & ds.valid & (ds.pdf > 0)
        # shadow ray (reference Scene::isOccluded); epsilon scales with the
        # local coordinate magnitude to stay above float32 ulp at scene scale
        eps = m.EPSILON * jnp.maximum(1.0, jnp.abs(its.p).max(-1))
        # DEFERRED: stash the shadow ray + contribution; visibility rides
        # the next bounce's fused kernel (or a post-scan flush)
        pend_ray = Ray.make(its.p, ds.d, mint=eps,
                            maxt=jnp.where(nee_ok, ds.dist * (1.0 - 1e-3),
                                           -1.0))
        w_nee = jnp.where(ds.delta, 1.0, mi_weight(ds.pdf, b_pdf))
        pend_contrib = throughput * fcos * ds.value * \
            (w_nee / jnp.maximum(ds.pdf, 1e-20))[:, None]
        pend_ok = nee_ok

        # --- BSDF sampling ----------------------------------------------
        bs = bsdf_sample(
            scene.materials, its.material_id, its.wi,
            _detach(u_bsdf_2d), _detach(u_lobe), albedo=albedo, uv=its.uv,
        )
        wo_world = its.to_world(bs["wo"])
        wo_z = bs["wo"][..., 2]
        if guide_sampling:
            # one-sample mixture: with prob (1-α) take the guide's
            # direction (never on delta lobes / empty cells); weight by
            # the true mixture pdf — unbiased for ANY guide content
            smooth = ~bs["delta"] & g_ok
            pick_g = smooth & (_detach(u_gpick) >= alpha_l) & cont
            wo_mix = jnp.where(pick_g[:, None], g_dir, wo_world)
            wo_mix_l = its.to_local(wo_mix)
            fcos_mix = bsdf_eval(scene.materials, its.material_id, its.wi,
                                 wo_mix_l, albedo=albedo, uv=its.uv)
            pb_mix = bsdf_pdf(scene.materials, its.material_id, its.wi,
                              wo_mix_l)
            pg_mix = jnp.where(pick_g, g_pdf_s, _guide_pdf(
                guide, _detach(its.p), _detach(wo_mix),
                normal=_detach(its.sh_n)))
            q_mix = alpha_l * pb_mix + (1.0 - alpha_l) * pg_mix
            ok_mix = q_mix > 1e-12
            w_mix = fcos_mix / jnp.maximum(q_mix, 1e-12)[:, None]
            use_mix = ~bs["delta"]          # delta lanes keep exact path
            bs = dict(
                bs,
                weight=jnp.where(use_mix[:, None], w_mix, bs["weight"]),
                pdf=jnp.where(use_mix, q_mix, bs["pdf"]),
                valid=jnp.where(use_mix, ok_mix, bs["valid"]),
            )
            wo_world = jnp.where(use_mix[:, None], wo_mix, wo_world)
            wo_z = jnp.where(use_mix, wo_mix_l[..., 2], wo_z)
        active = cont & bs["valid"]
        if cfg.strict_normals:
            wo_geo = jnp.sum(its.geo_n * wo_world, axis=-1)
            active = active & (wo_geo * wo_z > 0)

        # --- Russian roulette (reference path.cpp:196) ------------------
        albedo = jnp.minimum(0.9, jnp.max(_detach(bs["weight"]), axis=-1))
        kill = do_rr & (u_rr > albedo) & ~bs["transmission"]
        rr_scale = jnp.where(
            do_rr & ~bs["transmission"], 1.0 / jnp.maximum(albedo, 1e-3), 1.0
        )
        active = active & ~kill
        throughput = throughput * jnp.where(active, rr_scale, 1.0)[:, None]

        throughput = throughput * jnp.where(active[:, None], bs["weight"], 1.0)
        new_ray = Ray.make(its.p, wo_world, mint=eps)
        # dead lanes: keep o/d (masked anyway) but set maxt=-1 so they
        # trace NOTHING — a dead lane with maxt=inf still walked the full
        # scene every remaining bounce, and its stale origin/direction
        # widened its 128-lane row's conservative cull intervals
        ray = replace(
            new_ray,
            o=jnp.where(active[:, None], new_ray.o, ray.o),
            d=jnp.where(active[:, None], new_ray.d, ray.d),
            maxt=jnp.where(active, new_ray.maxt, -1.0),
        )
        carry = (L, throughput, ray, active, _detach(bs["pdf"]), bs["delta"],
                 depth_count, rays_traced, path_len, pend_ray, pend_contrib,
                 pend_ok, pred_table, pred_hits, guide_mass)
        return carry, None
      return bounce

    bounce = make_bounce(False)
    body = jax.checkpoint(bounce) if cfg.remat else bounce
    xs = (u_nee_sel, u_nee_pos, u_bsdf_2d, u_lobe, u_rr, u_gpick, u_gbin,
          is_last, do_rr, em_w)
    # peel the first bounce for the sorted cluster path: coherent caps,
    # no argsort, no dead shadow query (camera rays have no pending NEE)
    peel = cfg.sort_rays and not cfg.hit_prediction and d_max > 1 \
        and os.environ.get("MTS_PEEL", "1") != "0"
    if peel:
        b0 = make_bounce(True)
        body0 = jax.checkpoint(b0) if cfg.remat else b0
        carry, _ = body0(init, jax.tree_util.tree_map(lambda a: a[0], xs))
        carry, _ = jax.lax.scan(
            body, carry, jax.tree_util.tree_map(lambda a: a[1:], xs))
    else:
        carry, _ = jax.lax.scan(body, init, xs)
    (L, throughput, ray, active, prev_pdf, prev_delta, depth_count,
     rays_traced, _path_len, pend_ray, pend_contrib, pend_ok,
     _pred_table, pred_hits, guide_mass_out) = carry
    # no post-scan flush needed: NEE is gated off at the last depth
    # (cont = active & ~is_last), so the final pending set is empty
    aux = {
        "avg_path_length": jnp.mean(depth_count.astype(jnp.float32)),
        "rays_traced": rays_traced,
        # fraction of traced queries that had a usable prediction (bound
        # or shadow shortcut); 0 when hit_prediction is off
        "pred_hit_frac": pred_hits / jnp.maximum(rays_traced, 1.0),
    }
    if learn_guide and guide is not None:
        from mitsuba_jax.core.types import replace as _replace

        aux["guide"] = _replace(guide, mass=guide_mass_out)
    return L, aux


def render_motion(scenes, cfg: PathConfig, seed: int = 0):
    """Motion-blurred render: average renders over time-binned scenes
    (SceneBuilder.build_time_scenes). All bins share the same traced
    bounce-scan executable — scenes are pytree arguments with identical
    structure, so the compilation cache reuses one program across bins
    (the wavefront re-design of the reference's per-ray time + per-node
    AnimatedTransform::eval, animatedinstance.cpp:63 — data-dependent
    transforms inside the traversal would break the static wavefront).
    Each bin gets a distinct seed; the average integrates the shutter
    by stratified time sampling."""
    import numpy as np

    acc = None
    aux_last = None
    for k, scene in enumerate(scenes):
        img, aux_last = render(scene, cfg, seed=seed * 1031 + k)
        acc = img if acc is None else acc + img
    aux_last = dict(aux_last or {})
    aux_last["time_bins"] = len(scenes)
    return acc / len(scenes), aux_last


def render(scene, cfg: PathConfig, seed: int = 0, guide=None,
           learn_guide: bool = False, guide_alpha: float = 0.5,
           guide_sampling: bool = None):
    """Render the scene to an (H, W, 3) image with the configured
    reconstruction filter. Wavefront layout: lane = pixel * spp + sample.
    guide/learn_guide: see render_guided."""
    from mitsuba_jax.render.film import develop
    from mitsuba_jax.render.rfilter import make_rfilter

    if scene.subsurface is not None and scene.subsurface.irradiance is None:
        from mitsuba_jax.core.types import replace as _replace
        from mitsuba_jax.subsurface.dipole import prepare_scene_irradiance

        scene = _replace(scene,
                         subsurface=prepare_scene_irradiance(scene, seed=seed))

    w, h, spp = scene.width, scene.height, cfg.spp
    n = w * h * spp
    lane = jnp.arange(n)
    # Morton pixel order for the work-list cluster backend: compact
    # 128-lane pixel tiles keep cull frusta tight (see pixel_morton_perm).
    # The permutation is a trace-time constant; film development
    # un-permutes the radiance back to scanline order.
    morton = scene.geom.backend == "cluster"
    if morton:
        import numpy as np

        perm_px = pixel_morton_perm(w, h)
        pixel_id = jnp.asarray(perm_px, jnp.int32)[lane // spp]
        lane_tgt = perm_px[np.arange(n) // spp] * spp + np.arange(n) % spp
        inv_lane = jnp.asarray(np.argsort(lane_tgt), jnp.int32)
    else:
        pixel_id = lane // spp
    sample_id = (lane % spp).astype(jnp.int32)
    px = (pixel_id % w).astype(jnp.float32)
    py = (pixel_id // w).astype(jnp.float32)

    sampler = Sampler(seed, pixel_id, sample_id)
    jitter = sampler.next_2d()
    offset = sample_position(cfg.pattern, sample_id, spp, jitter)
    uv = jnp.stack([(px + offset[:, 0]) / w, (py + offset[:, 1]) / h], axis=-1)
    ray = scene.camera.sample_ray(uv)
    L, aux = path_trace(scene, ray, sampler, cfg, guide=guide,
                        learn_guide=learn_guide, guide_alpha=guide_alpha,
                        guide_sampling=guide_sampling)
    if morton:
        L = L[inv_lane]
        offset = offset[inv_lane]
    img = develop(L, offset, spp, h, w, make_rfilter(cfg.rfilter))
    return img, aux


def render_guided(scene, cfg: PathConfig, seed: int = 0,
                  learn_frac: float = 0.5, guide_alpha: float = 0.5,
                  res: int = 16):
    """Path-guided render (beyond-parity feature; arXiv:2405.06997-style
    wavefront guiding): phase 1 renders learn_frac of the spp unguided
    while depositing incident radiance into a spatial-directional
    histogram grid; phase 2 renders the rest drawing scatter directions
    from the one-sample mixture α·BSDF + (1-α)·guide. Both phases are
    unbiased; the result is their spp-weighted average."""
    import dataclasses

    import numpy as np

    from mitsuba_jax.integrators.guiding import make_guide

    spp1 = max(1, int(round(cfg.spp * learn_frac)))
    spp2 = max(0, cfg.spp - spp1)
    v0 = np.asarray(scene.geom.v0)
    ext = v0.max(0) - v0.min(0)
    guide = make_guide(v0.min(0) - 0.01 * ext, v0.max(0) + 0.01 * ext,
                       res=res)
    img1, aux1 = render(scene, dataclasses.replace(cfg, spp=spp1),
                        seed=seed, guide=guide, learn_guide=True)
    if spp2 == 0:
        return img1, aux1
    guide = aux1.pop("guide")
    img2, aux2 = render(scene, dataclasses.replace(cfg, spp=spp2),
                        seed=seed + 7507, guide=guide,
                        guide_alpha=guide_alpha)
    img = (img1 * spp1 + img2 * spp2) / (spp1 + spp2)
    aux2["rays_traced"] = aux1["rays_traced"] + aux2["rays_traced"]
    return img, aux2
