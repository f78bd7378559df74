"""Irradiance caching meta-integrator.

Functional parity with reference `IrradianceCacheIntegrator`
(src/integrators/misc/irrcache.cpp:45 + the parallel cache-filling process
irrcache_proc.cpp and the octree record store include/mitsuba/render/
irrcache.h:42,144): hemispherical irradiance is computed at a sparse set of
surface points and interpolated at shading time, so full global
illumination costs one cache lookup per pixel instead of a path per sample.

Wavefront re-design:
  * cache points come from a low-res camera pre-pass (the reference fills
    its cache lazily along camera rays; a pre-pass is the batched analog),
  * each point's irradiance is a cosine-hemisphere wavefront of short path
    traces — every cache point × hemisphere sample is one lane,
  * the octree + gradient interpolation becomes a HashGrid k-neighbour
    gather with inverse-distance & normal-agreement weights,
  * Ward's translational/rotational gradients (irrcache.h:226 stores both
    per record; HemisphereSampler computes them from stratified cells) are
    obtained by DIFFERENTIATING THE ESTIMATOR: E(x, n) is a jax-traced
    function of the query position and frame normal, so jax.jvp along the
    3 position axes and the 2 tangent axes yields exact gradients of the
    sampled estimate — no stratified-cell bookkeeping, and consistent
    with the detached-sampling AD used everywhere else.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core import math as m
from mitsuba_jax.core import warp
from mitsuba_jax.core.kdtree import HashGrid
from mitsuba_jax.integrators.path import PathConfig, path_trace
from mitsuba_jax.render.intersect import ray_intersect
from mitsuba_jax.render.records import Ray
from mitsuba_jax.render.sampler import Sampler, sample_position
from mitsuba_jax.emitters import eval_emitter_hit


def _camera_first_hits(scene, res: int, seed: int):
    n = res * res
    lane = jnp.arange(n)
    sampler = Sampler(seed ^ 0x5151, lane, jnp.zeros(n, jnp.int32))
    jitter = sampler.next_2d()
    px = (lane % res).astype(jnp.float32)
    py = (lane // res).astype(jnp.float32)
    uv = jnp.stack([(px + jitter[:, 0]) / res, (py + jitter[:, 1]) / res], -1)
    ray = scene.camera.sample_ray(uv)
    its = ray_intersect(scene.geom, ray)
    return its


def build_irradiance_cache(scene, cfg: PathConfig, cache_res: int = 32,
                           hemi_samples: int = 32, seed: int = 0,
                           gradients: bool = False):
    """Returns a HashGrid of cache records.  Payload layout:
    (E(3) | normal(3))                              gradients=False;
    (E(3) | normal(3) | gradT(3ch x 3) | gradR(3ch x 3))  gradients=True —
    Ward-Heckbert translational/rotational gradients in WORLD space
    (reference irrcache.h:226 stores exactly these two per record),
    computed from a cosine-stratified (M x N) hemisphere per point."""
    its = _camera_first_hits(scene, cache_res, seed)
    valid = np.asarray(its.valid)
    pts = np.asarray(its.p)[valid]
    nrm = np.asarray(its.sh_n)[valid]
    m_pts = pts.shape[0]
    sub_cfg = PathConfig(max_depth=max(cfg.max_depth - 1, 1),
                         rr_depth=cfg.rr_depth, spp=1, remat=False)
    pts_j = jnp.asarray(pts, jnp.float32)
    nrm_j = jnp.asarray(nrm, jnp.float32)

    if gradients:
        # stratified (M_t x N_p) grid per point (HemisphereSampler layout)
        m_t = max(4, int(np.sqrt(hemi_samples / 2.0)))
        n_p = 2 * m_t
        hemi = m_t * n_p
        n = m_pts * hemi
        sampler = Sampler(seed ^ 0xCACE, jnp.arange(n), jnp.zeros(n, jnp.int32))
        u = sampler.next_2d().reshape(m_pts, m_t, n_p, 2)
        d_local = stratified_hemisphere(m_t, n_p, u[..., 0], u[..., 1])
        frame = m.Frame.from_normal(nrm_j)
        d = (d_local[..., 0:1] * frame.s[:, None, None, :]
             + d_local[..., 1:2] * frame.t[:, None, None, :]
             + d_local[..., 2:3] * frame.n[:, None, None, :])
        rep_p = jnp.repeat(pts_j, hemi, axis=0)
        d_flat = d.reshape(n, 3)
        eps = m.EPSILON * jnp.maximum(1.0, jnp.abs(rep_p).max(-1))
        ray = Ray.make(rep_p, d_flat, mint=eps)
        L, _ = path_trace(scene, ray, sampler, sub_cfg)
        hits = ray_intersect(scene.geom, ray)
        r = jnp.where(hits.valid, hits.t, 1e6).reshape(m_pts, m_t, n_p)
        L_cells = L.reshape(m_pts, m_t, n_p, 3)
        e_pts = jnp.pi * L_cells.mean(axis=(1, 2))
        gt_l, gr_l = ward_gradients(L_cells, r, m_t, n_p)   # (M, 3ch, 3) local
        # local->world: axes (s, t, n)
        def to_world(g):
            return (g[..., 0:1] * frame.s[:, None, :]
                    + g[..., 1:2] * frame.t[:, None, :]
                    + g[..., 2:3] * frame.n[:, None, :])
        gt_w = np.asarray(to_world(gt_l)).reshape(m_pts, 9)
        gr_w = np.asarray(to_world(gr_l)).reshape(m_pts, 9)
        payload = np.concatenate([np.asarray(e_pts), nrm, gt_w, gr_w], axis=1)
    else:
        # unstratified cosine hemisphere (cheaper; no gradients)
        n = m_pts * hemi_samples
        rep_n = jnp.repeat(nrm_j, hemi_samples, axis=0)
        sampler = Sampler(seed ^ 0xCACE, jnp.arange(n), jnp.zeros(n, jnp.int32))
        u2 = sampler.next_2d()
        d_local = warp.square_to_cosine_hemisphere(u2)
        d = m.Frame.from_normal(rep_n).to_world(d_local)
        rep_p = jnp.repeat(pts_j, hemi_samples, axis=0)
        eps = m.EPSILON * jnp.maximum(1.0, jnp.abs(rep_p).max(-1))
        L, _ = path_trace(scene, Ray.make(rep_p, d, mint=eps), sampler, sub_cfg)
        e_pts = jnp.pi * L.reshape(m_pts, hemi_samples, 3).mean(axis=1)
        payload = np.concatenate([np.asarray(e_pts), nrm], axis=1)
    # cell size must be >= the interpolation radius (the gather only scans
    # the 27-cell neighbourhood): radius = 0.08 * extent -> res ~ 12
    return HashGrid.build(pts, payload, res=12, max_per_query=27 * 16)


def interpolate_irradiance(grid: HashGrid, x, n, radius):
    """Inverse-distance × normal-agreement weighted average of cached E.
    When records carry translational gradients (payload width 15), each
    record extrapolates E_i + (x - x_i)·∇E_i before weighting (Ward's
    gradient interpolation, reference irrcache.cpp)."""
    has_grad = grid.payload.shape[1] >= 24

    def contrib(rows, d2, dp):
        e = rows[:, 0:3]
        cn = rows[:, 3:6]
        if has_grad:
            # Ward gradient extrapolation (irrcache.cpp getValue):
            # E_i + (x-x_i)·∇t_i + (n_i x n)·∇r_i per channel
            gt = rows[:, 6:15].reshape(-1, 3, 3)     # (N, ch, axis)
            gr = rows[:, 15:24].reshape(-1, 3, 3)
            axis_rot = jnp.cross(cn, n)
            delta = (jnp.einsum("nca,na->nc", gt, dp)
                     + jnp.einsum("nca,na->nc", gr, axis_rot))
            # clamp the extrapolation (the reference bounds record validity
            # by the harmonic-mean distance; near occluders the gradient
            # magnitude is untrustworthy beyond a fraction of E)
            lim = 0.75 * jnp.abs(e) + 1e-4
            e = e + jnp.clip(delta, -lim, lim)
        w_n = jnp.maximum(jnp.sum(cn * n, axis=-1), 0.0) ** 2
        w_d = 1.0 / (1.0 + d2 / (radius * radius) * 16.0)
        w = (w_n * w_d)[:, None]
        # relaxed (no normal test) sums ride along for the fallback — the
        # batch analog of the reference's lazy record creation on a miss
        w_rel = w_d[:, None]
        return jnp.concatenate([e * w, w, e * w_rel, w_rel], axis=1)

    acc = grid.gather_sum(x, radius, contrib_pos_fn=contrib)
    e_sum, w_sum = acc[:, 0:3], acc[:, 3:4]
    e_rel, w_rel = acc[:, 4:7], acc[:, 7:8]
    miss = w_sum[:, 0] < 1e-6
    e_out = jnp.where(miss[:, None], e_rel / jnp.maximum(w_rel, 1e-9),
                      e_sum / jnp.maximum(w_sum, 1e-6))
    w_out = jnp.where(miss, w_rel[:, 0], w_sum[:, 0])
    return e_out, w_out


def irrcache_render(scene, cfg: PathConfig, cache_res: int = 32,
                    hemi_samples: int = 32, seed: int = 0,
                    gradients: bool = False):
    """Render using the irradiance cache: Le + albedo/pi * E_interp.
    gradients=True adds Ward translational-gradient extrapolation."""
    grid = build_irradiance_cache(scene, cfg, cache_res, hemi_samples, seed,
                                  gradients=gradients)
    extent = float(jnp.linalg.norm(
        jnp.max(grid.points, axis=0) - jnp.min(grid.points, axis=0)
    ))
    radius = 0.08 * extent

    w, h, spp = scene.width, scene.height, cfg.spp
    n = w * h * spp
    lane = jnp.arange(n)
    pixel_id = lane // spp
    sample_id = (lane % spp).astype(jnp.int32)
    sampler = Sampler(seed, pixel_id, sample_id)
    jitter = sampler.next_2d()
    offset = sample_position(cfg.pattern, sample_id, spp, jitter)
    px = (pixel_id % w).astype(jnp.float32)
    py = (pixel_id // w).astype(jnp.float32)
    uv = jnp.stack([(px + offset[:, 0]) / w, (py + offset[:, 1]) / h], -1)
    ray = scene.camera.sample_ray(uv)

    @jax.jit
    def shade(scene, grid, ray):
        its = ray_intersect(scene.geom, ray)
        le = eval_emitter_hit(scene.emitters, its.emitter_id, -ray.d, its.geo_n)
        e, wsum = interpolate_irradiance(grid, its.p, its.sh_n, radius)
        mclip = jnp.clip(its.material_id, 0, scene.materials.n_materials - 1)
        albedo = scene.materials.reflectance[mclip]
        lo = albedo * m.INV_PI * e
        return jnp.where(its.valid[:, None], le + lo, 0.0), wsum, its.valid

    L, wsum, valid = shade(scene, grid, ray)
    img = L.reshape(h, w, spp, 3).mean(axis=2)
    covered = jnp.where(valid, (wsum > 0), True)
    return img, {"cache_points": int(grid.points.shape[0]), "radius": radius,
                 "coverage": float(covered.mean())}


# ---------------------------------------------------------------------------
# Ward-Heckbert stratified-hemisphere gradients (reference HemisphereSampler,
# irrcache.h:42 + irrcache.cpp: computes translational/rotational gradients
# from an (M theta x N phi) cosine-stratified cell grid of radiances and hit
# distances).  Unlike the jvp estimator-gradient, these model cell-boundary
# motion (min-distance division), capturing silhouette/occluder shifts.
# ---------------------------------------------------------------------------

def stratified_hemisphere(m_theta: int, n_phi: int, u1, u2):
    """Cosine-stratified cell directions.  u1/u2: (..., M, N) jitters.
    Returns local directions (..., M, N, 3): theta_j = asin(sqrt((j+u)/M))."""
    j = jnp.arange(m_theta)[:, None]
    k = jnp.arange(n_phi)[None, :]
    sin2 = (j + u1) / m_theta
    sin_t = jnp.sqrt(jnp.clip(sin2, 0.0, 1.0))
    cos_t = jnp.sqrt(jnp.clip(1.0 - sin2, 0.0, 1.0))
    phi = 2.0 * jnp.pi * (k + u2) / n_phi
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t],
                     axis=-1)


def ward_gradients(L, r, m_theta: int, n_phi: int):
    """Translational + rotational irradiance gradients from stratified-cell
    radiances (Ward & Heckbert 1992 eqs. 6/7; reference irrcache.cpp).

    L: (..., M, N, C) cell radiances; r: (..., M, N) hit distances
    (inf/large for misses).  Returns (grad_t (..., C, 3), grad_r (..., C, 3))
    in the LOCAL hemisphere frame (z = normal)."""
    M, N = m_theta, n_phi
    j = jnp.arange(M)
    k = jnp.arange(N)
    # cell-boundary angles
    sin_m = jnp.sqrt(j / M)                    # sin(theta_j^-)
    cos_m = jnp.sqrt(1.0 - j / M)
    sin_p = jnp.sqrt((j + 1) / M)              # sin(theta_j^+)
    phi_c = 2.0 * jnp.pi * (k + 0.5) / N       # cell-center azimuth
    phi_b = 2.0 * jnp.pi * k / N               # lower cell boundary
    uk = jnp.stack([jnp.cos(phi_c), jnp.sin(phi_c)], -1)      # (N, 2)
    vk_b = jnp.stack([-jnp.sin(phi_b), jnp.cos(phi_b)], -1)

    r_safe = jnp.maximum(r, 1e-6)
    # --- translational: theta-difference term along u_k -----------------
    dl_t = L[..., 1:, :, :] - L[..., :-1, :, :]               # (.., M-1, N, C)
    rmin_t = jnp.minimum(r_safe[..., 1:, :], r_safe[..., :-1, :])
    coef_t = (sin_m[1:] * cos_m[1:] * cos_m[1:])              # sin-cos^2(θ_j^-)
    # boundary θ_j^- rises by cosθ/r when moving toward û_k -> weight
    # transfer -(2π/N)·sinθcos²θ·ΔL/r (Ward eq. 7 first term)
    t_term = (2.0 * jnp.pi / N) * jnp.sum(
        coef_t[:, None, None] * dl_t / rmin_t[..., None], axis=-3
    )                                                          # (.., N, C)
    # --- translational: phi-difference term along v_k -------------------
    dl_p = L - jnp.roll(L, 1, axis=-3 + 1)                     # wrap over N
    rmin_p = jnp.minimum(r_safe, jnp.roll(r_safe, 1, axis=-1))
    coef_p = (sin_p - sin_m)                                   # (M,)
    # φ boundary at 2πk/N shifts by 1/(r sinθ) along its v̂; the sinθ
    # cancels inside the θ integral leaving ∫cosθ dθ = Δsinθ (eq. 7)
    p_term = jnp.sum(
        coef_p[:, None, None] * dl_p / rmin_p[..., None], axis=-3
    )                                                          # (.., N, C)
    grad_t = (
        jnp.einsum("...nc,nd->...cd", t_term, uk)
        + jnp.einsum("...nc,nd->...cd", p_term, vk_b)
    )                                                          # (.., C, 2)
    grad_t = jnp.concatenate(
        [grad_t, jnp.zeros(grad_t.shape[:-1] + (1,))], axis=-1
    )
    # --- rotational (eq. 6): pi/(MN) * sum tan(theta_j) L_jk along v_k --
    sin_c = jnp.sqrt((j + 0.5) / M)            # cell-center angle
    cos_c = jnp.sqrt(1.0 - (j + 0.5) / M)
    tan_j = sin_c / jnp.maximum(cos_c, 1e-6)
    rot_mag = (jnp.pi / (M * N)) * jnp.sum(
        tan_j[:, None, None] * L, axis=-3
    )                                                          # (.., N, C)
    # rotation about axis â changes E by grad_r·â; the numeric fit against
    # the analytic vector irradiance of a rectangle light pins the cell
    # direction to -v̂ = (sinφ, -cosφ) (see tests)
    grad_r = jnp.einsum("...nc,nd->...cd", rot_mag,
                        jnp.stack([jnp.sin(phi_c), -jnp.cos(phi_c)], -1))
    grad_r = jnp.concatenate(
        [grad_r, jnp.zeros(grad_r.shape[:-1] + (1,))], axis=-1
    )
    return grad_t, grad_r
