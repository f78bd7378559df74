"""Photon mapping + progressive photon mapping (PPM/SPPM).

Functional parity with the reference photon-map family:
  * PhotonMapIntegrator (src/integrators/photonmapper/photonmapper.cpp:30):
    photon shooting + density-estimate radiance at the first diffuse vertex.
  * ProgressivePhotonMapIntegrator (ppm.cpp:32) / SPPM (sppm.cpp:33):
    iterated passes with Hachisuka's shrinking radius
    r_{i+1}^2 = r_i^2 (i+alpha)/(i+1).

Wavefront re-design: the reference's left-balanced kNN photon tree
(photonmap.h:43,88,221) is replaced by the uniform HashGrid
(core/kdtree.py) — photon gathers become static 27-cell neighbourhood sums
vectorized over every camera hit at once, instead of per-query tree walks.
Photon shooting reuses the wavefront light-tracing walk; each bounce's
vertices are emitted as scan outputs and compacted host-side.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.bsdfs import bsdf_sample
from mitsuba_jax.core import math as m
from mitsuba_jax.core.kdtree import HashGrid
from mitsuba_jax.core.types import replace
from mitsuba_jax.integrators.path import PathConfig, _detach
from mitsuba_jax.integrators.ptracer import _sample_emission
from mitsuba_jax.render.intersect import ray_intersect
from mitsuba_jax.render.records import Ray
from mitsuba_jax.render.sampler import Sampler, sample_position


def shoot_photons(scene, n_photons: int, max_depth: int, seed: int = 0):
    """Trace photons; returns host arrays (pos, power, dir_in, normal) of
    the surviving surface deposits (compacted)."""
    n = n_photons
    sampler = Sampler(seed ^ 0x9E3779B9, jnp.arange(n), jnp.zeros(n, jnp.int32))
    u_sel = sampler.next_1d()
    u_pos = sampler.next_2d()
    u_dir = sampler.next_2d()
    u_scatter = sampler.next_stacked_2d(max_depth)
    u_lobe = sampler.next_stacked_1d(max_depth)

    p0, n0, d0, beta, valid = _sample_emission(
        scene, _detach(u_sel), _detach(u_pos), _detach(u_dir)
    )
    eps0 = m.EPSILON * jnp.maximum(1.0, jnp.abs(p0).max(-1))
    ray = Ray.make(p0, d0, mint=eps0)

    @jax.jit
    def walk(scene, ray, beta, valid, u_scatter, u_lobe):
        def bounce(carry, xs):
            ray, beta, active = carry
            u2, u1 = xs
            its = ray_intersect(scene.geom, ray)
            active = active & its.valid
            # deposit at this vertex (power = beta/n_photons at estimate time)
            deposit = (its.p, beta, ray.d, its.sh_n, active)
            bs = bsdf_sample(
                scene.materials, its.material_id, its.wi,
                _detach(u2), _detach(u1),
            )
            wo_world = its.to_world(bs["wo"])
            active2 = active & bs["valid"]
            beta = beta * jnp.where(active2[:, None], bs["weight"], 1.0)
            eps = m.EPSILON * jnp.maximum(1.0, jnp.abs(its.p).max(-1))
            new_ray = Ray.make(its.p, wo_world, mint=eps)
            ray = replace(
                new_ray,
                o=jnp.where(active2[:, None], new_ray.o, ray.o),
                d=jnp.where(active2[:, None], new_ray.d, ray.d),
            )
            return (ray, beta, active2), deposit

        (_, _, _), deposits = jax.lax.scan(
            bounce, (ray, beta, valid), (u_scatter, u_lobe)
        )
        return deposits

    pos, power, din, nrm, act = walk(scene, ray, beta, valid, u_scatter, u_lobe)
    act = np.asarray(act).reshape(-1)
    pos = np.asarray(pos).reshape(-1, 3)[act]
    power = np.asarray(power).reshape(-1, 3)[act]
    din = np.asarray(din).reshape(-1, 3)[act]
    nrm = np.asarray(nrm).reshape(-1, 3)[act]
    return pos, power, din, nrm


def build_photon_grid(pos, power, din, nrm, res: int = 48,
                      max_per_query: int = 27 * 24) -> HashGrid:
    payload = np.concatenate([power, din, nrm], axis=1)  # (P, 9)
    return HashGrid.build(pos, payload, res=res, max_per_query=max_per_query)


def photon_estimate(scene, grid: HashGrid, its, radius, n_photons: int):
    """Density-estimate outgoing radiance at camera hits (diffuse part only
    — the reference's estimateRadianceFiltered, photonmap.h:136)."""
    mclip = jnp.clip(its.material_id, 0, scene.materials.n_materials - 1)
    albedo = scene.materials.reflectance[mclip]
    sh_n = its.sh_n

    # accumulate per-photon: power * max(cos(n, -din), 0)-sidedness mask
    def contrib(rows, d2):
        power = rows[:, 0:3]
        din = rows[:, 3:6]
        # photon arriving on the same side as the shading normal
        side = (jnp.sum(sh_n * -din, axis=-1) > 0).astype(jnp.float32)
        return power * side[:, None]

    flux = grid.gather_sum(its.p, radius, contrib_fn=contrib)
    area = jnp.pi * radius * radius
    return albedo * m.INV_PI * flux / (area * n_photons)


@jax.jit
def _pm_estimate(scene, grid, ray, radius_d, inv_np):
    from mitsuba_jax.emitters import eval_emitter_hit

    its = ray_intersect(scene.geom, ray)
    le = eval_emitter_hit(scene.emitters, its.emitter_id, -ray.d, its.geo_n)
    lr = photon_estimate(scene, grid, its, radius_d, 1.0) * inv_np
    return jnp.where(its.valid[:, None], le + lr, 0.0)


def photonmap_render(scene, cfg: PathConfig, n_photons: int = 200_000,
                     radius: float | None = None, seed: int = 0):
    """One-pass photon-map visualization at the first hit (direct photon
    density estimate; the reference's 'direct visualization' mode)."""
    pos, power, din, nrm = shoot_photons(scene, n_photons, cfg.max_depth, seed)
    if radius is None:
        extent = float(np.linalg.norm(pos.max(0) - pos.min(0))) if len(pos) else 1.0
        radius = 0.015 * extent
    grid = build_photon_grid(pos, power, din, nrm)

    w, h, spp = scene.width, scene.height, cfg.spp
    n = w * h * spp
    lane = jnp.arange(n)
    pixel_id = lane // spp
    sample_id = (lane % spp).astype(jnp.int32)
    px = (pixel_id % w).astype(jnp.float32)
    py = (pixel_id // w).astype(jnp.float32)
    sampler = Sampler(seed, pixel_id, sample_id)
    jitter = sampler.next_2d()
    offset = sample_position(cfg.pattern, sample_id, spp, jitter)
    uv = jnp.stack([(px + offset[:, 0]) / w, (py + offset[:, 1]) / h], -1)
    ray = scene.camera.sample_ray(uv)

    # radius/n_photons ride as device scalars and the jitted program is
    # module-level: a per-call closure (or closed-over Python floats)
    # re-traced this large gather graph on EVERY PPM pass
    L = _pm_estimate(scene, grid, ray, jnp.asarray(radius, jnp.float32),
                     jnp.asarray(1.0 / n_photons, jnp.float32))
    img = L.reshape(h, w, spp, 3).mean(axis=2)
    return img, {"n_photons": n_photons, "radius": radius,
                 "n_deposits": int(len(pos))}


def ppm_render(scene, cfg: PathConfig, n_photons_per_pass: int = 100_000,
               n_passes: int = 8, alpha: float = 0.7,
               initial_radius: float | None = None, seed: int = 0):
    """Progressive photon mapping (Hachisuka's radius schedule; reference
    ppm.cpp / sppm.cpp). Camera hits are re-sampled per pass (SPPM)."""
    w, h = scene.width, scene.height
    acc = jnp.zeros((h, w, 3))
    radius = initial_radius
    for i in range(n_passes):
        pcfg = PathConfig(max_depth=cfg.max_depth, spp=cfg.spp,
                          pattern=cfg.pattern, remat=False)
        img, aux = photonmap_render(
            scene, pcfg, n_photons=n_photons_per_pass,
            radius=radius, seed=seed * 131 + i,
        )
        if radius is None:
            radius = aux["radius"]
        acc = acc + img
        radius = float(radius) * float(np.sqrt((i + alpha) / (i + 1)))
    return acc / n_passes, {"final_radius": radius, "passes": n_passes}


def photonmapper_render(scene, cfg: PathConfig, n_photons: int = 150_000,
                        gather_samples: int = 8, radius: float | None = None,
                        seed: int = 0):
    """Full photon mapping with final gather (reference
    photonmapper/photonmapper.cpp:30, 441 LoC): at each camera hit
    L = Le + direct NEE + caustic-map estimate + final-gathered indirect.

    Maps: the global map holds every surface deposit; the caustic map is
    the subset whose previous interactions were all specular (flag from
    bre.shoot_photons_media).  Final gather shoots `gather_samples`
    cosine rays per hit; the global-map estimate at the gather hits is
    the incoming indirect radiance — each gather sample is a
    full-wavefront batch (no per-pixel loops).
    """
    from mitsuba_jax.emitters import eval_emitter_hit, sample_direct
    from mitsuba_jax.integrators.bre import shoot_photons_media
    from mitsuba_jax.media import no_medium
    from mitsuba_jax.render.intersect import ray_test

    pos, power, din, nrm, caustic = shoot_photons_media(
        scene, no_medium(), n_photons, cfg.max_depth, seed
    )[0]
    if radius is None:
        extent = float(np.linalg.norm(pos.max(0) - pos.min(0))) if len(pos) else 1.0
        radius = 0.02 * extent
    grid_global = build_photon_grid(pos, power, din, nrm)
    has_caustic = bool(caustic.sum() > 8)
    if has_caustic:
        grid_caustic = build_photon_grid(
            pos[caustic], power[caustic], din[caustic], nrm[caustic]
        )

    w, h, spp = scene.width, scene.height, cfg.spp
    n = w * h * spp
    lane = jnp.arange(n)
    pixel_id = lane // spp
    sample_id = (lane % spp).astype(jnp.int32)
    px = (pixel_id % w).astype(jnp.float32)
    py = (pixel_id // w).astype(jnp.float32)
    sampler = Sampler(seed, pixel_id, sample_id)
    jitter = sampler.next_2d()
    offset = sample_position(cfg.pattern, sample_id, spp, jitter)
    uv = jnp.stack([(px + offset[:, 0]) / w, (py + offset[:, 1]) / h], -1)
    ray = scene.camera.sample_ray(uv)
    u_nee1 = sampler.next_1d()
    u_nee2 = sampler.next_2d()
    u_g = sampler.next_stacked_2d(gather_samples)

    @jax.jit
    def shade(scene, ray, grid_global, grid_caustic, u_nee1, u_nee2, u_g):
        from mitsuba_jax.bsdfs import bsdf_eval
        from mitsuba_jax.core import warp

        its = ray_intersect(scene.geom, ray)
        le = eval_emitter_hit(scene.emitters, its.emitter_id, -ray.d, its.geo_n)
        # direct NEE (one light sample; the reference uses its own counts)
        ds = sample_direct(scene.emitters, scene.geom, its.p, u_nee1, u_nee2)
        eps = m.EPSILON * jnp.maximum(1.0, jnp.abs(its.p).max(-1))
        shadow = Ray.make(its.p, ds.d, mint=eps, maxt=ds.dist * (1 - 1e-3))
        occ = ray_test(scene.geom, shadow)
        fcos = bsdf_eval(scene.materials, its.material_id, its.wi,
                         its.to_local(ds.d))
        ok = its.valid & ds.valid & ~occ & (ds.pdf > 0)
        direct = jnp.where(ok[:, None],
                           fcos * ds.value / jnp.maximum(ds.pdf, 1e-20)[:, None],
                           0.0)
        # caustics straight from the caustic map (sharp features)
        lc = (photon_estimate(scene, grid_caustic, its, radius,
                              n_photons)
              if grid_caustic is not None else jnp.zeros_like(direct))
        # final gather: indirect = E_cos[ radiance_est(gather hit) ] * albedo
        mclip = jnp.clip(its.material_id, 0, scene.materials.n_materials - 1)
        albedo = scene.materials.reflectance[mclip]
        frame = its.frame()

        def gather(acc, u2):
            d_loc = warp.square_to_cosine_hemisphere(u2)
            d_w = frame.to_world(d_loc)
            gray = Ray.make(its.p, d_w, mint=eps)
            gits = ray_intersect(scene.geom, gray)
            lg = photon_estimate(scene, grid_global, gits, radius, n_photons)
            return acc + jnp.where(gits.valid[:, None], lg, 0.0), None

        ind, _ = jax.lax.scan(gather, jnp.zeros((its.p.shape[0], 3)), u_g)
        indirect = albedo * ind / gather_samples
        return jnp.where(its.valid[:, None],
                         le + direct + lc + indirect, 0.0)

    L = shade(scene, ray, grid_global,
              grid_caustic if has_caustic else None, u_nee1, u_nee2, u_g)
    img = L.reshape(h, w, spp, 3).mean(axis=2)
    return img, {"n_photons": n_photons, "radius": radius,
                 "n_caustic": int(caustic.sum()), "gather": gather_samples}


@functools.partial(jax.jit, static_argnames=("w", "h"))
def _sppm_pass(scene, grid, R, N, tau, direct, pass_seed, alpha_d, inv_np,
               w, h):
    """One SPPM pass (module-level jit: per-call closures would re-trace
    the gather graph every pass)."""
    from mitsuba_jax.emitters import eval_emitter_hit

    n = w * h
    pixel_id = jnp.arange(n)
    px = (pixel_id % w).astype(jnp.float32)
    py = (pixel_id // w).astype(jnp.float32)
    sampler = Sampler(pass_seed, pixel_id, jnp.zeros(n, jnp.int32))
    jitter = sampler.next_2d()
    uv = jnp.stack([(px + jitter[:, 0]) / w,
                    (py + jitter[:, 1]) / h], -1)
    ray = scene.camera.sample_ray(uv)
    its = ray_intersect(scene.geom, ray)
    mclip = jnp.clip(its.material_id, 0, scene.materials.n_materials - 1)
    albedo = scene.materials.reflectance[mclip]
    sh_n = its.sh_n

    def contrib(rows, d2):
        power = rows[:, 0:3]
        din = rows[:, 3:6]
        n_ph = rows[:, 6:9]
        # arriving on the shading side AND deposited on a surface
        # facing the same way: the spherical gather would otherwise
        # count photons on adjacent perpendicular walls (proximity
        # bias — photonmap.h's normal check)
        side = ((jnp.sum(sh_n * -din, axis=-1) > 0)
                & (jnp.sum(sh_n * n_ph, axis=-1) > 0.5)).astype(
                    jnp.float32)
        return jnp.concatenate(
            [power * side[:, None], side[:, None]], axis=1)

    g4 = grid.gather_sum(its.p, R, contrib_fn=contrib)
    flux, M = g4[:, 0:3], g4[:, 3]
    M = jnp.where(its.valid, M, 0.0)
    N_new = N + alpha_d * M
    ratio = jnp.where(M > 0, N_new / jnp.maximum(N + M, 1e-9), 1.0)
    R_new = R * jnp.sqrt(ratio)
    phi = albedo * m.INV_PI * flux * inv_np
    tau_new = (tau + jnp.where(its.valid[:, None], phi, 0.0)) \
        * ratio[:, None]

    # emitted radiance only (photons carry direct+indirect)
    le = eval_emitter_hit(scene.emitters, its.emitter_id, -ray.d,
                          its.geo_n)
    d_new = direct + jnp.where(its.valid[:, None], le, 0.0)
    return R_new, N, tau_new, d_new, N_new


def sppm_render(scene, cfg: PathConfig, n_photons_per_pass: int = 100_000,
                n_passes: int = 8, alpha: float = 0.7,
                initial_radius: float | None = None, seed: int = 0):
    """Stochastic progressive photon mapping with PER-PIXEL statistics
    (reference sppm.cpp:33 — distinct from ppm_render's global radius
    schedule). Each pixel i carries (R_i, N_i, tau_i); per pass with M_i
    gathered photons (Hachisuka & Jensen 2009):

        N'   = N + alpha * M
        R'   = R * sqrt(N' / (N + M))          (no-op when M = 0)
        tau' = (tau + albedo/pi * Phi / n_photons) * (R'/R)^2

    Camera hit points are re-jittered every pass (the S in SPPM), so
    distributed effects (anti-aliasing, DoF) converge too. The final
    estimate is tau / (pi R^2 * passes) + averaged emitted Le — photons
    carry BOTH direct and indirect illumination (they deposit on first
    contact), so no separate NEE term is added (it would double count;
    same convention as photonmap_render's visualization mode)."""
    from mitsuba_jax.emitters import eval_emitter_hit

    w, h = scene.width, scene.height
    n = w * h
    pixel_id = jnp.arange(n)
    px = (pixel_id % w).astype(jnp.float32)
    py = (pixel_id // w).astype(jnp.float32)

    # initial radius: from the first pass's photon cloud extent
    pos0, _, _, _ = shoot_photons(scene, n_photons_per_pass,
                                  cfg.max_depth, seed)
    extent = float(np.linalg.norm(pos0.max(0) - pos0.min(0))) \
        if len(pos0) else 1.0
    r0 = initial_radius if initial_radius is not None else 0.01 * extent
    # hash-grid cell must cover the largest (= initial) radius
    grid_res = max(4, min(48, int(extent / max(r0, 1e-6))))

    R = jnp.full(n, r0)
    N = jnp.zeros(n)
    tau = jnp.zeros((n, 3))
    direct = jnp.zeros((n, 3))

    for i in range(n_passes):
        pos, power, din, nrm = shoot_photons(
            scene, n_photons_per_pass, cfg.max_depth, seed * 131 + 7 * i + 1)
        grid = build_photon_grid(pos, power, din, nrm, res=grid_res)
        R, _, tau, direct, N = _sppm_pass(
            scene, grid, R, N, tau, direct,
            jnp.asarray(seed * 977 + i, jnp.uint32),
            jnp.asarray(alpha, jnp.float32),
            jnp.asarray(1.0 / n_photons_per_pass, jnp.float32), w, h)

    L = tau / (jnp.pi * jnp.maximum(R, 1e-9)[:, None] ** 2 * n_passes) \
        + direct / n_passes
    img = L.reshape(h, w, 3)
    return img, {
        "passes": n_passes,
        "mean_radius": float(jnp.mean(R)),
        "min_radius": float(jnp.min(R)),
        "mean_N": float(jnp.mean(N)),
        "radius_map": np.asarray(R).reshape(h, w),
    }
