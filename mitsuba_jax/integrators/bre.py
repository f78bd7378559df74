"""Volume photon mapping + beam radiance estimate.

Capability parity with the reference's volume-photon machinery:
  * `GatherPhotonProcess` EVolumePhotons mode (gatherproc.h:34) — photons
    deposited at medium scattering events;
  * `BeamRadianceEstimator` (photonmapper/bre.cpp, 180 LoC) — in-scattered
    radiance along a camera ray from the volume photon map.

Wavefront re-design: the reference builds a BRE kd-tree with per-photon radii
and intersects camera rays against photon discs.  Here volume photons go
into the same uniform HashGrid as surface photons, and the beam integral
is evaluated by fixed-count stratified marching: S sample points per
camera ray, each doing a 27-cell grid gather with a 3-D Epanechnikov
kernel — every lane does identical static work (no per-photon radii, no
tree descent), which is the shape XLA wants.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.bsdfs import bsdf_sample
from mitsuba_jax.core import math as m
from mitsuba_jax.core.kdtree import HashGrid
from mitsuba_jax.core.types import replace
from mitsuba_jax.integrators.path import PathConfig, _detach
from mitsuba_jax.integrators.ptracer import _sample_emission
from mitsuba_jax.media.medium import sample_distance
from mitsuba_jax.media.phase import phase_eval
from mitsuba_jax.render.intersect import ray_intersect
from mitsuba_jax.render.records import Ray
from mitsuba_jax.render.sampler import Sampler, sample_position


def shoot_photons_media(scene, medium, n_photons: int, max_depth: int,
                        seed: int = 0):
    """Photon walk through a participating medium.

    Returns (surface deposits, volume deposits) as compacted host arrays:
      surface: (pos, power, din, nrm, caustic)  — caustic = the photon's
        previous surface interactions were all delta and there was at
        least one (the reference's ECausticPhotons classification,
        gatherproc.h:34);
      volume: (pos, power, din) at medium scattering events.
    """
    n = n_photons
    sampler = Sampler(seed ^ 0xBEEF1234, jnp.arange(n), jnp.zeros(n, jnp.int32))
    u_sel = sampler.next_1d()
    u_pos = sampler.next_2d()
    u_dir = sampler.next_2d()
    u_scatter = sampler.next_stacked_2d(max_depth)
    u_lobe = sampler.next_stacked_1d(max_depth)
    u_mch = sampler.next_stacked_1d(max_depth)
    u_mdist = sampler.next_stacked_1d(max_depth)
    u_ph = sampler.next_stacked_2d(max_depth)

    p0, n0, d0, beta, valid0 = _sample_emission(
        scene, _detach(u_sel), _detach(u_pos), _detach(u_dir)
    )
    eps0 = m.EPSILON * jnp.maximum(1.0, jnp.abs(p0).max(-1))
    ray = Ray.make(p0, d0, mint=eps0)

    # scene bounds: volume deposits outside are dropped (the ambient
    # medium is infinite, but photons outside the geometry can never be
    # gathered — keeping them would only dilate the HashGrid cells)
    v0 = np.asarray(scene.geom.v0)
    vmax = v0 + np.asarray(scene.geom.e1) + np.asarray(scene.geom.e2)
    margin = 0.05 * float(np.linalg.norm(vmax.max(0) - v0.min(0)) + 1e-6)
    bmin = jnp.asarray(v0.min(0) - margin, jnp.float32)
    bmax = jnp.asarray(vmax.max(0) + margin, jnp.float32)

    @jax.jit
    def walk(scene, medium, ray, beta, active, xs):
        spec_only = jnp.zeros(n, bool)   # all previous surface hits delta?
        n_surf = jnp.zeros(n, jnp.int32)

        def bounce(carry, x):
            ray, beta, active, spec_only, n_surf = carry
            u2, u1, umc, umd, uph = x
            its = ray_intersect(scene.geom, ray)
            max_t = jnp.where(its.valid, its.t, 1e8)
            med = sample_distance(medium, ray.o, ray.d, max_t,
                                  _detach(umc), _detach(umd))
            in_medium = active & med["valid"]
            at_surface = active & its.valid & ~med["valid"]
            # --- volume deposit: arriving power at the scatter point
            # (only a scattering medium produces usable volume photons —
            # absorption-only collisions would estimate to exactly 0)
            in_box = jnp.all((med["p"] >= bmin) & (med["p"] <= bmax), axis=-1)
            scatters = jnp.any(medium.sigma_s > 0)
            vol_dep = (med["p"], beta, ray.d, in_medium & in_box & scatters)
            beta_m = beta * med["weight"]
            # phase scattering (HG sample weight = 1: pdf == phase)
            from mitsuba_jax.media.phase import phase_sample

            d_new_m, _ = phase_sample(medium.phase_kind, medium.phase_g,
                                      ray.d, _detach(uph))
            # --- surface deposit
            caustic = spec_only & (n_surf >= 1)
            surf_dep = (its.p, beta * med["surface_weight"], ray.d,
                        its.sh_n, at_surface, caustic & at_surface)
            beta_s = beta * med["surface_weight"]
            bs = bsdf_sample(scene.materials, its.material_id, its.wi,
                             _detach(u2), _detach(u1))
            wo_world = its.to_world(bs["wo"])
            # next state: medium lanes scatter, surface lanes reflect
            nxt_s = at_surface & bs["valid"]
            nxt = in_medium | nxt_s
            beta = jnp.where(in_medium[:, None], beta_m,
                             jnp.where(nxt_s[:, None],
                                       beta_s * bs["weight"], beta))
            new_o = jnp.where(in_medium[:, None], med["p"], its.p)
            new_d = jnp.where(in_medium[:, None], d_new_m, wo_world)
            eps = m.EPSILON * jnp.maximum(1.0, jnp.abs(new_o).max(-1))
            new_ray = Ray.make(new_o, new_d, mint=eps)
            ray = replace(
                new_ray,
                o=jnp.where(nxt[:, None], new_ray.o, ray.o),
                d=jnp.where(nxt[:, None], new_ray.d, ray.d),
            )
            spec_only = jnp.where(
                at_surface, spec_only & bs["delta"] | ((n_surf == 0) & bs["delta"]),
                spec_only,
            )
            n_surf = n_surf + at_surface.astype(jnp.int32)
            return (ray, beta, nxt, spec_only, n_surf), (surf_dep, vol_dep)

        _, deps = jax.lax.scan(
            bounce, (ray, beta, active, spec_only, n_surf), xs
        )
        return deps

    (sp, spw, sd, sn, sact, scau), (vp, vpw, vd, vact) = walk(
        scene, medium, ray, beta, valid0,
        (u_scatter, u_lobe, u_mch, u_mdist, u_ph),
    )
    flat = lambda a: np.asarray(a).reshape((-1,) + a.shape[2:])
    sm = flat(sact).astype(bool)
    vm = flat(vact).astype(bool)
    # absorption collisions (sigma_s = 0) carry zero power — drop them
    vm &= flat(vpw).sum(axis=1) > 0
    surface = (flat(sp)[sm], flat(spw)[sm], flat(sd)[sm], flat(sn)[sm],
               flat(scau)[sm])
    volume = (flat(vp)[vm], flat(vpw)[vm], flat(vd)[vm])
    return surface, volume


def build_volume_grid(pos, power, din, res: int = 32) -> tuple:
    """Uniform HashGrid over volume photons; returns (grid, radius) with
    the gather radius matched to the grid cell (27-cell coverage).

    The per-cell scan budget adapts to the observed occupancy (p99):
    volume photons pack 3-D cells far denser than surface deposits, and
    the default budget of 64/27 ≈ 2 would subsample dense cells ~10x —
    unbiased after gather_sum's count/budget rescale, but noisy enough to
    shift small-image means."""
    if len(pos) == 0:
        return None, 0.0
    pos = np.asarray(pos)
    radius = float((pos.max(0) - pos.min(0)).max() + 1e-6) / res
    bmin = pos.min(0) - 1e-6
    cell = (pos.max(0) + 1e-6 - bmin).max() / res
    ijk = np.clip(((pos - bmin) / cell).astype(np.int64), 0, res - 1)
    cid = (ijk[:, 0] * res + ijk[:, 1]) * res + ijk[:, 2]
    occ = np.bincount(cid)
    occ = occ[occ > 0]
    per_cell = int(min(max(np.percentile(occ, 99), 4), 48))
    grid = HashGrid.build(
        pos, np.concatenate(
            [np.asarray(power), np.asarray(din)], axis=1
        ), res=res, max_per_query=27 * per_cell,
    )
    return grid, radius


def beam_radiance_estimate(medium, grid: HashGrid, radius: float,
                           ray_o, ray_d, max_t, n_emitted: int,
                           n_march: int = 32, u_offset=None):
    """In-scattered radiance along camera rays from the volume photon map
    (reference bre.cpp BeamRadianceEstimator::query).

    Stratified marching: L = Σ_s Δt·Tr(t_s)·(σs/σt)·Σ_i K3(d_i)·phase·P_i/N.

    The σs/σt ratio (not σs): volume deposits are stored at EVERY sampled
    medium event (density ∝ σt·Tr along photon paths, shoot_photons_media)
    carrying the un-attenuated arriving power, so Σ Φ·K3/N estimates
    σt·fluence — dividing by σt recovers the fluence and σs turns it into
    in-scattered radiance (Jensen & Christensen 98 store only scattering
    events, which cancels their σs instead; a bare σs here is
    dimensionally wrong and made the beam term ~σt·extent ≈ 100x too
    small)."""
    n = ray_o.shape[0]
    sigma_t = medium.sigma_t
    albedo_m = medium.sigma_s / jnp.maximum(medium.sigma_t, 1e-20)
    dt = max_t / n_march
    if u_offset is None:
        u_offset = jnp.full((n,), 0.5)
    inv_kernel = 15.0 / (8.0 * jnp.pi * radius ** 3)   # 3-D Epanechnikov

    def contrib(rows, d2):
        ph_pow = rows[:, 0:3]
        ph_din = rows[:, 3:6]
        w = jnp.maximum(1.0 - d2 / radius ** 2, 0.0)[:, None]
        # phase between the photon's propagation dir and the camera ray
        f = phase_eval(medium.phase_kind, medium.phase_g, ph_din, -ray_d)
        return ph_pow * w * f[:, None]

    # ONE traced gather per scan step (n_march steps), not an unrolled loop
    def step(acc, s_i):
        t_s = (s_i.astype(jnp.float32) + u_offset) * dt
        p_s = ray_o + ray_d * t_s[:, None]
        tr = jnp.exp(-sigma_t[None, :] * t_s[:, None])
        dens = grid.gather_sum(p_s, radius, contrib_fn=contrib)
        return acc + tr * albedo_m[None, :] * dens * inv_kernel \
            * dt[:, None], None

    L, _ = jax.lax.scan(step, jnp.zeros((n, 3)), jnp.arange(n_march))
    return L / n_emitted


def bre_render(scene, medium, cfg: PathConfig, n_photons: int = 100_000,
               n_march: int = 32, seed: int = 0):
    """Camera-ray beam estimate through the medium + surface photon
    visualization at the far hit (single-scatter-from-photons picture)."""
    from mitsuba_jax.emitters import eval_emitter_hit
    from mitsuba_jax.integrators.photonmap import (
        build_photon_grid, photon_estimate,
    )
    from mitsuba_jax.media.medium import medium_transmittance

    surface, volume = shoot_photons_media(
        scene, medium, n_photons, cfg.max_depth, seed
    )
    sp, spw, sd, sn, _ = surface
    vgrid, vradius = build_volume_grid(*volume)
    sgrid = build_photon_grid(sp, spw, sd, sn)
    extent = float(np.linalg.norm(sp.max(0) - sp.min(0))) if len(sp) else 1.0
    sradius = 0.02 * extent

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
    u_march = sampler.next_1d()

    @jax.jit
    def estimate(scene, medium, vgrid, sgrid, ray, u_march):
        its = ray_intersect(scene.geom, ray)
        max_t = jnp.where(its.valid, its.t, 1e4)
        le = eval_emitter_hit(scene.emitters, its.emitter_id, -ray.d, its.geo_n)
        lr = photon_estimate(scene, sgrid, its, sradius, n_photons)
        tr_surf = medium_transmittance(medium, ray.o, ray.d, max_t)
        l_surf = jnp.where(its.valid[:, None], (le + lr) * tr_surf, 0.0)
        if vgrid is None:
            return l_surf
        l_beam = beam_radiance_estimate(
            medium, vgrid, vradius, ray.o, ray.d, max_t, n_photons,
            n_march=n_march, u_offset=u_march,
        )
        return l_surf + l_beam

    L = estimate(scene, medium, vgrid, sgrid, ray, u_march)
    img = L.reshape(h, w, spp, 3).mean(axis=2)
    return img, {
        "n_volume_photons": int(len(volume[0])),
        "n_surface_photons": int(len(sp)),
        "volume_radius": vradius,
    }
