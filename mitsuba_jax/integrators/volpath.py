"""Volumetric path tracer — full RTE estimation in an ambient medium.

Functional parity with reference `VolumetricPathTracer`
(src/integrators/path/volpath.cpp:37): free-path sampling via
`Medium::sampleDistance`, phase-function importance sampling with MIS
against emitter sampling, attenuated next-event estimation, surface
interactions interleaved with medium events.  volpath_simple semantics
(volpath_simple.cpp — no MIS on the phase side) are available with
`mis=False`.

Same wavefront/scan architecture as integrators/path.py; each bounce first
samples a medium interaction against the surface hit distance, then the
medium and surface lanes proceed masked in parallel.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from mitsuba_jax.bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_jax.core import math as m
from mitsuba_jax.core.types import replace
from mitsuba_jax.emitters import (
    eval_emitter_hit,
    eval_environment,
    pdf_direct_area,
    pdf_environment,
    sample_direct,
)
from mitsuba_jax.integrators.path import PathConfig, mi_weight, _detach
from mitsuba_jax.media import (
    medium_transmittance,
    phase_eval,
    phase_pdf,
    phase_sample,
    sample_distance,
)
from mitsuba_jax.render.intersect import ray_intersect, ray_test
from mitsuba_jax.render.records import Ray
from mitsuba_jax.render.sampler import Sampler

_FAR = 1e6


def volpath_trace(scene, medium, ray: Ray, sampler: Sampler, cfg: PathConfig,
                  seed: int = 0, mis: bool = True, guide=None,
                  learn_guide: bool = False, guide_alpha: float = 0.5,
                  guide_sampling: bool = None):
    """Trace radiance with an ambient participating medium.

    medium: MediumTable (media/medium.py); mis=False reproduces the
    volpath_simple estimator (no phase-side MIS).
    guide/learn_guide: volumetric path guiding (integrators/guiding) —
    medium scatter directions draw from the α·phase + (1-α)·guide
    mixture; surfaces keep plain BSDF sampling."""
    n = ray.o.shape[0]
    d_max = cfg.max_depth

    u_ch = sampler.next_stacked_1d(d_max)
    u_dist = sampler.next_stacked_1d(d_max)
    u_nee_sel = sampler.next_stacked_1d(d_max)
    u_nee_pos = sampler.next_stacked_2d(d_max)
    u_scatter = sampler.next_stacked_2d(d_max)
    u_lobe = sampler.next_stacked_1d(d_max)
    u_rr = sampler.next_stacked_1d(d_max)
    if guide_sampling is None:
        guide_sampling = guide is not None and not learn_guide
    guide_sampling = guide_sampling and guide is not None
    if guide_sampling:
        u_gpick = sampler.next_stacked_1d(d_max)
        u_gbin = sampler.next_stacked_1d(d_max)
    else:
        u_gpick = u_gbin = jnp.zeros((d_max, 1))
    wd_keys = jax.random.split(jax.random.fold_in(jax.random.key(seed), 0x77), d_max)
    is_last = (jnp.arange(d_max) + 1) >= d_max
    do_rr = jnp.arange(d_max) >= cfg.rr_depth

    init = (
        jnp.zeros((n, 3)), jnp.ones((n, 3)), ray,
        jnp.ones(n, bool), jnp.zeros(n), jnp.ones(n, bool),
        jnp.zeros(n, jnp.int32),
        guide.mass if learn_guide and guide is not None
        else jnp.zeros(()),
    )

    def bounce(carry, xs):
        (L, throughput, ray, active, prev_pdf, prev_delta, depth_count,
         guide_mass) = carry
        (u_ch, u_dist, u_nee_sel, u_nee_pos, u_scatter, u_lobe, u_rr,
         u_gpick, u_gbin, wd_key, is_last, do_rr) = xs
        act_in = active

        its = ray_intersect(scene.geom, ray)
        t_surf = jnp.where(its.valid, its.t, _FAR)

        md = sample_distance(
            medium, ray.o, ray.d, t_surf,
            _detach(u_ch), _detach(u_dist), key=wd_key,
        )
        in_medium = active & md.get("valid")
        at_surface = active & ~md.get("valid") & its.valid
        escaped = active & ~md.get("valid") & ~its.valid

        # throughput after the free-path decision
        thr_med = throughput * md["weight"]
        thr_surf = throughput * md["surface_weight"]

        # --- escaped: background radiance (attenuated weight already in
        # surface_weight for analog sampling) ---------------------------
        env = eval_environment(scene.emitters, ray.d)
        env_pdf = pdf_environment(scene.emitters, ray.d)
        w_env = jnp.where(prev_delta, 1.0, mi_weight(prev_pdf, env_pdf))
        L = L + jnp.where(escaped[:, None], thr_surf * env * w_env[:, None], 0.0)

        depth_count = depth_count + (in_medium | at_surface).astype(jnp.int32)

        # --- surface emitter hit ---------------------------------------
        le = eval_emitter_hit(scene.emitters, its.emitter_id, -ray.d, its.geo_n)
        if learn_guide and guide is not None:
            from mitsuba_jax.core.types import replace as _vreplace
            from mitsuba_jax.integrators.guiding import guide_update

            inc = jnp.where(at_surface[:, None], le, 0.0) \
                + jnp.where(escaped[:, None], env, 0.0)
            lum = (0.2126 * inc[:, 0] + 0.7152 * inc[:, 1]
                   + 0.0722 * inc[:, 2])
            g_tmp = guide_update(_vreplace(guide, mass=guide_mass),
                                 _detach(ray.o), _detach(ray.d),
                                 _detach(lum), act_in & (lum > 0))
            guide_mass = g_tmp.mass
        lum_pdf = pdf_direct_area(scene.emitters, its.prim_id, ray.o,
                                  its.p, its.geo_n,
                                  emitter_id=its.emitter_id)
        w_bsdf = jnp.where(prev_delta, 1.0, mi_weight(prev_pdf, lum_pdf))
        L = L + jnp.where(at_surface[:, None], thr_surf * le * w_bsdf[:, None], 0.0)

        cont_m = in_medium & ~is_last
        cont_s = at_surface & ~is_last

        # --- NEE (shared emitter sample; per-lane scatter point) --------
        p_scatter = jnp.where(in_medium[:, None], md["p"], its.p)
        ds = sample_direct(
            scene.emitters, scene.geom, p_scatter,
            _detach(u_nee_sel), _detach(u_nee_pos),
        )
        # medium side: phase value (oriented media fetch the local fiber
        # axis; gaussian-flake media also need the fitted σ_t expansion)
        if medium.oriented or medium.flake_coeffs is not None:
            from mitsuba_jax.media.medium import lookup_orientation

            ph_axis = lookup_orientation(medium, p_scatter)
        else:
            ph_axis = None
        ph_val = phase_eval(medium.phase_kind, medium.phase_g, ray.d, ds.d,
                            fiber_axis=ph_axis,
                            flake_coeffs=medium.flake_coeffs)
        ph_pdf = phase_pdf(medium.phase_kind, medium.phase_g, ray.d, ds.d,
                           fiber_axis=ph_axis,
                           flake_coeffs=medium.flake_coeffs) if mis \
            else jnp.zeros(n)
        if guide_sampling:
            # volumetric guiding: the scatter strategy below is the
            # α·phase + (1-α)·guide mixture, so MIS counterweights use
            # the mixture pdf too
            from mitsuba_jax.integrators.guiding import (
                guide_pdf as _guide_pdf, guide_sample as _guide_sample,
            )

            g_dir, g_pdf_s, g_ok = _guide_sample(
                guide, _detach(p_scatter), _detach(u_scatter),
                _detach(u_gbin))
            alpha_l = jnp.where(g_ok, guide_alpha, 1.0)
            if mis:
                ph_pdf = alpha_l * ph_pdf + (1.0 - alpha_l) * _guide_pdf(
                    guide, _detach(p_scatter), _detach(ds.d))
        # surface side: BSDF value
        wo_local = its.to_local(ds.d)
        fcos = bsdf_eval(scene.materials, its.material_id, its.wi, wo_local)
        b_pdf = bsdf_pdf(scene.materials, its.material_id, its.wi, wo_local)

        eps = m.EPSILON * jnp.maximum(1.0, jnp.abs(p_scatter).max(-1))
        shadow = Ray.make(p_scatter, ds.d, mint=eps, maxt=ds.dist * (1.0 - 1e-3))
        occluded = ray_test(scene.geom, shadow)
        tr = medium_transmittance(medium, p_scatter, ds.d, ds.dist)

        nee_ok = (cont_m | cont_s) & ds.valid & (ds.pdf > 0) & ~occluded
        scatter_pdf = jnp.where(in_medium, ph_pdf, b_pdf)
        w_nee = jnp.where(ds.delta, 1.0, mi_weight(ds.pdf, scatter_pdf))
        f_scatter = jnp.where(in_medium[:, None], ph_val[:, None], fcos)
        thr_here = jnp.where(in_medium[:, None], thr_med, thr_surf)
        contrib = thr_here * f_scatter * ds.value * tr * \
            (w_nee / jnp.maximum(ds.pdf, 1e-20))[:, None]
        L = L + jnp.where(nee_ok[:, None], contrib, 0.0)

        # --- scatter: phase sample (medium) / BSDF sample (surface) -----
        wo_phase, phase_p = phase_sample(
            medium.phase_kind, medium.phase_g, ray.d, _detach(u_scatter),
            fiber_axis=ph_axis, flake_coeffs=medium.flake_coeffs,
        )
        w_med = jnp.ones(n)
        if guide_sampling:
            pick_g = g_ok & (_detach(u_gpick) >= alpha_l)
            # a phase-sampling failure lane (pdf=0, e.g. gaussian-flake
            # rejection exhaustion) stays dead unless the guide drew it
            ph_dead = ~pick_g & (phase_p <= 0)
            wo_mix = jnp.where(pick_g[:, None], g_dir, wo_phase)
            ph_mix = phase_eval(medium.phase_kind, medium.phase_g, ray.d,
                                wo_mix, fiber_axis=ph_axis,
                                flake_coeffs=medium.flake_coeffs)
            pg_mix = jnp.where(pick_g, g_pdf_s, _guide_pdf(
                guide, _detach(p_scatter), _detach(wo_mix)))
            q_mix = alpha_l * ph_mix + (1.0 - alpha_l) * pg_mix
            wo_phase = wo_mix
            # medium throughput weight: phase/q (1 when unguided since
            # phase sampling is exact)
            w_med = jnp.where((q_mix > 1e-12) & ~ph_dead,
                              ph_mix / jnp.maximum(q_mix, 1e-12), 0.0)
            phase_p = jnp.where(ph_dead, 0.0, q_mix)
        bs = bsdf_sample(
            scene.materials, its.material_id, its.wi,
            _detach(u_scatter), _detach(u_lobe),
        )
        wo_world = jnp.where(
            in_medium[:, None], wo_phase, its.to_world(bs["wo"])
        )
        next_pdf = jnp.where(in_medium, phase_p if mis else jnp.zeros(n), bs["pdf"])
        next_delta = jnp.where(in_medium, jnp.zeros(n, bool) if mis else jnp.ones(n, bool), bs["delta"])
        from mitsuba_jax.media.phase import MICROFLAKE_GAUSS as _MFG

        med_ok = (phase_p > 0) if medium.phase_kind == _MFG \
            else jnp.ones(n, bool)
        scatter_ok = jnp.where(in_medium, med_ok, bs["valid"])
        active = (cont_m | cont_s) & scatter_ok

        new_thr = jnp.where(
            in_medium[:, None],
            # phase weight: 1 for exact phase sampling; phase/q_mix when
            # the guided mixture drew the direction
            thr_med * w_med[:, None],
            thr_surf * bs["weight"],
        )

        # --- Russian roulette ------------------------------------------
        albedo = jnp.minimum(0.9, jnp.maximum(jnp.max(_detach(new_thr), axis=-1) /
                                              jnp.maximum(jnp.max(_detach(throughput), axis=-1), 1e-8), 0.05))
        kill = do_rr & (u_rr > albedo) & ~bs["transmission"]
        rr_scale = jnp.where(do_rr & ~bs["transmission"],
                             1.0 / jnp.maximum(albedo, 1e-3), 1.0)
        active = active & ~kill
        new_thr = new_thr * jnp.where(active, rr_scale, 1.0)[:, None]

        throughput = jnp.where(active[:, None], new_thr, throughput)
        origin = jnp.where(in_medium[:, None], md["p"], its.p)
        new_ray = Ray.make(origin, wo_world, mint=eps)
        ray = replace(
            new_ray,
            o=jnp.where(active[:, None], new_ray.o, ray.o),
            d=jnp.where(active[:, None], new_ray.d, ray.d),
        )
        return (L, throughput, ray, active, _detach(next_pdf), next_delta,
                depth_count, guide_mass), None

    body = jax.checkpoint(bounce) if cfg.remat else bounce
    carry, _ = jax.lax.scan(
        body, init,
        (u_ch, u_dist, u_nee_sel, u_nee_pos, u_scatter, u_lobe, u_rr,
         u_gpick, u_gbin, wd_keys, is_last, do_rr),
    )
    L = carry[0]
    aux = {"avg_path_length": jnp.mean(carry[6].astype(jnp.float32))}
    if learn_guide and guide is not None:
        from mitsuba_jax.core.types import replace as _vreplace

        aux["guide"] = _vreplace(guide, mass=carry[7])
    return L, aux


def render_volpath(scene, medium, cfg: PathConfig, seed: int = 0,
                   mis: bool = True, guide=None, learn_guide: bool = False,
                   guide_alpha: float = 0.5, guide_sampling: bool = None):
    from mitsuba_jax.render.sampler import sample_position

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
    uv = jnp.stack([(px + offset[:, 0]) / w, (py + offset[:, 1]) / h], axis=-1)
    ray = scene.camera.sample_ray(uv)
    L, aux = volpath_trace(scene, medium, ray, sampler, cfg, seed=seed,
                           mis=mis, guide=guide, learn_guide=learn_guide,
                           guide_alpha=guide_alpha,
                           guide_sampling=guide_sampling)
    img = L.reshape(h, w, spp, 3).mean(axis=2)
    return img, aux


def render_volpath_guided(scene, medium, cfg: PathConfig, seed: int = 0,
                          mis: bool = True, learn_frac: float = 0.5,
                          guide_alpha: float = 0.5, res: int = 16):
    """Volumetric path guiding: phase-1 learning pass + phase-2 guided
    pass (see path.render_guided; here the mixture replaces PHASE
    sampling at medium scatter events)."""
    import dataclasses

    import numpy as np

    from mitsuba_jax.integrators.guiding import make_guide

    spp1 = max(1, int(round(cfg.spp * learn_frac)))
    spp2 = max(0, cfg.spp - spp1)
    v0 = np.asarray(scene.geom.v0)
    ext = v0.max(0) - v0.min(0)
    guide = make_guide(v0.min(0) - 0.01 * ext, v0.max(0) + 0.01 * ext,
                       res=res)
    img1, aux1 = render_volpath(scene, medium,
                                dataclasses.replace(cfg, spp=spp1),
                                seed=seed, mis=mis, guide=guide,
                                learn_guide=True)
    if spp2 == 0:
        return img1, aux1
    guide = aux1.pop("guide")
    img2, aux2 = render_volpath(scene, medium,
                                dataclasses.replace(cfg, spp=spp2),
                                seed=seed + 7507, mis=mis, guide=guide,
                                guide_alpha=guide_alpha)
    return (img1 * spp1 + img2 * spp2) / (spp1 + spp2), aux2


# ---------------------------------------------------------------------------
# Shape-attached interior media (reference: Shape interior/exterior medium
# pointers traversed by volpath.cpp at refractive boundaries).
# Per-lane current-medium index through the scan; homogeneous closed-form
# sampling on one-hot-gathered sigmas (media/medium.py MediumStack).
# ---------------------------------------------------------------------------

def boundary_transmittance(scene, o, d, dist, cur, max_crossings: int = 4):
    """Transmittance from o along d over [0, dist] across ALL media on the
    segment (reference scene.cpp:417 getTransmittance): walk boundary
    crossings, attenuate each segment by its medium, switch media at
    non-occluding surfaces (opacity < 1; materials.null()), and block at
    opaque ones. cur: (N,) current medium index (-1 = vacuum).

    max_crossings bounds the walk (reference iterates up to 100; wavefront
    lanes all pay the worst case, and >4 crossings along one shadow ray is
    pathological). Lanes still unresolved after the cap attenuate the
    remainder with their current medium."""
    from mitsuba_jax.media.medium import (
        stack_params, stack_transmittance, stack_transmittance_het,
    )

    stack = scene.media
    interior = scene.shape_interior
    n = o.shape[0]
    tr = jnp.ones((n, 3))
    t0 = jnp.zeros(n)
    done = jnp.zeros(n, bool)
    eps = m.EPSILON * jnp.maximum(1.0, jnp.abs(o).max(-1))

    def seg_transmittance(cur, t0, seg_len):
        ss, sa, g_lane, inside = stack_params(stack, cur)
        if stack is not None and stack.has_hetero:
            seg_tr = stack_transmittance_het(
                stack, cur, ss, sa, o + d * t0[:, None], d, seg_len)
        else:
            seg_tr = stack_transmittance(ss, sa, seg_len)
        return jnp.where(inside[:, None], seg_tr, 1.0)

    for _ in range(max_crossings):
        seg_ray = Ray.make(o, d, mint=t0 + eps,
                           maxt=jnp.where(done, -1.0, dist))
        its = ray_intersect(scene.geom, seg_ray)
        hit = its.valid & (its.t < dist) & ~done
        seg_end = jnp.where(hit, its.t, dist)
        seg_tr = seg_transmittance(cur, t0, jnp.maximum(seg_end - t0, 0.0))
        tr = tr * jnp.where(done[:, None], 1.0, seg_tr)
        mclip = jnp.clip(its.material_id, 0, scene.materials.n_materials - 1)
        opac = scene.materials.opacity[mclip]
        tr = jnp.where(hit[:, None], tr * (1.0 - opac[:, None]), tr)
        sid = jnp.clip(its.shape_id, 0, interior.shape[0] - 1)
        entering = jnp.sum(d * its.geo_n, axis=-1) < 0
        cur = jnp.where(hit, jnp.where(entering, interior[sid], -1), cur)
        done = done | ~hit
        t0 = jnp.where(hit, its.t, t0)
    # unresolved lanes: attenuate the remainder by the current medium
    rest = seg_transmittance(cur, t0, jnp.maximum(dist - t0, 0.0))
    return tr * jnp.where(done[:, None], 1.0, rest)


def volpath_media_trace(scene, ray: Ray, sampler: Sampler, cfg: PathConfig,
                        mis: bool = True, _debug_unroll: bool = False,
                        seed_het: int = 17):
    """Volumetric path tracing with per-shape interior media.

    Every lane carries the index of the medium it is travelling through
    (-1 = vacuum); crossing a transmissive surface into a shape switches
    to scene.shape_interior[shape], exiting returns to vacuum (single-level
    nesting, like the reference's common usage).  NEE shadow rays attenuate
    by the CURRENT medium only (boundary-crossing shadow attenuation is an
    ambient-medium feature; see volpath_trace)."""
    from mitsuba_jax.media import HG
    from mitsuba_jax.media.medium import (
        stack_params, stack_sample_distance, stack_sample_distance_het,
        stack_transmittance,
    )

    n = ray.o.shape[0]
    d_max = cfg.max_depth
    stack = scene.media
    interior = scene.shape_interior
    has_het = stack is not None and stack.has_hetero
    woodcock_keys = (jax.random.split(jax.random.key(seed_het), d_max)
                     if has_het else jnp.zeros((d_max, 2), jnp.uint32))

    u_ch = sampler.next_stacked_1d(d_max)
    u_dist = sampler.next_stacked_1d(d_max)
    u_nee_sel = sampler.next_stacked_1d(d_max)
    u_nee_pos = sampler.next_stacked_2d(d_max)
    u_scatter = sampler.next_stacked_2d(d_max)
    u_lobe = sampler.next_stacked_1d(d_max)
    u_rr = sampler.next_stacked_1d(d_max)
    is_last = (jnp.arange(d_max) + 1) >= d_max
    do_rr = jnp.arange(d_max) >= cfg.rr_depth

    init = (
        jnp.zeros((n, 3)), jnp.ones((n, 3)), ray,
        jnp.ones(n, bool), jnp.zeros(n), jnp.ones(n, bool),
        jnp.zeros(n, jnp.int32),
        jnp.full((n,), -1, jnp.int32),      # current medium index
    )

    def bounce(carry, xs):
        (L, throughput, ray, active, prev_pdf, prev_delta, depth_count,
         cur) = carry
        (u_ch, u_dist, u_nee_sel, u_nee_pos, u_scatter, u_lobe, u_rr,
         is_last, do_rr, wkey) = xs

        its = ray_intersect(scene.geom, ray)
        t_surf = jnp.where(its.valid, its.t, _FAR)

        ss, sa, g_lane, inside = stack_params(stack, cur)
        if has_het:
            md = stack_sample_distance_het(
                stack, cur, ss, sa, ray.o, ray.d, t_surf, _detach(u_ch),
                _detach(u_dist), jax.random.wrap_key_data(wkey))
        else:
            md = stack_sample_distance(ss, sa, t_surf, _detach(u_ch),
                                       _detach(u_dist))
        md_valid = md["valid"] & inside
        in_medium = active & md_valid
        at_surface = active & ~md_valid & its.valid
        escaped = active & ~md_valid & ~its.valid
        p_med = ray.o + ray.d * md["t"][:, None]

        thr_med = throughput * md["weight"]
        thr_surf = throughput * jnp.where(inside[:, None],
                                          md["surface_weight"], 1.0)

        env = eval_environment(scene.emitters, ray.d)
        env_pdf = pdf_environment(scene.emitters, ray.d)
        w_env = jnp.where(prev_delta, 1.0, mi_weight(prev_pdf, env_pdf))
        L = L + jnp.where(escaped[:, None], thr_surf * env * w_env[:, None], 0.0)

        depth_count = depth_count + (in_medium | at_surface).astype(jnp.int32)

        le = eval_emitter_hit(scene.emitters, its.emitter_id, -ray.d, its.geo_n)
        lum_pdf = pdf_direct_area(scene.emitters, its.prim_id, ray.o, its.p,
                                  its.geo_n, emitter_id=its.emitter_id)
        w_bsdf = jnp.where(prev_delta, 1.0, mi_weight(prev_pdf, lum_pdf))
        L = L + jnp.where(at_surface[:, None], thr_surf * le * w_bsdf[:, None], 0.0)

        cont_m = in_medium & ~is_last
        cont_s = at_surface & ~is_last

        p_scatter = jnp.where(in_medium[:, None], p_med, its.p)
        ds = sample_direct(
            scene.emitters, scene.geom, p_scatter,
            _detach(u_nee_sel), _detach(u_nee_pos),
        )
        ph_val = phase_eval(HG, g_lane, ray.d, ds.d)
        ph_pdf = phase_pdf(HG, g_lane, ray.d, ds.d) if mis else jnp.zeros(n)
        wo_local = its.to_local(ds.d)
        fcos = bsdf_eval(scene.materials, its.material_id, its.wi, wo_local)
        b_pdf = bsdf_pdf(scene.materials, its.material_id, its.wi, wo_local)

        eps = m.EPSILON * jnp.maximum(1.0, jnp.abs(p_scatter).max(-1))
        # degenerate emitter samples can carry NaN dist — sanitize before
        # the exp (same cotangent-poisoning mechanism as the pdfs above)
        base_ok = (cont_m | cont_s) & ds.valid & (ds.pdf > 0)
        dist_safe = jnp.where(base_ok, ds.dist, 0.0)
        if interior is not None:
            # boundary-aware shadow transmittance (reference
            # getTransmittance walk): crosses null boundaries, switches
            # media per segment, zero at opaque surfaces
            tr = boundary_transmittance(
                scene, p_scatter, ds.d, dist_safe * (1.0 - 1e-3), cur)
            occluded = jnp.max(tr, axis=-1) <= 1e-7
        else:
            shadow = Ray.make(p_scatter, ds.d, mint=eps,
                              maxt=dist_safe * (1.0 - 1e-3))
            occluded = ray_test(scene.geom, shadow)
            tr = stack_transmittance(ss, sa, dist_safe)
            tr = jnp.where(inside[:, None], tr, 1.0)

        nee_ok = (cont_m | cont_s) & ds.valid & (ds.pdf > 0) & ~occluded
        scatter_pdf = jnp.where(in_medium, ph_pdf, b_pdf)
        # sanitize BEFORE arithmetic: where() still evaluates the masked
        # branch, and garbage pdfs (1e12+ from degenerate scatter points)
        # overflow mi_weight's squares into inf/inf = NaN — which then
        # poisons parameter gradients via zero-cotangent products
        pdf_safe = jnp.where(nee_ok, ds.pdf, 1.0)
        spdf_safe = jnp.where(nee_ok, scatter_pdf, 1.0)
        w_nee = jnp.where(ds.delta, 1.0, mi_weight(pdf_safe, spdf_safe))
        f_scatter = jnp.where(in_medium[:, None], ph_val[:, None], fcos)
        thr_here = jnp.where(in_medium[:, None], thr_med, thr_surf)
        gate = nee_ok[:, None]
        contrib = (jnp.where(gate, thr_here, 0.0)
                   * jnp.where(gate, f_scatter, 0.0)
                   * jnp.where(gate, ds.value, 0.0)
                   * jnp.where(gate, tr, 0.0)
                   * jnp.where(nee_ok,
                               w_nee / jnp.maximum(pdf_safe, 1e-20),
                               0.0)[:, None])
        L = L + contrib

        wo_phase, phase_p = phase_sample(HG, g_lane, ray.d, _detach(u_scatter))
        bs = bsdf_sample(
            scene.materials, its.material_id, its.wi,
            _detach(u_scatter), _detach(u_lobe),
        )
        wo_world = jnp.where(in_medium[:, None], wo_phase,
                             its.to_world(bs["wo"]))
        next_pdf = jnp.where(in_medium, phase_p if mis else jnp.zeros(n),
                             bs["pdf"])
        next_delta = jnp.where(
            in_medium,
            jnp.zeros(n, bool) if mis else jnp.ones(n, bool), bs["delta"])
        scatter_ok = jnp.where(in_medium, True, bs["valid"])
        active = (cont_m | cont_s) & scatter_ok

        new_thr = jnp.where(in_medium[:, None], thr_med,
                            thr_surf * bs["weight"])

        # --- medium transition at transmissive surfaces -----------------
        if interior is not None:
            sid = jnp.clip(its.shape_id, 0, interior.shape[0] - 1)
            hit_interior = interior[sid]
            entering = jnp.sum(wo_world * its.geo_n, axis=-1) < 0
            crossed = at_surface & bs["transmission"] & active
            cur = jnp.where(
                crossed, jnp.where(entering, hit_interior, -1), cur
            )

        albedo = jnp.minimum(0.9, jnp.maximum(
            jnp.max(_detach(new_thr), axis=-1)
            / jnp.maximum(jnp.max(_detach(throughput), axis=-1), 1e-8), 0.05))
        kill = do_rr & (u_rr > albedo) & ~bs["transmission"]
        rr_scale = jnp.where(do_rr & ~bs["transmission"],
                             1.0 / jnp.maximum(albedo, 1e-3), 1.0)
        active = active & ~kill
        new_thr = new_thr * jnp.where(active, rr_scale, 1.0)[:, None]

        throughput = jnp.where(active[:, None], new_thr, throughput)
        origin = jnp.where(in_medium[:, None], p_med, its.p)
        new_ray = Ray.make(origin, wo_world, mint=eps)
        ray = replace(
            new_ray,
            o=jnp.where(active[:, None], new_ray.o, ray.o),
            d=jnp.where(active[:, None], new_ray.d, ray.d),
        )
        return (L, throughput, ray, active, _detach(next_pdf), next_delta,
                depth_count, cur), None

    body = jax.checkpoint(bounce) if cfg.remat else bounce
    xs = (u_ch, u_dist, u_nee_sel, u_nee_pos, u_scatter, u_lobe, u_rr,
          is_last, do_rr, jax.random.key_data(woodcock_keys)
          if has_het else woodcock_keys)
    if _debug_unroll:   # python loop: per-line NaN locations under grad
        carry = init
        for i in range(d_max):
            carry, _ = bounce(carry, jax.tree_util.tree_map(
                lambda a: a[i], xs))
    else:
        carry, _ = jax.lax.scan(body, init, xs)
    return carry[0], {"avg_path_length": jnp.mean(carry[6].astype(jnp.float32))}


def render_volpath_media(scene, cfg: PathConfig, seed: int = 0,
                         mis: bool = True):
    """Render a scene whose shapes carry interior media
    (SceneBuilder.add_medium + add_shape(interior_medium=...))."""
    from mitsuba_jax.render.sampler import sample_position

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
    uv = jnp.stack([(px + offset[:, 0]) / w, (py + offset[:, 1]) / h], axis=-1)
    ray = scene.camera.sample_ray(uv)
    L, aux = volpath_media_trace(scene, ray, sampler, cfg, mis=mis)
    img = L.reshape(h, w, spp, 3).mean(axis=2)
    return img, aux
