"""Adjoint particle tracer — light tracing with camera connections.

Functional parity with reference `AdjointParticleTracer`
(src/integrators/path/ptracer.cpp:45 + ptracer_proc.cpp
CaptureParticleWorker): particles start on the luminaires, random-walk
through the scene, and every vertex is connected to the camera; the
contribution is splatted to the film at the projected pixel.

Wavefront form: N particles advance in lockstep (scan over depth); film
accumulation is a single scatter-add per bounce (`.at[].add`), the
Data-parallel replacement for the reference's per-worker ImageBlock splats.
Supports the perspective pinhole camera (thin-lens connection needs an
aperture sample; reference ptracer also specializes the pinhole case).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from mitsuba_jax.bsdfs import bsdf_eval, bsdf_sample
from mitsuba_jax.core import math as m
from mitsuba_jax.core import transform as tf
from mitsuba_jax.core import warp
from mitsuba_jax.core.types import replace
from mitsuba_jax.integrators.path import PathConfig, _detach
from mitsuba_jax.render.intersect import ray_intersect, ray_test
from mitsuba_jax.render.records import Ray
from mitsuba_jax.render.sampler import Sampler


def _sample_emission(scene, u_sel, u_pos, u_dir):
    """Sample photon origins/directions ∝ record power over ALL finite
    emitters: triangle area lights, analytic sphere lights, point and spot
    lights (reference Luminaire::sampleEmission, luminaire.h).

    Returns (p, n, d, beta, valid) with beta = Le·cosθ/(p_pos·p_dir)
    (surface lights) or I(d)/p_dir (delta positions), already divided by
    the record pmf, so E[Σ beta·(...)] estimates emitted power transport.
    Env/directional emission (needs a scene bounding-disk sampler) is not
    yet supported — such records return valid=False."""
    from mitsuba_jax.emitters.table import POINT, SPHERE, SPOT

    em = scene.emitters
    geom = scene.geom
    rec = jnp.clip(
        jnp.searchsorted(em.rec_cdf, u_sel, side="right"), 0, em.rec_pmf.shape[0] - 1
    ).astype(jnp.int32)
    pmf = em.rec_pmf[rec]
    eid = em.rec_emitter[rec]
    le = em.radiance[eid]
    is_tri = rec < em.n_tri_records

    # --- surface emitters (triangle | analytic sphere): uniform-area
    # position + cosine hemisphere direction about the surface normal
    # (rec_prim: tri records are compacted to emissive triangles)
    ti = em.rec_prim[jnp.clip(rec, 0, em.rec_prim.shape[0] - 1)]
    bary = warp.square_to_uniform_triangle(u_pos)
    p_tri = geom.v0[ti] + geom.e1[ti] * bary[:, :1] + geom.e2[ti] * bary[:, 1:2]
    n_tri = m.normalize(jnp.cross(geom.e1[ti], geom.e2[ti]))
    area_tri = 0.5 * m.length(jnp.cross(geom.e1[ti], geom.e2[ti]))

    kind = em.kind[eid]
    is_sph = (~is_tri) & (kind == SPHERE)
    n_sph = warp.square_to_uniform_sphere(u_pos)
    sph_r = em.radius[eid] if em.radius is not None else jnp.zeros_like(pmf)
    p_sph = em.position[eid] + sph_r[:, None] * n_sph
    area_sph = 4.0 * jnp.pi * sph_r * sph_r

    is_surf = is_tri | is_sph
    p = jnp.where(is_tri[:, None], p_tri, p_sph)
    n = jnp.where(is_tri[:, None], n_tri, n_sph)
    area = jnp.where(is_tri, area_tri, area_sph)
    d_local = warp.square_to_cosine_hemisphere(u_dir)
    frame = m.Frame.from_normal(n)
    d = frame.to_world(d_local)
    pdf_pos = pmf / jnp.maximum(area, 1e-12)
    pdf_dir = warp.square_to_cosine_hemisphere_pdf(d_local)
    cos_t = jnp.maximum(m.cos_theta(d_local), 0.0)
    beta = le * (cos_t / jnp.maximum(pdf_pos * pdf_dir, 1e-20))[:, None]
    valid = is_surf & (pmf > 0)

    # --- point lights: uniform-sphere direction, Φ = 4π·I
    is_pt = (~is_tri) & (kind == POINT)
    if POINT in em.kinds_present:
        d_pt = warp.square_to_uniform_sphere(u_dir)
        beta_pt = le * (4.0 * jnp.pi) / jnp.maximum(pmf, 1e-20)[:, None]
        p = jnp.where(is_pt[:, None], em.position[eid], p)
        n = jnp.where(is_pt[:, None], d_pt, n)
        d = jnp.where(is_pt[:, None], d_pt, d)
        beta = jnp.where(is_pt[:, None], beta_pt, beta)
        valid = valid | (is_pt & (pmf > 0))

    # --- spot lights: uniform cone within the cutoff, linear falloff
    # (same falloff convention as sample_direct, table.py SPOT branch)
    is_spot = (~is_tri) & (kind == SPOT)
    if SPOT in em.kinds_present:
        cc = em.cutoff_cos[eid]
        fc = em.falloff_cos[eid]
        d_cone = warp.square_to_uniform_cone(cc, u_dir)
        ax_frame = m.Frame.from_normal(em.direction[eid])
        d_sp = ax_frame.to_world(d_cone)
        pdf_cone = warp.square_to_uniform_cone_pdf(cc)
        fall = jnp.clip((m.cos_theta(d_cone) - cc)
                        / jnp.maximum(fc - cc, 1e-6), 0.0, 1.0)
        beta_sp = le * (fall / jnp.maximum(pmf * pdf_cone, 1e-20))[:, None]
        p = jnp.where(is_spot[:, None], em.position[eid], p)
        n = jnp.where(is_spot[:, None], d_sp, n)
        d = jnp.where(is_spot[:, None], d_sp, d)
        beta = jnp.where(is_spot[:, None], beta_sp, beta)
        valid = valid | (is_spot & (pmf > 0))

    return p, n, d, jnp.where(valid[:, None], beta, 0.0), valid


def _connect_camera(scene, p, accum_shape):
    """Project world points through the pinhole camera.

    Returns (pixel_index, importance_weight, direction to camera, distance,
    on_film mask). importance includes the film-measure Jacobian
    W·H/(4·tanx·tany·cos³θ) and the 1/d² geometry factor's direction part
    handled by the caller."""
    cam = scene.camera
    w2c = jnp.linalg.inv(cam.to_world)
    pc = tf.apply_point(w2c, p)                 # camera space, +z forward
    z = pc[:, 2]
    behind = z <= 1e-5
    zs = jnp.where(behind, 1.0, z)
    ndc_x = pc[:, 0] / zs
    ndc_y = pc[:, 1] / zs
    u = (ndc_x / cam.tan_half_fov_x + 1.0) * 0.5
    v = (1.0 - ndc_y / cam.tan_half_fov_y) * 0.5
    on_film = (~behind) & (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    px = jnp.clip((u * scene.width).astype(jnp.int32), 0, scene.width - 1)
    py = jnp.clip((v * scene.height).astype(jnp.int32), 0, scene.height - 1)
    pix = py * scene.width + px
    cam_origin = cam.to_world[:3, 3]
    to_cam = cam_origin[None, :] - p
    dist = m.length(to_cam)
    d_cam = to_cam / jnp.maximum(dist, 1e-12)[:, None]
    # cos at the camera between the view axis and the connection
    view_axis = tf.apply_vector(cam.to_world, jnp.array([0.0, 0.0, 1.0]))
    cos_cam = jnp.maximum(m.dot(-d_cam, view_axis[None, :]), 1e-6)
    importance = (scene.width * scene.height) / (
        4.0 * cam.tan_half_fov_x * cam.tan_half_fov_y * cos_cam ** 3
    )
    return pix, importance, d_cam, dist, on_film


def ptracer_render(scene, cfg: PathConfig, n_particles: int, seed: int = 0):
    """Render by light tracing. Returns ((H,W,3) image, aux)."""
    n = n_particles
    sampler = Sampler(seed, jnp.arange(n), jnp.zeros(n, jnp.int32))
    d_max = cfg.max_depth

    u_sel = sampler.next_1d()
    u_pos = sampler.next_2d()
    u_dir = sampler.next_2d()
    u_scatter = sampler.next_stacked_2d(d_max)
    u_lobe = sampler.next_stacked_1d(d_max)

    p0, n0, d0, beta, valid = _sample_emission(
        scene, _detach(u_sel), _detach(u_pos), _detach(u_dir)
    )
    film = jnp.zeros((scene.height * scene.width, 3))

    eps0 = m.EPSILON * jnp.maximum(1.0, jnp.abs(p0).max(-1))
    ray = Ray.make(p0, d0, mint=eps0)

    def bounce(carry, xs):
        film, ray, beta, active = carry
        u_scatter, u_lobe = xs
        its = ray_intersect(scene.geom, ray)
        active = active & its.valid

        # connect the surface vertex to the camera
        pix, importance, d_cam, dist, on_film = _connect_camera(
            scene, its.p, film.shape
        )
        wo_local = its.to_local(d_cam)
        # importance transport: evaluate the *adjoint* BSDF; for the
        # reciprocal models here fCos with swapped args works
        fcos = bsdf_eval(scene.materials, its.material_id, its.wi, wo_local)
        eps = m.EPSILON * jnp.maximum(1.0, jnp.abs(its.p).max(-1))
        shadow = Ray.make(its.p, d_cam, mint=eps, maxt=dist * (1.0 - 1e-4))
        occluded = ray_test(scene.geom, shadow)
        ok = active & on_film & ~occluded
        contrib = beta * fcos * (importance / jnp.maximum(dist, 1e-6) ** 2)[:, None]
        film = film.at[pix].add(jnp.where(ok[:, None], contrib, 0.0))

        # continue the walk
        bs = bsdf_sample(
            scene.materials, its.material_id, its.wi,
            _detach(u_scatter), _detach(u_lobe),
        )
        wo_world = its.to_world(bs["wo"])
        active = active & bs["valid"]
        beta = beta * jnp.where(active[:, None], bs["weight"], 1.0)
        new_ray = Ray.make(its.p, wo_world, mint=eps)
        ray = replace(
            new_ray,
            o=jnp.where(active[:, None], new_ray.o, ray.o),
            d=jnp.where(active[:, None], new_ray.d, ray.d),
        )
        return (film, ray, beta, active), None

    body = jax.checkpoint(bounce) if cfg.remat else bounce
    (film, ray, beta, active), _ = jax.lax.scan(
        body, (film, ray, beta, valid), (u_scatter, u_lobe)
    )

    # directly visible emitters are not captured by surface connections;
    # add the emitter-surface camera connection from the photon ORIGINS
    pix, importance, d_cam, dist, on_film = _connect_camera(scene, p0, film.shape)
    cos_e = jnp.maximum(m.dot(n0, d_cam), 0.0)
    eps = m.EPSILON * jnp.maximum(1.0, jnp.abs(p0).max(-1))
    shadow = Ray.make(p0, d_cam, mint=eps, maxt=dist * (1.0 - 1e-4))
    occluded = ray_test(scene.geom, shadow)
    em = scene.emitters
    rec = jnp.clip(
        jnp.searchsorted(em.rec_cdf, _detach(u_sel), side="right"),
        0, em.rec_pmf.shape[0] - 1,
    ).astype(jnp.int32)
    ti = em.rec_prim[jnp.clip(rec, 0, em.rec_prim.shape[0] - 1)]
    area = 0.5 * m.length(jnp.cross(scene.geom.e1[ti], scene.geom.e2[ti]))
    pmf = em.rec_pmf[rec]
    le = em.radiance[em.rec_emitter[rec]]
    w_emit = le * (area / jnp.maximum(pmf, 1e-20))[:, None]  # 1/pdf_pos
    contrib0 = w_emit * (cos_e * importance / jnp.maximum(dist, 1e-6) ** 2)[:, None]
    ok0 = valid & on_film & ~occluded
    film = film.at[pix].add(jnp.where(ok0[:, None], contrib0, 0.0))

    img = film.reshape(scene.height, scene.width, 3) / n
    return img, {"n_particles": n}
