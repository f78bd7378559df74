"""Virtual point lights: generation + instant-radiosity renderer.

Capability parity with the reference's VPL machinery:
  * `generateVPLs` (render/vpl.h:59, vpl.cpp:61) — random-walk particles
    deposit luminaire VPLs + surface VPLs;
  * `VPLIntegrator` (vpl/vpl.cpp:35) — direct lighting from every VPL
    with a clamped geometry term.

Wavefront re-design: the reference iterates VPLs per pixel with recursive ray
casts.  Here ALL camera hits shade against one VPL per `lax.scan` step —
each step is a full-wavefront shadow-ray batch + fused shading, so the
work is (pixels × VPLs) perfectly vectorized lanes with no per-pixel
control flow.  VPLs live in small (V, ·) SoA tables.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from mitsuba_jax.bsdfs import bsdf_eval, bsdf_sample
from mitsuba_jax.core import math as m
from mitsuba_jax.core.types import pytree_dataclass, replace
from mitsuba_jax.integrators.path import PathConfig, _detach
from mitsuba_jax.integrators.ptracer import _sample_emission
from mitsuba_jax.render.intersect import ray_intersect, ray_test
from mitsuba_jax.render.records import Ray
from mitsuba_jax.render.sampler import Sampler, sample_position


@pytree_dataclass
class VPLSet:
    """SoA table of virtual point lights (luminaire + surface deposits)."""
    p: jnp.ndarray          # (V, 3) position
    n: jnp.ndarray          # (V, 3) surface normal
    d_in: jnp.ndarray       # (V, 3) world dir the particle ARRIVED along
    material_id: jnp.ndarray  # (V,) int32; -1 for luminaire VPLs
    flux: jnp.ndarray       # (V, 3) path throughput (radiance-like units)
    is_lum: jnp.ndarray     # (V,) bool
    valid: jnp.ndarray      # (V,) bool
    n_paths: jnp.ndarray    # () normalization


def generate_vpls(scene, n_paths: int, max_depth: int = 3,
                  seed: int = 0) -> VPLSet:
    """Random-walk VPL generation (reference vpl.cpp:61).

    Luminaire VPLs carry Le/pdf_pos; each walk vertex deposits a surface
    VPL carrying the arriving throughput; the actual BSDF is re-evaluated
    at shading time (the reference stores its BSDF pointer the same way).
    """
    sampler = Sampler(seed ^ 0x51AB7E, jnp.arange(n_paths),
                      jnp.zeros(n_paths, jnp.int32))
    u_sel = sampler.next_1d()
    u_pos = sampler.next_2d()
    u_dir = sampler.next_2d()
    u_scatter = sampler.next_stacked_2d(max_depth)
    u_lobe = sampler.next_stacked_1d(max_depth)

    p0, n0, d0, beta, valid0 = _sample_emission(
        scene, _detach(u_sel), _detach(u_pos), _detach(u_dir)
    )
    # luminaire VPL flux: Le / pdf_pos = beta * pdf_dir / cos (undo the
    # directional part folded into beta by _sample_emission)
    cos0 = jnp.maximum(jnp.sum(n0 * d0, axis=-1), 1e-6)
    pdf_dir0 = cos0 * m.INV_PI
    lum_flux = beta * (pdf_dir0 / cos0)[:, None]

    eps0 = m.EPSILON * jnp.maximum(1.0, jnp.abs(p0).max(-1))
    ray = Ray.make(p0, d0, mint=eps0)

    @jax.jit
    def walk(scene, ray, beta, active, u_scatter, u_lobe):
        def bounce(carry, xs):
            ray, beta, active = carry
            u2, u1 = xs
            its = ray_intersect(scene.geom, ray)
            active = active & its.valid
            deposit = (its.p, its.sh_n, ray.d, its.material_id, beta, active)
            bs = bsdf_sample(
                scene.materials, its.material_id, its.wi,
                _detach(u2), _detach(u1),
            )
            wo_world = its.to_world(bs["wo"])
            nxt = active & bs["valid"]
            beta = beta * jnp.where(nxt[:, None], bs["weight"], 1.0)
            eps = m.EPSILON * jnp.maximum(1.0, jnp.abs(its.p).max(-1))
            new_ray = Ray.make(its.p, wo_world, mint=eps)
            ray = replace(
                new_ray,
                o=jnp.where(nxt[:, None], new_ray.o, ray.o),
                d=jnp.where(nxt[:, None], new_ray.d, ray.d),
            )
            return (ray, beta, nxt), deposit

        _, deps = jax.lax.scan(bounce, (ray, beta, active), (u_scatter, u_lobe))
        return deps

    sp, sn, sdin, smat, sbeta, sact = walk(
        scene, ray, beta, valid0, u_scatter, u_lobe
    )
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    neg1 = jnp.full((n_paths,), -1, jnp.int32)
    return VPLSet(
        p=jnp.concatenate([p0, flat(sp)]),
        n=jnp.concatenate([n0, flat(sn)]),
        d_in=jnp.concatenate([-d0, flat(sdin)]),
        material_id=jnp.concatenate([neg1, flat(smat).astype(jnp.int32)]),
        flux=jnp.concatenate([lum_flux, flat(sbeta)]),
        is_lum=jnp.concatenate(
            [jnp.ones(n_paths, bool), jnp.zeros(flat(sact).shape[0], bool)]
        ),
        valid=jnp.concatenate([valid0, flat(sact)]),
        n_paths=jnp.asarray(float(n_paths)),
    )


def _shade_from_vpls(scene, its, vpls: VPLSet, clamp_dist: float):
    """Σ over VPLs of f_x · G · f_vpl · flux · V — one scan step per VPL,
    full-wavefront shadow batch each (vpl.cpp VPLIntegrator loop)."""

    def one_vpl(acc, v):
        vp, vn, vdin, vmat, vflux, vlum, vvalid = v
        to_v = vp[None, :] - its.p                          # (N, 3)
        d2 = jnp.sum(to_v * to_v, axis=-1)
        dist = jnp.sqrt(jnp.maximum(d2, 1e-20))
        wd = to_v / dist[:, None]
        cos_x = jnp.sum(its.sh_n * wd, axis=-1)
        cos_v = jnp.sum(vn[None, :] * (-wd), axis=-1)
        # clamped inverse-square bounds the d->0 singularity (the
        # reference clamps relative to the scene size the same way);
        # both cosines live in the fCos evaluations below
        g = 1.0 / jnp.maximum(d2, clamp_dist * clamp_dist)
        # fCos at the shading point (cos_x folded in by bsdf_eval)
        f_x = bsdf_eval(scene.materials, its.material_id, its.wi,
                        its.to_local(wd))
        # VPL-side response: emitter cosine for luminaire VPLs, fCos
        # re-eval for surface VPLs (frame about the stored normal)
        vframe = m.Frame.from_normal(vn)
        wi_v = vframe.to_local(vdin[None, :].repeat(its.p.shape[0], 0))
        wo_v = vframe.to_local(-wd)
        f_v = bsdf_eval(scene.materials,
                        jnp.maximum(vmat, 0)[None].repeat(its.p.shape[0], 0),
                        wi_v, wo_v)
        resp = jnp.where(vlum, jnp.maximum(cos_v, 0.0)[:, None], f_v)
        eps = m.EPSILON * jnp.maximum(1.0, jnp.abs(its.p).max(-1))
        shadow = Ray.make(its.p, wd, mint=eps, maxt=dist * (1.0 - 1e-3))
        lit = ~ray_test(scene.geom, shadow)
        ok = its.valid & lit & vvalid & (cos_x > 0) & (cos_v > 0)
        contrib = f_x * resp * (g[:, None] * vflux[None, :])
        return acc + jnp.where(ok[:, None], contrib, 0.0), None

    acc0 = jnp.zeros((its.p.shape[0], 3))
    vs = (vpls.p, vpls.n, vpls.d_in, vpls.material_id, vpls.flux,
          vpls.is_lum, vpls.valid)
    total, _ = jax.lax.scan(one_vpl, acc0, vs)
    return total / vpls.n_paths


def render_vpl(scene, cfg: PathConfig, n_paths: int = 64,
               vpl_depth: int = 3, clamp_dist: float = 0.05,
               seed: int = 0):
    """Instant-radiosity render (reference vpl/vpl.cpp:35): direct +
    VPL-indirect, pixel-sampled like integrators/path.render."""
    from mitsuba_jax.emitters import eval_emitter_hit
    from mitsuba_jax.render.film import develop
    from mitsuba_jax.render.rfilter import make_rfilter

    vpls = generate_vpls(scene, n_paths, max_depth=vpl_depth, seed=seed + 7)

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

    @jax.jit
    def shade(scene, ray, vpls):
        its = ray_intersect(scene.geom, ray)
        le = eval_emitter_hit(scene.emitters, its.emitter_id, -ray.d, its.geo_n)
        ind = _shade_from_vpls(scene, its, vpls, clamp_dist)
        return le + jnp.where(its.valid[:, None], ind, 0.0)

    L = shade(scene, ray, vpls)
    img = develop(L, offset, spp, h, w, make_rfilter(cfg.rfilter))
    return img, vpls
