"""End-to-end render tests: analytic ground truths + statistical gates.

Mirrors the reference's statistical render testing (testcase.cpp:168 t-test
machinery) with analytically solvable scenes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_jax.core import math as m
from mitsuba_jax.core import transform as tf
from mitsuba_jax.integrators import PathConfig, path_trace, render
from mitsuba_jax.render import mesh as mesh_mod
from mitsuba_jax.render.camera import make_perspective
from mitsuba_jax.render.records import Ray
from mitsuba_jax.render.sampler import Sampler
from mitsuba_jax.render.scene import SceneBuilder, cornell_box


def furnace_scene(albedo=0.8, radiance=1.0, backend="brute", include_floor=True):
    """Closed emitting sphere with a lambertian floor in the middle.

    With constant env-like emission from a surrounding sphere of radiance Le,
    a lambertian surface sees total radiosity Le * sum_k rho^k.
    """
    b = SceneBuilder()
    mat = b.materials.lambertian((albedo, albedo, albedo))
    light_mat = b.materials.lambertian((0.0, 0.0, 0.0))
    sph = mesh_mod.make_sphere_mesh([0, 0, 0], 10.0, 48, 96)
    # flip faces inward so normals point toward the center
    sph.faces = sph.faces[:, ::-1].copy()
    sph.normals = -sph.normals
    b.add_area_emitter_shape(sph, light_mat, (radiance,) * 3)
    if include_floor:
        # winding: CCW seen from +y so the normal faces up toward the camera
        quad = mesh_mod.make_quad([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1])
        b.add_shape(quad, mat)
    cam = make_perspective(
        tf.look_at([0, 3, 0.01], [0, 0, 0], [0, 1, 0]), 40.0, 1.0
    )
    b.set_camera(cam, 16, 16)
    return b.build(backend=backend)


def test_emitter_direct_view():
    """Camera staring at an emissive quad sees exactly its radiance."""
    b = SceneBuilder()
    lm = b.materials.lambertian((0.0, 0.0, 0.0))
    quad = mesh_mod.make_quad([-5, -5, 5], [-5, 5, 5], [5, 5, 5], [5, -5, 5])
    # normal check: this quad faces -z (toward camera at origin looking +z)?
    b.add_area_emitter_shape(quad, lm, (2.0, 3.0, 4.0))
    cam = make_perspective(tf.look_at([0, 0, 0], [0, 0, 1], [0, 1, 0]), 30.0, 1.0)
    b.set_camera(cam, 8, 8)
    scene = b.build(backend="brute")
    img, aux = render(scene, PathConfig(max_depth=2, spp=4, remat=False), seed=1)
    img = np.asarray(img)
    np.testing.assert_allclose(img, np.broadcast_to([2.0, 3.0, 4.0], img.shape), atol=1e-4)


def test_furnace_single_bounce():
    """Depth-2 path: L = Le*(1) at emitter + direct lighting = Le*albedo on
    the floor (hemispherical constant illumination)."""
    scene = furnace_scene(albedo=0.7, radiance=1.0)
    n = 512
    key = jax.random.key(0)
    # rays straight down onto the quad from random offsets
    o = jnp.stack(
        [jax.random.uniform(key, (n,)) - 0.5, jnp.full((n,), 2.0),
         jax.random.uniform(jax.random.key(1), (n,)) - 0.5], -1
    )
    d = jnp.broadcast_to(jnp.array([0.0, -1.0, 0.0]), (n, 3))
    ray = Ray.make(o, d)
    sampler = Sampler(7, jnp.arange(n), jnp.zeros(n, jnp.int32))
    L, _ = path_trace(scene, ray, sampler, PathConfig(max_depth=2, spp=1, remat=False))
    mean = float(jnp.mean(L[:, 0]))
    # direct illumination of lambertian under uniform hemispherical Le=1:
    # Lo = albedo * Le
    assert abs(mean - 0.7) < 0.02, mean


def test_furnace_depth_invariance():
    """The floor quad's bounces beyond the first all terminate on the black
    emissive sphere, so any max_depth >= 2 must give exactly L = rho."""
    rho = 0.5
    scene = furnace_scene(albedo=rho, radiance=1.0)
    n = 256
    o = jnp.stack([jnp.zeros(n), jnp.full((n,), 2.0), jnp.zeros(n)], -1)
    d = jnp.broadcast_to(jnp.array([0.0, -1.0, 0.0]), (n, 3))
    ray = Ray.make(o, d)
    sampler = Sampler(3, jnp.arange(n), jnp.zeros(n, jnp.int32))
    L2, _ = path_trace(scene, ray, sampler, PathConfig(max_depth=2, spp=1, remat=False))
    sampler = Sampler(3, jnp.arange(n), jnp.zeros(n, jnp.int32))
    L5, _ = path_trace(scene, ray, sampler, PathConfig(max_depth=5, spp=1, remat=False))
    assert abs(float(L2[:, 0].mean()) - rho) < 0.02
    assert abs(float(L5[:, 0].mean()) - rho) < 0.02


def test_cornell_smoke():
    """Cornell box renders: finite, non-black, light region brightest."""
    scene = cornell_box(32, 32)
    img, aux = render(scene, PathConfig(max_depth=3, spp=8, remat=False), seed=0)
    img = np.asarray(img)
    assert np.isfinite(img).all()
    assert img.mean() > 0.01, "image is black"
    # the light (top middle) must be the brightest area
    top = img[1:8, 10:22].mean()
    assert top > img.mean()
    assert float(aux["avg_path_length"]) > 1.0


def test_deterministic_rendering():
    scene = cornell_box(16, 16)
    img1, _ = render(scene, PathConfig(max_depth=3, spp=4, remat=False), seed=5)
    img2, _ = render(scene, PathConfig(max_depth=3, spp=4, remat=False), seed=5)
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))
    img3, _ = render(scene, PathConfig(max_depth=3, spp=4, remat=False), seed=6)
    assert np.abs(np.asarray(img1) - np.asarray(img3)).max() > 0
