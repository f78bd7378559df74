"""Point / spot / directional / collimated emitters: analytic irradiance
checks through the full integrator (reference src/luminaires parity)."""
import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core import math as m
from mitsuba_jax.core import transform as tf
from mitsuba_jax.integrators import PathConfig, path_trace
from mitsuba_jax.render import mesh as mesh_mod
from mitsuba_jax.render.camera import make_perspective
from mitsuba_jax.render.records import Ray
from mitsuba_jax.render.sampler import Sampler
from mitsuba_jax.render.scene import SceneBuilder


def floor_scene(add_emitter, albedo=0.8):
    b = SceneBuilder()
    mat = b.materials.lambertian((albedo,) * 3)
    quad = mesh_mod.make_quad([-20, 0, -20], [-20, 0, 20], [20, 0, 20], [20, 0, -20])
    b.add_shape(quad, mat)
    add_emitter(b)
    cam = make_perspective(tf.look_at([0, 5, -5], [0, 0, 0], [0, 1, 0]), 40, 1.0)
    b.set_camera(cam, 8, 8)
    return b.build(backend="brute")


def down_rays(n=256, height=3.0, spread=0.2):
    key = jax.random.key(0)
    o = jnp.stack([
        (jax.random.uniform(key, (n,)) - 0.5) * spread,
        jnp.full((n,), height),
        (jax.random.uniform(jax.random.key(1), (n,)) - 0.5) * spread,
    ], -1)
    d = jnp.broadcast_to(jnp.array([0.0, -1.0, 0.0]), (n, 3))
    return Ray.make(o, d)


def radiance_at_origin(scene, depth=2, seed=5, n=256):
    ray = down_rays(n)
    sampler = Sampler(seed, jnp.arange(n), jnp.zeros(n, jnp.int32))
    L, _ = path_trace(scene, ray, sampler,
                      PathConfig(max_depth=depth, spp=1, remat=False))
    return float(L[:, 0].mean())


def test_point_light_inverse_square():
    """L = albedo/pi * I * cos / d^2 for a point source."""
    h = 4.0
    scene = floor_scene(lambda b: b.emitters.point((0, h, 0), (10.0,) * 3))
    got = radiance_at_origin(scene)
    expect = 0.8 / np.pi * 10.0 * 1.0 / (h * h)
    np.testing.assert_allclose(got, expect, rtol=0.03)


def test_directional_light():
    """L = albedo/pi * E * cos(theta)."""
    d = m.normalize(jnp.asarray([0.0, -1.0, 0.3]))
    scene = floor_scene(lambda b: b.emitters.directional(tuple(np.asarray(d)), (2.0,) * 3))
    got = radiance_at_origin(scene)
    cos_t = float(-d[1]) / 1.0
    expect = 0.8 / np.pi * 2.0 * cos_t
    np.testing.assert_allclose(got, expect, rtol=0.03)


def test_spot_light_cone():
    """Inside the cone: point-light falloff; a floor point outside the
    cutoff receives nothing."""
    h = 4.0
    scene = floor_scene(
        lambda b: b.emitters.spot((0, h, 0), (0, -1, 0), (10.0,) * 3,
                                  cutoff_deg=25.0, falloff_deg=24.0)
    )
    inside = radiance_at_origin(scene)
    expect = 0.8 / np.pi * 10.0 / (h * h)
    np.testing.assert_allclose(inside, expect, rtol=0.05)
    # a ray hitting the floor far outside the cone
    n = 64
    o = jnp.broadcast_to(jnp.asarray([8.0, 3.0, 0.0]), (n, 3))
    d = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0]), (n, 3))
    sampler = Sampler(3, jnp.arange(n), jnp.zeros(n, jnp.int32))
    L, _ = path_trace(scene, Ray.make(o, d), sampler,
                      PathConfig(max_depth=2, spp=1, remat=False))
    assert float(L.mean()) < 1e-6


def test_collimated_beam():
    """Inside the beam footprint: L = albedo/pi * E; outside: 0."""
    scene = floor_scene(
        lambda b: b.emitters.collimated((0, 5, 0), (0, -1, 0), (4.0,) * 3,
                                        radius=1.0)
    )
    got = radiance_at_origin(scene)
    expect = 0.8 / np.pi * 4.0
    np.testing.assert_allclose(got, expect, rtol=0.03)
