"""Environment emitters: sampling consistency, furnace equivalence, sky."""
import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core import math as m
from mitsuba_jax.core.chi2 import chi2_test
from mitsuba_jax.emitters.envmap import (
    build_env_cdfs, env_eval, env_pdf, env_sample, latlong_dir_to_uv,
    latlong_uv_to_dir, preetham_sky,
)
from mitsuba_jax.integrators import PathConfig, path_trace
from mitsuba_jax.render import mesh as mesh_mod
from mitsuba_jax.render.records import Ray
from mitsuba_jax.render.sampler import Sampler
from mitsuba_jax.render.scene import SceneBuilder
from mitsuba_jax.core import transform as tf
from mitsuba_jax.render.camera import make_perspective


def random_env(seed, h=16, w=32):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.1, 2.0, (h, w, 3)).astype(np.float32)
    img[3:6, 10:14] *= 20.0  # a bright blob to stress importance sampling
    return img


def test_latlong_roundtrip():
    key = jax.random.key(0)
    d = m.normalize(jax.random.normal(key, (1000, 3)))
    d2 = latlong_uv_to_dir(latlong_dir_to_uv(d))
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d), atol=1e-5)


def test_env_sampling_chi2():
    img = random_env(1)
    prob, alias, pdf_img = build_env_cdfs(img)
    rc, cc, pi = jnp.asarray(prob), jnp.asarray(alias), jnp.asarray(pdf_img)

    def sample_fn(key, n):
        u2 = jax.random.uniform(key, (n, 2))
        d, _ = env_sample(rc, cc, pi, u2)
        return d

    def pdf_fn(d):
        sh = d.shape[:-1]
        return env_pdf(pi, d.reshape(-1, 3)).reshape(sh)

    res = chi2_test(jax.random.key(2), sample_fn, pdf_fn, n_samples=400_000,
                    theta_res=16, phi_res=32)
    assert res.passed, f"chi2={res.chi2:.1f} p={res.p_value:.2e}"


def test_env_pdf_integrates_to_one():
    from mitsuba_jax.core.quad import sphere_bin_integrate

    img = random_env(3)
    _, _, pdf_img = build_env_cdfs(img)
    pi = jnp.asarray(pdf_img)
    total = float(sphere_bin_integrate(
        lambda d: env_pdf(pi, d.reshape(-1, 3)).reshape(d.shape[:-1]), 32, 64, sub=4
    ).sum())
    assert abs(total - 1.0) < 2e-2, total


def test_envmap_furnace():
    """Uniform (constant-value) envmap over a lambertian plane -> L = albedo."""
    b = SceneBuilder()
    mat = b.materials.lambertian((0.6, 0.6, 0.6))
    quad = mesh_mod.make_quad([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1])
    b.add_shape(quad, mat)
    b.emitters.envmap(np.ones((8, 16, 3), np.float32))
    cam = make_perspective(tf.look_at([0, 3, 0.01], [0, 0, 0], [0, 1, 0]), 40, 1.0)
    b.set_camera(cam, 8, 8)
    scene = b.build(backend="brute")
    n = 1024
    o = jnp.broadcast_to(jnp.array([0.0, 2.0, 0.0]), (n, 3))
    d = jnp.broadcast_to(jnp.array([0.0, -1.0, 0.0]), (n, 3))
    ray = Ray.make(o, d)
    sampler = Sampler(4, jnp.arange(n), jnp.zeros(n, jnp.int32))
    L, _ = path_trace(scene, ray, sampler,
                      PathConfig(max_depth=3, spp=1, remat=False))
    assert abs(float(L[:, 0].mean()) - 0.6) < 0.02, float(L[:, 0].mean())


def test_sky_properties():
    sun = m.normalize(jnp.asarray([0.3, 0.8, 0.2]))
    key = jax.random.key(5)
    d = m.normalize(jax.random.normal(key, (5000, 3)))
    d = d * jnp.sign(d[:, 1:2])  # upper hemisphere (y-up)
    rad = preetham_sky(d, sun, turbidity=3.0)
    lum = np.asarray(rad).mean(-1)
    assert np.isfinite(lum).all() and (lum > 0).all()
    # brighter toward the sun
    cosg = np.asarray(m.dot(d, sun))
    near = lum[cosg > 0.95].mean()
    far = lum[cosg < 0.0].mean()
    assert near > 2.0 * far, (near, far)
