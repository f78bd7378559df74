import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_jax.core import math as m
from mitsuba_jax.core import fresnel as fr
from mitsuba_jax.core import spectrum as spec
from mitsuba_jax.core import transform as tf
from mitsuba_jax.core.pdf import DiscretePDF


def test_coordinate_system_orthonormal():
    key = jax.random.key(0)
    n = m.normalize(jax.random.normal(key, (1000, 3)))
    s, t = m.coordinate_system(n)
    np.testing.assert_allclose(m.dot(s, n), 0, atol=1e-5)
    np.testing.assert_allclose(m.dot(t, n), 0, atol=1e-5)
    np.testing.assert_allclose(m.dot(s, t), 0, atol=1e-5)
    np.testing.assert_allclose(m.length(s), 1, atol=1e-5)
    np.testing.assert_allclose(m.length(t), 1, atol=1e-5)
    # right-handed: s x t == n
    np.testing.assert_allclose(m.cross(s, t), n, atol=1e-5)


def test_frame_roundtrip():
    key = jax.random.key(1)
    n = m.normalize(jax.random.normal(key, (100, 3)))
    f = m.Frame.from_normal(n)
    v = m.normalize(jax.random.normal(jax.random.key(2), (100, 3)))
    np.testing.assert_allclose(f.to_world(f.to_local(v)), v, atol=1e-5)
    np.testing.assert_allclose(
        m.cos_theta(f.to_local(v)), m.dot(v, n), atol=1e-5
    )


def test_reflect_refract():
    n = jnp.array([0.0, 0.0, 1.0])
    wi = m.normalize(jnp.array([1.0, 0.0, 1.0]))
    r = m.reflect(wi, n)
    np.testing.assert_allclose(r, m.normalize(jnp.array([-1.0, 0.0, 1.0])), atol=1e-6)
    # Snell's law check for refraction
    wt, tir = m.refract(wi, n, 1.5)
    assert not bool(tir)
    sin_i = m.length(wi[:2] * jnp.array([1.0, 1.0]))
    sin_t = float(jnp.linalg.norm(wt[:2]))
    np.testing.assert_allclose(sin_t, float(sin_i) / 1.5, atol=1e-5)
    assert float(wt[2]) < 0  # transmitted to the other side


def test_fresnel_normal_incidence():
    # R0 = ((n1-n2)/(n1+n2))^2
    f = fr.fresnel(jnp.array(1.0), 1.0, 1.5)
    np.testing.assert_allclose(float(f), ((1 - 1.5) / (1 + 1.5)) ** 2, atol=1e-6)
    # grazing incidence -> 1
    f = fr.fresnel(jnp.array(1e-4), 1.0, 1.5)
    assert float(f) > 0.95
    # TIR from inside beyond critical angle
    f = fr.fresnel(jnp.array(-0.2), 1.0, 1.5)
    np.testing.assert_allclose(float(f), 1.0)


def test_fresnel_ext_consistency():
    cos_i = jnp.linspace(0.01, 1.0, 64)
    f1 = fr.fresnel(cos_i, 1.0, 1.5)
    f2, cos_t = fr.fresnel_dielectric_ext(cos_i, 1.5)
    np.testing.assert_allclose(f1, f2, atol=1e-6)
    assert np.all(np.asarray(cos_t) <= 0)


def test_fresnel_conductor_range():
    eta = jnp.array([0.2, 0.9, 1.4])
    k = jnp.array([3.9, 2.5, 2.1])
    f = fr.fresnel_conductor(jnp.linspace(0.01, 1, 32), eta, k)
    assert f.shape == (32, 3)
    assert np.all(np.asarray(f) >= 0) and np.all(np.asarray(f) <= 1.0)


def test_spectrum_xyz_roundtrip():
    key = jax.random.key(3)
    s = jax.random.uniform(key, (64, 3))
    np.testing.assert_allclose(spec.from_xyz(spec.to_xyz(s)), s, atol=1e-4)
    np.testing.assert_allclose(spec.luminance(s), spec.to_xyz(s)[..., 1], atol=1e-5)


def test_srgb_roundtrip():
    s = jnp.linspace(0, 1, 100)
    np.testing.assert_allclose(spec.from_srgb(spec.to_srgb(s)), s, atol=1e-5)


def test_discrete_pdf():
    w = jnp.array([1.0, 2.0, 0.0, 3.0])
    d = DiscretePDF.build(w)
    np.testing.assert_allclose(float(d.total), 6.0)
    u = jax.random.uniform(jax.random.key(4), (200_000,))
    idx, p = d.sample(u)
    counts = np.bincount(np.asarray(idx), minlength=4) / 200_000
    np.testing.assert_allclose(counts, np.asarray(w) / 6.0, atol=5e-3)
    # sample_reuse returns uniform u within bin
    idx2, p2, u2 = d.sample_reuse(u)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(idx2))
    assert 0.45 < float(jnp.mean(u2)) < 0.55


def test_transforms():
    p = jnp.array([1.0, 2.0, 3.0])
    t = tf.translate([1, 0, 0])
    np.testing.assert_allclose(tf.apply_point(t, p), jnp.array([2.0, 2.0, 3.0]))
    np.testing.assert_allclose(tf.apply_vector(t, p), p)
    r = tf.rotate([0, 0, 1], 90)
    np.testing.assert_allclose(
        tf.apply_point(r, jnp.array([1.0, 0, 0])), jnp.array([0.0, 1.0, 0.0]), atol=1e-6
    )
    lk = tf.look_at([0, 0, -5], [0, 0, 0], [0, 1, 0])
    # camera +z must map to world view direction
    np.testing.assert_allclose(
        tf.apply_vector(lk, jnp.array([0.0, 0, 1.0])), jnp.array([0.0, 0, 1.0]), atol=1e-6
    )
    np.testing.assert_allclose(tf.apply_point(lk, jnp.zeros(3)), jnp.array([0.0, 0, -5.0]))
    # normal transform under non-uniform scale stays perpendicular
    s = tf.scale([1.0, 2.0, 3.0])
    n = jnp.array([0.0, 1.0, 1.0]) / np.sqrt(2)
    v = jnp.array([0.0, 1.0, -1.0])  # perpendicular to n
    np.testing.assert_allclose(
        m.dot(tf.apply_normal(s, n), tf.apply_vector(s, v)), 0.0, atol=1e-5
    )
