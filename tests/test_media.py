"""Volumetrics: phase-function χ², Beer–Lambert attenuation, the volumetric
furnace (energy conservation), and Woodcock-vs-closed-form agreement."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_jax.core import math as m
from mitsuba_jax.core.chi2 import chi2_test
from mitsuba_jax.integrators import PathConfig
from mitsuba_jax.integrators.volpath import render_volpath, volpath_trace
from mitsuba_jax.media import (
    HG,
    ISOTROPIC,
    MICROFLAKE,
    make_heterogeneous,
    make_homogeneous,
    medium_transmittance,
    no_medium,
    phase_eval,
    phase_sample,
    sample_distance,
)
from mitsuba_jax.render.records import Ray
from mitsuba_jax.render.sampler import Sampler
from tests.test_render_e2e import furnace_scene


@pytest.mark.parametrize("kind,g", [(ISOTROPIC, 0.0), (HG, 0.6), (HG, -0.4),
                                    (MICROFLAKE, 0.0)])
def test_phase_chi2(kind, g):
    wi_dir = m.normalize(jnp.asarray([0.3, -0.2, 0.95]))

    def sample_fn(key, n):
        u2 = jax.random.uniform(key, (n, 2))
        wo, _ = phase_sample(kind, g, jnp.broadcast_to(wi_dir, (n, 3)), u2)
        return wo

    def pdf_fn(d):
        sh = d.shape[:-1]
        dd = d.reshape(-1, 3)
        return phase_eval(kind, g, jnp.broadcast_to(wi_dir, dd.shape), dd).reshape(sh)

    res = chi2_test(jax.random.key(kind * 3 + 1), sample_fn, pdf_fn,
                    n_samples=300_000)
    assert res.passed, f"kind={kind} g={g}: chi2={res.chi2:.1f} p={res.p_value:.2e}"


def test_phase_normalization():
    from mitsuba_jax.core.quad import sphere_bin_integrate

    wi_dir = m.normalize(jnp.asarray([0.1, 0.7, 0.7]))
    for kind, g in [(ISOTROPIC, 0.0), (HG, 0.8), (HG, -0.7), (MICROFLAKE, 0.0)]:
        total = float(
            sphere_bin_integrate(
                lambda d: phase_eval(kind, g, jnp.broadcast_to(wi_dir, d.shape), d),
                24, 24, sub=8,
            ).sum()
        )
        assert abs(total - 1.0) < 5e-3, (kind, g, total)


def test_homogeneous_transmittance_beer_lambert():
    med = make_homogeneous(sigma_s=(0.0,) * 3, sigma_a=(0.5, 1.0, 2.0))
    o = jnp.zeros((4, 3))
    d = jnp.broadcast_to(jnp.array([0.0, 0, 1.0]), (4, 3))
    dist = jnp.asarray([0.5, 1.0, 2.0, 4.0])
    tr = np.asarray(medium_transmittance(med, o, d, dist))
    expect = np.exp(-np.outer(np.asarray(dist), [0.5, 1.0, 2.0]))
    np.testing.assert_allclose(tr, expect, rtol=1e-5)


def test_homogeneous_distance_sampling_unbiased():
    """E[weight·1{medium}]·f + E[surface_weight·1{surface}] must reproduce
    analytic transmittance integrals: with f=1 the estimator of
    ∫ sigma_s e^{-sigma_t t} dt + e^{-sigma_t D} is exact in expectation."""
    sig_s, sig_a = 0.6, 0.4
    med = make_homogeneous((sig_s,) * 3, (sig_a,) * 3)
    n = 200_000
    k = jax.random.key(0)
    o = jnp.zeros((n, 3))
    d = jnp.broadcast_to(jnp.array([0.0, 0, 1.0]), (n, 3))
    dmax = jnp.full((n,), 2.0)
    u1 = jax.random.uniform(jax.random.key(1), (n,))
    u2 = jax.random.uniform(jax.random.key(2), (n,))
    md = sample_distance(med, o, d, dmax, u1, u2)
    est = (
        jnp.where(md["valid"], md["weight"][:, 0], 0.0)
        + jnp.where(~md["valid"], md["surface_weight"][:, 0], 0.0)
    )
    sig_t = sig_s + sig_a
    analytic = (sig_s / sig_t) * (1 - np.exp(-sig_t * 2.0)) + np.exp(-sig_t * 2.0)
    assert abs(float(est.mean()) - analytic) < 5e-3


def test_volumetric_furnace():
    """Emitting enclosure + purely scattering medium: L == Le everywhere
    (energy conservation through multiple scattering).  No floor quad — a
    one-sided surface's black backface would absorb scattered rays."""
    scene = furnace_scene(albedo=1.0, radiance=1.0, include_floor=False)
    med = make_homogeneous(sigma_s=(0.15,) * 3, sigma_a=(0.0,) * 3, g=0.0)
    n = 2048
    o = jnp.zeros((n, 3))
    dirs = m.normalize(jax.random.normal(jax.random.key(5), (n, 3)))
    ray = Ray.make(o, dirs)
    sampler = Sampler(11, jnp.arange(n), jnp.zeros(n, jnp.int32))
    cfg = PathConfig(max_depth=64, rr_depth=1000, spp=1, remat=False)
    L, _ = volpath_trace(scene, med, ray, sampler, cfg, seed=3)
    mean = float(L[:, 0].mean())
    assert abs(mean - 1.0) < 0.03, mean


def test_absorbing_medium_attenuates_emitter():
    """Camera at sphere center: L = Le * exp(-sigma_a * r)."""
    scene = furnace_scene(albedo=0.0, radiance=2.0)
    sig_a = 0.1
    med = make_homogeneous((0.0,) * 3, (sig_a,) * 3)
    n = 512
    dirs = m.normalize(jax.random.normal(jax.random.key(6), (n, 3)))
    # offset origin above the floor quad to avoid hitting it
    o = jnp.broadcast_to(jnp.array([0.0, 5.0, 0.0]), (n, 3))
    ray = Ray.make(o, dirs)
    sampler = Sampler(12, jnp.arange(n), jnp.zeros(n, jnp.int32))
    cfg = PathConfig(max_depth=2, rr_depth=100, spp=1, remat=False)
    L, _ = volpath_trace(scene, med, ray, sampler, cfg, seed=4)
    # distance from (0,5,0) to sphere radius 10 varies by direction; compare
    # against per-ray analytic attenuation is complex — use mean over
    # directions with MC on the same rays:
    from mitsuba_jax.render.intersect import ray_intersect

    its = ray_intersect(scene.geom, ray)
    mask = np.asarray(its.emitter_id) >= 0
    expect = 2.0 * np.exp(-sig_a * np.asarray(its.t))
    got = np.asarray(L[:, 0])
    # analog distance sampling makes the per-ray estimator binary {0, Le};
    # only the mean is comparable
    np.testing.assert_allclose(got[mask].mean(), expect[mask].mean(), rtol=0.05)


def test_woodcock_matches_homogeneous():
    """Constant-density heterogeneous medium must agree with the closed-form
    homogeneous sampler in expectation."""
    sig_s, sig_a = 0.5, 0.5
    hom = make_homogeneous((sig_s,) * 3, (sig_a,) * 3)
    # grid covering [-20,20]^3 with density 1
    import numpy as _np
    from mitsuba_jax.core import transform as tf

    w2g = tf.compose(tf.scale([4 / 40, 4 / 40, 4 / 40]), tf.translate([20, 20, 20]))
    het = make_heterogeneous(
        _np.ones((5, 5, 5), _np.float32), w2g, (sig_s,) * 3, (sig_a,) * 3
    )
    n = 100_000
    o = jnp.zeros((n, 3))
    d = jnp.broadcast_to(jnp.array([0.0, 0, 1.0]), (n, 3))
    dmax = jnp.full((n,), 3.0)
    u1 = jax.random.uniform(jax.random.key(7), (n,))
    u2 = jax.random.uniform(jax.random.key(8), (n,))
    md_h = sample_distance(hom, o, d, dmax, u1, u2)
    md_w = sample_distance(het, o, d, dmax, u1, u2, key=jax.random.key(9))
    # interaction probability matches
    p_h = float(md_h["valid"].mean())
    p_w = float(md_w["valid"].mean())
    assert abs(p_h - p_w) < 0.01, (p_h, p_w)
    # mean interaction distance matches
    t_h = float(jnp.where(md_h["valid"], md_h["t"], 0).sum() / md_h["valid"].sum())
    t_w = float(jnp.where(md_w["valid"], md_w["t"], 0).sum() / md_w["valid"].sum())
    assert abs(t_h - t_w) < 0.02, (t_h, t_w)


# ---------------------------------------------------------------------------
# gaussian-fiber microflake (reference microflake.cpp + microflake_fiber.h
# GaussianFiberDistribution; σ_t fit = the uflakefit utility)
# ---------------------------------------------------------------------------

def test_gauss_flake_sigma_t_limits():
    from mitsuba_jax.media.phase import fit_fiber_sigma_t, gauss_fiber_sigma_t

    # σ -> 0: flakes exactly perpendicular to the axis -> σ_t = (2/π)sinθ
    c, err = fit_fiber_sigma_t(4e-4)
    assert err < 1e-3
    assert abs(float(c[1]) - 2.0 / np.pi) < 0.02
    assert abs(float(c[0])) < 1e-3
    # σ large: near-uniform flake normals -> σ_t ≈ E|cosγ| = 1/2, flat
    c4, err4 = fit_fiber_sigma_t(4.0)
    assert err4 < 1e-4
    for ct in (0.0, 0.4, 0.9):
        assert abs(float(gauss_fiber_sigma_t(jnp.asarray(ct), c4)) - 0.5) \
            < 0.01


@pytest.mark.parametrize("stddev", [0.2, 0.8])
def test_gauss_flake_phase_chi2(stddev):
    from mitsuba_jax.media.phase import MICROFLAKE_GAUSS, fit_fiber_sigma_t

    coeffs, _ = fit_fiber_sigma_t(stddev)
    coeffs = jnp.asarray(coeffs)
    wi_dir = m.normalize(jnp.asarray([0.6, -0.45, 0.5]))

    def sample_fn(key, n):
        u2 = jax.random.uniform(key, (n, 2))
        wo, _ = phase_sample(MICROFLAKE_GAUSS, stddev,
                             jnp.broadcast_to(wi_dir, (n, 3)), u2,
                             flake_coeffs=coeffs)
        return wo

    def pdf_fn(d):
        sh = d.shape[:-1]
        dd = d.reshape(-1, 3)
        return phase_eval(MICROFLAKE_GAUSS, stddev,
                          jnp.broadcast_to(wi_dir, dd.shape), dd,
                          flake_coeffs=coeffs).reshape(sh)

    res = chi2_test(jax.random.key(int(stddev * 100)), sample_fn, pdf_fn,
                    n_samples=300_000)
    assert res.passed, f"stddev={stddev}: chi2={res.chi2:.1f} p={res.p_value:.2e}"


def test_gauss_flake_normalization():
    from mitsuba_jax.core.quad import sphere_bin_integrate
    from mitsuba_jax.media.phase import MICROFLAKE_GAUSS, fit_fiber_sigma_t

    wi_dir = m.normalize(jnp.asarray([0.1, 0.7, 0.7]))
    for stddev in (0.15, 0.5, 2.0):
        coeffs = jnp.asarray(fit_fiber_sigma_t(stddev)[0])
        total = float(
            sphere_bin_integrate(
                lambda d: phase_eval(MICROFLAKE_GAUSS, stddev,
                                     jnp.broadcast_to(wi_dir, d.shape), d,
                                     flake_coeffs=coeffs),
                24, 24, sub=8,
            ).sum()
        )
        assert abs(total - 1.0) < 6e-3, (stddev, total)


def test_oriented_medium_directional_extinction():
    """Transmittance through a fiber medium depends on the ray's angle to
    the fiber axis: along the fibers σ_t is small, across it is maximal
    (reference microflake.cpp sigmaDir)."""
    from mitsuba_jax.media.medium import (
        make_heterogeneous, medium_transmittance,
    )

    med = make_heterogeneous(
        np.ones((2, 2, 2), np.float32), np.eye(4),
        sigma_s=(0.5,) * 3, sigma_a=(0.5,) * 3,
        orientation=(0.0, 0.0, 1.0), flake_stddev=0.1,
    )
    o = jnp.asarray([[0.0, 0.0, 0.0]])
    dist = jnp.asarray([1.0])
    tr_along = float(medium_transmittance(
        med, o, jnp.asarray([[0.0, 0.0, 1.0]]), dist)[0, 0])
    tr_across = float(medium_transmittance(
        med, o, jnp.asarray([[1.0, 0.0, 0.0]]), dist)[0, 0])
    assert tr_along > tr_across + 0.2, (tr_along, tr_across)
    # quantitative: sigmaDir(cos=0) = 2 σ_t(0) ≈ 2·(2/π)·erf-ish; compare
    # against the fitted expansion directly
    from mitsuba_jax.media.phase import gauss_fiber_sigma_t

    f_across = 2.0 * float(gauss_fiber_sigma_t(jnp.asarray(0.0),
                                               med.flake_coeffs))
    assert abs(tr_across - np.exp(-1.0 * f_across)) < 1e-3
    f_along = 2.0 * float(gauss_fiber_sigma_t(jnp.asarray(1.0),
                                              med.flake_coeffs))
    assert abs(tr_along - np.exp(-1.0 * f_along)) < 1e-3


def test_oriented_volpath_renders():
    """volpath end-to-end with a gaussian-flake oriented medium: finite,
    non-black, and Woodcock event rate responds to the fiber angle."""
    from mitsuba_jax.integrators.volpath import render_volpath
    from mitsuba_jax.media.medium import make_heterogeneous
    from mitsuba_jax.integrators import PathConfig

    scene = furnace_scene(16, 16)
    med = make_heterogeneous(
        np.ones((2, 2, 2), np.float32) * 0.5,
        np.diag([0.02, 0.02, 0.02, 1.0]) @ np.eye(4),
        sigma_s=(1.0,) * 3, sigma_a=(0.2,) * 3,
        orientation=(0.0, 0.0, 1.0), flake_stddev=0.3,
    )
    img, _ = render_volpath(scene, med,
                            PathConfig(max_depth=4, spp=4, remat=False),
                            seed=3)
    img = np.asarray(img)
    assert np.isfinite(img).all() and img.mean() > 0.01
