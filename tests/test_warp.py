"""χ² validation of every warp, mirroring the reference's systematic
sampler testing (test_chisquare.cpp / chisquare.h)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_jax.core import warp
from mitsuba_jax.core.chi2 import chi2_test

N = 400_000


def run(key_seed, sample_fn, pdf_fn, **kw):
    res = chi2_test(jax.random.key(key_seed), sample_fn, pdf_fn, n_samples=N, **kw)
    assert res.passed, f"chi2={res.chi2:.1f} dof={res.dof} p={res.p_value:.2e}"


def u2(key, n):
    return jax.random.uniform(key, (n, 2))


def test_uniform_sphere():
    run(0, lambda k, n: warp.square_to_uniform_sphere(u2(k, n)),
        warp.square_to_uniform_sphere_pdf)


def test_uniform_hemisphere():
    run(1, lambda k, n: warp.square_to_uniform_hemisphere(u2(k, n)),
        warp.square_to_uniform_hemisphere_pdf)


def test_cosine_hemisphere():
    run(2, lambda k, n: warp.square_to_cosine_hemisphere(u2(k, n)),
        warp.square_to_cosine_hemisphere_pdf)


def test_uniform_cone():
    cc = 0.8
    run(3, lambda k, n: warp.square_to_uniform_cone(cc, u2(k, n)),
        lambda d: warp.square_to_uniform_cone_pdf(cc, d))


def test_disk_mappings_area_preserving():
    s = u2(jax.random.key(4), 200_000)
    for fn in (warp.square_to_uniform_disk, warp.square_to_uniform_disk_concentric):
        p = np.asarray(fn(s))
        r2 = (p ** 2).sum(-1)
        assert r2.max() <= 1.0 + 1e-5
        # uniform in area: E[r^2] = 1/2
        np.testing.assert_allclose(r2.mean(), 0.5, atol=5e-3)
        # mean should be at origin
        np.testing.assert_allclose(p.mean(0), [0, 0], atol=5e-3)


def test_triangle_uniform():
    s = u2(jax.random.key(5), 200_000)
    b = np.asarray(warp.square_to_uniform_triangle(s))
    assert (b >= 0).all() and (b.sum(-1) <= 1 + 1e-6).all()
    # uniform barycentric: E[b0] = E[b1] = 1/3
    np.testing.assert_allclose(b.mean(0), [1 / 3, 1 / 3], atol=5e-3)


def test_std_normal():
    s = u2(jax.random.key(6), 400_000)
    x = np.asarray(warp.square_to_std_normal(s))
    np.testing.assert_allclose(x.mean(0), [0, 0], atol=1e-2)
    np.testing.assert_allclose(x.std(0), [1, 1], atol=1e-2)


def test_tent():
    x = np.asarray(warp.interval_to_tent(jnp.linspace(0, 1, 100001)))
    assert abs(x.mean()) < 1e-3
    assert x.min() >= -1 and x.max() <= 1


def test_chi2_detects_bad_sampler():
    # uniform-sphere samples against cosine pdf must FAIL
    res = chi2_test(
        jax.random.key(7),
        lambda k, n: warp.square_to_uniform_hemisphere(u2(k, n)),
        warp.square_to_cosine_hemisphere_pdf,
        n_samples=N,
    )
    assert not res.passed
