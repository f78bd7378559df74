"""Core-math parity extras: SH, Haar wavelets, Brent, Hilbert curve, kNN."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_jax.core import math as m
from mitsuba_jax.core import sh
from mitsuba_jax.core.brent import brent
from mitsuba_jax.core.kdtree import HashGrid, KDTree
from mitsuba_jax.core.sfcurve import hilbert_d2xy, hilbert_pixel_order, hilbert_xy2d
from mitsuba_jax.core.wavelet import (
    haar_fwd_2d, haar_fwd_3d, haar_inv_2d, haar_inv_3d, sparsify,
)


def test_sh_orthonormal():
    """∫ y_i y_j dω = δ_ij on a quadrature grid."""
    bands = 4
    res = 64
    theta = (jnp.arange(res) + 0.5) / res * jnp.pi
    phi = (jnp.arange(2 * res) + 0.5) / (2 * res) * 2 * jnp.pi
    tt, pp = jnp.meshgrid(theta, phi, indexing="ij")
    d = m.spherical_direction(tt, pp)
    basis = sh.eval_basis(bands, d)           # (res, 2res, 16)
    w = jnp.sin(tt) * (jnp.pi / res) * (jnp.pi / res)
    gram = jnp.einsum("ijk,ijl,ij->kl", basis, basis, w)
    np.testing.assert_allclose(np.asarray(gram), np.eye(16), atol=2e-3)


def test_sh_project_eval_roundtrip():
    """Projecting a band-limited function reproduces it."""
    bands = 3
    rng = np.random.default_rng(0)
    coeffs_true = jnp.asarray(rng.normal(size=bands * bands), jnp.float32)

    def f(d):
        return sh.eval_sh(coeffs_true, d)

    coeffs = sh.project(f, bands, res=96)
    np.testing.assert_allclose(np.asarray(coeffs), np.asarray(coeffs_true), atol=5e-3)


def test_sh_rotate_z():
    bands = 4
    rng = np.random.default_rng(1)
    coeffs = jnp.asarray(rng.normal(size=bands * bands), jnp.float32)
    ang = 0.7
    rot = sh.rotate_z(coeffs, jnp.asarray(ang))
    d = m.normalize(jnp.asarray(rng.normal(size=(200, 3)), jnp.float32))
    # rotating coefficients == evaluating at inversely-rotated directions
    ca, sa = np.cos(ang), np.sin(ang)
    d_rot = jnp.stack(
        [ca * d[:, 0] + sa * d[:, 1], -sa * d[:, 0] + ca * d[:, 1], d[:, 2]], -1
    )
    np.testing.assert_allclose(
        np.asarray(sh.eval_sh(rot, d)), np.asarray(sh.eval_sh(coeffs, d_rot)),
        atol=1e-4,
    )


def test_sh_sampler_chi2():
    from mitsuba_jax.core.chi2 import chi2_test

    bands = 3
    # a positive function: constant + gentle y_1^0 tilt
    coeffs = jnp.zeros(bands * bands).at[0].set(1.0).at[sh.sh_index(1, 0)].set(0.4)
    sampler = sh.SHSampler(bands, res=64)
    norm = None

    def sample_fn(key, n):
        u2 = jax.random.uniform(key, (n, 2))
        d, _ = sampler.sample(coeffs, u2)
        return d

    def pdf_fn(d):
        sh_val = jnp.maximum(sh.eval_sh(coeffs, d), 0.0)
        # normalization constant of max(f,0): integrate numerically once
        return sh_val / (np.sqrt(4 * np.pi) * float(coeffs[0]))

    res = chi2_test(jax.random.key(2), sample_fn, pdf_fn, n_samples=200_000)
    assert res.passed, f"p={res.p_value:.3e}"


def test_haar_roundtrips():
    rng = np.random.default_rng(2)
    img = rng.normal(size=(16, 16))
    np.testing.assert_allclose(haar_inv_2d(haar_fwd_2d(img)), img, atol=1e-10)
    vol = rng.normal(size=(8, 8, 8))
    np.testing.assert_allclose(haar_inv_3d(haar_fwd_3d(vol)), vol, atol=1e-10)
    # energy preservation (orthonormal transform)
    c = haar_fwd_2d(img)
    np.testing.assert_allclose((c ** 2).sum(), (img ** 2).sum(), rtol=1e-10)


def test_sparsify_compression():
    rng = np.random.default_rng(3)
    img = rng.normal(size=(32, 32)) * (rng.uniform(size=(32, 32)) < 0.05)
    c = haar_fwd_2d(img)
    sc, kept = sparsify(c, 0.25)
    rec = haar_inv_2d(sc)
    assert kept <= 0.26 * c.size
    # most energy survives
    assert ((rec - img) ** 2).sum() < 0.5 * (img ** 2).sum() + 1e-12


def test_brent_batched():
    targets = jnp.linspace(0.1, 0.9, 32)
    f = lambda x: jnp.cos(x) - targets   # root: arccos(target)
    x, ok = brent(f, jnp.zeros(32), jnp.full((32,), 1.6))
    assert bool(ok.all())
    np.testing.assert_allclose(np.asarray(x), np.arccos(np.asarray(targets)), atol=1e-5)


def test_hilbert_curve():
    order = 4
    d = np.arange((1 << order) ** 2)
    x, y = hilbert_d2xy(order, d)
    # bijective
    assert len(set(zip(x.tolist(), y.tolist()))) == d.size
    d2 = hilbert_xy2d(order, x, y)
    np.testing.assert_array_equal(d2, d)
    # consecutive points are neighbours (curve continuity)
    steps = np.abs(np.diff(x)) + np.abs(np.diff(y))
    assert (steps == 1).all()
    perm = hilbert_pixel_order(10, 6)
    assert sorted(perm.tolist()) == list(range(60))


def test_kdtree_knn_matches_bruteforce():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(500, 3))
    tree = KDTree(pts)
    q = rng.normal(size=3)
    idx, dist = tree.knn(q, 8)
    d_all = np.linalg.norm(pts - q, axis=1)
    expect = np.sort(d_all)[:8]
    np.testing.assert_allclose(np.sort(dist), expect, atol=1e-12)
    # range query
    ids = tree.range_query(q, 0.8)
    expect_ids = np.nonzero(d_all <= 0.8)[0]
    assert set(ids.tolist()) == set(expect_ids.tolist())


def test_hashgrid_gather_matches_bruteforce():
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, (2000, 3))
    payload = rng.uniform(size=(2000, 2))
    grid = HashGrid.build(pts, payload, res=8, max_per_query=27 * 40)
    q = jnp.asarray(rng.uniform(0.2, 0.8, (50, 3)), jnp.float32)
    r = 0.08
    got = np.asarray(grid.gather_sum(q, r))
    d = np.linalg.norm(pts[None, :, :] - np.asarray(q)[:, None, :], axis=-1)
    expect = (d <= r)[..., None] * payload[None]
    expect = expect.sum(1)
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Perlin noise (reference src/librender/noise.cpp)
# ---------------------------------------------------------------------------

def test_perlin_range_and_zero_mean():
    from mitsuba_jax.core.noise import perlin_noise

    rng = np.random.default_rng(0)
    p = jnp.asarray(rng.uniform(-50, 50, size=(20000, 3)), jnp.float32)
    v = np.asarray(perlin_noise(p))
    assert np.isfinite(v).all()
    assert np.abs(v).max() <= 1.5          # bounded
    assert abs(v.mean()) < 0.02            # zero-mean
    assert v.std() > 0.05                  # not degenerate


def test_perlin_zero_at_lattice():
    """Gradient noise vanishes exactly at integer lattice points."""
    from mitsuba_jax.core.noise import perlin_noise

    p = jnp.asarray([[0, 0, 0], [1, 2, 3], [-4, 7, 11]], jnp.float32)
    np.testing.assert_allclose(np.asarray(perlin_noise(p)), 0.0, atol=1e-6)


def test_perlin_smooth():
    """Small input perturbations produce small output changes."""
    from mitsuba_jax.core.noise import perlin_noise

    p = jnp.asarray([[0.3, 0.7, 0.1]], jnp.float32)
    a = float(perlin_noise(p)[0])
    b = float(perlin_noise(p + 1e-3)[0])
    assert abs(a - b) < 0.02


def test_fbm_and_turbulence():
    from mitsuba_jax.core.noise import fbm, turbulence

    rng = np.random.default_rng(1)
    p = jnp.asarray(rng.uniform(-10, 10, size=(1000, 3)), jnp.float32)
    f = np.asarray(fbm(p, omega=0.5, max_octaves=6))
    t = np.asarray(turbulence(p, omega=0.5, max_octaves=6))
    assert np.isfinite(f).all() and np.isfinite(t).all()
    assert (t >= 0).all()                  # turbulence sums |noise|
    assert t.std() > 0 and f.std() > 0
    # turbulence >= |fbm| is not an identity, but both share scale
    assert t.mean() > 0.1


def test_sh4d_roundtrip():
    """SHVector4D analog: tabulating an HG-like 4-D phase function and
    looking it up reproduces the function (reference shvector4d.h)."""
    import jax.numpy as jnp

    from mitsuba_jax.core.sh import eval_sh_4d, project_4d

    g = 0.4

    def f(wi, wo):
        c = jnp.sum(wi[None, :] * wo, axis=-1)
        return (1 - g * g) / (4 * np.pi * (1 + g * g - 2 * g * c) ** 1.5)

    grid = project_4d(f, bands=6, res_theta=6, res_phi=12, res=32)
    rng = np.random.default_rng(0)
    wi = rng.normal(size=(64, 3)); wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wo = rng.normal(size=(64, 3)); wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    approx = np.asarray(eval_sh_4d(grid, jnp.asarray(wi, jnp.float32),
                                   jnp.asarray(wo, jnp.float32)))
    exact = np.asarray(f(jnp.asarray(wi[0], jnp.float32),
                         jnp.asarray(wo, jnp.float32)))
    # check the wi[0] row against exact values
    row = np.asarray(eval_sh_4d(grid, jnp.asarray(np.tile(wi[0], (64, 1)), jnp.float32),
                                jnp.asarray(wo, jnp.float32)))
    err = np.abs(row - exact) / (np.abs(exact) + 1e-2)
    assert np.isfinite(approx).all()
    assert err.mean() < 0.15, err.mean()
