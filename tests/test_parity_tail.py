"""Round-3 parity-tail modules: sparse wavelets (reference
include/mitsuba/core/wavelet.h:201,340), N-D adaptive cubature
(quad.h:136 NDIntegrator), and the SAH cost auto-fit (sahkdtree3.h:575
findCosts via kdbench -f)."""
import numpy as np
import pytest

from mitsuba_jax.core import wavelet as w
from mitsuba_jax.core.quad import ndintegrate


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


def test_sparse_wavelet2d_roundtrip(rng):
    img = rng.normal(size=(16, 16))
    c = w.haar_fwd_2d(img)
    sw = w.SparseWavelet2D.from_dense(c)
    assert np.allclose(sw.to_dense(), c)
    ys, xs = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    rec = sw.get_pixel(np.stack([ys, xs], -1))
    assert np.abs(rec - img).max() < 1e-12


def test_sparse_wavelet2d_put_get():
    sw = w.SparseWavelet2D(8)
    sw.put(1, 2, 1, 0, 0.25)
    assert sw.get(1, 2, 1, 0) == 0.25
    assert sw.get(1, 2, 0, 1) == 0.0
    assert sw.n_coefficients() == 1


def test_sparse_wavelet2d_line_integral(rng):
    img = rng.normal(size=(16, 16))
    sw = w.SparseWavelet2D.from_dense(w.haar_fwd_2d(img))
    p0, p1 = np.array([0.3, 1.7]), np.array([14.2, 9.9])
    li = sw.line_integral(p0, p1)
    # brute-force: sample the piecewise-constant reconstruction densely
    T = np.linalg.norm(p1 - p0)
    ts = (np.arange(100_000) + 0.5) / 100_000 * T
    pts = p0[None] + (p1 - p0)[None] / T * ts[:, None]
    cells = np.clip(np.floor(pts).astype(int), 0, 15)
    brute = img[cells[:, 0], cells[:, 1]].mean() * T
    assert abs(li - brute) < 1e-3


def test_sparse_wavelet2d_threshold_compresses(rng):
    img = rng.normal(size=(16, 16))
    c = w.haar_fwd_2d(img)
    full = w.SparseWavelet2D.from_dense(c)
    thr = w.SparseWavelet2D.from_dense(c, threshold=1.0)
    assert thr.n_coefficients() < full.n_coefficients()


def test_sparse_wavelet_octree_roundtrip(rng):
    vol = rng.normal(size=(8, 8, 8))
    so = w.SparseWaveletOctree.from_dense(w.haar_fwd_3d(vol))
    ii, jj, kk = np.meshgrid(*[np.arange(8)] * 3, indexing="ij")
    rec = so.get_voxel(np.stack([ii, jj, kk], -1))
    assert np.abs(rec - vol).max() < 1e-12


def test_sparse_wavelet_octree_put():
    so = w.SparseWaveletOctree(8)
    so.put(1, 0, 1, 0, [0.5, 0, 0, 0, 0, 0, -0.25])
    assert so.n_coefficients() == 2


def test_sparse_wavelet_octree_line_integral(rng):
    vol = rng.normal(size=(8, 8, 8))
    so = w.SparseWaveletOctree.from_dense(w.haar_fwd_3d(vol))
    p0 = np.array([0.2, 7.1, 1.3])
    p1 = np.array([7.7, 0.4, 6.6])
    li = so.line_integral(p0, p1)
    T = np.linalg.norm(p1 - p0)
    ts = (np.arange(200_000) + 0.5) / 200_000 * T
    pts = p0[None] + (p1 - p0)[None] / T * ts[:, None]
    cells = np.clip(np.floor(pts).astype(int), 0, 7)
    brute = vol[cells[:, 0], cells[:, 1], cells[:, 2]].mean() * T
    assert abs(li - brute) < 1e-3


def test_ndintegrate_polynomial():
    f = lambda x: (x[:, 0] ** 2 * x[:, 1] * x[:, 2] ** 3)[:, None]
    v, e, n = ndintegrate(f, 1, [0, 0, 0], [1, 1, 1], rel_err=1e-8)
    assert abs(v[0] - 1 / 24) < 1e-8
    assert n >= 33


def test_ndintegrate_adaptive_gaussian():
    from math import erf, pi, sqrt

    f = lambda x: np.exp(
        -50 * ((x[:, 0] - 0.3) ** 2 + (x[:, 1] - 0.7) ** 2))[:, None]
    v, e, n = ndintegrate(f, 1, [0, 0], [1, 1], rel_err=1e-7,
                          max_evals=300_000)
    g = sqrt(pi / 50) / 2 * (erf(sqrt(50) * 0.3) + erf(sqrt(50) * 0.7))
    assert abs(v[0] - g * g) < 1e-6
    assert n > 33          # adaptivity actually split regions


def test_ndintegrate_vector_integrand():
    f = lambda x: np.stack([np.ones(len(x)), x.sum(-1)], -1)
    v, e, n = ndintegrate(f, 2, [0] * 4, [1] * 4, rel_err=1e-9)
    assert np.allclose(v, [1.0, 2.0], atol=1e-9)


def test_find_costs_smoke():
    from mitsuba_jax.render.intersect import build_geometry
    from mitsuba_jax.render.mesh import make_sphere_mesh
    from mitsuba_jax.utils.raybench import find_costs

    msh = make_sphere_mesh((0, 0, 0), 1.0, n_theta=12, n_phi=24)
    geom = build_geometry([(msh, 0, -1)], backend="bvh")
    tc, ic, fit = find_costs(geom, n=4096, batches=4)
    assert tc == 10.0 and ic == 10.0
    assert fit["step_us"] > 0.0
