"""Octree + LRU containers (reference core/octree.h, subsurface/irrtree.h,
core/lrucache.h)."""
import numpy as np

from mitsuba_jax.core.lru import LRUCache
from mitsuba_jax.core.octree import Octree


def _cloud(n=600, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, 3))


def test_octree_range_query_matches_bruteforce():
    pts = _cloud()
    tree = Octree(pts, leaf_size=6)
    rng = np.random.default_rng(1)
    for _ in range(20):
        c = rng.uniform(-1, 1, 3)
        r = rng.uniform(0.1, 0.8)
        got = np.sort(tree.range_query(c, r))
        want = np.sort(np.where(((pts - c) ** 2).sum(1) <= r * r)[0])
        np.testing.assert_array_equal(got, want)


def test_octree_knn_matches_bruteforce():
    pts = _cloud(400, seed=2)
    tree = Octree(pts, leaf_size=5)
    rng = np.random.default_rng(3)
    for _ in range(15):
        c = rng.uniform(-1, 1, 3)
        k = int(rng.integers(1, 12))
        got = tree.knn(c, k)
        d2 = ((pts - c) ** 2).sum(1)
        want = np.argsort(d2)[:k]
        np.testing.assert_array_equal(np.sort(got), np.sort(want))


def test_octree_hierarchical_gather_converges_to_exact():
    """irrtree.h-style far-cluster approximation: with eps -> 0 the
    gather is exact; at eps=0.05 the dipole-like kernel error stays
    below 1% while visiting far fewer points."""
    pts = _cloud(1500, seed=4)
    rng = np.random.default_rng(5)
    vals = rng.uniform(0.1, 1.0, (1500, 3))
    tree = Octree(pts, vals, leaf_size=8)
    sigma_tr = 2.0

    def kernel(r):
        r = np.maximum(r, 1e-3)
        return np.exp(-sigma_tr * r) / (r * r + 0.01)

    for _ in range(10):
        x = rng.uniform(-1, 1, 3)
        exact = (kernel(np.sqrt(((pts - x) ** 2).sum(1)))[:, None]
                 * vals).sum(0)
        z = tree.gather(x, kernel, solid_angle_eps=0.0)
        np.testing.assert_allclose(z, exact, rtol=1e-10)
        approx = tree.gather(x, kernel, solid_angle_eps=0.05)
        assert np.abs(approx - exact).max() / exact.max() < 0.01


def test_lru_eviction_order_and_hooks():
    evicted = []
    c = LRUCache(3, on_evict=lambda k, v: evicted.append(k))
    for k in "abc":
        c.put(k, k.upper())
    assert c.get("a") == "A"        # refresh a
    c.put("d", "D")                 # evicts b (LRU)
    assert evicted == ["b"]
    assert "a" in c and "c" in c and "d" in c and "b" not in c


def test_lru_read_through_loader():
    loads = []

    def loader(k):
        loads.append(k)
        return k * 2

    c = LRUCache(2, loader=loader)
    assert c.get("x") == "xx"
    assert c.get("x") == "xx"
    assert loads == ["x"]           # second get was a hit
    assert c.hits == 1 and c.misses == 1


def test_image_cache_decodes_once(tmp_path):
    from mitsuba_jax.io import bitmap

    img = np.random.default_rng(6).integers(0, 255, (4, 4, 3),
                                            dtype=np.uint8)
    p = str(tmp_path / "t.png")
    bitmap.write_png(p, img)
    a = bitmap.read_image_cached(p)
    b = bitmap.read_image_cached(p)
    assert a is b                   # same decoded object (cache hit)
    np.testing.assert_array_equal(a, img)


def test_hierarchical_sss_gather_matches_scan():
    """scene_ss_lo_hier (octree, irrtree.h analog) vs scene_ss_lo (exact
    chunked scan) on a dipole entry: <1% relative error at eps=0.05 and
    exact at eps=0."""
    import jax.numpy as jnp

    from mitsuba_jax.subsurface.dipole import (
        SceneSubsurface, build_scene_subsurface, scene_ss_lo,
        scene_ss_lo_hier,
    )

    from mitsuba_jax.render.intersect import build_geometry
    from mitsuba_jax.render.mesh import make_quad

    rng = np.random.default_rng(11)
    K = 512
    quad = make_quad([-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0])
    geom = build_geometry([(quad, 0, -1)], backend="brute")
    entries = [dict(material_id=0, sigma_s=(2.0, 2.5, 3.0),
                    sigma_a=(0.02, 0.04, 0.08), g=0.0, eta=1.3)]
    ss = build_scene_subsurface(entries, n_materials=1, geom=geom,
                                n_points=K)
    irr = rng.uniform(0.2, 1.0, (1, K, 3)).astype(np.float32)
    from mitsuba_jax.core.types import replace
    ss = replace(ss, irradiance=jnp.asarray(irr))

    x = rng.uniform(-0.5, 0.5, (16, 3)).astype(np.float32)
    x[:, 2] = 0.0
    wo = np.full(16, 0.8, np.float32)
    exact = np.asarray(scene_ss_lo(ss, 0, jnp.asarray(x), jnp.asarray(wo)))
    h0 = scene_ss_lo_hier(ss, 0, x, wo, solid_angle_eps=0.0)
    np.testing.assert_allclose(h0, exact, rtol=2e-3, atol=1e-6)
    h = scene_ss_lo_hier(ss, 0, x, wo, solid_angle_eps=0.05)
    assert np.abs(h - exact).max() / exact.max() < 0.01
