"""Cluster cutting and the cluster backend's ray ordering.

cut_clusters must partition the triangles into contiguous BVH-subtree
ranges (instancing decodes virtual prim ids through them); the per-bounce
ray ordering and hit prediction must not change the image."""
import numpy as np

from mitsuba_jax.render import mesh as mesh_mod
from mitsuba_jax.render.bvh import build_bvh
from mitsuba_jax.render.clusters import CLUSTER_K, cut_clusters


def _make_geom(n_sub=24):
    m = mesh_mod.make_sphere_mesh([0.0, 0.0, 0.0], 1.0, n_sub, n_sub * 2)
    v = np.asarray(m.vertices, np.float32)
    f = np.asarray(m.faces, np.int64)
    bvh = build_bvh(v, f)
    tri = v[f[bvh.perm]]
    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    return v0, e1, e2, bvh


def test_cut_clusters_cover():
    v0, e1, e2, bvh = _make_geom()
    t = v0.shape[0]
    ranges = cut_clusters(bvh.first, bvh.count, bvh.skip, t)
    got = sorted(ranges)
    pos = 0
    for s, c in got:
        assert s == pos and 0 < c <= CLUSTER_K
        pos += c
    assert pos == t


def test_octant_sort_mode_matches_full(cluster_scene=None):
    """'octant' linear counting-sort ordering must not change radiance
    (ordering is a perf knob; every lane resolves exactly either way)."""
    import numpy as np

    from mitsuba_jax.integrators import PathConfig, render
    from mitsuba_jax.render.scene import cornell_box_specular

    # force cluster: the analytic-sphere specular box is otherwise small
    # enough that "auto" picks brute, and this test targets cluster sorting
    scene = cornell_box_specular(32, 32, backend="cluster")
    a, _ = render(scene, PathConfig(max_depth=3, spp=2, sort_mode="full"))
    b, _ = render(scene, PathConfig(max_depth=3, spp=2, sort_mode="octant"))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_hit_prediction_identical_render():
    """hash-based hit prediction (PathConfig.hit_prediction) must be an
    exact optimization: bounds/shortcuts only, bitwise-equal output."""
    import dataclasses

    import numpy as np

    from mitsuba_jax.integrators import PathConfig, render
    from mitsuba_jax.render.scene import cornell_box

    scene = cornell_box(24, 24, backend="brute")
    base = PathConfig(max_depth=4, spp=2)
    a, _ = render(scene, base)
    b, aux = render(scene, dataclasses.replace(base, hit_prediction=True))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(aux["pred_hit_frac"]) >= 0.0
