"""Geometry tests: BVH traversal must agree with brute-force all-pairs
intersection (the correctness oracle), mirroring the reference's kd-tree
validation strategy (src/tests/test_kd.cpp)."""
import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core import math as m
from mitsuba_jax.core.types import replace
from mitsuba_jax.render import mesh as mesh_mod
from mitsuba_jax.render.bvh import build_bvh
from mitsuba_jax.render.intersect import build_geometry, ray_intersect, ray_test
from mitsuba_jax.render.records import Ray


def random_mesh(seed, n_tri=200, spread=2.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n_tri, 1, 3))
    offs = rng.normal(0, 0.3, (n_tri, 2, 3))
    v = np.concatenate([base, base + offs[:, :1], base + offs[:, 1:]], axis=1)
    verts = v.reshape(-1, 3).astype(np.float32)
    faces = np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3)
    return mesh_mod.TriMesh(verts, faces)


def random_rays(seed, n=2000, spread=4.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return Ray.make(jnp.asarray(o), jnp.asarray(d))


def test_bvh_structure():
    msh = random_mesh(0, 500)
    bvh = build_bvh(msh.vertices, msh.faces)
    # every triangle appears exactly once
    assert sorted(bvh.perm.tolist()) == list(range(500))
    # leaf counts sum to T
    assert bvh.count.sum() == 500
    # skip links are strictly ahead (DFS preorder)
    assert np.all(bvh.skip > np.arange(bvh.n_nodes))


def test_bvh_matches_brute():
    msh = random_mesh(1, 300)
    geom_b = build_geometry([(msh, 0, -1)], backend="brute")
    geom_t = build_geometry([(msh, 0, -1)], backend="bvh")
    ray = random_rays(2, 4000)
    ib = jax.jit(ray_intersect, static_argnames=())(geom_b, ray)
    it = ray_intersect(geom_t, ray)
    np.testing.assert_array_equal(np.asarray(ib.valid), np.asarray(it.valid))
    hit = np.asarray(ib.valid)
    np.testing.assert_allclose(
        np.asarray(ib.t)[hit], np.asarray(it.t)[hit], rtol=1e-4, atol=1e-5
    )
    # prim ids live in backend-local (permuted) order; compare the actual
    # triangles they refer to
    np.testing.assert_allclose(
        np.asarray(geom_b.v0)[np.asarray(ib.prim_id)[hit]],
        np.asarray(geom_t.v0)[np.asarray(it.prim_id)[hit]],
        atol=1e-6,
    )
    # shadow rays agree too
    sb = ray_test(geom_b, ray)
    st = ray_test(geom_t, ray)
    np.testing.assert_array_equal(np.asarray(sb), np.asarray(st))


def test_box_interior_hits():
    box = mesh_mod.make_box([-1, -1, -1], [1, 1, 1])
    geom = build_geometry([(box, 0, -1)], backend="brute")
    # rays from center must all hit at t=1 with inward-facing geo normals
    d = np.asarray(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        np.float32,
    )
    ray = Ray.make(jnp.zeros((6, 3)), jnp.asarray(d))
    its = ray_intersect(geom, ray)
    assert bool(its.valid.all())
    np.testing.assert_allclose(np.asarray(its.t), 1.0, atol=1e-5)
    # outward box normals → dot(n, d) > 0 when exiting through the wall
    assert np.all(np.asarray(m.dot(its.geo_n, ray.d)) > 0)
    # wi is in upper local hemisphere relative to the *shading* normal?
    # (normals face outward, ray exits, so local wi.z < 0 here)
    assert np.all(np.asarray(m.cos_theta(its.wi)) < 0)


def test_sphere_mesh_normals_and_uv():
    sph = mesh_mod.make_sphere_mesh([0, 0, 0], 1.0, 64, 128)
    geom = build_geometry([(sph, 0, -1)], backend="bvh")
    rng = np.random.default_rng(3)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.asarray(d) * 3.0
    ray = Ray.make(jnp.asarray(o), jnp.asarray(-d))
    its = ray_intersect(geom, ray)
    assert bool(its.valid.all())
    np.testing.assert_allclose(np.asarray(its.t), 2.0, atol=5e-3)
    # interpolated shading normal ≈ hit direction
    cosang = np.asarray(m.dot(its.sh_n, jnp.asarray(d)))
    assert cosang.min() > 0.999


def test_mint_maxt_respected():
    box = mesh_mod.make_box([-1, -1, -1], [1, 1, 1])
    geom = build_geometry([(box, 0, -1)], backend="brute")
    o = jnp.zeros((1, 3))
    d = jnp.asarray([[1.0, 0, 0]])
    # maxt short of the wall -> no hit
    ray = replace(Ray.make(o, d), maxt=jnp.asarray([0.5]))
    assert not bool(ray_intersect(geom, ray).valid[0])
    assert not bool(ray_test(geom, ray)[0])
    # mint beyond the wall -> no hit
    ray = replace(Ray.make(o, d), mint=jnp.asarray([1.5]))
    assert not bool(ray_intersect(geom, ray).valid[0])


def test_empty_direction_misses():
    msh = random_mesh(4, 50)
    geom = build_geometry([(msh, 0, -1)], backend="bvh")
    ray = Ray.make(jnp.asarray([[100.0, 100, 100]]), jnp.asarray([[0.0, 0, 1.0]]))
    its = ray_intersect(geom, ray)
    assert not bool(its.valid[0])
    assert int(its.material_id[0]) == -1
