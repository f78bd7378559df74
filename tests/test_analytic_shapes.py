"""Analytic sphere/cylinder primitives + solid-angle sphere emitters
(VERDICT round-1 missing #2; reference src/shapes/sphere.cpp:359,
cylinder.cpp)."""
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core import transform as tf
from mitsuba_jax.integrators import PathConfig, render
from mitsuba_jax.render import mesh as mesh_mod
from mitsuba_jax.render.camera import make_perspective
from mitsuba_jax.render.intersect import ray_intersect, ray_test
from mitsuba_jax.render.records import Ray
from mitsuba_jax.render.scene import SceneBuilder


def _sphere_scene():
    b = SceneBuilder()
    lm = b.materials.lambertian((0.7, 0.7, 0.7))
    b.add_sphere((0, 0, 0), 1.0, lm)
    floor = mesh_mod.make_quad([-5, -5, -1.2], [5, -5, -1.2],
                               [5, 5, -1.2], [-5, 5, -1.2])
    b.add_shape(floor, lm)
    b.emitters.point((3, 3, 5), (60.0,) * 3)
    cam = make_perspective(tf.look_at([0, 0, 5], [0, 0, 0], [0, 1, 0]),
                           40, 1.0)
    b.set_camera(cam, 16, 16)
    return b.build(backend="brute")


def test_sphere_exact_intersection():
    scene = _sphere_scene()
    g = scene.geom
    assert g.n_spheres == 1
    o = jnp.asarray([[0.0, 0.0, 5.0], [3.0, 0.0, 5.0], [0.0, 2.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 3)
    its = ray_intersect(g, Ray.make(o, d, mint=jnp.full(3, 1e-4)))
    t = np.asarray(its.t)
    # exact quadratic roots, no tessellation error
    np.testing.assert_allclose(t[0], 4.0, rtol=1e-6)
    np.testing.assert_allclose(t[1], 6.2, rtol=1e-6)   # floor at z=-1.2
    np.testing.assert_allclose(t[2], 6.2, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(its.geo_n[0]), [0, 0, 1],
                               atol=1e-6)
    assert int(its.prim_id[0]) == g.n_tris  # prim-id space: T + sphere idx
    # shadow rays see the sphere
    occ = ray_test(g, Ray.make(
        jnp.asarray([[0.0, 0.0, 5.0], [6.0, 6.0, 5.0]]),
        jnp.asarray([[0.0, 0.0, -1.0]] * 2),
        mint=jnp.full(2, 1e-4), maxt=jnp.full(2, 100.0)))
    assert bool(occ[0]) and not bool(occ[1])


def test_cylinder_exact_intersection():
    b = SceneBuilder()
    lm = b.materials.lambertian((0.5, 0.5, 0.5))
    b.add_cylinder((0, 0, -1), (0, 0, 1), 0.5, lm)
    scene = b.build(backend="brute")
    g = scene.geom
    o = jnp.asarray([[3.0, 0.0, 0.0], [3.0, 0.0, 2.0]])
    d = jnp.asarray([[-1.0, 0.0, 0.0]] * 2)
    its = ray_intersect(g, Ray.make(o, d, mint=jnp.full(2, 1e-4)))
    np.testing.assert_allclose(float(its.t[0]), 2.5, rtol=1e-6)
    assert not bool(its.valid[1])      # above the finite extent, no caps
    np.testing.assert_allclose(np.asarray(its.geo_n[0]), [1, 0, 0],
                               atol=1e-6)


def test_sphere_emitter_matches_tessellated():
    """Solid-angle-sampled analytic sphere light agrees with an area-
    sampled tessellated sphere light (same scene, independent
    estimators)."""
    def build(analytic):
        b = SceneBuilder()
        lm = b.materials.lambertian((0.6, 0.6, 0.6))
        black = b.materials.lambertian((0.0, 0.0, 0.0))
        floor = mesh_mod.make_quad([-4, -4, 0], [4, -4, 0],
                                   [4, 4, 0], [-4, 4, 0])
        b.add_shape(floor, lm)
        if analytic:
            b.add_sphere_emitter((0, 0, 3.0), 0.5, black, (20.0,) * 3)
        else:
            ball = mesh_mod.make_sphere_mesh((0, 0, 3.0), 0.5, 24, 48)
            b.add_area_emitter_shape(ball, black, (20.0,) * 3)
        cam = make_perspective(
            tf.look_at([0, -6, 2.5], [0, 0, 0.5], [0, 0, 1]), 40, 1.0)
        b.set_camera(cam, 12, 12)
        return b.build(backend="brute")

    cfg = PathConfig(max_depth=3, spp=64)
    means = {}
    for analytic in (True, False):
        imgs = [np.asarray(render(build(analytic), cfg, seed=s)[0])
                for s in (1, 2)]
        means[analytic] = np.mean(imgs)
    rel = abs(means[True] - means[False]) / means[False]
    assert rel < 0.05, means


def test_xml_analytic_sphere_and_cylinder():
    from mitsuba_jax.io.xml import load_scene_string

    xml = """<scene>
      <camera type="perspective">
        <transform name="toWorld">
          <lookAt ox="0" oy="0" oz="6" tx="0" ty="0" tz="0" ux="0" uy="1" uz="0"/>
        </transform>
        <film type="exrfilm">
          <integer name="width" value="8"/><integer name="height" value="8"/>
        </film>
      </camera>
      <shape type="sphere">
        <point name="center" x="0" y="0" z="0"/>
        <float name="radius" value="1"/>
        <bsdf type="lambertian"/>
      </shape>
      <shape type="cylinder">
        <point name="p1" x="2" y="0" z="-1"/>
        <point name="p2" x="2" y="0" z="1"/>
        <float name="radius" value="0.3"/>
        <bsdf type="lambertian"/>
      </shape>
      <shape type="sphere">
        <point name="center" x="-2" y="0" z="2"/>
        <float name="radius" value="0.4"/>
        <luminaire type="area">
          <spectrum name="intensity" value="10"/>
        </luminaire>
      </shape>
    </scene>"""
    scene, _ = load_scene_string(xml)
    g = scene.geom
    assert g.n_spheres == 2
    assert g.n_cylinders == 1
    img, _ = render(scene, PathConfig(max_depth=3, spp=8), seed=0)
    a = np.asarray(img)
    assert np.isfinite(a).all() and a.mean() > 0.001
