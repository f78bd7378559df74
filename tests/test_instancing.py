"""TRUE instancing end to end (reference src/shapes/instance.cpp +
shapegroup.cpp — kd-tree-in-kd-tree; here instances share one object-space
cluster/triangle table, per-instance world boxes + transforms).

Every platform runs the exact per-instance walks
(render/intersect.py _instances_closest/_instances_any)."""
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core import transform as tf
from mitsuba_jax.integrators import PathConfig, render
from mitsuba_jax.render import mesh as mesh_mod
from mitsuba_jax.render.camera import make_perspective
from mitsuba_jax.render.scene import SceneBuilder


def _xform(t, s=1.0):
    m = np.eye(4)
    m[:3, 3] = t
    m[0, 0] = m[1, 1] = m[2, 2] = s
    return m


def _base_builder():
    b = SceneBuilder()
    white = b.materials.lambertian((0.7, 0.7, 0.7))
    red = b.materials.lambertian((0.7, 0.2, 0.2))
    floor = mesh_mod.make_quad([-6, -6, 0], [6, -6, 0], [6, 6, 0],
                               [-6, 6, 0])
    b.add_shape(floor, white)
    lm = b.materials.lambertian((0.0, 0.0, 0.0))
    light = mesh_mod.make_quad([-2, -2, 8], [-2, 2, 8], [2, 2, 8],
                               [2, -2, 8])
    b.add_area_emitter_shape(light, lm, (25.0,) * 3)
    cam = make_perspective(tf.look_at([0, -7, 4], [0, 0, 1], [0, 0, 1]),
                           50, 1.0)
    b.set_camera(cam, 32, 32)
    return b, red


_PLACES = [(-2.0, 0.0, 1.0, 1.0), (2.0, 0.5, 1.2, 0.7),
           (0.0, 2.0, 0.8, 1.3)]


def _instanced_scene():
    b, red = _base_builder()
    ball = mesh_mod.make_sphere_mesh([0, 0, 0], 1.0, 10, 20)
    gid = b.add_instanced_group([(ball, red)])
    for x, y, z, s in _PLACES:
        b.add_instance(gid, _xform([x, y, z], s))
    return b.build(backend="cluster")


def _flattened_scene():
    b, red = _base_builder()
    ball = mesh_mod.make_sphere_mesh([0, 0, 0], 1.0, 10, 20)
    for x, y, z, s in _PLACES:
        b.add_shape(ball.transformed(_xform([x, y, z], s)), red)
    return b.build(backend="cluster")


def test_instanced_matches_flattened_render():
    cfg = PathConfig(max_depth=3, spp=4, remat=False)
    si = _instanced_scene()
    sf = _flattened_scene()
    # the instanced scene stores ONE copy of the ball's triangles
    assert si.geom.n_tris + si.geom.inst_groups[0].n_tris < sf.geom.n_tris
    img_i, _ = render(si, cfg, seed=3)
    img_f, _ = render(sf, cfg, seed=3)
    img_i, img_f = np.asarray(img_i), np.asarray(img_f)
    assert np.isfinite(img_i).all()
    # same scene, same sampler streams: images agree pixelwise up to the
    # object-space vs baked-world float differences
    d = np.abs(img_i - img_f)
    assert d.max() < 5e-2, float(d.max())
    assert abs(img_i.mean() - img_f.mean()) / img_f.mean() < 1e-3


def test_instances_shadow_and_materials():
    """Shadows from instanced geometry land on the floor (any-hit path)
    and instanced hits shade with the group's material."""
    cfg = PathConfig(max_depth=2, spp=8, remat=False)
    si = _instanced_scene()
    b, _ = _base_builder()
    empty = b.build(backend="cluster")
    img_i = np.asarray(render(si, cfg, seed=1)[0])
    img_e = np.asarray(render(empty, cfg, seed=1)[0])
    # the balls occlude the light somewhere: some floor pixels darken
    darkened = (img_e.mean(-1) - img_i.mean(-1)) > 0.05
    assert darkened.sum() > 10
    # and the balls themselves show the red material (r > g on many px)
    reddish = (img_i[..., 0] > img_i[..., 1] * 1.5) & (img_i[..., 0] > 0.05)
    assert reddish.sum() > 10
