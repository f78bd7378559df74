"""Motion blur: animated shapes + time-binned rendering (reference
src/shapes/animatedinstance.cpp + include/mitsuba/render/track.h)."""
import os
import tempfile

import numpy as np

from mitsuba_jax.core import transform as tf
from mitsuba_jax.core.track import (
    AnimatedTransform, load_animated_transform, save_animated_transform,
)
from mitsuba_jax.integrators.path import PathConfig, render, render_motion
from mitsuba_jax.render import mesh as mesh_mod
from mitsuba_jax.render.camera import make_perspective
from mitsuba_jax.render.scene import SceneBuilder


def _translate(x):
    m = np.eye(4)
    m[0, 3] = x
    return m


def _moving_box_builder(shutter_time):
    b = SceneBuilder()
    white = b.materials.lambertian((0.8, 0.8, 0.8))
    dark = b.materials.lambertian((0.05, 0.05, 0.05))
    floor = mesh_mod.make_quad([-5, -5, 0], [5, -5, 0], [5, 5, 0],
                               [-5, 5, 0])
    b.add_shape(floor, dark)
    track = AnimatedTransform()
    track.append_transform(0.0, _translate(-1.0) @ np.diag([1, 1, 1, 1.0]))
    track.append_transform(1.0, _translate(1.0))
    box = mesh_mod.make_box([-0.3, -0.3, 0.2], [0.3, 0.3, 0.8])
    b.add_animated_shape(box, white, track)
    lm = b.materials.lambertian((0.0, 0.0, 0.0))
    light = mesh_mod.make_quad([-2, -2, 6], [-2, 2, 6], [2, 2, 6],
                               [2, -2, 6])   # wound so the normal faces -z
    b.add_area_emitter_shape(light, lm, (20.0,) * 3)
    cam = make_perspective(tf.look_at([0, -6, 3], [0, 0, 0.5], [0, 0, 1]),
                           45, 1.0, shutter_open=0.0,
                           shutter_time=shutter_time)
    b.set_camera(cam, 32, 32)
    return b


def test_track_binary_roundtrip():
    at = AnimatedTransform()
    at.append_transform(0.0, _translate(-1.0))
    rot = np.eye(4)
    c, s = np.cos(0.7), np.sin(0.7)
    rot[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    at.append_transform(1.0, _translate(2.0) @ rot)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "anim.track")
        save_animated_transform(p, at)
        at2 = load_animated_transform(p)
    for t in (0.0, 0.25, 0.5, 1.0):
        m1 = np.asarray(at.eval(t))
        m2 = np.asarray(at2.eval(t))
        np.testing.assert_allclose(m1, m2, atol=1e-5)


def test_static_build_bakes_shutter_open():
    """build() without time bakes the track at shutter open — identical
    geometry to an explicitly transformed static shape."""
    b = _moving_box_builder(0.0)
    s0 = b.build(backend="brute")
    s_t0 = b.build(backend="brute", time=0.0)
    np.testing.assert_allclose(np.asarray(s0.geom.v0),
                               np.asarray(s_t0.geom.v0), atol=1e-6)
    # time=1 geometry is shifted +2 in x relative to time=0
    s_t1 = b.build(backend="brute", time=1.0)
    dx = np.asarray(s_t1.geom.v0) - np.asarray(s_t0.geom.v0)
    moving = np.abs(dx[:, 0]) > 1.0
    assert moving.sum() > 0            # the box triangles moved
    np.testing.assert_allclose(dx[moving, 0], 2.0, atol=1e-5)


def test_motion_blur_smears_along_motion():
    """The time-binned render must spread the box across x (its motion
    axis): the blurred image's bright-pixel x-extent exceeds the static
    render's, y-extent stays put, and total energy is preserved."""
    b = _moving_box_builder(1.0)
    scenes = b.build_time_scenes(4, backend="brute")
    assert len(scenes) == 4
    cfg = PathConfig(max_depth=2, spp=4, remat=False)
    img_m, aux = render_motion(scenes, cfg, seed=0)
    img_s, _ = render(b.build(backend="brute", time=0.5), cfg, seed=0)
    img_m, img_s = np.asarray(img_m), np.asarray(img_s)
    assert aux["time_bins"] == 4
    assert np.isfinite(img_m).all()

    def x_extent(img):
        bright = img.mean(-1) > 0.35
        cols = np.where(bright.any(0))[0]
        return (cols.max() - cols.min()) if len(cols) else 0

    assert x_extent(img_m) > x_extent(img_s) + 3, (
        x_extent(img_m), x_extent(img_s))
    # energy within a few percent (box albedo ~constant over the sweep)
    assert abs(img_m.mean() - img_s.mean()) / img_s.mean() < 0.1
