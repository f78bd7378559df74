"""Volume photons + beam radiance estimate vs the volumetric path tracer."""
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_jax.integrators.bre import (
    bre_render, build_volume_grid, shoot_photons_media,
)
from mitsuba_jax.integrators.path import PathConfig
from mitsuba_jax.media import make_homogeneous, no_medium
from mitsuba_jax.render.scene import cornell_box


def test_volume_deposits_scale_with_sigma():
    scene = cornell_box(width=8, height=8)
    thin = make_homogeneous((0.0005,) * 3, (0.0001,) * 3)
    thick = make_homogeneous((0.002,) * 3, (0.0001,) * 3)
    _, vol_thin = shoot_photons_media(scene, thin, 2000, 4, seed=0)
    _, vol_thick = shoot_photons_media(scene, thick, 2000, 4, seed=0)
    assert len(vol_thin[0]) > 0
    assert len(vol_thick[0]) > 1.2 * len(vol_thin[0])
    # no medium -> no volume deposits, surface deposits survive
    surf, vol0 = shoot_photons_media(scene, no_medium(), 2000, 4, seed=0)
    assert len(vol0[0]) == 0
    assert len(surf[0]) > 1000


def test_caustic_classification():
    """All-diffuse cornell: no caustic photons.  With a mirror floor,
    L(S)+D deposits must appear flagged caustic."""
    from mitsuba_jax.render import mesh as mesh_mod
    from mitsuba_jax.render.camera import make_perspective
    from mitsuba_jax.render.scene import SceneBuilder
    from mitsuba_jax.core import transform as tf

    surf, _ = shoot_photons_media(
        cornell_box(width=8, height=8), no_medium(), 4000, 4, seed=0
    )
    assert surf[4].sum() == 0   # no delta materials anywhere

    b = SceneBuilder()
    white = b.materials.lambertian((0.7, 0.7, 0.7))
    mirror = b.materials.mirror((0.95, 0.95, 0.95))
    lm = b.materials.lambertian((0.0, 0.0, 0.0))
    # mirror floor (normal +y), diffuse walls, emitter at top
    b.add_shape(mesh_mod.make_quad([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1]), mirror)  # +y
    b.add_shape(mesh_mod.make_quad([-1, 0, -1], [-1, 2, -1], [-1, 2, 1], [-1, 0, 1]), white)
    b.add_shape(mesh_mod.make_quad([1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1]), white)
    # ceiling (normal -y) so mirror-reflected photons land somewhere
    b.add_shape(mesh_mod.make_quad([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1]), white)
    # winding so cross(e1,e2) points -y (down toward the mirror floor)
    light = mesh_mod.make_quad([-0.3, 1.99, -0.3], [0.3, 1.99, -0.3],
                               [0.3, 1.99, 0.3], [-0.3, 1.99, 0.3])
    b.add_area_emitter_shape(light, lm, (10.0, 10.0, 10.0))
    cam = make_perspective(tf.look_at([0, 1, 3.5], [0, 1, 0], [0, 1, 0]), 50, 1.0)
    b.set_camera(cam, 8, 8)
    scene = b.build(backend="brute")
    surf_m, _ = shoot_photons_media(scene, no_medium(), 4000, 4, seed=0)
    assert surf_m[4].sum() > 10   # light -> mirror -> diffuse wall deposits


def test_bre_vs_volpath():
    """Beam estimate through homogeneous fog agrees with the volumetric
    path tracer on image mean (both unbiased-ish; loose gate)."""
    from mitsuba_jax.integrators.volpath import render_volpath

    scene = cornell_box(width=16, height=16)
    med = make_homogeneous((0.0012,) * 3, (0.0002,) * 3)
    cfg = PathConfig(max_depth=5, spp=2, remat=False)
    img_b, aux = bre_render(scene, med, cfg, n_photons=60_000,
                            n_march=24, seed=3)
    assert aux["n_volume_photons"] > 500
    img_v, _ = render_volpath(
        scene, med, PathConfig(max_depth=5, spp=48, remat=False), seed=5
    )
    # compare image INTERIORS: photon density estimates darken at box
    # edges/corners (gather discs clipped by adjacent walls — the same
    # artifact as the reference's kNN estimate near geometry boundaries;
    # the old full-image gate only passed because the hash-grid border
    # double-counting bug inflated wall pixels ~2x, see core/kdtree.py)
    inner = (slice(4, 12), slice(4, 12))
    a = float(jnp.mean(img_b[inner]))
    b = float(jnp.mean(img_v[inner]))
    assert np.isfinite(np.asarray(img_b)).all()
    assert a > 0
    assert abs(a - b) / b < 0.4, (a, b)
