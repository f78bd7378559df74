"""Subsurface scattering end-to-end (VERDICT round-1 missing #1).

Reference: src/subsurface/dipole.cpp (Lo gather), irrproc.cpp (irradiance
samples), integrator hook in path tracers (its.hasSubsurface()).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_jax.core import transform as tf
from mitsuba_jax.integrators import PathConfig, render
from mitsuba_jax.render import mesh as mesh_mod
from mitsuba_jax.render.camera import make_perspective
from mitsuba_jax.render.scene import SceneBuilder
from mitsuba_jax.subsurface.dipole import dipole_rd, make_dipole


def _total_diffuse_reflectance(alpha_p, a_bc):
    """Classic closed form of integral 2 pi r Rd(r) dr (Jensen 2001 eq. 9)."""
    s = np.sqrt(3.0 * (1.0 - alpha_p))
    return (alpha_p / 2.0) * (1.0 + np.exp(-4.0 / 3.0 * a_bc * s)) * np.exp(-s)


def test_rd_integral_matches_closed_form():
    eta = 1.4
    p = make_dipole((2.0, 2.0, 2.0), (0.05, 0.05, 0.05), eta=eta)
    fdr = float(p.fdr)
    a_bc = (1.0 + fdr) / (1.0 - fdr)
    r = np.linspace(1e-4, 40.0, 200000)
    rd = np.asarray(dipole_rd(p, jnp.asarray(r)))[:, 0]
    num = np.trapezoid(rd * 2 * np.pi * r, r)
    ref = _total_diffuse_reflectance(float(p.alpha_p[0]), a_bc)
    assert abs(num - ref) / ref < 0.01, (num, ref)


def _plane_scene(with_sss, eta=1.0):
    b = SceneBuilder()
    mat = b.materials.lambertian((0.0, 0.0, 0.0))  # dark base: SSS dominates
    # plane at z=0, 40x40 units (mean free path ~0.4 units)
    quad = mesh_mod.make_quad((-20, -20, 0), (20, -20, 0), (20, 20, 0),
                              (-20, 20, 0))
    b.add_shape(quad, mat)
    if with_sss:
        b.add_subsurface(mat, sigma_s=(2.0,) * 3, sigma_a=(0.05,) * 3,
                         eta=eta, n_points=2048)
    b.emitters.directional((0, 0, -1), (1.0, 1.0, 1.0))
    cam = make_perspective(
        tf.look_at((0, 0, 8.0), (0, 0, 0), (0, 1, 0)), 40.0, 1.0)
    b.set_camera(cam, 16, 16)
    return b.build()


def test_plane_dipole_matches_total_reflectance():
    """eta=1 flat half-space under normal directional irradiance E:
    Lo = E * R / pi with R the closed-form total diffuse reflectance.
    Validates the full chain: point sampling -> NEE irradiance ->
    Rd gather -> integrator hook."""
    scene = _plane_scene(True, eta=1.0)
    img, _ = render(scene, PathConfig(max_depth=2, spp=8), seed=1)
    img = np.asarray(img)
    assert np.isfinite(img).all()
    # closed form with eta=1 boundary
    p = make_dipole((2.0,) * 3, (0.05,) * 3, eta=1.0)
    fdr = float(p.fdr)
    a_bc = (1.0 + fdr) / (1.0 - fdr)
    ref = _total_diffuse_reflectance(float(p.alpha_p[0]), a_bc) / np.pi
    center = img[6:10, 6:10].mean()
    assert abs(center - ref) / ref < 0.15, (center, ref)


def test_sss_visibly_contributes():
    s0 = _plane_scene(False)
    s1 = _plane_scene(True, eta=1.3)
    i0, _ = render(s0, PathConfig(max_depth=2, spp=4), seed=1)
    i1, _ = render(s1, PathConfig(max_depth=2, spp=4), seed=1)
    assert float(i1.mean()) > 10.0 * max(float(i0.mean()), 1e-6)


def test_xml_subsurface_scene():
    from mitsuba_jax.io.xml import load_scene_string

    xml = """<scene version="0.2.1">
      <camera type="perspective">
        <float name="fov" value="40"/>
        <transform name="toWorld">
          <lookAt ox="0" oy="0" oz="6" tx="0" ty="0" tz="0"
                  ux="0" uy="1" uz="0"/>
        </transform>
        <film type="exrfilm">
          <integer name="width" value="12"/>
          <integer name="height" value="12"/>
        </film>
      </camera>
      <shape type="obj">
        <string name="filename" value="quad.obj"/>
        <bsdf type="lambertian">
          <spectrum name="reflectance" value="0.05"/>
        </bsdf>
        <subsurface type="dipole">
          <spectrum name="sigmaS" value="2.0"/>
          <spectrum name="sigmaA" value="0.05"/>
          <float name="eta" value="1.3"/>
        </subsurface>
      </shape>
      <luminaire type="directional">
        <vector name="direction" x="0" y="0" z="-1"/>
        <spectrum name="intensity" value="1.0"/>
      </luminaire>
    </scene>"""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        with open(os.path.join(td, "quad.obj"), "w") as f:
            f.write("v -5 -5 0\nv 5 -5 0\nv 5 5 0\nv -5 5 0\n"
                    "f 1 2 3\nf 1 3 4\n")
        scene, rcfg = load_scene_string(xml, base_dir=td)
    assert scene.subsurface is not None
    assert scene.subsurface.n_entries == 1
    img, _ = render(scene, PathConfig(max_depth=2, spp=4), seed=0)
    img = np.asarray(img)
    assert np.isfinite(img).all()
    assert img.mean() > 0.02, img.mean()


def test_multipole_thick_slab_converges_to_dipole():
    """Scene-level multipole (pole-sum path): for a very thick slab the
    extra mirror poles vanish and the render must match the dipole render;
    for a thin slab it must lose energy (light leaks out the back —
    reference multipole.cpp motivation)."""
    def scene_with(profile, thickness=1e4):
        b = SceneBuilder()
        mat = b.materials.lambertian((0.0, 0.0, 0.0))
        quad = mesh_mod.make_quad((-20, -20, 0), (20, -20, 0), (20, 20, 0),
                                  (-20, 20, 0))
        b.add_shape(quad, mat)
        b.add_subsurface(mat, sigma_s=(2.0,) * 3, sigma_a=(0.05,) * 3,
                         eta=1.0, n_points=2048, profile=profile,
                         thickness=thickness)
        b.emitters.directional((0, 0, -1), (1.0, 1.0, 1.0))
        cam = make_perspective(
            tf.look_at((0, 0, 8.0), (0, 0, 0), (0, 1, 0)), 40.0, 1.0)
        b.set_camera(cam, 16, 16)
        return b.build()

    cfg = PathConfig(max_depth=2, spp=4)
    i_d, _ = render(scene_with("dipole"), cfg, seed=1)
    i_thick, _ = render(scene_with("multipole", 1e4), cfg, seed=1)
    i_thin, _ = render(scene_with("multipole", 0.3), cfg, seed=1)
    d = float(np.asarray(i_d)[6:10, 6:10].mean())
    thick = float(np.asarray(i_thick)[6:10, 6:10].mean())
    thin = float(np.asarray(i_thin)[6:10, 6:10].mean())
    assert abs(thick - d) / d < 0.02, (thick, d)
    assert thin < 0.8 * d, (thin, d)


def test_adipole_elongates_along_direction():
    """Scene-level adipole: a point-ish irradiance spot diffuses farther
    along the anisotropy direction than across it (fork adipole.cpp
    capability)."""
    from mitsuba_jax.core.types import replace as _replace

    b = SceneBuilder()
    mat = b.materials.lambertian((0.0, 0.0, 0.0))
    quad = mesh_mod.make_quad((-20, -20, 0), (20, -20, 0), (20, 20, 0),
                              (-20, 20, 0))
    b.add_shape(quad, mat)
    b.add_subsurface(mat, sigma_s=(2.0,) * 3, sigma_a=(0.2,) * 3,
                     eta=1.0, n_points=4096, profile="adipole",
                     aniso_dir=(1.0, 0.0, 0.0), aniso_ratio=3.0)
    b.emitters.directional((0, 0, -1), (1.0, 1.0, 1.0))
    cam = make_perspective(
        tf.look_at((0, 0, 8.0), (0, 0, 0), (0, 1, 0)), 40.0, 1.0)
    b.set_camera(cam, 33, 33)
    scene = b.build()

    # synthetic irradiance: one bright spot at the origin
    ss = scene.subsurface
    d2 = jnp.sum(ss.points[0] ** 2, axis=-1)
    spot = jnp.where(d2[:, None] < 0.5, 10.0, 0.0) * jnp.ones((1, 3))
    scene = _replace(scene, subsurface=_replace(ss, irradiance=spot[None]))
    img, _ = render(scene, PathConfig(max_depth=2, spp=4), seed=2)
    img = np.asarray(img)
    c = 16
    # radiance 6 pixels out along x (aniso dir) vs along y
    along = 0.5 * (img[c, c + 6].mean() + img[c, c - 6].mean())
    across = 0.5 * (img[c + 6, c].mean() + img[c - 6, c].mean())
    assert along > 1.5 * across, (along, across)
