"""Dipole BSSRDF: profile normalization + translucency behavior."""
import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core import transform as tf
from mitsuba_jax.render import mesh as mesh_mod
from mitsuba_jax.render.camera import make_perspective
from mitsuba_jax.render.scene import SceneBuilder
from mitsuba_jax.subsurface import (
    dipole_lo, dipole_rd, make_dipole, prepare_dipole,
)


def test_rd_total_reflectance():
    """∫ Rd(r) 2πr dr equals the classical dipole total diffuse reflectance
    for the given reduced albedo (Jensen 2001 eq. 5 closed form)."""
    p = make_dipole(sigma_s=(1.0,) * 3, sigma_a=(0.05,) * 3, eta=1.0)
    r = jnp.linspace(1e-3, 60.0, 200_000)
    dr = float(r[1] - r[0])
    rd = dipole_rd(p, r)                 # (R, 3)
    total = float((rd[:, 0] * 2 * np.pi * np.asarray(r)).sum() * dr)
    # closed form: Rd_total = a'/2 (1 + e^{-4/3 A sqrt(3(1-a'))}) e^{-sqrt(3(1-a'))}
    ap = float(p.alpha_p[0])
    a_bc = 1.0  # eta=1 -> Fdr=0? reference formula gives A=(1+Fdr)/(1-Fdr)
    s = np.sqrt(3 * (1 - ap))
    expect = ap / 2 * (1 + np.exp(-4.0 / 3.0 * a_bc * s)) * np.exp(-s)
    assert abs(total - expect) / expect < 0.08, (total, expect)


def test_rd_monotone_decreasing():
    p = make_dipole((2.0,) * 3, (0.1,) * 3)
    r = jnp.asarray([0.1, 0.5, 1.0, 2.0, 5.0])
    rd = np.asarray(dipole_rd(p, r))[:, 0]
    assert (np.diff(rd) < 0).all()


def _slab_scene():
    b = SceneBuilder()
    mat = b.materials.lambertian((0.0, 0.0, 0.0))
    lightm = b.materials.lambertian((0.0, 0.0, 0.0))
    # vertical slab in the x=0 plane; winding so the normal faces +x
    # (toward the light): cross(e1,e2) must point at +x
    slab = mesh_mod.make_quad([0, -1, -1], [0, 1, -1], [0, 1, 1], [0, -1, 1])
    b.add_shape(slab, mat)
    # light normal must face -x (toward the slab)
    light = mesh_mod.make_quad([3, -1, -1], [3, -1, 1], [3, 1, 1], [3, 1, -1])
    b.add_area_emitter_shape(light, lightm, (5.0, 5.0, 5.0))
    cam = make_perspective(tf.look_at([-3, 0, 0], [0, 0, 0], [0, 1, 0]), 40, 1.0)
    b.set_camera(cam, 8, 8)
    return b.build(backend="brute")


def test_dipole_translucency():
    """Irradiance arrives on the lit (+x) side; dipole transport must carry
    energy to query points on the shadow side."""
    scene = _slab_scene()
    p = make_dipole(sigma_s=(2.0,) * 3, sigma_a=(0.02,) * 3, eta=1.3)
    cache = prepare_dipole(scene, p, n_points=512, n_irr_samples=8, seed=0,
                           shape_id=0)
    # the slab's irradiance samples must see light
    assert float(cache.irradiance.mean()) > 0.05
    # query Lo on the dark side of the slab center vs far corner
    x_center = jnp.asarray([[0.0, 0.0, 0.0]])
    x_corner = jnp.asarray([[0.0, 0.95, 0.95]])
    wo_cos = jnp.asarray([1.0])
    lo_c = float(dipole_lo(cache, x_center, wo_cos)[0, 0])
    lo_k = float(dipole_lo(cache, x_corner, wo_cos)[0, 0])
    assert lo_c > 0.0
    assert lo_c > lo_k  # more surrounding material near the center
    # physical sanity: Lo below the incident radiance scale
    assert lo_c < 5.0


def test_multipole_thick_slab_converges_to_dipole():
    """For a very thick slab the multipole sum reduces to the dipole."""
    from mitsuba_jax.subsurface import multipole_rd

    p = make_dipole((2.0,) * 3, (0.1,) * 3)
    r = jnp.linspace(0.05, 3.0, 50)
    d = np.asarray(dipole_rd(p, r))
    m = np.asarray(multipole_rd(p, r, thickness=100.0, n_poles=3))
    np.testing.assert_allclose(m, d, rtol=1e-3, atol=1e-7)


def test_multipole_thin_slab_transmits():
    """A thin slab reflects LESS than the half-space dipole (light escapes
    through the back)."""
    from mitsuba_jax.subsurface import multipole_rd

    p = make_dipole((2.0,) * 3, (0.05,) * 3)
    r = jnp.linspace(0.05, 2.0, 40)
    thick = np.asarray(multipole_rd(p, r, thickness=100.0)).sum()
    thin = np.asarray(multipole_rd(p, r, thickness=0.3)).sum()
    assert thin < thick


def test_adipole_anisotropy():
    """Diffusion extends farther along the anisotropy axis."""
    from mitsuba_jax.subsurface import adipole_rd

    p = make_dipole((2.0,) * 3, (0.1,) * 3)
    axis = jnp.asarray([1.0, 0.0, 0.0])
    r_along = jnp.asarray([[1.0, 0.0, 0.0]])
    r_perp = jnp.asarray([[0.0, 1.0, 0.0]])
    v_along = float(adipole_rd(p, r_along, axis, aniso_ratio=2.0)[0, 0])
    v_perp = float(adipole_rd(p, r_perp, axis, aniso_ratio=2.0)[0, 0])
    assert v_along > v_perp


def test_indirect_irradiance_captured():
    """A one-sided emitter faces AWAY from the cache plane; light reaches
    it only after bouncing off a white ceiling. The direct-only
    estimator (round-3 state, indirect_depth=0) sees ~nothing; the
    integrator-backed estimate (reference dipole.cpp:362 samples via the
    scene integrator) must see the bounce light."""
    import jax.numpy as jnp
    import numpy as np

    from mitsuba_jax.render import mesh as mesh_mod
    from mitsuba_jax.render.scene import SceneBuilder
    from mitsuba_jax.render.camera import make_perspective
    from mitsuba_jax.core import transform as tf
    from mitsuba_jax.subsurface.dipole import compute_irradiance

    b = SceneBuilder()
    white = b.materials.lambertian((0.8, 0.8, 0.8))
    # emitter at y=1 facing +y (away from the floor below)
    b.add_area_emitter_shape(
        mesh_mod.make_quad([-0.4, 1.0, -0.4], [-0.4, 1.0, 0.4],
                           [0.4, 1.0, 0.4], [0.4, 1.0, -0.4]),
        white, (5.0, 5.0, 5.0))
    # white ceiling at y=2 facing down
    b.add_shape(mesh_mod.make_quad([-2, 2.0, -2], [2, 2.0, -2],
                                   [2, 2.0, 2], [-2, 2.0, 2]), white)
    cam = make_perspective(tf.look_at([0, 1, -3], [0, 0.5, 0], [0, 1, 0]),
                           fov_deg=45.0, aspect=1.0)
    b.set_camera(cam, 16, 16)
    scene = b.build(backend="bvh")

    pts = jnp.asarray(np.stack([np.linspace(-0.2, 0.2, 64),
                                np.zeros(64), np.zeros(64)], -1),
                      jnp.float32)
    nrm = jnp.asarray(np.tile([0.0, 1.0, 0.0], (64, 1)), jnp.float32)
    e_dir = compute_irradiance(scene, pts, nrm, n_samples=8,
                               indirect_depth=0)
    e_full = compute_irradiance(scene, pts, nrm, n_samples=8,
                                indirect_depth=3, n_indirect=32)
    dmean = float(jnp.mean(e_dir))
    fmean = float(jnp.mean(e_full))
    assert dmean < 1e-4, dmean          # emitter faces away: no direct
    assert fmean > 10 * max(dmean, 1e-6), (dmean, fmean)
