"""n-channel spectral rendering (VERDICT round-4 missing #3 / next #8):
SPECTRUM_SAMPLES != 3 as a table shape. Core conversions are gated by
round-trip/physics checks; the render path is gated by an n=8 furnace
render whose per-channel expectation is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_jax.core import spectral as sp


def test_rgb_round_trip_exact():
    """rgb -> n bins -> rgb is exact by construction for any n."""
    rng = np.random.default_rng(0)
    rgb = jnp.asarray(rng.random((32, 3)).astype(np.float32))
    for n in (8, 16, 32):
        bins = sp.from_rgb(rgb, sp.SpectralBins(n))
        back = sp.to_rgb(bins, sp.SpectralBins(n))
        np.testing.assert_allclose(np.asarray(back), np.asarray(rgb),
                                   rtol=2e-4, atol=2e-5)


def test_flat_spectrum_luminance():
    """A flat unit spectrum has Y = 1 (the reference normalizes toXYZ by
    the y-bar integral the same way)."""
    for n in (8, 64):
        spec = sp.SpectralBins(n)
        y = sp.luminance(jnp.ones(n), spec)
        assert abs(float(y) - 1.0) < 1e-5


def test_cie_fit_peaks():
    """Wyman-fit matching functions peak near the canonical wavelengths."""
    lam = np.linspace(380, 780, 2001)
    bar = sp.cie_xyz_bar(lam)
    assert abs(lam[np.argmax(bar[:, 1])] - 555) < 15    # y-bar
    assert abs(lam[np.argmax(bar[:, 2])] - 447) < 15    # z-bar


def test_blackbody_wien_shift():
    """Hotter blackbody peaks at shorter wavelengths; bins are positive."""
    spec = sp.SpectralBins(32)
    b3000 = np.asarray(sp.blackbody(3000.0, spec))
    b8000 = np.asarray(sp.blackbody(8000.0, spec))
    assert (b3000 > 0).all() and (b8000 > 0).all()
    c = spec.centers
    assert c[np.argmax(b8000)] < c[np.argmax(b3000)]
    # hotter is brighter at every wavelength (Planck monotonicity in T)
    assert (b8000 > b3000).all()


def test_from_continuous_flat():
    spec = sp.SpectralBins(8)
    v = sp.from_continuous(lambda lam: np.full_like(lam, 2.5), spec)
    np.testing.assert_allclose(np.asarray(v), 2.5, rtol=1e-6)


N_CH = 8


def _spectral_furnace(albedo, radiance):
    """Closed emitting lambertian sphere, camera inside — per-channel
    L = Le_c * sum_k a_c^k at depth D (test_render_e2e.furnace_scene
    generalized to n channels)."""
    from mitsuba_jax.core import transform as tf
    from mitsuba_jax.render import mesh as mesh_mod
    from mitsuba_jax.render.camera import make_perspective
    from mitsuba_jax.render.scene import SceneBuilder

    b = SceneBuilder()
    mat = b.materials.lambertian(tuple(albedo))
    sph = mesh_mod.make_sphere_mesh([0, 0, 0], 10.0, 24, 48)
    sph.faces = sph.faces[:, ::-1].copy()
    sph.normals = -sph.normals
    b.add_area_emitter_shape(sph, mat, tuple(radiance))
    cam = make_perspective(
        tf.look_at([0, 0, 0.01], [0, 0, 5], [0, 1, 0]), 40.0, 1.0)
    b.set_camera(cam, 16, 16)
    return b.build(backend="brute")


def test_furnace_render_n8():
    """Depth-3 furnace at n=8 channels with DISTINCT per-channel albedo
    and emission: every channel must independently match
    Le_c * (1 + a_c + a_c^2) — the whole wavefront loop (NEE, MIS,
    emitter hits, film) runs n-channel."""
    from mitsuba_jax.integrators.path import PathConfig, render

    rng = np.random.default_rng(5)
    a = 0.2 + 0.6 * rng.random(N_CH)
    le = 0.5 + rng.random(N_CH)
    scene = _spectral_furnace(a, le)
    assert scene.materials.reflectance.shape[-1] == N_CH
    img, _ = render(scene, PathConfig(max_depth=3, spp=96), seed=11)
    got = np.asarray(img).mean(axis=(0, 1))             # (N_CH,)
    want = le * (1.0 + a + a * a)
    np.testing.assert_allclose(got, want, rtol=0.05)


def test_rgb_scene_to_spectral_tables():
    """from_rgb upsampling feeds the material/emitter builders: a
    spectral furnace built from RGB values develops back to ~the RGB
    furnace result through to_rgb."""
    from mitsuba_jax.integrators.path import PathConfig, render

    spec = sp.SpectralBins(N_CH)
    a_rgb = np.array([0.7, 0.5, 0.3])
    le_rgb = np.array([1.0, 0.8, 0.6])
    a_sp = np.clip(np.asarray(sp.from_rgb(jnp.asarray(a_rgb), spec)),
                   0.0, 0.95)
    le_sp = np.maximum(
        np.asarray(sp.from_rgb(jnp.asarray(le_rgb), spec)), 0.0)
    scene = _spectral_furnace(a_sp, le_sp)
    img, _ = render(scene, PathConfig(max_depth=2, spp=64), seed=3)
    got_rgb = np.asarray(
        sp.to_rgb(jnp.asarray(np.asarray(img).mean(axis=(0, 1))), spec))
    # depth-2: L = Le + a*Le per channel, then project to RGB.
    want_sp = le_sp * (1.0 + a_sp)
    want_rgb = np.asarray(sp.to_rgb(jnp.asarray(want_sp), spec))
    np.testing.assert_allclose(got_rgb, want_rgb, rtol=0.06, atol=0.01)
