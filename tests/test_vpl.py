"""VPL generation + instant-radiosity renderer vs the path tracer."""
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.integrators.path import PathConfig, render
from mitsuba_jax.integrators.vpl import generate_vpls, render_vpl
from mitsuba_jax.render.scene import cornell_box


def test_generate_vpls_structure():
    scene = cornell_box(width=8, height=8)
    vpls = generate_vpls(scene, n_paths=32, max_depth=3, seed=0)
    v = 32 * (1 + 3)
    assert vpls.p.shape == (v, 3)
    assert bool(vpls.is_lum[:32].all())
    assert not bool(vpls.is_lum[32:].any())
    # luminaire VPLs sit on the light (y near the ceiling, cornell scale)
    ly = np.asarray(vpls.p[:32, 1])
    assert (ly > 540).all()
    # surface VPL flux is finite and non-negative where valid
    fl = np.asarray(vpls.flux)
    assert np.isfinite(fl).all()
    assert (fl[np.asarray(vpls.valid)] >= 0).all()


def test_vpl_matches_path_direct_plus_indirect():
    """With many paths, VPL rendering approximates the path tracer at the
    same depth (clamping bias keeps this a loose comparison)."""
    scene = cornell_box(width=16, height=16)
    img_vpl, _ = render_vpl(
        scene, PathConfig(max_depth=2, spp=2, remat=False),
        n_paths=256, vpl_depth=2, clamp_dist=10.0, seed=1,
    )
    img_path, _ = render(
        scene, PathConfig(max_depth=3, spp=128, remat=False), seed=2
    )
    a = float(jnp.mean(img_vpl))
    b = float(jnp.mean(img_path))
    assert np.isfinite(np.asarray(img_vpl)).all()
    assert a > 0
    # means agree within 35% (VPL clamp removes some near-field energy)
    assert abs(a - b) / b < 0.35, (a, b)


def test_vpl_deterministic():
    scene = cornell_box(width=8, height=8)
    cfg = PathConfig(max_depth=2, spp=1, remat=False)
    i1, _ = render_vpl(scene, cfg, n_paths=32, seed=5)
    i2, _ = render_vpl(scene, cfg, n_paths=32, seed=5)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_vpl_preview():
    from mitsuba_jax.render.preview import vpl_preview

    scene = cornell_box(width=16, height=16)
    img = vpl_preview(scene, n_paths=32)
    a = np.asarray(img)
    assert a.shape == (16, 16, 3)
    assert np.isfinite(a).all()
    assert a.mean() > 0
