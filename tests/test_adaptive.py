"""Adaptive errctrl-style sampling: converges, allocates more samples to
noisy pixels, and matches the plain estimator in expectation."""
import numpy as np

from mitsuba_jax.integrators import PathConfig, render
from mitsuba_jax.integrators.adaptive import adaptive_render
from mitsuba_jax.render.scene import cornell_box


def test_adaptive_converges_and_matches():
    scene = cornell_box(16, 16)
    cfg = PathConfig(max_depth=3, spp=8, remat=False)
    img_a, aux = adaptive_render(
        scene, cfg, max_error=0.25, max_sample_factor=6, seed=0
    )
    img_a = np.asarray(img_a)
    assert np.isfinite(img_a).all()
    assert 2 <= aux["passes"] <= 6
    cnt = np.asarray(aux["sample_count"])
    assert cnt.min() >= 2 * cfg.spp  # min_passes=2
    # reference render at high spp; compare robustly — the raw image mean is
    # dominated by the few direct-light pixels (radiance ~18 vs ~0.1)
    img_ref, _ = render(scene, PathConfig(max_depth=3, spp=64, remat=False), seed=9)
    r = np.asarray(img_ref)
    lum_a = img_a.mean(-1).ravel()
    lum_r = r.mean(-1).ravel()
    cut = np.quantile(lum_r, 0.98)
    sel = lum_r < cut
    a_m, r_m = lum_a[sel].mean(), lum_r[sel].mean()
    assert abs(a_m - r_m) / r_m < 0.08, (a_m, r_m)


def test_adaptive_allocates_where_noisy():
    scene = cornell_box(16, 16)
    cfg = PathConfig(max_depth=3, spp=4, remat=False)
    _, aux = adaptive_render(scene, cfg, max_error=0.1, max_sample_factor=8, seed=1)
    cnt = np.asarray(aux["sample_count"]).astype(float)
    # sample counts should vary spatially (not all pixels equally hard)
    assert cnt.max() > cnt.min()
