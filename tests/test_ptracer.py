"""Light tracing must agree with path tracing — the reference's
two-estimator consistency test (ttest utility, src/utils/ttest.cpp)."""
import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.integrators import PathConfig, render
from mitsuba_jax.integrators.ptracer import ptracer_render
from mitsuba_jax.render.scene import cornell_box


def test_ptracer_matches_path_tracer():
    scene = cornell_box(24, 24)
    pcfg = PathConfig(max_depth=4, spp=48, remat=False)
    img_pt, _ = render(scene, pcfg, seed=0)
    img_lt, _ = ptracer_render(
        scene, PathConfig(max_depth=4, remat=False), n_particles=400_000, seed=1
    )
    a, b = np.asarray(img_pt), np.asarray(img_lt)
    assert np.isfinite(b).all()
    # overall energy agreement
    assert abs(a.mean() - b.mean()) / a.mean() < 0.06, (a.mean(), b.mean())
    # correlation of the spatial structure (light tracing is noisy per-pixel)
    ca = a.mean(-1).ravel()
    cb = b.mean(-1).ravel()
    corr = np.corrcoef(ca, cb)[0, 1]
    assert corr > 0.9, corr


def test_ptracer_deterministic():
    scene = cornell_box(12, 12)
    cfg = PathConfig(max_depth=3, remat=False)
    i1, _ = ptracer_render(scene, cfg, n_particles=20_000, seed=7)
    i2, _ = ptracer_render(scene, cfg, n_particles=20_000, seed=7)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
