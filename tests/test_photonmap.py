"""Photon mapping: density estimate must agree with path tracing on the
diffuse Cornell box (the reference validates estimators against each other
the same way, ttest.cpp)."""
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_jax.integrators import PathConfig, render
from mitsuba_jax.integrators.photonmap import (
    photonmap_render, ppm_render, shoot_photons,
)
from mitsuba_jax.render.scene import cornell_box


def test_photon_shooting_conserves_energy():
    scene = cornell_box(16, 16)
    pos, power, din, nrm = shoot_photons(scene, 20_000, max_depth=4, seed=0)
    assert len(pos) > 20_000  # several bounces worth of deposits
    assert np.isfinite(power).all()
    # each photon carries the full emitted power (the estimator divides by
    # n): bounce-0 deposit = Le * pi * A_light (light 130x105, Le_r=18.4)
    em_power = 18.4 * (130 * 105) * np.pi
    first = power[:10_000, 0]      # deposits are bounce-major; bounce 0 first
    assert abs(first.mean() - em_power) / em_power < 0.05, (first.mean(), em_power)


def test_photonmap_matches_path_tracer():
    scene = cornell_box(20, 20)
    img_pm, aux = photonmap_render(
        scene, PathConfig(max_depth=4, spp=4, remat=False),
        n_photons=300_000, radius=5.0, seed=0,
    )
    # deeper PT baseline: a photon deposited at bounce k estimates a
    # camera+k-segment path, so photon depth 4 reaches PT depth ~6
    img_pt, _ = render(scene, PathConfig(max_depth=6, spp=32, remat=False), seed=1)
    a = np.asarray(img_pm)
    b = np.asarray(img_pt)
    assert np.isfinite(a).all()
    assert aux["n_deposits"] > 100_000
    lum_a = a.mean(-1)
    lum_b = b.mean(-1)
    cut = np.quantile(lum_b, 0.98)
    sel = lum_b < cut
    # brightness within 20% (residual density-estimation boundary bias)
    ratio = lum_a[sel].mean() / lum_b[sel].mean()
    assert 0.8 < ratio < 1.2, ratio
    # structure correlates
    corr = np.corrcoef(lum_a[sel], lum_b[sel])[0, 1]
    assert corr > 0.7, corr


def test_ppm_radius_shrinks_and_converges():
    scene = cornell_box(12, 12)
    img, aux = ppm_render(
        scene, PathConfig(max_depth=4, spp=2, remat=False),
        n_photons_per_pass=40_000, n_passes=3, seed=2,
    )
    assert np.isfinite(np.asarray(img)).all()
    assert aux["passes"] == 3


def test_photonmapper_final_gather_vs_path():
    """Full photon mapping (direct NEE + final gather) cross-validates
    against the path tracer (reference photonmapper.cpp mode)."""
    from mitsuba_jax.integrators.photonmap import photonmapper_render

    scene = cornell_box(width=16, height=16)
    img_pm, aux = photonmapper_render(
        scene, PathConfig(max_depth=4, spp=2, remat=False),
        n_photons=80_000, gather_samples=8, seed=2,
    )
    img_pt, _ = render(
        scene, PathConfig(max_depth=5, spp=64, remat=False), seed=7
    )
    a = float(jnp.mean(img_pm))
    b = float(jnp.mean(img_pt))
    assert np.isfinite(np.asarray(img_pm)).all()
    assert a > 0
    assert abs(a - b) / b < 0.30, (a, b)
