"""Smoke tests for off-default path-tracer knobs so negative-result
archaeology can't silently rot (VERDICT round-4 #6): every MTS_* knob
that switches a perf-critical code path gets one oracle-gated run in the
fast lane."""
import jax
import numpy as np


def test_glue_chunks_render_matches(monkeypatch):
    """MTS_GLUE_CHUNKS (chunked bounce glue with all-dead chunk skip)
    must not change the image: live chunks compute identically, dead
    chunks reproduce the masked body's outputs exactly."""
    from mitsuba_jax.integrators.path import PathConfig, render
    from mitsuba_jax.render.scene import cornell_box

    sc = cornell_box(16, 16, backend="cluster")
    cfg = PathConfig(max_depth=4, spp=2)
    monkeypatch.setenv("MTS_GLUE_CHUNKS", "1")
    jax.clear_caches()
    img0, _ = render(sc, cfg, seed=9)
    monkeypatch.setenv("MTS_GLUE_CHUNKS", "8")
    jax.clear_caches()
    try:
        img1, _ = render(sc, cfg, seed=9)
    finally:
        monkeypatch.delenv("MTS_GLUE_CHUNKS")
        jax.clear_caches()
    np.testing.assert_allclose(np.asarray(img0), np.asarray(img1),
                               rtol=1e-6, atol=1e-7)


def test_fusesort_render_matches(monkeypatch):
    """MTS_FUSESORT=1 (shared sort epoch for closest+shadow, measured
    slower on config-3 but kept for coherent scenes) must render
    identically — the fused path reorders queries, not results."""
    from mitsuba_jax.integrators.path import PathConfig, render
    from mitsuba_jax.render.scene import cornell_box

    sc = cornell_box(24, 24, backend="cluster")
    cfg = PathConfig(max_depth=3, spp=2)
    img0, _ = render(sc, cfg, seed=5)
    monkeypatch.setenv("MTS_FUSESORT", "1")
    jax.clear_caches()      # env is read at trace time in the bounce
    try:
        img1, _ = render(sc, cfg, seed=5)
    finally:
        monkeypatch.delenv("MTS_FUSESORT")
        jax.clear_caches()
    assert np.allclose(np.asarray(img0), np.asarray(img1),
                       rtol=1e-5, atol=1e-6)
