"""Aux subsystems: logging/stats/progress, animated transforms, checkpoints."""
import io

import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core import transform as tf
from mitsuba_jax.core.track import AnimatedTransform
from mitsuba_jax.utils.checkpoint import FilmCheckpoint, load_pytree, save_pytree
from mitsuba_jax.utils.logging import (
    LogLevel, Logger, ProgressReporter, Statistics,
)


def test_logger_levels_and_appenders():
    log = Logger(LogLevel.WARN)
    seen = []
    log.clear_appenders()
    log.add_appender(lambda lv, msg: seen.append((lv, msg)))
    log.info("hidden")
    log.warn("visible %d", 42, cls="Test")
    assert len(seen) == 1
    assert "visible 42" in seen[0][1] and "[Test]" in seen[0][1]


def test_statistics():
    st = Statistics()
    st.increment("Path tracer", "rays", 100)
    st.increment("Path tracer", "rays", 50)
    st.increment("Path tracer", "avg path length", 12, base=4)
    assert st.value("Path tracer", "rays") == 150
    out = io.StringIO()
    st.print_stats(out)
    assert "rays: 150" in out.getvalue()
    assert "avg path length: 3" in out.getvalue()


def test_progress_reporter():
    out = io.StringIO()
    pr = ProgressReporter("render", 10, stream=out, min_interval=0.0)
    pr.update(5)
    pr.finish()
    s = out.getvalue()
    assert "50.0%" in s and "100.0%" in s


def test_animated_transform_interpolation():
    at = AnimatedTransform()
    at.append_transform(0.0, np.asarray(tf.translate([0, 0, 0])))
    at.append_transform(1.0, np.asarray(tf.translate([2, 0, 0])))
    m = at.eval(jnp.asarray([0.0, 0.5, 1.0]))
    np.testing.assert_allclose(np.asarray(m)[:, 0, 3], [0, 1, 2], atol=1e-5)
    # rotation keys slerp: 0 -> 90 deg about z, eval at half = 45 deg
    at2 = AnimatedTransform()
    at2.append_transform(0.0, np.asarray(tf.rotate([0, 0, 1], 0)))
    at2.append_transform(1.0, np.asarray(tf.rotate([0, 0, 1], 90)))
    m45 = np.asarray(at2.eval(jnp.asarray(0.5)))
    expect = np.asarray(tf.rotate([0, 0, 1], 45))
    np.testing.assert_allclose(m45, expect, atol=1e-5)


def test_pytree_checkpoint_roundtrip(tmp_path):
    from mitsuba_jax.render.scene import cornell_box

    scene = cornell_box(8, 8)
    p = str(tmp_path / "scene.ckpt")
    save_pytree(p, scene)
    back = load_pytree(p, scene)
    np.testing.assert_array_equal(
        np.asarray(back.geom.v0), np.asarray(scene.geom.v0)
    )
    np.testing.assert_array_equal(
        np.asarray(back.materials.reflectance),
        np.asarray(scene.materials.reflectance),
    )
    assert back.width == scene.width


def test_film_checkpoint(tmp_path):
    fc = FilmCheckpoint(4, 4)
    img1 = np.full((4, 4, 3), 1.0)
    img2 = np.full((4, 4, 3), 3.0)
    fc.add_pass(img1, 8)
    p = str(tmp_path / "film.npz")
    fc.save(p)
    fc2 = FilmCheckpoint.load(p)
    fc2.add_pass(img2, 8)
    np.testing.assert_allclose(fc2.image, 2.0)
    assert fc2.count == 16


def test_progressive_preview_accumulates():
    from mitsuba_jax.integrators import PathConfig, render
    from mitsuba_jax.render.preview import progressive_render
    from mitsuba_jax.render.scene import cornell_box

    scene = cornell_box(12, 12)
    cfg = PathConfig(max_depth=2, spp=2, remat=False)
    frames = []
    img, fc = progressive_render(
        scene, cfg, n_passes=3,
        callback=lambda im, i, n, dt: frames.append((i, n)),
        seed=1,
    )
    assert [n for _, n in frames] == [2, 4, 6]
    # accumulated result equals the mean of the individual pass renders
    imgs = [np.asarray(render(scene, cfg, seed=1 * 7919 + i)[0]) for i in range(3)]
    np.testing.assert_allclose(np.asarray(img), np.mean(imgs, axis=0), atol=1e-5)
    # resume: 2 more passes starting from the checkpoint
    img2, fc2 = progressive_render(scene, cfg, n_passes=2, checkpoint=fc, seed=1)
    assert fc2.count == 10


def test_strict_normals_runs():
    from mitsuba_jax.integrators import PathConfig, render
    from mitsuba_jax.render.scene import cornell_box

    scene = cornell_box(10, 10)
    img, _ = render(scene, PathConfig(max_depth=3, spp=2, remat=False,
                                      strict_normals=True), seed=0)
    a = np.asarray(img)
    assert np.isfinite(a).all() and a.mean() > 0


# ---------------------------------------------------------------------------
# failure detection (utils/debug.py)
# ---------------------------------------------------------------------------

def test_checked_catches_nan():
    import jax
    import jax.numpy as jnp
    import pytest

    from mitsuba_jax.utils.debug import checked

    def bad(x):
        return jnp.log(x) / jnp.sqrt(x - 2.0)   # NaN for x in (0, 2)

    f = checked(jax.jit(bad))
    assert float(f(jnp.asarray(9.0))) > 0       # clean input passes
    with pytest.raises(Exception):
        f(jnp.asarray(1.0))


def test_assert_finite_reports_leaf_and_index():
    import numpy as np
    import pytest

    from mitsuba_jax.utils.debug import assert_finite, find_nonfinite

    tree = {"film": np.ones((4, 4)), "grad": np.array([1.0, np.nan, np.inf])}
    bad = find_nonfinite(tree)
    assert len(bad) == 1
    path, count, idx = bad[0]
    assert "grad" in path and count == 2 and idx[0] == (1,)
    with pytest.raises(FloatingPointError, match="grad"):
        assert_finite(tree)
    assert_finite({"x": np.zeros(3)})           # clean tree passes


def test_render_output_finite():
    """End-to-end film validation via assert_finite (checkify cannot gate
    full renders: masked multi-eval legitimately computes-then-discards
    NaN lanes — see utils/debug.py docstring)."""
    from mitsuba_jax.integrators.path import PathConfig, render
    from mitsuba_jax.render.scene import cornell_box
    from mitsuba_jax.utils.debug import assert_finite

    scene = cornell_box(width=8, height=8)
    cfg = PathConfig(max_depth=3, spp=2, remat=False)
    img, aux = render(scene, cfg, seed=0)
    assert_finite({"film": img, "aux": aux}, "render output")
