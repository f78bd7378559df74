"""MIP pyramid + trilinear/anisotropic filtering (reference mipmap.h)."""
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.render.mipmap import (
    build_mipmap, eval_aniso, eval_trilinear, lod_from_duv,
)


def _checker(n=64):
    yy, xx = np.mgrid[0:n, 0:n]
    img = (((xx // 4) + (yy // 4)) % 2).astype(np.float32)
    return np.repeat(img[:, :, None], 3, 2)


def test_pyramid_structure_and_energy():
    mip = build_mipmap(_checker(64))
    assert mip.n_levels == 7                       # 64 -> 1
    assert mip.levels[0].shape == (64, 64, 3)
    assert mip.levels[-1].shape == (1, 1, 3)
    # box downsampling preserves the mean exactly at every level
    means = [float(jnp.mean(l)) for l in mip.levels]
    np.testing.assert_allclose(means, means[0], rtol=1e-6)
    np.testing.assert_allclose(means[-1], 0.5, atol=1e-6)


def test_non_pow2_resampled():
    mip = build_mipmap(np.ones((48, 20, 3), np.float32) * 0.25)
    assert mip.levels[0].shape == (64, 32, 3)
    np.testing.assert_allclose(np.asarray(mip.levels[0]), 0.25, atol=1e-6)


def test_trilinear_level_selection():
    """lod 0 reproduces the sharp checker; high lod converges to the
    0.5 average."""
    mip = build_mipmap(_checker(64))
    uv = jnp.asarray([[6.0 / 64, 1.0 - 2.0 / 64]])  # bright 4x4 cell ((1+0)%2==1)
    v0 = float(eval_trilinear(mip, uv, jnp.asarray([0.0]))[0, 0])
    v_hi = float(eval_trilinear(mip, uv, jnp.asarray([6.0]))[0, 0])
    assert v0 > 0.9
    assert abs(v_hi - 0.5) < 1e-5
    # halfway lod sits between its neighbours
    v3 = float(eval_trilinear(mip, uv, jnp.asarray([3.0]))[0, 0])
    v4 = float(eval_trilinear(mip, uv, jnp.asarray([4.0]))[0, 0])
    v35 = float(eval_trilinear(mip, uv, jnp.asarray([3.5]))[0, 0])
    lo, hi = min(v3, v4), max(v3, v4)
    assert lo - 1e-6 <= v35 <= hi + 1e-6


def test_lod_from_footprint():
    mip = build_mipmap(_checker(64))
    # one-texel footprint -> lod 0; 8-texel -> lod 3
    one = jnp.asarray([[1.0 / 64, 0.0]])
    zero = jnp.zeros((1, 2))
    assert abs(float(lod_from_duv(mip, one, zero)[0])) < 1e-5
    eight = jnp.asarray([[8.0 / 64, 0.0]])
    assert abs(float(lod_from_duv(mip, eight, zero)[0]) - 3.0) < 1e-5


def test_aniso_sharper_than_isotropic():
    """A footprint long in u but thin in v: anisotropic filtering must
    preserve v-variation that the isotropic (trilinear at major-axis lod)
    filter blurs away."""
    n = 64
    yy = np.mgrid[0:n, 0:n][0]
    stripes = ((yy // 8) % 2).astype(np.float32)     # horizontal stripes
    mip = build_mipmap(np.repeat(stripes[:, :, None], 3, 2))
    duv_dx = jnp.asarray([[16.0 / n, 0.0]])          # wide in u
    duv_dy = jnp.asarray([[0.0, 1.0 / n]])           # thin in v
    uv_bright = jnp.asarray([[0.5, 1.0 - 12.5 / n]])  # rows 8-15 are bright
    uv_dark = jnp.asarray([[0.5, 1.0 - 4.5 / n]])
    a_b = float(eval_aniso(mip, uv_bright, duv_dx, duv_dy, taps=8)[0, 0])
    a_d = float(eval_aniso(mip, uv_dark, duv_dx, duv_dy, taps=8)[0, 0])
    iso_lod = lod_from_duv(mip, duv_dx, duv_dy)
    i_b = float(eval_trilinear(mip, uv_bright, iso_lod)[0, 0])
    i_d = float(eval_trilinear(mip, uv_dark, iso_lod)[0, 0])
    assert (a_b - a_d) > 2.0 * (i_b - i_d)  # aniso keeps far more contrast
    assert (a_b - a_d) > 0.5


def test_eval_texture_mip_integration():
    """TextureBuilder(build_mips=True) + duv args -> filtered lookups."""
    from mitsuba_jax.render.texture import TextureBuilder, eval_texture

    tb = TextureBuilder(build_mips=True)
    tid = tb.bitmap(_checker(64), gamma=1.0)
    tex = tb.build()
    uv = jnp.asarray([[6.0 / 64, 1.0 - 2.0 / 64],     # bright cell
                      [2.0 / 64, 1.0 - 2.0 / 64]])    # dark cell
    ids = jnp.asarray([tid, tid], jnp.int32)
    sharp = eval_texture(tex, ids, uv)
    wide = jnp.full((2, 2), 0.5)     # half-texture footprint
    blurred = eval_texture(tex, ids, uv, duv_dx=wide, duv_dy=wide)
    # sharp lookup keeps checker contrast, filtered one is near the mean
    assert abs(float(sharp[0, 0]) - float(sharp[1, 0])) > 0.5
    np.testing.assert_allclose(np.asarray(blurred), 0.5, atol=0.05)


def test_path_tracer_ewa_aniso():
    """aniso_filter=True (EWA in the render path): on a grazing-view
    checker floor the anisotropic filter must keep more texture contrast
    than the isotropic ray-cone filter (which lods by the stretched major
    axis and overblurs), while still de-aliasing vs unfiltered and
    preserving energy."""
    import numpy as np

    from mitsuba_jax.core import transform as tf
    from mitsuba_jax.integrators.path import PathConfig, render
    from mitsuba_jax.render import mesh as mesh_mod
    from mitsuba_jax.render.camera import make_perspective
    from mitsuba_jax.render.scene import SceneBuilder

    b = SceneBuilder(build_mips=True)
    # stripes varying along v ONLY: v maps to the minor footprint axis on
    # this floor (major = view direction = u), so EWA keeps the stripes
    # while the isotropic filter (lod from the stretched major) blurs them
    n_tex = 128
    yy = np.mgrid[0:n_tex, 0:n_tex][0]
    stripes = ((yy // 4) % 2).astype(np.float32)
    tid = b.textures.bitmap(np.repeat(stripes[:, :, None], 3, 2),
                            gamma=1.0, uv_scale=(8.0, 8.0))
    floor = b.materials.lambertian((1.0, 1.0, 1.0), tex_id=tid)
    lm = b.materials.lambertian((0.0, 0.0, 0.0))
    b.add_shape(mesh_mod.make_quad([-50, 0, -50], [-50, 0, 50],
                                   [50, 0, 50], [50, 0, -50]), floor)
    light = mesh_mod.make_quad([-2, 8, -2], [2, 8, -2], [2, 8, 2],
                               [-2, 8, 2])
    b.add_area_emitter_shape(light, lm, (30.0, 30.0, 30.0))
    cam = make_perspective(tf.look_at([0, 1.2, 6], [0, 0.6, 0], [0, 1, 0]),
                           55, 1.0)
    b.set_camera(cam, 32, 32)
    scene = b.build(backend="brute")
    img_n, _ = render(scene, PathConfig(max_depth=2, spp=4, remat=False),
                      seed=0)
    img_m, _ = render(scene, PathConfig(max_depth=2, spp=4, remat=False,
                                        mip_filter=True), seed=0)
    img_a, _ = render(scene, PathConfig(max_depth=2, spp=4, remat=False,
                                        aniso_filter=True), seed=0)
    img_n, img_m, img_a = map(np.asarray, (img_n, img_m, img_a))
    assert np.isfinite(img_a).all()
    assert abs(img_a.mean() - img_n.mean()) / img_n.mean() < 0.12
    mid = slice(18, 30)
    # stripe contrast along image x within the band: aniso must keep
    # clearly more than the isotropic ray-cone filter
    def contrast(img):
        band = img[mid, :, 0]
        return float(np.std(band, axis=1).mean())
    assert contrast(img_a) > 1.3 * contrast(img_m), (
        contrast(img_a), contrast(img_m))
    assert abs(img_a[mid].mean() - img_m[mid].mean()) \
        / img_m[mid].mean() < 0.12


def test_path_tracer_ray_cone_mip():
    """mip_filter=True renders run and de-alias: with a high-frequency
    checker bitmap on the floor, distant pixels converge toward the mean
    instead of aliasing; image stays energy-consistent with bilinear."""
    import numpy as np

    from mitsuba_jax.core import transform as tf
    from mitsuba_jax.integrators.path import PathConfig, render
    from mitsuba_jax.render import mesh as mesh_mod
    from mitsuba_jax.render.camera import make_perspective
    from mitsuba_jax.render.scene import SceneBuilder

    b = SceneBuilder(build_mips=True)
    tid = b.tex_floor = b.textures.bitmap(_checker(128), gamma=1.0,
                                          uv_scale=(40.0, 40.0))
    floor = b.materials.lambertian((1.0, 1.0, 1.0), tex_id=tid)
    lm = b.materials.lambertian((0.0, 0.0, 0.0))
    # big floor receding to the horizon, light overhead
    b.add_shape(mesh_mod.make_quad([-50, 0, -50], [-50, 0, 50],
                                   [50, 0, 50], [50, 0, -50]), floor)
    light = mesh_mod.make_quad([-2, 8, -2], [2, 8, -2], [2, 8, 2], [-2, 8, 2])
    b.add_area_emitter_shape(light, lm, (30.0, 30.0, 30.0))
    cam = make_perspective(tf.look_at([0, 1.2, 6], [0, 0.6, 0], [0, 1, 0]),
                           55, 1.0)
    b.set_camera(cam, 32, 32)
    scene = b.build(backend="brute")
    cfg_n = PathConfig(max_depth=2, spp=2, remat=False, mip_filter=False)
    cfg_m = PathConfig(max_depth=2, spp=2, remat=False, mip_filter=True)
    img_n, _ = render(scene, cfg_n, seed=0)
    img_m, _ = render(scene, cfg_m, seed=0)
    img_n = np.asarray(img_n)
    img_m = np.asarray(img_m)
    assert np.isfinite(img_m).all()
    # energy preserved (box downsampling)
    assert abs(img_m.mean() - img_n.mean()) / img_n.mean() < 0.12
    # floor rows (horizon ~row 15 at this camera) lose checker aliasing
    # variance under mip filtering while keeping the mean
    far = slice(18, 30)
    assert img_m[far].std() < 0.5 * img_n[far].std(), (
        float(img_m[far].std()), float(img_n[far].std()))
    assert abs(img_m[far].mean() - img_n[far].mean()) / img_n[far].mean() < 0.12
