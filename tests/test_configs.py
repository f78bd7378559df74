"""The BASELINE.json benchmark configurations as render tests."""
import numpy as np
import jax
import jax.numpy as jnp

from mitsuba_jax.core.types import replace
from mitsuba_jax.integrators import PathConfig, render
from mitsuba_jax.render.scene import cornell_box_specular, textured_mesh_scene


def test_config2_specular_cornell():
    """Mirror + dielectric + rough conductor with MIS: finite, energy in a
    sane range, mirror block shows a reflection (non-black)."""
    scene = cornell_box_specular(48, 48)
    img, aux = render(scene, PathConfig(max_depth=8, spp=12, remat=False), seed=0)
    a = np.asarray(img)
    assert np.isfinite(a).all()
    assert 0.02 < a.mean() < 2.0
    # right side (mirror tall block region, x>0.5 of image) not black
    assert a[20:40, 8:20].mean() > 0.01
    assert float(aux["avg_path_length"]) > 2.0


def test_config3_textured_mesh_envmap():
    scene = textured_mesh_scene(40, 40)
    assert scene.geom.n_tris > 60_000, scene.geom.n_tris
    img, _ = render(scene, PathConfig(max_depth=3, spp=4, remat=False), seed=0)
    a = np.asarray(img)
    assert np.isfinite(a).all()
    assert a.mean() > 0.05
    # checkerboard floor: distinct bright/dark texels in the lower image
    floor = a[32:, :, :].mean(-1)
    assert floor.std() > 0.03


def test_config4_inverse_rendering_recovers_albedo():
    """Differentiable inverse rendering: recover a wall albedo by gradient
    descent on an MSE loss against a target render."""
    from mitsuba_jax.render.scene import cornell_box

    scene = cornell_box(16, 16)
    cfg = PathConfig(max_depth=3, spp=8, remat=True)
    true_refl = scene.materials.reflectance
    target, _ = render(scene, cfg, seed=0)

    # start from a wrong red-wall albedo (material 1)
    refl0 = true_refl.at[1].set(jnp.asarray([0.2, 0.4, 0.4]))

    def loss_fn(refl):
        sc = replace(scene, materials=replace(scene.materials, reflectance=refl))
        img, _ = render(sc, cfg, seed=0)
        return jnp.mean((img - target) ** 2)

    import optax

    opt = optax.adam(0.05)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    refl = refl0
    state = opt.init(refl)
    l0 = None
    for i in range(60):
        l, g = grad_fn(refl)
        if l0 is None:
            l0 = float(l)
        upd, state = opt.update(g, state)
        refl = jnp.clip(optax.apply_updates(refl, upd), 0.0, 1.0)
    err0 = float(jnp.abs(refl0[1] - true_refl[1]).mean())
    err1 = float(jnp.abs(refl[1] - true_refl[1]).mean())
    assert float(l) < 0.25 * l0, (l0, float(l))
    assert err1 < 0.25 * err0, (err0, err1)
