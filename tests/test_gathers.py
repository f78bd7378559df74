"""Material, emitter and medium parameter lookups are plain indexed
gathers: each lane gets its table row bit for bit, on every backend (a
float32 one-hot matrix product may run in TF32 on a GPU and round them)."""
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_jax.render.scene import cornell_box, cornell_box_specular


@pytest.mark.parametrize("make", [cornell_box, cornell_box_specular])
def test_material_gather_exact(make):
    mats = make(8, 8).materials
    m = mats.n_materials
    ids = np.concatenate([np.arange(-2, m + 2), np.arange(m)[::-1]])
    rows = mats.gather(jnp.asarray(ids, jnp.int32))
    clipped = np.clip(ids, 0, m - 1)
    for field, got in rows.items():
        want = np.asarray(getattr(mats, field))[clipped]
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=field)


def test_area_light_samples_lie_on_the_light():
    """sample_direct gathers the chosen light triangle's rows exactly: the
    sampled points sit on the Cornell light's plane y = 548.7."""
    from mitsuba_jax.emitters import sample_direct

    scene = cornell_box(8, 8)
    n = 4096
    rng = np.random.default_rng(0)
    p_ref = jnp.asarray(rng.uniform([100, 50, 100], [450, 400, 450],
                                    (n, 3)), jnp.float32)
    ds = sample_direct(scene.emitters, scene.geom, p_ref,
                       jnp.asarray(rng.uniform(size=n), jnp.float32),
                       jnp.asarray(rng.uniform(size=(n, 2)), jnp.float32))
    ok = np.asarray(ds.valid)
    assert ok.mean() > 0.9
    p = np.asarray(p_ref + ds.d * ds.dist[:, None])[ok]
    np.testing.assert_allclose(p[:, 1], 548.7, atol=2e-3)
    assert (p[:, 0] >= 213 - 1e-2).all() and (p[:, 0] <= 343 + 1e-2).all()


def test_medium_params_gather_exact():
    from mitsuba_jax.media.medium import make_medium_stack, stack_params

    stack = make_medium_stack([((0.5, 0.25, 0.125), (0.1, 0.2, 0.3), 0.3),
                               ((2.0, 1.0, 0.5), (0.0, 0.5, 1.0), -0.2)])
    cur = jnp.asarray([-1, 0, 1, 1, 0, -1], jnp.int32)
    ss, sa, g, inside = (np.asarray(x) for x in stack_params(stack, cur))
    k = np.clip(np.asarray(cur), 0, 1)
    ins = np.asarray(cur) >= 0
    np.testing.assert_array_equal(inside, ins)
    np.testing.assert_array_equal(
        ss, np.where(ins[:, None], np.asarray(stack.sigma_s)[k], 0.0))
    np.testing.assert_array_equal(
        sa, np.where(ins[:, None], np.asarray(stack.sigma_a)[k], 0.0))
    np.testing.assert_array_equal(
        g, np.where(ins, np.asarray(stack.phase_g)[k], 0.0))
