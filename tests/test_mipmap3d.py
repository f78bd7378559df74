"""3-D MIP map line integrals (reference include/mitsuba/render/mipmap3d.h
SparseMipmap3D — NOTE: no in-tree consumer in the reference either; this
is the medium-utility capability)."""
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core.mipmap3d import (
    build_mipmap3d, invert_line_integral, line_integral,
)


def _const_mip(density=2.0, r=16):
    vol = np.full((r, r, r), density, np.float32)
    return build_mipmap3d(vol, (0, 0, 0), (1, 1, 1))


def test_pyramid_preserves_mean():
    rng = np.random.default_rng(0)
    vol = rng.uniform(0, 3, (16, 16, 16)).astype(np.float32)
    mip = build_mipmap3d(vol, (0, 0, 0), (2, 2, 2))
    assert mip.n_levels == 5
    for lv in mip.levels:
        np.testing.assert_allclose(float(jnp.mean(lv)), vol.mean(),
                                   rtol=1e-5)


def test_line_integral_constant_volume():
    """Axis ray through a constant-density unit cube: integral = rho * L
    exactly, at every level."""
    mip = _const_mip(2.0)
    o = jnp.asarray([[-1.0, 0.5, 0.5], [0.25, 0.5, 0.5]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    mint = jnp.zeros(2)
    maxt = jnp.asarray([jnp.inf, jnp.inf])
    for level in (0, 2):
        li = np.asarray(line_integral(mip, o, d, mint, maxt, level=level))
        np.testing.assert_allclose(li, [2.0 * 1.0, 2.0 * 0.75], rtol=2e-2)


def test_line_integral_diagonal_and_miss():
    mip = _const_mip(1.5)
    o = jnp.asarray([[-0.5, -0.5, -0.5], [2.0, 2.0, 0.5]])
    d0 = np.asarray([1.0, 1.0, 1.0]) / np.sqrt(3)
    d = jnp.asarray([d0, [1.0, 0.0, 0.0]])
    li = np.asarray(line_integral(mip, o, d, jnp.zeros(2),
                                  jnp.full(2, jnp.inf)))
    np.testing.assert_allclose(li[0], 1.5 * np.sqrt(3), rtol=2e-2)
    assert li[1] == 0.0                      # ray misses the volume


def test_invert_line_integral_roundtrip():
    """invert(desired) then integrate up to the returned t reproduces
    `desired`; infeasible targets report failure with the full integral."""
    rng = np.random.default_rng(1)
    vol = rng.uniform(0.5, 2.0, (16, 16, 16)).astype(np.float32)
    mip = build_mipmap3d(vol, (0, 0, 0), (1, 1, 1))
    o = jnp.asarray([[-0.5, 0.52, 0.47]] * 2)
    d = jnp.asarray([[1.0, 0.0, 0.0]] * 2)
    mint = jnp.zeros(2)
    maxt = jnp.full(2, jnp.inf)
    total = float(line_integral(mip, o, d, mint, maxt, n_steps=256)[0])
    desired = jnp.asarray([0.4 * total, 2.0 * total])
    ok, acc, t_s, dens = invert_line_integral(
        mip, o, d, mint, maxt, desired, n_steps=256)
    ok = np.asarray(ok)
    assert ok[0] and not ok[1]
    np.testing.assert_allclose(float(acc[1]), total, rtol=1e-5)
    # integrate back to the sampled t
    li = float(line_integral(mip, o, d, mint, jnp.full(2, float(t_s[0])),
                             n_steps=256)[0])
    np.testing.assert_allclose(li, 0.4 * total, rtol=3e-2)
    assert float(dens[0]) > 0
