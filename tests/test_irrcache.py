"""Irradiance caching: coverage + agreement with path tracing."""
import numpy as np

from mitsuba_jax.integrators import PathConfig, render
from mitsuba_jax.integrators.irrcache import irrcache_render
from mitsuba_jax.render.scene import cornell_box


def test_irrcache_matches_path_tracer():
    scene = cornell_box(24, 24)
    img_ic, aux = irrcache_render(
        scene, PathConfig(max_depth=4, spp=4, remat=False),
        cache_res=48, hemi_samples=48, seed=0,
    )
    img_pt, _ = render(scene, PathConfig(max_depth=5, spp=32, remat=False), seed=1)
    a = np.asarray(img_ic).mean(-1)
    b = np.asarray(img_pt).mean(-1)
    assert np.isfinite(a).all()
    assert aux["coverage"] > 0.95
    cut = np.quantile(b, 0.98)
    sel = b < cut
    ratio = a[sel].mean() / b[sel].mean()
    assert 0.75 < ratio < 1.25, ratio
    corr = np.corrcoef(a[sel], b[sel])[0, 1]
    assert corr > 0.7, corr


def test_gradient_extrapolation_improves_interpolation():
    """Translational gradients (Ward, irrcache.h:226 — here via jax.jvp of
    the estimator) must reduce interpolation error against brute-force
    irradiance at off-record query points."""
    import jax.numpy as jnp

    from mitsuba_jax.integrators.irrcache import (
        build_irradiance_cache, interpolate_irradiance,
    )

    scene = cornell_box(width=16, height=16)
    cfg = PathConfig(max_depth=3, spp=1, remat=False)
    g_plain = build_irradiance_cache(scene, cfg, cache_res=12,
                                     hemi_samples=512, seed=0)
    g_grad = build_irradiance_cache(scene, cfg, cache_res=12,
                                    hemi_samples=512, seed=0, gradients=True)
    assert g_grad.payload.shape[1] == 24
    # gradients are finite and not all zero (light varies over the box)
    gr = np.asarray(g_grad.payload[:, 6:24])
    assert np.isfinite(gr).all()
    assert np.abs(gr).max() > 0
    # query halfway between records on the floor: compare both caches
    # against a dense reference cache (res x2)
    g_ref = build_irradiance_cache(scene, cfg, cache_res=24,
                                   hemi_samples=512, seed=1)
    extent = float(jnp.linalg.norm(
        jnp.max(g_plain.points, 0) - jnp.min(g_plain.points, 0)))
    radius = 0.08 * extent
    q = g_ref.points[::7]
    nq = g_ref.payload[::7, 3:6]
    e_ref = g_ref.payload[::7, 0:3]
    e_p, w_p = interpolate_irradiance(g_plain, q, nq, radius)
    e_g, w_g = interpolate_irradiance(g_grad, q, nq, radius)
    ok = np.asarray(w_p) > 1e-6
    err_p = np.abs(np.asarray(e_p) - np.asarray(e_ref))[ok].mean()
    err_g = np.abs(np.asarray(e_g) - np.asarray(e_ref))[ok].mean()
    # gradient extrapolation should not be worse; typically clearly better
    assert err_g < err_p * 1.02, (err_g, err_p)

def test_ward_gradients_match_analytic_rectangle_light():
    """Ward-Heckbert stratified gradients (reference HemisphereSampler,
    irrcache.h:42) vs the exact contour-integral irradiance gradient of an
    unoccluded rectangle light: translational <5%, rotational <10%."""
    import jax.numpy as jnp

    from mitsuba_jax.integrators.irrcache import (
        stratified_hemisphere, ward_gradients,
    )

    le = 10.0
    corners = np.array([[-0.5, 2.0, -0.5], [0.5, 2.0, -0.5],
                        [0.5, 2.0, 0.5], [-0.5, 2.0, 0.5]])

    def e_vec(x):
        d = corners - x
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        v = np.zeros(3)
        for i in range(4):
            a, b = d[i], d[(i + 1) % 4]
            th = np.arccos(np.clip(a @ b, -1, 1))
            u = np.cross(a, b)
            v += th * u / np.linalg.norm(u)
        v *= 0.5 * le
        return v if v[1] > 0 else -v

    m_t, n_p = 32, 64
    u = jnp.full((m_t, n_p), 0.5)
    d_loc = np.asarray(stratified_hemisphere(m_t, n_p, u, u))
    # frame: x_l->world x, y_l->world z, z_l->world y (floor normal +y)
    d_world = np.stack([d_loc[..., 0], d_loc[..., 2], d_loc[..., 1]], -1)
    for x0 in ([0.3, 0.0, 0.2], [-0.6, 0.0, 0.1], [0.0, 0.5, -0.4]):
        x0 = np.array(x0)
        t = (2.0 - x0[1]) / np.where(d_world[..., 1] > 1e-6,
                                     d_world[..., 1], np.nan)
        hp = x0 + t[..., None] * d_world
        on = ((np.abs(hp[..., 0]) <= 0.5) & (np.abs(hp[..., 2]) <= 0.5)
              & np.isfinite(t))
        L = np.where(on, le, 0.0)[..., None] * np.ones(3)
        r = np.where(on, t, 1e6)
        gt, gr = ward_gradients(jnp.asarray(L, jnp.float32),
                                jnp.asarray(r, jnp.float32), m_t, n_p)
        gt = np.asarray(gt)[0]
        gw = np.array([gt[0], 0.0, gt[1]])   # local->world
        h = 1e-3
        fd = np.array([
            (e_vec(x0 + [h, 0, 0])[1] - e_vec(x0 - [h, 0, 0])[1]) / (2 * h),
            0.0,
            (e_vec(x0 + [0, 0, h])[1] - e_vec(x0 - [0, 0, h])[1]) / (2 * h),
        ])
        assert np.linalg.norm(gw - fd) / np.linalg.norm(fd) < 0.05, (x0, gw, fd)
        # rotational: dE/deps about axis a = grad_r · a; analytic from the
        # (normal-independent) vector irradiance: E_vec·(a x n)
        gr0 = np.asarray(gr)[0]
        grw = np.array([gr0[0], 0.0, gr0[1]])
        ev = e_vec(x0)
        nw = np.array([0.0, 1.0, 0.0])
        for aw in (np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0])):
            exact = ev @ np.cross(aw, nw)
            got = grw @ aw
            assert abs(got - exact) < 0.10 * (abs(exact) + 0.05), (
                x0, aw, got, exact)


def test_irrcache_render_with_gradients():
    scene = cornell_box(width=16, height=16)
    cfg = PathConfig(max_depth=3, spp=1, remat=False)
    img, aux = irrcache_render(scene, cfg, cache_res=16, hemi_samples=32,
                               seed=0, gradients=True)
    assert np.isfinite(np.asarray(img)).all()
    assert float(np.asarray(img).mean()) > 0
    assert aux["coverage"] > 0.95
