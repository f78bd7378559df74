"""Environment emitters: lat-long image maps + Preetham sun/sky model.

Capability parity with reference src/luminaires/envmap.cpp (lat-long EXR
environment with luminance-weighted importance sampling) and
src/luminaires/sky.cpp:38-56 (Preetham analytic sky with turbidity).

The envmap sampler builds a Walker/Vose ALIAS TABLE over the flattened
texel distribution weighted by luminance·sin(theta); sampling is O(1):
two (N,)-gathers + a compare per lane. (The previous marginal/conditional
CDF scheme gathered a full (N, W) conditional row per lane and ran a
vmapped per-row searchsorted, a gather loop per lane. The alias table is
the wavefront replacement for the reference's per-call 2-D CDF walk.)
Directions use the reference's lat-long convention: v=0 at +z pole
(theta=0), u wraps phi in [0, 2pi).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from mitsuba_jax.core import math as m
from mitsuba_jax.core.spectrum import from_xyz


def latlong_dir_to_uv(d):
    """Unit direction → lat-long uv (reference envmap.cpp mapping)."""
    theta, phi = m.to_spherical(d)
    return jnp.stack([phi * m.INV_TWOPI, theta / jnp.pi], axis=-1)


def latlong_uv_to_dir(uv):
    theta = uv[..., 1] * jnp.pi
    phi = uv[..., 0] * 2.0 * jnp.pi
    return m.spherical_direction(theta, phi)


def _vose_alias(w):
    """Walker/Vose alias table for weights w (K,): returns (prob (K,) f64,
    alias (K,) i64) s.t. picking k = floor(u*K) and branching to alias[k]
    when the in-bin remainder exceeds prob[k] samples ∝ w exactly."""
    k = w.size
    p = w / w.sum() * k
    prob = np.ones(k)
    alias = np.arange(k, dtype=np.int64)
    small = [i for i in range(k) if p[i] < 1.0]
    large = [i for i in range(k) if p[i] >= 1.0]
    p = p.copy()
    while small and large:
        s_i = small.pop()
        l_i = large.pop()
        prob[s_i] = p[s_i]
        alias[s_i] = l_i
        p[l_i] = (p[l_i] + p[s_i]) - 1.0
        (small if p[l_i] < 1.0 else large).append(l_i)
    for i in large + small:
        prob[i] = 1.0
    return prob, alias


def build_env_cdfs(image):
    """Luminance·sinθ-weighted sampling tables for an (H, W, 3) envmap.

    Returns (prob (H*W,), alias (H*W,), pdf_image (H, W)) — a flat alias
    table over texels plus the solid-angle pdf of each texel's
    direction."""
    img = np.asarray(image, np.float64)
    h, w = img.shape[:2]
    lum = 0.212671 * img[..., 0] + 0.71516 * img[..., 1] + 0.072169 * img[..., 2]
    theta = (np.arange(h) + 0.5) / h * np.pi
    weight = np.maximum(lum, 0.0) * np.sin(theta)[:, None]
    total = weight.sum()
    if total <= 0:
        weight = np.ones_like(weight)
        total = weight.sum()
    prob, alias = _vose_alias(weight.reshape(-1))
    # pixel solid angle: (2pi/w)(pi/h) sin(theta)
    pix_sa = (2 * np.pi / w) * (np.pi / h) * np.sin(theta)[:, None]
    pdf_img = (weight / total) / np.maximum(pix_sa, 1e-12)
    return (
        prob.astype(np.float32),
        alias.astype(np.int32),
        pdf_img.astype(np.float32),
    )


def env_eval(image, d, to_env=None, scale=1.0):
    """Bilinear radiance lookup for directions d (world).

    Gathers through FLAT single-index rows of the (H*W, 3) image — a
    2-D advanced-index gather (two index vectors) lowers to a slower
    XLA gather than one flat row-gather."""
    if to_env is not None:
        from mitsuba_jax.core import transform as tf
        d = tf.apply_vector(to_env, d)
    uv = latlong_dir_to_uv(d)
    h, w = image.shape[0], image.shape[1]
    flat = image.reshape(h * w, -1)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi0 = jnp.mod(x0.astype(jnp.int32), w)
    xi1 = jnp.mod(x0.astype(jnp.int32) + 1, w)
    yi0 = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    yi1 = jnp.clip(y0.astype(jnp.int32) + 1, 0, h - 1)
    c = (
        flat[yi0 * w + xi0] * (1 - fx) * (1 - fy)
        + flat[yi0 * w + xi1] * fx * (1 - fy)
        + flat[yi1 * w + xi0] * (1 - fx) * fy
        + flat[yi1 * w + xi1] * fx * fy
    )
    return c * scale


def env_sample(prob, alias, pdf_img, u2, from_env=None, image=None):
    """Sample directions ∝ luminance·sinθ via the flat alias table:
    O(1) per lane — two gathers and a compare. Returns (d_world,
    pdf_sa) or, when `image` is given, (d_world, pdf_sa, radiance).

    The sampled direction is the TEXEL CENTER, where the bilinear
    env_eval mathematically degenerates to the texel value (fx = fy = 0)
    — so the NEE radiance is ONE flat (H*W, 3) row-gather at the
    already-computed texel index, replacing env_eval(image, d)'s 4
    corner gathers and its roundtrip-error-prone dir→uv trig pass
    (whose fx, fy land at small nonzero epsilon, so the two paths can
    differ in the last ulp; this single-gather value is the one
    consistent with pdf_img[idx])."""
    h, w = pdf_img.shape
    hw = h * w
    x = jnp.clip(u2[..., 0], 0.0, 1.0 - 1e-7) * hw
    k = jnp.clip(x.astype(jnp.int32), 0, hw - 1)
    frac = x - k.astype(jnp.float32)
    # packed rows: [prob | alias] gathered ONCE at k, then
    # [pdf | r g b] ONCE at idx — 2 row-gathers instead of 4 flat
    # gathers (per-index cost dominates, so channels ride along
    # almost free; the concats are loop-invariant scene
    # constants that XLA hoists out of the bounce scan)
    pa = jnp.concatenate(
        [prob[:, None],
         jax.lax.bitcast_convert_type(alias, jnp.float32)[:, None]],
        axis=1)[k]
    idx = jnp.where(frac < pa[..., 0],
                    k, jax.lax.bitcast_convert_type(pa[..., 1],
                                                    jnp.int32))
    row = idx // w
    col = idx % w
    uv = jnp.stack([(col + 0.5) / w, (row + 0.5) / h], axis=-1)
    d = latlong_uv_to_dir(uv)
    if from_env is not None:
        from mitsuba_jax.core import transform as tf
        d = tf.apply_vector(from_env, d)
    if image is not None:
        pv = jnp.concatenate([pdf_img.reshape(hw, 1),
                              image.reshape(hw, -1)], axis=1)[idx]
        return d, pv[..., 0], pv[..., 1:]
    return d, pdf_img.reshape(-1)[idx]


def env_eval_pdf(image, pdf_img, d, to_env=None):
    """Fused bilinear radiance + nearest-texel sampling pdf for world
    directions d — one dir→uv trig roundtrip and one shared index
    computation instead of env_eval + env_pdf's two (the escape block
    evaluates both for every lane every bounce). Bit-identical to
    (env_eval(image, d, to_env), env_pdf(pdf_img, d, to_env))."""
    if to_env is not None:
        from mitsuba_jax.core import transform as tf
        d = tf.apply_vector(to_env, d)
    uv = latlong_dir_to_uv(d)
    h, w = image.shape[0], image.shape[1]
    hp, wp = pdf_img.shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi0 = jnp.mod(x0.astype(jnp.int32), w)
    xi1 = jnp.mod(x0.astype(jnp.int32) + 1, w)
    yi0 = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    yi1 = jnp.clip(y0.astype(jnp.int32) + 1, 0, h - 1)
    if (hp, wp) == (h, w):
        # pdf rides the 4 corner gathers as a packed 4th channel: the
        # nearest texel (colp = floor(uv*w) = the nearer bilinear
        # corner, incl. at the wrap seam and clipped poles) is always
        # one of the corners, so selecting its pdf value by the
        # bilinear fractions replaces the 5th (N,)-gather
        flat = jnp.concatenate([image.reshape(h * w, -1),
                                pdf_img.reshape(h * w, 1)], axis=1)
        c00 = flat[yi0 * w + xi0]
        c10 = flat[yi0 * w + xi1]
        c01 = flat[yi1 * w + xi0]
        c11 = flat[yi1 * w + xi1]
        c = (c00[..., :3] * (1 - fx) * (1 - fy)
             + c10[..., :3] * fx * (1 - fy)
             + c01[..., :3] * (1 - fx) * fy
             + c11[..., :3] * fx * fy)
        right = fx[..., 0] >= 0.5
        down = fy[..., 0] >= 0.5
        pdf = jnp.where(
            down, jnp.where(right, c11[..., 3], c01[..., 3]),
            jnp.where(right, c10[..., 3], c00[..., 3]))
        return c, pdf
    flat = image.reshape(h * w, -1)
    c = (
        flat[yi0 * w + xi0] * (1 - fx) * (1 - fy)
        + flat[yi0 * w + xi1] * fx * (1 - fy)
        + flat[yi1 * w + xi0] * (1 - fx) * fy
        + flat[yi1 * w + xi1] * fx * fy
    )
    colp = jnp.clip((uv[..., 0] * wp).astype(jnp.int32), 0, wp - 1)
    rowp = jnp.clip((uv[..., 1] * hp).astype(jnp.int32), 0, hp - 1)
    pdf = pdf_img.reshape(-1)[rowp * wp + colp]
    return c, pdf


def env_pdf(pdf_img, d, to_env=None):
    """Solid-angle pdf of env_sample for given world directions."""
    if to_env is not None:
        from mitsuba_jax.core import transform as tf
        d = tf.apply_vector(to_env, d)
    uv = latlong_dir_to_uv(d)
    h, w = pdf_img.shape
    col = jnp.clip((uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
    row = jnp.clip((uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
    return pdf_img.reshape(-1)[row * w + col]


# ---------------------------------------------------------------------------
# Preetham sun/sky (reference src/luminaires/sky.cpp)
# ---------------------------------------------------------------------------

def _perez(theta, gamma, a, b, c, d, e):
    cos_t = jnp.maximum(jnp.cos(theta), 1e-3)
    cg = jnp.cos(gamma)
    return (1.0 + a * jnp.exp(b / cos_t)) * (1.0 + c * jnp.exp(d * gamma) + e * cg * cg)


def preetham_sky(d_world, sun_dir, turbidity: float = 3.0, scale: float = 1.0,
                 extend_below: bool = True):
    """Preetham analytic sky radiance for world directions (y-up convention:
    zenith = +y, like the reference's default frame).  Returns linear RGB.

    sun_dir: unit direction TOWARD the sun.
    """
    t = turbidity
    sun_dir = m.normalize(jnp.asarray(sun_dir, jnp.float32))
    up = jnp.array([0.0, 1.0, 0.0])
    cos_theta = jnp.clip(m.dot(d_world, up), -1.0, 1.0)
    theta = jnp.arccos(jnp.clip(jnp.abs(cos_theta), 1e-4, 1.0))
    cos_gamma = jnp.clip(m.dot(d_world, sun_dir), -1.0, 1.0)
    gamma = jnp.arccos(cos_gamma)
    theta_s = jnp.arccos(jnp.clip(m.dot(sun_dir, up), 0.0, 1.0))

    # zenith values (Preetham A.2)
    chi = (4.0 / 9.0 - t / 120.0) * (jnp.pi - 2.0 * theta_s)
    yz = (4.0453 * t - 4.9710) * jnp.tan(chi) - 0.2155 * t + 2.4192  # kcd/m^2
    t2 = t * t
    ts = theta_s
    ts2, ts3 = ts * ts, ts * ts * ts
    xz = (
        (0.00166 * ts3 - 0.00375 * ts2 + 0.00209 * ts) * t2
        + (-0.02903 * ts3 + 0.06377 * ts2 - 0.03202 * ts + 0.00394) * t
        + (0.11693 * ts3 - 0.21196 * ts2 + 0.06052 * ts + 0.25886)
    )
    yz_c = (
        (0.00275 * ts3 - 0.00610 * ts2 + 0.00317 * ts) * t2
        + (-0.04214 * ts3 + 0.08970 * ts2 - 0.04153 * ts + 0.00516) * t
        + (0.15346 * ts3 - 0.26756 * ts2 + 0.06670 * ts + 0.26688)
    )

    # Perez coefficients (Preetham A.1)
    ay, by, cy, dy, ey = (
        0.1787 * t - 1.4630, -0.3554 * t + 0.4275, -0.0227 * t + 5.3251,
        0.1206 * t - 2.5771, -0.0670 * t + 0.3703,
    )
    ax, bx, cx, dx, ex = (
        -0.0193 * t - 0.2592, -0.0665 * t + 0.0008, -0.0004 * t + 0.2125,
        -0.0641 * t - 0.8989, -0.0033 * t + 0.0452,
    )
    ayc, byc, cyc, dyc, eyc = (
        -0.0167 * t - 0.2608, -0.0950 * t + 0.0092, -0.0079 * t + 0.2102,
        -0.0441 * t - 1.6537, -0.0109 * t + 0.0529,
    )

    def ratio(a, b, c, d, e):
        return _perez(theta, gamma, a, b, c, d, e) / jnp.maximum(
            _perez(jnp.zeros_like(theta), theta_s, a, b, c, d, e), 1e-6
        )

    yy = yz * ratio(ay, by, cy, dy, ey) * 1000.0     # cd/m^2
    x = xz * ratio(ax, bx, cx, dx, ex)
    y = yz_c * ratio(ayc, byc, cyc, dyc, eyc)

    # xyY -> XYZ -> RGB; normalize so the output is in comfortable HDR units
    big_y = yy / 20000.0 * scale
    big_x = big_y / jnp.maximum(y, 1e-5) * x
    big_z = big_y / jnp.maximum(y, 1e-5) * (1.0 - x - y)
    rgb = from_xyz(jnp.stack([big_x, big_y, big_z], axis=-1))
    rgb = jnp.maximum(rgb, 0.0)
    if not extend_below:
        rgb = jnp.where((cos_theta > 0)[..., None], rgb, 0.0)
    return rgb
