"""Microfacet normal distributions: Beckmann, GGX, Phong.

Capability parity with the reference's microfacet/roughglass models
(src/bsdfs/microfacet.cpp, src/bsdfs/roughglass.cpp:776 — Beckmann/GGX/Phong
distributions with Smith shadowing).  All functions operate in the local
shading frame (+z = normal) and broadcast over wavefront axes.

Type codes (static ints, dispatched with jnp.where at trace time):
  BECKMANN = 0, GGX = 1, PHONG = 2
"""
from __future__ import annotations

import jax.numpy as jnp

from mitsuba_jax.core import math as m

BECKMANN, GGX, PHONG = 0, 1, 2


def _ct2(w):
    return jnp.clip(w[..., 2] * w[..., 2], 1e-12, 1.0)


def eval_d(dist_type: int, alpha, wh):
    """Microfacet distribution D(wh) for half-vector wh (upper hemisphere)."""
    ct = wh[..., 2]
    ct2 = _ct2(wh)
    t2 = (1.0 - ct2) / ct2  # tan^2 theta_h
    a2 = alpha * alpha
    if dist_type == BECKMANN:
        d = jnp.exp(-t2 / a2) / (jnp.pi * a2 * ct2 * ct2)
    elif dist_type == GGX:
        denom = jnp.pi * ct2 * ct2 * (a2 + t2) ** 2
        d = a2 / jnp.maximum(denom, 1e-20)
    elif dist_type == PHONG:
        # alpha here is the Phong exponent
        d = (alpha + 2.0) * m.INV_TWOPI * jnp.power(jnp.maximum(ct, 0.0), alpha)
    else:
        raise ValueError(dist_type)
    return jnp.where(ct > 0, d, 0.0)


def sample_wh(dist_type: int, alpha, sample):
    """Sample a half-vector ~ D(wh) |cos| ; returns (wh, pdf)."""
    u1, u2 = sample[..., 0], sample[..., 1]
    phi = 2.0 * jnp.pi * u2
    if dist_type == BECKMANN:
        log_u = jnp.log(jnp.maximum(1.0 - u1, 1e-20))
        t2 = -alpha * alpha * log_u
    elif dist_type == GGX:
        t2 = alpha * alpha * u1 / jnp.maximum(1.0 - u1, 1e-9)
    elif dist_type == PHONG:
        ct = jnp.power(jnp.maximum(u1, 1e-20), 1.0 / (alpha + 2.0))
        st = m.safe_sqrt(1.0 - ct * ct)
        wh = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)
        return wh, pdf_wh(dist_type, alpha, wh)
    else:
        raise ValueError(dist_type)
    ct = 1.0 / jnp.sqrt(1.0 + t2)
    st = m.safe_sqrt(1.0 - ct * ct)
    wh = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)
    return wh, pdf_wh(dist_type, alpha, wh)


def pdf_wh(dist_type: int, alpha, wh):
    """pdf of sample_wh w.r.t. solid angle: D(wh) * cos(theta_h)."""
    return eval_d(dist_type, alpha, wh) * jnp.maximum(wh[..., 2], 0.0)


def smith_g1(dist_type: int, alpha, w, wh):
    """Smith masking-shadowing for one direction (reference roughglass.cpp)."""
    ct = w[..., 2]
    tan_t = jnp.abs(m.tan_theta(w))
    # back-facing w.r.t. half vector -> fully shadowed
    backfacing = (m.dot(w, wh) * ct) <= 0
    if dist_type == BECKMANN or dist_type == PHONG:
        if dist_type == PHONG:
            eff_alpha = jnp.sqrt(2.0 / (alpha + 2.0))  # Walter exponent mapping
        else:
            eff_alpha = alpha
        a = 1.0 / jnp.maximum(eff_alpha * tan_t, 1e-20)
        g = jnp.where(
            a < 1.6,
            (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a),
            1.0,
        )
    elif dist_type == GGX:
        root = alpha * tan_t
        g = 2.0 / (1.0 + jnp.sqrt(1.0 + root * root))
    else:
        raise ValueError(dist_type)
    return jnp.where(backfacing, 0.0, g)


def smith_g(dist_type: int, alpha, wi, wo, wh):
    return smith_g1(dist_type, alpha, wi, wh) * smith_g1(dist_type, alpha, wo, wh)


def roughness_to_alpha(dist_type: int, roughness):
    """Map a user 'alpha/roughness' value to the internal parameter.

    For Phong, converts Beckmann-style roughness to an exponent
    (reference roughglass.cpp:176 transformation).
    """
    if dist_type == PHONG:
        return jnp.maximum(2.0 / (roughness * roughness) - 2.0, 0.1)
    return roughness
