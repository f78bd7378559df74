"""Fresnel reflectance for dielectrics and conductors.

Capability parity with reference src/libcore/util.cpp
(fresnelDielectric/fresnel/fresnelConductor), vectorized over wavefronts.
"""
from __future__ import annotations

import jax.numpy as jnp

from mitsuba_jax.core.math import safe_sqrt


def fresnel_dielectric(cos_i, cos_t, eta_i, eta_t):
    """Unpolarized Fresnel reflectance given both angles (positive cosines)."""
    rs = (eta_i * cos_i - eta_t * cos_t) / (eta_i * cos_i + eta_t * cos_t)
    rp = (eta_t * cos_i - eta_i * cos_t) / (eta_t * cos_i + eta_i * cos_t)
    return 0.5 * (rs * rs + rp * rp)


def fresnel(cos_i, eta_ext, eta_int):
    """Fresnel reflectance handling incidence from either side.

    cos_i is signed (positive = outside). Returns reflectance in [0, 1];
    1.0 under total internal reflection.
    """
    entering = cos_i > 0.0
    eta_i = jnp.where(entering, eta_ext, eta_int)
    eta_t = jnp.where(entering, eta_int, eta_ext)
    abs_ci = jnp.abs(cos_i)
    sin2_t = (eta_i / eta_t) ** 2 * jnp.maximum(0.0, 1.0 - abs_ci * abs_ci)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    fr = fresnel_dielectric(abs_ci, cos_t, eta_i, eta_t)
    return jnp.where(tir, 1.0, fr)


def fresnel_dielectric_ext(cos_i, eta):
    """Convenience: reflectance + transmitted cosine for relative IOR eta.

    Returns (F, cos_t) where cos_t is the signed transmitted-side cosine
    (opposite sign to cos_i); cos_t = 0 under TIR.
    """
    entering = cos_i > 0.0
    rel_eta = jnp.where(entering, eta, 1.0 / eta)
    abs_ci = jnp.abs(cos_i)
    sin2_t = jnp.maximum(0.0, 1.0 - abs_ci * abs_ci) / (rel_eta * rel_eta)
    tir = sin2_t >= 1.0
    abs_ct = safe_sqrt(1.0 - sin2_t)
    fr = jnp.where(tir, 1.0, fresnel_dielectric(abs_ci, abs_ct, 1.0, rel_eta))
    cos_t = jnp.where(tir, 0.0, -jnp.sign(cos_i) * abs_ct)
    return fr, cos_t


def fresnel_conductor(cos_i, eta, k):
    """Unpolarized conductor Fresnel (per spectral channel).

    eta, k have a trailing spectrum axis; cos_i broadcasts from (...,).
    Matches reference util.cpp fresnelConductor.
    """
    ci = jnp.abs(jnp.asarray(cos_i))[..., None]
    ci2 = ci * ci
    tmp = (eta * eta + k * k) * ci2
    rs2 = (tmp - 2.0 * eta * ci + 1.0) / (tmp + 2.0 * eta * ci + 1.0)
    tmp2 = eta * eta + k * k
    rp2 = (tmp2 - 2.0 * eta * ci + ci2) / (tmp2 + 2.0 * eta * ci + ci2)
    return 0.5 * (rp2 + rs2)
