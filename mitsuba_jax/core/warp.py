"""Square → distribution warping functions with matching pdfs.

Capability parity with the reference's sampling toolbox
(src/libcore/util.cpp: squareToSphere/Hemisphere/HemispherePSA/Cone/Disk/
DiskConcentric/Triangle).  Every warp here comes with its pdf so the χ²
harness (core/chi2.py) can validate sample/pdf consistency, mirroring the
reference test strategy (include/mitsuba/core/chisquare.h).

All functions take uniform samples in [0,1)^2 with a trailing axis of 2 and
broadcast over leading axes. pdfs are w.r.t. solid angle unless noted.
"""
from __future__ import annotations

import jax.numpy as jnp

from mitsuba_jax.core.math import INV_FOURPI, INV_PI, INV_TWOPI, safe_sqrt


def square_to_uniform_sphere(sample):
    z = 1.0 - 2.0 * sample[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * sample[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def square_to_uniform_sphere_pdf(d):
    return jnp.full(d.shape[:-1], INV_FOURPI)


def square_to_uniform_hemisphere(sample):
    z = sample[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * sample[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def square_to_uniform_hemisphere_pdf(d):
    return jnp.where(d[..., 2] >= 0, INV_TWOPI, 0.0)


def square_to_cosine_hemisphere(sample):
    """PSA-weighted hemisphere (pdf = cos(theta)/pi), via concentric disk."""
    p = square_to_uniform_disk_concentric(sample)
    z = safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    return jnp.stack([p[..., 0], p[..., 1], z], axis=-1)


def square_to_cosine_hemisphere_pdf(d):
    return jnp.maximum(d[..., 2], 0.0) * INV_PI


def square_to_uniform_cone(cos_cutoff, sample):
    """Uniform direction in a cone around +z with cos(angle) >= cos_cutoff."""
    cos_theta = (1.0 - sample[..., 0]) + sample[..., 0] * cos_cutoff
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * jnp.pi * sample[..., 1]
    return jnp.stack(
        [jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, cos_theta], axis=-1
    )


def square_to_uniform_cone_pdf(cos_cutoff, d=None):
    pdf = 1.0 / (2.0 * jnp.pi * (1.0 - cos_cutoff))
    if d is None:
        return pdf
    return jnp.where(d[..., 2] >= cos_cutoff, pdf, 0.0)


def square_to_uniform_disk(sample):
    r = jnp.sqrt(sample[..., 0])
    phi = 2.0 * jnp.pi * sample[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def square_to_uniform_disk_concentric(sample):
    """Shirley's low-distortion concentric mapping — branchless variant."""
    ox = 2.0 * sample[..., 0] - 1.0
    oy = 2.0 * sample[..., 1] - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = jnp.abs(ox) > jnp.abs(oy)
    r = jnp.where(use_x, ox, oy)
    denom = jnp.where(use_x, jnp.where(ox == 0, 1.0, ox), jnp.where(oy == 0, 1.0, oy))
    ratio = jnp.where(use_x, oy, ox) / denom
    phi = jnp.where(
        use_x, (jnp.pi / 4.0) * ratio, (jnp.pi / 2.0) - (jnp.pi / 4.0) * ratio
    )
    r = jnp.where(zero, 0.0, r)
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def square_to_uniform_triangle(sample):
    """Uniform barycentric coordinates (reference util.cpp squareToTriangle)."""
    a = safe_sqrt(1.0 - sample[..., 0])
    return jnp.stack([1.0 - a, a * sample[..., 1]], axis=-1)


def square_to_std_normal(sample):
    """Box-Muller 2-D standard normal (used by gaussian-perturbation samplers)."""
    r = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(1.0 - sample[..., 0], 1e-20)))
    phi = 2.0 * jnp.pi * sample[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def interval_to_tent(sample):
    """[0,1] → tent distribution on [-1,1] (filter importance sampling)."""
    sign = jnp.where(sample < 0.5, 1.0, -1.0)
    s = jnp.where(sample < 0.5, 2.0 * sample, 2.0 - 2.0 * sample)
    return sign * (1.0 - safe_sqrt(s))
