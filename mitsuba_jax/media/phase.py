"""Phase functions: isotropic, Henyey–Greenstein, Kajiya–Kay, microflake.

Capability parity with reference src/phase/ (isotropic.cpp, hg.cpp,
kajiyakay.cpp, microflake.cpp).  Conventions: wi points toward where the
light came FROM (backward along the incident ray), wo is the new outgoing
direction; cos_theta below is dot(-wi_ray_dir_convention)… concretely we
follow the reference: eval(wi_dir, wo) with wi_dir the propagation
direction of the incoming ray, so forward scattering means
dot(wi_dir, wo) ≈ +1.  pdfs are w.r.t. solid angle and equal eval (phase
functions are normalized densities).
"""
from __future__ import annotations

import jax.numpy as jnp

from mitsuba_jax.core import math as m
from mitsuba_jax.core import warp

ISOTROPIC, HG, KAJIYA_KAY, MICROFLAKE = 0, 1, 2, 3
MICROFLAKE_GAUSS = 4        # specular flakes, Gaussian fiber distribution


# ---------------------------------------------------------------------------
# Gaussian fiber distribution (reference src/phase/microflake_fiber.h:201
# GaussianFiberDistribution; the SIGGRAPH-2011 fabric/snow flake model).
# D(ω) = exp(-cos²θ/(2σ²)) / ((2π)^{3/2} σ erf(1/(√2 σ))): flake normals
# concentrated around the plane ⊥ to the fiber axis.
# ---------------------------------------------------------------------------

def _gauss_fiber_norm(stddev):
    import jax.scipy.special as jsp

    return 1.0 / ((2.0 * jnp.pi) ** 1.5 * stddev
                  * jsp.erf(1.0 / (jnp.sqrt(2.0) * stddev)))


def gauss_fiber_pdf_cos(cos_t, stddev):
    """Flake-normal density as a function of cosθ to the fiber axis."""
    return jnp.exp(-cos_t * cos_t / (2.0 * stddev * stddev)) \
        * _gauss_fiber_norm(stddev)


def gauss_fiber_sample_cos(xi, stddev):
    """Closed-form inverse-CDF sample of cosθ (the reference runs a Brent
    solver per sample, microflake_fiber.h:262 — erfinv gives the inverse
    directly, which is what a wavefront needs)."""
    import jax.scipy.special as jsp

    c1 = jsp.erf(1.0 / (jnp.sqrt(2.0) * stddev))
    return jnp.sqrt(2.0) * stddev * jsp.erfinv((1.0 - 2.0 * xi) * c1)


def fit_fiber_sigma_t(stddev: float, n_coeffs: int = 10,
                      n_theta: int = 181, n_quad: int = 256):
    """σ_t(θ_i) = ∫ D(ω) |ω·w_i| dω expanded in powers of sin θ_i — the
    reference's `mtsutil uflakefit` (src/utils/uflakefit.cpp) producing
    the fiberSigmaTCoeffs rows (microflake_fiber.h:55). Host-side: the
    azimuthal integral has the closed form
      ∫₀^{2π} |a + b cosφ| dφ = 2π|a|                      (|a| ≥ |b|)
                              = 4(√(b²-a²) + a·asin(a/|b|)) (|a| < |b|)
    with a = cosθ_h cosθ_i, b = sinθ_h sinθ_i, leaving one Gauss-Legendre
    quadrature over cosθ_h. Returns (coeffs (n_coeffs,), max_abs_err)."""
    import numpy as np
    from math import erf as _erf

    xg, wg = np.polynomial.legendre.leggauss(n_quad)  # cosθ_h ∈ [-L,L]
    # concentrate nodes on the gaussian's support: for small stddev the
    # density lives in |cosθ_h| < ~8σ and uniform [-1,1] nodes all miss it
    L = min(1.0, 10.0 * stddev)
    xg = xg * L
    wg = wg * L
    norm = 1.0 / ((2.0 * np.pi) ** 1.5 * stddev
                  * _erf(1.0 / (np.sqrt(2.0) * stddev)))
    d_cos = np.exp(-xg ** 2 / (2.0 * stddev ** 2)) * norm
    sin_h = np.sqrt(np.maximum(1.0 - xg ** 2, 0.0))
    theta_i = np.linspace(0.0, np.pi / 2, n_theta)
    sig = np.empty(n_theta)
    for k, ti in enumerate(theta_i):
        a = xg * np.cos(ti)
        b = sin_h * np.sin(ti)
        aa, ab = np.abs(a), np.abs(b)
        inner = np.where(
            aa >= ab, 2.0 * np.pi * aa,
            4.0 * (np.sqrt(np.maximum(ab * ab - a * a, 0.0))
                   + a * np.arcsin(np.clip(a / np.maximum(ab, 1e-300),
                                           -1, 1))))
        sig[k] = np.sum(wg * d_cos * inner)
    s = np.sin(theta_i)
    basis = np.stack([s ** i for i in range(n_coeffs)], axis=1)
    coeffs, *_ = np.linalg.lstsq(basis, sig, rcond=None)
    err = float(np.abs(basis @ coeffs - sig).max())
    return coeffs.astype(np.float32), err


def gauss_fiber_sigma_t(cos_t, coeffs):
    """σ_t(cosθ) from the fitted sin-power expansion (Horner — the
    wavefront-hot path, microflake_fiber.h:229 sigmaT)."""
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    acc = jnp.zeros_like(sin_t)
    for c in coeffs[::-1]:
        acc = acc * sin_t + c
    return acc


def _hg(cos_t, g):
    """cos_t = dot(propagation_dir, wo): forward peak at +1 for g>0.
    (The reference hg.cpp writes +2g·cosθ because its wi points TOWARD the
    source — opposite sign convention, same function.)"""
    denom = 1.0 + g * g - 2.0 * g * cos_t
    return m.INV_FOURPI * (1.0 - g * g) / jnp.power(jnp.maximum(denom, 1e-8), 1.5)


def phase_eval(kind: int, g, wi_dir, wo, fiber_axis=None,
               flake_coeffs=None):
    """Phase value (= pdf, normalized) for propagation dir wi_dir → wo.
    For MICROFLAKE_GAUSS, g carries the fiber stddev and flake_coeffs the
    fitted σ_t expansion (fit_fiber_sigma_t)."""
    if kind == ISOTROPIC:
        return jnp.full(wi_dir.shape[:-1], m.INV_FOURPI)
    if kind == MICROFLAKE_GAUSS:
        # reference microflake.cpp:74 f(): 0.5 D(h) / σ_t(cosθ_i), h the
        # half-vector of source-pointing wi and wo. Our wi_dir is the
        # propagation direction (= -wi_ref), so h ∝ wo - wi_dir.
        if flake_coeffs is None:
            raise ValueError("MICROFLAKE_GAUSS needs flake_coeffs "
                             "(fit_fiber_sigma_t)")
        axis = fiber_axis if fiber_axis is not None else jnp.broadcast_to(
            jnp.array([0.0, 0.0, 1.0]), wi_dir.shape
        )
        h = wo - wi_dir
        hl = jnp.sqrt(jnp.maximum(jnp.sum(h * h, axis=-1), 1e-20))
        cos_h = jnp.sum(h * axis, axis=-1) / hl
        cos_i = -jnp.sum(wi_dir * axis, axis=-1)
        sig = gauss_fiber_sigma_t(cos_i, flake_coeffs)
        return 0.5 * gauss_fiber_pdf_cos(cos_h, g) \
            / jnp.maximum(sig, 1e-6)
    if kind == HG:
        return _hg(m.dot(wi_dir, wo), g)
    if kind == KAJIYA_KAY:
        # reference kajiyakay.cpp: scattering about the local fiber axis;
        # normalized sin-lobe around the axis-orthogonal plane
        axis = fiber_axis if fiber_axis is not None else jnp.broadcast_to(
            jnp.array([0.0, 0.0, 1.0]), wi_dir.shape
        )
        cos_o = m.dot(axis, wo)
        sin_o = jnp.sqrt(jnp.maximum(1.0 - cos_o * cos_o, 0.0))
        # normalization: int sin(theta_axis) dω = pi^2 -> p = sin / pi^2... use
        # exact: ∫ sinθ dω = 2π·∫ sin²θ dθ = π² ⇒ pdf = sinθ/π²
        return sin_o / (jnp.pi * jnp.pi)
    if kind == MICROFLAKE:
        # sin^2-distributed flakes (fiber-like) — normalized sin² lobe:
        # ∫ sin²θ dω = 2π·(4/3)·... = 8π/3 ⇒ pdf = 3 sin²θ / (8π)
        axis = fiber_axis if fiber_axis is not None else jnp.broadcast_to(
            jnp.array([0.0, 0.0, 1.0]), wi_dir.shape
        )
        cos_o = m.dot(axis, wo)
        sin2 = jnp.maximum(1.0 - cos_o * cos_o, 0.0)
        return 3.0 * sin2 / (8.0 * jnp.pi)
    raise ValueError(kind)


def phase_pdf(kind: int, g, wi_dir, wo, fiber_axis=None,
              flake_coeffs=None):
    return phase_eval(kind, g, wi_dir, wo, fiber_axis, flake_coeffs)


def phase_sample(kind: int, g, wi_dir, u2, fiber_axis=None,
                 flake_coeffs=None):
    """Sample wo ~ phase(wi_dir, ·). Returns (wo, pdf). weight = 1 (exact).
    MICROFLAKE_GAUSS lanes that exhaust the rejection budget return
    pdf=0 (the reference's failure mode, microflake.cpp:130)."""
    if kind == ISOTROPIC:
        wo = warp.square_to_uniform_sphere(u2)
        return wo, jnp.full(wi_dir.shape[:-1], m.INV_FOURPI)
    if kind == MICROFLAKE_GAUSS:
        # reference microflake.cpp:97 sample(): draw flake normals
        # h ~ D, accept with probability |wi·h|, mirror-reflect. The
        # per-ray while-loop becomes K vectorized proposals per lane
        # (first accepted wins). Acceptance per proposal is E|wi·h| — for
        # wi nearly along the fiber axis of a tight distribution it
        # approaches σ, so lanes can exhaust the budget; they return
        # pdf=0, the reference's own failure mode after 1000 iterations
        # (microflake.cpp:130).
        import jax

        K = 64
        axis = fiber_axis if fiber_axis is not None else jnp.broadcast_to(
            jnp.array([0.0, 0.0, 1.0]), wi_dir.shape
        )
        # per-lane proposal stream derived from u2's bits: u2 itself is
        # counter-based per (seed, lane, dim), so the fold is
        # deterministic and replay-stable
        b = jax.lax.bitcast_convert_type(u2, jnp.uint32)
        base = jax.random.key(0x51AB)
        k1 = jax.vmap(jax.random.fold_in, (None, 0))(base, b[..., 0])
        k2 = jax.vmap(jax.random.fold_in)(k1, b[..., 1])
        u = jax.vmap(lambda k: jax.random.uniform(k, (K, 3)))(k2)
        cos_h = gauss_fiber_sample_cos(u[..., 0], g)            # (N,K)
        sin_h = jnp.sqrt(jnp.maximum(1.0 - cos_h * cos_h, 0.0))
        phi = 2.0 * jnp.pi * u[..., 1]
        fr = m.Frame.from_normal(axis)
        hx = sin_h * jnp.cos(phi)
        hy = sin_h * jnp.sin(phi)
        h = (hx[..., None] * fr.s[..., None, :]
             + hy[..., None] * fr.t[..., None, :]
             + cos_h[..., None] * fr.n[..., None, :])           # (N,K,3)
        wi_ref = -wi_dir
        dp = jnp.sum(wi_ref[..., None, :] * h, axis=-1)         # (N,K)
        accept = u[..., 2] < jnp.abs(dp)
        valid = jnp.any(accept, axis=-1)
        idx = jnp.argmax(accept, axis=-1)                       # first True
        hsel = jnp.take_along_axis(h, idx[..., None, None].repeat(3, -1),
                                   axis=-2)[..., 0, :]
        dpsel = jnp.take_along_axis(dp, idx[..., None], axis=-1)[..., 0]
        wo = 2.0 * dpsel[..., None] * hsel - wi_ref
        wo = jnp.where(valid[..., None], wo, wi_dir)
        pdf = phase_eval(kind, g, wi_dir, wo, fiber_axis, flake_coeffs)
        return wo, jnp.where(valid, pdf, 0.0)
    if kind == HG:
        g_safe = jnp.where(jnp.abs(g) < 1e-4, 1e-4, g)
        sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u2[..., 0])
        cos_t = jnp.where(
            jnp.abs(g) < 1e-4,
            1.0 - 2.0 * u2[..., 0],
            (1.0 + g * g - sqr * sqr) / (2.0 * g_safe),
        )
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        phi = 2.0 * jnp.pi * u2[..., 1]
        local = jnp.stack(
            [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1
        )
        frame = m.Frame.from_normal(wi_dir)
        wo = frame.to_world(local)
        return wo, _hg(m.dot(wi_dir, wo), g)
    if kind in (KAJIYA_KAY, MICROFLAKE):
        # sample via inversion of the sin / sin² marginal around the axis
        axis = fiber_axis if fiber_axis is not None else jnp.broadcast_to(
            jnp.array([0.0, 0.0, 1.0]), wi_dir.shape
        )
        u0 = u2[..., 0]
        if kind == KAJIYA_KAY:
            # marginal p(θ) = 2sin²θ/π, cdf(θ) = (θ - sinθcosθ)/π:
            # bisection (endpoint derivatives vanish, Newton is unstable)
            lo = jnp.zeros_like(u0)
            hi = jnp.full_like(u0, jnp.pi)
            for _ in range(24):
                mid = 0.5 * (lo + hi)
                cdf = (mid - jnp.sin(mid) * jnp.cos(mid)) / jnp.pi
                lo = jnp.where(cdf < u0, mid, lo)
                hi = jnp.where(cdf < u0, hi, mid)
            cos_t = jnp.cos(0.5 * (lo + hi))
        else:
            # sin²-lobe: cdf over c=cosθ decreasing: (c³/3 - c + 2/3)/(4/3)
            lo = jnp.full_like(u0, -1.0)
            hi = jnp.ones_like(u0)
            for _ in range(24):
                mid = 0.5 * (lo + hi)
                cdf = (mid ** 3 / 3.0 - mid + 2.0 / 3.0) / (4.0 / 3.0)
                # cdf decreases with c; want cdf(c) = u0
                hi = jnp.where(cdf < u0, mid, hi)
                lo = jnp.where(cdf < u0, lo, mid)
            cos_t = 0.5 * (lo + hi)
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        phi = 2.0 * jnp.pi * u2[..., 1]
        local = jnp.stack(
            [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1
        )
        frame = m.Frame.from_normal(axis)
        wo = frame.to_world(local)
        return wo, phase_eval(kind, g, wi_dir, wo, fiber_axis)
    raise ValueError(kind)
