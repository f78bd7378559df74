"""BSDF model implementations (local shading frame, batched over lanes).

Functional parity with the reference plugins (cited per function).  Each
model provides:
    eval(p, wi, wo)   -> fCos (N,3): f(wi,wo) * |cos_theta(wo)|
    pdf(p, wi, wo)    -> (N,) solid-angle density of sample()
    sample(p, wi, u2, u1) -> dict(wo, weight, pdf, delta, transmission, eta)
with p the per-lane gathered parameter dict (bsdfs/table.py).

Delta models return pdf=1 for the *discrete* event probability embedded in
weight, and eval/pdf = 0 (they can never be hit by the smooth strategies) —
exactly the reference's EDelta convention (bsdf.h:149).
"""
from __future__ import annotations

import jax.numpy as jnp

from mitsuba_jax.core import math as m
from mitsuba_jax.core import microfacet as mf
from mitsuba_jax.core import warp
from mitsuba_jax.core.fresnel import fresnel_conductor, fresnel_dielectric_ext
from mitsuba_jax.core.spectrum import luminance


def _both_upper(wi, wo):
    return (m.cos_theta(wi) > 0) & (m.cos_theta(wo) > 0)


def _mask3(mask, x):
    return jnp.where(mask[..., None], x, 0.0)


def _zero_sample(wi, c=3):
    n = wi.shape[0]
    return dict(
        wo=jnp.zeros_like(wi),
        weight=jnp.zeros((n, c)),
        pdf=jnp.zeros(n),
        delta=jnp.zeros(n, bool),
        transmission=jnp.zeros(n, bool),
        eta=jnp.ones(n),
        valid=jnp.zeros(n, bool),
    )


# ---------------------------------------------------------------------------
# Lambertian  (src/bsdfs/lambertian.cpp:204)
# ---------------------------------------------------------------------------

def lambertian_eval(p, wi, wo):
    f = p["reflectance"] * m.INV_PI * jnp.maximum(m.cos_theta(wo), 0.0)[..., None]
    return _mask3(_both_upper(wi, wo), f)


def lambertian_pdf(p, wi, wo):
    return jnp.where(_both_upper(wi, wo), warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def lambertian_sample(p, wi, u2, u1):
    wo = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    valid = (m.cos_theta(wi) > 0) & (pdf > 0)
    s = _zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, p["reflectance"]),
        pdf=jnp.where(valid, pdf, 0.0),
        valid=valid,
    )
    return s


# ---------------------------------------------------------------------------
# Smooth mirror  (src/bsdfs/mirror.cpp)
# ---------------------------------------------------------------------------

def mirror_eval(p, wi, wo):
    return jnp.zeros(wi.shape[:-1] + (p["reflectance"].shape[-1],))


def mirror_pdf(p, wi, wo):
    return jnp.zeros(wi.shape[:-1])


def mirror_sample(p, wi, u2, u1):
    wo = m.reflect_local(wi)
    valid = m.cos_theta(wi) > 0
    s = _zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, p["specular"]),
        pdf=jnp.where(valid, 1.0, 0.0),
        delta=valid,
        valid=valid,
    )
    return s


# ---------------------------------------------------------------------------
# Smooth dielectric  (src/bsdfs/dielectric.cpp)
# ---------------------------------------------------------------------------

def dielectric_eval(p, wi, wo):
    return jnp.zeros(wi.shape[:-1] + (p["reflectance"].shape[-1],))


def dielectric_pdf(p, wi, wo):
    return jnp.zeros(wi.shape[:-1])


def dielectric_sample(p, wi, u2, u1):
    eta = p["eta"]
    ci = m.cos_theta(wi)
    fr, cos_t = fresnel_dielectric_ext(ci, eta)
    reflect = u1 < fr
    wo_r = m.reflect_local(wi)
    rel_eta = jnp.where(ci > 0, eta, 1.0 / eta)
    # refracted direction in local frame (z-axis normal):
    scale = -1.0 / rel_eta
    wo_t = jnp.stack([wi[..., 0] * scale, wi[..., 1] * scale, cos_t], axis=-1)
    wo = jnp.where(reflect[..., None], wo_r, wo_t)
    # radiance transport: (1/eta)^2 compression on refraction
    # (reference dielectric.cpp sampleCos radiance scaling)
    t_scale = (1.0 / rel_eta) ** 2
    weight = jnp.where(
        reflect[..., None],
        p["specular"],
        p["transmittance"] * t_scale[..., None],
    )
    tir = cos_t == 0.0
    valid = jnp.where(reflect, True, ~tir)
    s = _zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, weight),
        pdf=jnp.where(valid, jnp.where(reflect, fr, 1.0 - fr), 0.0),
        delta=valid,
        transmission=valid & ~reflect,
        eta=jnp.where(reflect, 1.0, rel_eta),
        valid=valid,
    )
    # weight convention: f/pdf with the discrete prob folded in -> specular tint
    s["weight"] = jnp.where(valid[..., None], s["weight"], 0.0)
    s["pdf"] = jnp.where(valid, jnp.where(reflect, fr, 1.0 - fr), 0.0)
    return s


# ---------------------------------------------------------------------------
# Rough conductor — microfacet reflection (src/bsdfs/roughmetal.cpp,
# microfacet lobe of src/bsdfs/microfacet.cpp)
# ---------------------------------------------------------------------------

def _rough_conductor_terms(p, wi, wo):
    wh = m.normalize(wi + wo)
    dist = p["_dist_static"]
    alpha = p["alpha_u"]
    d = mf.eval_d(dist, alpha, wh)
    g = mf.smith_g(dist, alpha, wi, wo, wh)
    f = fresnel_conductor(m.dot(wi, wh), p["cond_eta"], p["cond_k"])
    return wh, d, g, f


def rough_conductor_eval(p, wi, wo):
    upper = _both_upper(wi, wo)
    wh, d, g, f = _rough_conductor_terms(p, wi, wo)
    ci = jnp.maximum(m.cos_theta(wi), 1e-6)
    spec = p["specular"] * f * (d * g / (4.0 * ci))[..., None]
    return _mask3(upper, spec)


def rough_conductor_pdf(p, wi, wo):
    upper = _both_upper(wi, wo)
    wh = m.normalize(wi + wo)
    pdf_h = mf.pdf_wh(p["_dist_static"], p["alpha_u"], wh)
    pdf = pdf_h / jnp.maximum(4.0 * jnp.abs(m.dot(wo, wh)), 1e-8)
    return jnp.where(upper, pdf, 0.0)


def rough_conductor_sample(p, wi, u2, u1):
    dist = p["_dist_static"]
    wh, pdf_h = mf.sample_wh(dist, p["alpha_u"], u2)
    wo = m.reflect(wi, wh)
    pdf = pdf_h / jnp.maximum(4.0 * jnp.abs(m.dot(wo, wh)), 1e-8)
    valid = _both_upper(wi, wo) & (pdf > 1e-12)
    fcos = rough_conductor_eval(p, wi, wo)
    s = _zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, fcos / jnp.maximum(pdf, 1e-12)[..., None]),
        pdf=jnp.where(valid, pdf, 0.0),
        valid=valid,
    )
    return s


# ---------------------------------------------------------------------------
# Modified Phong  (src/bsdfs/phong.cpp)
# ---------------------------------------------------------------------------

def _phong_weights(p):
    """Diffuse/specular lobe selection probabilities by luminance."""
    kd = luminance(p["reflectance"])
    ks = luminance(p["specular"])
    total = jnp.maximum(kd + ks, 1e-8)
    return ks / total


def phong_eval(p, wi, wo):
    upper = _both_upper(wi, wo)
    alpha = m.dot(wo, m.reflect_local(wi))
    n = p["exponent"]
    spec = p["specular"] * ((n + 2.0) * m.INV_TWOPI * jnp.power(jnp.maximum(alpha, 0.0), n))[..., None]
    diff = p["reflectance"] * m.INV_PI
    return _mask3(upper, (spec + diff) * jnp.maximum(m.cos_theta(wo), 0.0)[..., None])


def phong_pdf(p, wi, wo):
    upper = _both_upper(wi, wo)
    alpha = jnp.maximum(m.dot(wo, m.reflect_local(wi)), 0.0)
    n = p["exponent"]
    spec_prob = _phong_weights(p)
    pdf_spec = (n + 1.0) * m.INV_TWOPI * jnp.power(alpha, n)
    pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo)
    return jnp.where(upper, spec_prob * pdf_spec + (1.0 - spec_prob) * pdf_diff, 0.0)


def phong_sample(p, wi, u2, u1):
    spec_prob = _phong_weights(p)
    choose_spec = u1 < spec_prob
    # specular: sample cos^n lobe around the reflection direction
    n = p["exponent"]
    cos_a = jnp.power(jnp.maximum(u2[..., 0], 1e-20), 1.0 / (n + 1.0))
    sin_a = m.safe_sqrt(1.0 - cos_a * cos_a)
    phi = 2.0 * jnp.pi * u2[..., 1]
    lobe_local = jnp.stack(
        [sin_a * jnp.cos(phi), sin_a * jnp.sin(phi), cos_a], axis=-1
    )
    r = m.reflect_local(wi)
    frame = m.Frame.from_normal(r)
    wo_spec = frame.to_world(lobe_local)
    wo_diff = warp.square_to_cosine_hemisphere(u2)
    wo = jnp.where(choose_spec[..., None], wo_spec, wo_diff)
    pdf = phong_pdf(p, wi, wo)
    valid = _both_upper(wi, wo) & (pdf > 1e-10)
    fcos = phong_eval(p, wi, wo)
    s = _zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, fcos / jnp.maximum(pdf, 1e-10)[..., None]),
        pdf=jnp.where(valid, pdf, 0.0),
        valid=valid,
    )
    return s


# ---------------------------------------------------------------------------
# Anisotropic Ward  (src/bsdfs/ward.cpp, Walter's sampling notes)
# ---------------------------------------------------------------------------

def ward_eval(p, wi, wo):
    upper = _both_upper(wi, wo)
    au, av = p["alpha_u"], p["alpha_v"]
    ci = jnp.maximum(m.cos_theta(wi), 1e-6)
    co = jnp.maximum(m.cos_theta(wo), 1e-6)
    h = wi + wo
    hz2 = jnp.maximum(h[..., 2] * h[..., 2], 1e-12)
    exp_term = jnp.exp(-((h[..., 0] / au) ** 2 + (h[..., 1] / av) ** 2) / hz2)
    spec = p["specular"] * (
        exp_term / (4.0 * jnp.pi * au * av * jnp.sqrt(ci * co))
    )[..., None]
    diff = p["reflectance"] * m.INV_PI
    return _mask3(upper, (spec + diff) * co[..., None])


def _ward_pdf_h(p, wi, wo):
    """pdf of sampled wo through the half-vector (Walter PCG-05-06 eq.9)."""
    au, av = p["alpha_u"], p["alpha_v"]
    wh = m.normalize(wi + wo)
    ct = jnp.maximum(wh[..., 2], 1e-6)
    st2 = jnp.maximum(1.0 - ct * ct, 0.0)
    cp2 = jnp.where(st2 > 0, wh[..., 0] ** 2 / jnp.maximum(st2, 1e-12), 1.0)
    sp2 = jnp.where(st2 > 0, wh[..., 1] ** 2 / jnp.maximum(st2, 1e-12), 0.0)
    tan2 = st2 / (ct * ct)
    e = jnp.exp(-tan2 * (cp2 / (au * au) + sp2 / (av * av)))
    dot_hw = jnp.maximum(jnp.abs(m.dot(wh, wi)), 1e-6)
    return e / (4.0 * jnp.pi * au * av * dot_hw * ct ** 3)


def ward_pdf(p, wi, wo):
    upper = _both_upper(wi, wo)
    spec_prob = _phong_weights(p)
    pdf = spec_prob * _ward_pdf_h(p, wi, wo) + (1.0 - spec_prob) * \
        warp.square_to_cosine_hemisphere_pdf(wo)
    return jnp.where(upper, pdf, 0.0)


def ward_sample(p, wi, u2, u1):
    au, av = p["alpha_u"], p["alpha_v"]
    spec_prob = _phong_weights(p)
    choose_spec = u1 < spec_prob
    # anisotropic half-vector (quadrant-correct phi)
    phi_p = jnp.arctan2(av * jnp.sin(2 * jnp.pi * u2[..., 1]),
                        au * jnp.cos(2 * jnp.pi * u2[..., 1]))
    cp, sp = jnp.cos(phi_p), jnp.sin(phi_p)
    denom = cp * cp / (au * au) + sp * sp / (av * av)
    tan2t = -jnp.log(jnp.maximum(u2[..., 0], 1e-20)) / jnp.maximum(denom, 1e-12)
    ct = 1.0 / jnp.sqrt(1.0 + tan2t)
    st = m.safe_sqrt(1.0 - ct * ct)
    wh = jnp.stack([st * cp, st * sp, ct], axis=-1)
    wo_spec = m.reflect(wi, wh)
    wo_diff = warp.square_to_cosine_hemisphere(u2)
    wo = jnp.where(choose_spec[..., None], wo_spec, wo_diff)
    pdf = ward_pdf(p, wi, wo)
    valid = _both_upper(wi, wo) & (pdf > 1e-10)
    fcos = ward_eval(p, wi, wo)
    s = _zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, fcos / jnp.maximum(pdf, 1e-10)[..., None]),
        pdf=jnp.where(valid, pdf, 0.0),
        valid=valid,
    )
    return s


# ---------------------------------------------------------------------------
# Rough dielectric (Walter 2007) — src/bsdfs/roughglass.cpp:776
# ---------------------------------------------------------------------------

def _roughglass_terms(p, wi, wo):
    """Half-vectors, Fresnel and D/G terms for the Walter'07 rough dielectric.

    Micronormals live on the +z (exterior) hemisphere; `fresnel_dielectric_ext`
    gets a signed cosine (positive when wi arrives from outside) so it picks
    the right relative IOR on its own.
    """
    dist, alpha, eta = p["_dist_static"], p["alpha_u"], p["eta"]
    ci, co = m.cos_theta(wi), m.cos_theta(wo)
    # reflection half-vector, oriented to +z
    wh = m.normalize(wi + wo)
    wh = wh * jnp.sign(wh[..., 2:3])
    # transmission half-vector
    eta_i = jnp.where(ci > 0, 1.0, eta)
    eta_o = jnp.where(ci > 0, eta, 1.0)
    ht = m.normalize(-(wi * eta_i[..., None] + wo * eta_o[..., None]))
    ht = ht * jnp.sign(ht[..., 2:3])
    # physical-orientation guards (reference roughglass.cpp sidedness):
    # each direction must lie on its own side of the micronormal
    ok_r = (m.dot(wi, wh) * ci > 0) & (m.dot(wo, wh) * co > 0)
    ok_t = (m.dot(wi, ht) * ci > 0) & (m.dot(wo, ht) * co > 0)
    return dist, alpha, eta, ci, co, wh, ht, eta_i, eta_o, ok_r, ok_t


def roughglass_eval(p, wi, wo):
    (dist, alpha, eta, ci, co, wh, ht, eta_i, eta_o, ok_r, ok_t) = \
        _roughglass_terms(p, wi, wo)
    is_reflect = ci * co > 0
    # ---- reflection: fCos = F D G / (4 |ci|)
    fr_r, _ = fresnel_dielectric_ext(m.dot(wi, wh), eta)
    d_r = mf.eval_d(dist, alpha, wh)
    g_r = mf.smith_g(dist, alpha, wi, wo, wh)
    val_r = p["specular"] * (fr_r * d_r * g_r / jnp.maximum(4.0 * jnp.abs(ci), 1e-8))[..., None]
    # ---- transmission (Walter 2007 eq. 21) + radiance scaling (eta_i/eta_o)^2
    wi_ht, wo_ht = m.dot(wi, ht), m.dot(wo, ht)
    fr_t, _ = fresnel_dielectric_ext(wi_ht, eta)
    d_t = mf.eval_d(dist, alpha, ht)
    g_t = mf.smith_g(dist, alpha, wi, wo, ht)
    denom = (eta_i * wi_ht + eta_o * wo_ht) ** 2
    f_t = (jnp.abs(wi_ht * wo_ht) * eta_o * eta_o * (1.0 - fr_t) * d_t * g_t) / (
        jnp.maximum(jnp.abs(ci * co), 1e-8) * jnp.maximum(denom, 1e-10)
    )
    f_t = f_t * (eta_i / eta_o) ** 2
    val_t = p["transmittance"] * (f_t * jnp.abs(co))[..., None]
    val = jnp.where(
        is_reflect[..., None],
        jnp.where(ok_r[..., None], val_r, 0.0),
        jnp.where(ok_t[..., None], val_t, 0.0),
    )
    return jnp.where((jnp.abs(ci) > 1e-6)[..., None], val, 0.0)


def roughglass_pdf(p, wi, wo):
    (dist, alpha, eta, ci, co, wh, ht, eta_i, eta_o, ok_r, ok_t) = \
        _roughglass_terms(p, wi, wo)
    is_reflect = ci * co > 0
    fr_r, _ = fresnel_dielectric_ext(m.dot(wi, wh), eta)
    pdf_r = fr_r * mf.pdf_wh(dist, alpha, wh) / jnp.maximum(4.0 * jnp.abs(m.dot(wo, wh)), 1e-8)
    wi_ht, wo_ht = m.dot(wi, ht), m.dot(wo, ht)
    fr_t, _ = fresnel_dielectric_ext(wi_ht, eta)
    jac = eta_o * eta_o * jnp.abs(wo_ht) / jnp.maximum((eta_i * wi_ht + eta_o * wo_ht) ** 2, 1e-10)
    pdf_t = (1.0 - fr_t) * mf.pdf_wh(dist, alpha, ht) * jac
    return jnp.where(
        is_reflect, jnp.where(ok_r, pdf_r, 0.0), jnp.where(ok_t, pdf_t, 0.0)
    )


def roughglass_sample(p, wi, u2, u1):
    dist, alpha, eta = p["_dist_static"], p["alpha_u"], p["eta"]
    ci = m.cos_theta(wi)
    wh, _ = mf.sample_wh(dist, alpha, u2)   # +z hemisphere micronormal
    cos_ih = m.dot(wi, wh)
    fr, _ = fresnel_dielectric_ext(cos_ih, eta)
    reflect = u1 < fr
    wo_r = m.reflect(wi, wh)
    # crossing relative IOR: target/source given which side wi is on
    rel_eta = jnp.where(cos_ih > 0, eta, 1.0 / eta)
    wo_t, tir = m.refract(wi, wh, rel_eta)
    wo = jnp.where(reflect[..., None], wo_r, wo_t)
    pdf = roughglass_pdf(p, wi, wo)
    fcos = roughglass_eval(p, wi, wo)
    co = m.cos_theta(wo)
    ok_side = jnp.where(reflect, ci * co > 0, ci * co < 0)
    # reject backfacing micronormals (wh not visible from wi's side) — the
    # pdf only models front-facing events; cf. reference roughglass.cpp
    # sidedness guard
    facing = cos_ih * ci > 0
    valid = ok_side & facing & (pdf > 1e-10) & (reflect | ~tir)
    s = _zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, fcos / jnp.maximum(pdf, 1e-10)[..., None]),
        pdf=jnp.where(valid, pdf, 0.0),
        transmission=valid & ~reflect,
        eta=jnp.where(reflect, 1.0, rel_eta),
        valid=valid,
    )
    return s


# ---------------------------------------------------------------------------
# Diffuse transmitter  (src/bsdfs/difftrans.cpp)
# ---------------------------------------------------------------------------

def difftrans_eval(p, wi, wo):
    opposite = (m.cos_theta(wi) > 0) & (m.cos_theta(wo) < 0)
    f = p["transmittance"] * m.INV_PI * jnp.abs(m.cos_theta(wo))[..., None]
    return _mask3(opposite, f)


def difftrans_pdf(p, wi, wo):
    opposite = (m.cos_theta(wi) > 0) & (m.cos_theta(wo) < 0)
    return jnp.where(opposite, jnp.abs(m.cos_theta(wo)) * m.INV_PI, 0.0)


def difftrans_sample(p, wi, u2, u1):
    wo_up = warp.square_to_cosine_hemisphere(u2)
    wo = wo_up * jnp.array([1.0, 1.0, -1.0])
    pdf = jnp.abs(m.cos_theta(wo)) * m.INV_PI
    valid = (m.cos_theta(wi) > 0) & (pdf > 0)
    s = _zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, p["transmittance"]),
        pdf=jnp.where(valid, pdf, 0.0),
        transmission=valid,
        valid=valid,
    )
    return s


# ---------------------------------------------------------------------------
# Wiscombe-Warren snow BRDF  (fork feature: src/bsdfs/wiscombe.cpp:294)
# ---------------------------------------------------------------------------
# Delta-Eddington constants are precomputed at build time (table.py
# wiscombe()): reflectance <- A = wStar/(1+P), specular <- xi,
# transmittance <- bStar. Reference evaluates
# f = albedo(cos wo) * fBar * INV_PI^2 (wiscombe.cpp:112-133, incl. the
# reference's double INV_PI) with cosine-hemisphere sampling.

def wiscombe_eval(p, wi, wo):
    upper = _both_upper(wi, wo)
    mu0 = jnp.maximum(m.cos_theta(wo), 1e-6)
    mu_p = jnp.maximum(m.cos_theta(wi), 1e-6)
    a_const = p["reflectance"]       # wStar/(1+P)
    xi = p["specular"]
    b_star = p["transmittance"]
    albedo = a_const * (1.0 - xi * mu0[..., None] * b_star) / (1.0 + xi * mu0[..., None])
    b = 1.07 * mu0 - 0.84
    fbar = (3.0 / (3.0 - b)) * (1.0 + b * (mu_p - 1.0))
    f = albedo * (fbar * m.INV_PI * m.INV_PI)[..., None]
    return _mask3(upper, f * jnp.maximum(m.cos_theta(wo), 0.0)[..., None])


def wiscombe_pdf(p, wi, wo):
    return lambertian_pdf(p, wi, wo)


def wiscombe_sample(p, wi, u2, u1):
    wo = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    valid = (m.cos_theta(wi) > 0) & (pdf > 0)
    fcos = wiscombe_eval(p, wi, wo)
    s = _zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, fcos / jnp.maximum(pdf, 1e-9)[..., None]),
        pdf=jnp.where(valid, pdf, 0.0),
        valid=valid,
    )
    return s


# ---------------------------------------------------------------------------
# Hanrahan-Krueger thin-slab single scattering + diffuse term
# (src/bsdfs/hanrahan-krueger.cpp:154-193)
# ---------------------------------------------------------------------------
# Precomputed at build time: reflectance <- singleScatteringAlbedo*ssFactor,
# transmittance <- diffuseReflectance (delta-Eddington dipole approx),
# eta <- etaInt/etaExt, alpha_u <- g.

def hk_eval(p, wi, wo):
    from mitsuba_jax.core.fresnel import fresnel

    upper = _both_upper(wi, wo)
    ci = m.cos_theta(wi)
    co = m.cos_theta(wo)
    eta = p["eta"]
    ft1 = 1.0 - fresnel(co, jnp.ones_like(eta), eta)
    ft2 = 1.0 - fresnel(ci, jnp.ones_like(eta), eta)
    fr_prod = ft1 * ft2
    g = p["alpha_u"]
    # reference hgPhaseFunction: cos = dot(-wi, wo), 0.5 normalization
    cos_t = m.dot(-wi, wo)
    g2 = g * g
    phase = 0.5 * (1.0 - g2) / jnp.power(
        jnp.maximum(1.0 + g2 - 2.0 * g * cos_t, 1e-8), 1.5
    )
    f1 = p["reflectance"] * (fr_prod * phase / jnp.maximum(jnp.abs(ci) + jnp.abs(co), 1e-6))[..., None]
    lo = f1 + p["transmittance"] * (fr_prod * m.INV_PI)[..., None]
    f = lo * m.INV_PI
    return _mask3(upper, f * jnp.maximum(co, 0.0)[..., None])


def hk_pdf(p, wi, wo):
    return lambertian_pdf(p, wi, wo)


def hk_sample(p, wi, u2, u1):
    wo = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    valid = (m.cos_theta(wi) > 0) & (pdf > 0)
    fcos = hk_eval(p, wi, wo)
    s = _zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, fcos / jnp.maximum(pdf, 1e-9)[..., None]),
        pdf=jnp.where(valid, pdf, 0.0),
        valid=valid,
    )
    return s


