"""Wavefront BSDF dispatch: masked multi-eval over the kinds in the scene.

Replaces the reference's per-ray virtual dispatch (`its.getBSDF(ray)` →
`BSDF::fCos/sampleCos/pdf`): each BSDF kind present in the scene is
evaluated on ALL lanes and results are selected by material mask.  With k
kinds the cost is k small elementwise passes over the wavefront —
branchless, fully vectorized; k is tiny in practice.

The `twosided` adapter (src/bsdfs/twosided.cpp) is applied here by mirroring
the local frame for lanes whose material has the flag and wi.z < 0.
"""
from __future__ import annotations

import jax.numpy as jnp

from mitsuba_jax.bsdfs import irawan as ir
from mitsuba_jax.bsdfs import models as md
from mitsuba_jax.bsdfs.table import (
    CLOTH,
    COMPOSITE,
    DIELECTRIC,
    DIFF_TRANS,
    HANRAHAN_KRUEGER,
    LAMBERTIAN,
    MAX_COMPOSITE_LOBES,
    MIRROR,
    PHONG,
    ROUGH_CONDUCTOR,
    ROUGH_GLASS,
    WARD,
    WISCOMBE,
    MaterialTable,
)

_MODELS = {
    LAMBERTIAN: (md.lambertian_eval, md.lambertian_pdf, md.lambertian_sample),
    MIRROR: (md.mirror_eval, md.mirror_pdf, md.mirror_sample),
    DIELECTRIC: (md.dielectric_eval, md.dielectric_pdf, md.dielectric_sample),
    ROUGH_CONDUCTOR: (
        md.rough_conductor_eval,
        md.rough_conductor_pdf,
        md.rough_conductor_sample,
    ),
    PHONG: (md.phong_eval, md.phong_pdf, md.phong_sample),
    WARD: (md.ward_eval, md.ward_pdf, md.ward_sample),
    ROUGH_GLASS: (md.roughglass_eval, md.roughglass_pdf, md.roughglass_sample),
    DIFF_TRANS: (md.difftrans_eval, md.difftrans_pdf, md.difftrans_sample),
    WISCOMBE: (md.wiscombe_eval, md.wiscombe_pdf, md.wiscombe_sample),
    HANRAHAN_KRUEGER: (md.hk_eval, md.hk_pdf, md.hk_sample),
    CLOTH: (ir.irawan_eval, ir.irawan_pdf, ir.irawan_sample),
}

_NO_FLIP_KINDS = (DIELECTRIC, ROUGH_GLASS)  # genuinely two-sided already


def _flip_mask(p, wi):
    """twosided adapter: flip the local frame when hit from behind."""
    return p["two_sided"] & (wi[..., 2] < 0)


def _flip(v, mask):
    return jnp.where(mask[..., None], v * jnp.array([1.0, 1.0, -1.0]), v)


def _resolve(p, albedo=None, uv=None):
    """Apply per-lane texture-resolved albedo / hit-uv overrides."""
    if albedo is not None or uv is not None:
        p = dict(p)
    if albedo is not None:
        p["reflectance"] = albedo
    if uv is not None:
        p["_uv"] = uv
    return p


def _composite_resolve(table, material_id, u_lobe=None):
    """For composite rows: per-lane (child_id, weight_scale, child_pdf_mix).

    Returns (is_comp, child slots) for the wrapper layer in eval/pdf/sample.
    """
    i = jnp.clip(material_id, 0, table.n_materials - 1)
    is_comp = table.kind[i] == COMPOSITE
    cids = table.child_ids[i]       # (N, 4)
    cws = table.child_weights[i]    # (N, 4)
    return is_comp, cids, cws


def bsdf_eval(table: MaterialTable, material_id, wi, wo, albedo=None, uv=None):
    """fCos for every lane (reference BSDF::fCos); composite rows sum their
    weighted children (reference composite.cpp f())."""
    if table.has_composite:
        is_comp, cids, cws = _composite_resolve(table, material_id)
        base = _bsdf_eval_leaf(table, material_id, wi, wo, albedo, uv)
        total = jnp.zeros_like(base)
        for k in range(MAX_COMPOSITE_LOBES):
            child = jnp.where(cids[:, k] >= 0, cids[:, k], 0)
            val = _bsdf_eval_leaf(table, child, wi, wo, None, uv)
            total = total + jnp.where(
                (is_comp & (cids[:, k] >= 0))[:, None],
                cws[:, k][:, None] * val, 0.0,
            )
        return jnp.where(is_comp[:, None], total, base)
    return _bsdf_eval_leaf(table, material_id, wi, wo, albedo, uv)


def _bsdf_eval_leaf(table: MaterialTable, material_id, wi, wo, albedo=None, uv=None):
    """fCos for every lane (reference BSDF::fCos)."""
    p = _resolve(table.gather(material_id), albedo, uv)
    fl = _flip_mask(p, wi)
    wi_f, wo_f = _flip(wi, fl), _flip(wo, fl)
    out = jnp.zeros(wi.shape[:-1] + (table.reflectance.shape[-1],))
    for kind, dist in table.kinds_present:
        pk = dict(p, _dist_static=dist)
        mask = p["kind"] == kind
        if kind in (ROUGH_CONDUCTOR, ROUGH_GLASS):
            mask = mask & (p["dist_type"] == dist)
        use_wi = wi if kind in _NO_FLIP_KINDS else wi_f
        use_wo = wo if kind in _NO_FLIP_KINDS else wo_f
        val = _MODELS[kind][0](pk, use_wi, use_wo)
        out = jnp.where(mask[..., None], val, out)
    return out


def bsdf_pdf(table: MaterialTable, material_id, wi, wo):
    """Solid-angle pdf (composite: weight-mixed child pdfs)."""
    if table.has_composite:
        is_comp, cids, cws = _composite_resolve(table, material_id)
        base = _bsdf_pdf_leaf(table, material_id, wi, wo)
        wsum = jnp.maximum(jnp.where(cids >= 0, cws, 0.0).sum(-1), 1e-8)
        total = jnp.zeros_like(base)
        for k in range(MAX_COMPOSITE_LOBES):
            child = jnp.where(cids[:, k] >= 0, cids[:, k], 0)
            val = _bsdf_pdf_leaf(table, child, wi, wo)
            total = total + jnp.where(
                is_comp & (cids[:, k] >= 0), (cws[:, k] / wsum) * val, 0.0
            )
        return jnp.where(is_comp, total, base)
    return _bsdf_pdf_leaf(table, material_id, wi, wo)


def _bsdf_pdf_leaf(table: MaterialTable, material_id, wi, wo):
    """Solid-angle pdf of bsdf_sample (reference BSDF::pdf)."""
    p = table.gather(material_id)
    fl = _flip_mask(p, wi)
    wi_f, wo_f = _flip(wi, fl), _flip(wo, fl)
    out = jnp.zeros(wi.shape[:-1])
    for kind, dist in table.kinds_present:
        pk = dict(p, _dist_static=dist)
        mask = p["kind"] == kind
        if kind in (ROUGH_CONDUCTOR, ROUGH_GLASS):
            mask = mask & (p["dist_type"] == dist)
        use_wi = wi if kind in _NO_FLIP_KINDS else wi_f
        use_wo = wo if kind in _NO_FLIP_KINDS else wo_f
        out = jnp.where(mask, _MODELS[kind][1](pk, use_wi, use_wo), out)
    return out


def bsdf_sample(table: MaterialTable, material_id, wi, u2, u1, albedo=None,
                uv=None):
    """Sample wo ~ BSDF.

    Opacity masks (reference mask.cpp): with probability 1-opacity the
    surface is passed straight through (delta transmission, weight 1); u1 is
    rescaled for the surviving lobe decision.  Composite rows pick a child
    lobe by weight (composite.cpp sample())."""
    i = jnp.clip(material_id, 0, table.n_materials - 1)
    opacity = table.opacity[i]
    has_mask = bool((_np_min_opacity(table)) < 0.999)
    if has_mask:
        pass_through = u1 >= opacity
        u1 = jnp.clip(u1 / jnp.maximum(opacity, 1e-6), 0.0, 1.0 - 1e-7)
    s = _bsdf_sample_dispatch(table, material_id, wi, u2, u1, albedo, uv)
    if has_mask:
        wo_pass = -wi
        s = dict(s)
        s["wo"] = jnp.where(pass_through[:, None], wo_pass, s["wo"])
        s["weight"] = jnp.where(pass_through[:, None], 1.0, s["weight"])
        s["pdf"] = jnp.where(pass_through, 1.0, s["pdf"])
        s["delta"] = jnp.where(pass_through, True, s["delta"])
        s["transmission"] = jnp.where(pass_through, True, s["transmission"])
        s["valid"] = jnp.where(pass_through, True, s["valid"])
    return s


def _np_min_opacity(table):
    import numpy as np

    try:
        return float(np.asarray(table.opacity).min())
    except Exception:
        return 1.0


def _bsdf_sample_dispatch(table: MaterialTable, material_id, wi, u2, u1,
                          albedo=None, uv=None):
    """Composite/leaf sampling dispatch."""
    if table.has_composite:
        is_comp, cids, cws = _composite_resolve(table, material_id)
        w_valid = jnp.where(cids >= 0, cws, 0.0)
        wsum = jnp.maximum(w_valid.sum(-1), 1e-8)
        cdf = jnp.cumsum(w_valid / wsum[:, None], axis=-1)
        u_sel = u1
        chosen = jnp.argmax(u_sel[:, None] <= cdf + 1e-7, axis=-1)
        lo = jnp.where(chosen > 0,
                       jnp.take_along_axis(cdf, jnp.maximum(chosen - 1, 0)[:, None],
                                           axis=-1)[:, 0], 0.0)
        pk = jnp.take_along_axis(w_valid / wsum[:, None], chosen[:, None], axis=-1)[:, 0]
        u1_re = jnp.clip((u_sel - lo) / jnp.maximum(pk, 1e-8), 0.0, 1.0 - 1e-7)
        child = jnp.take_along_axis(cids, chosen[:, None], axis=-1)[:, 0]
        child = jnp.where(child >= 0, child, 0)
        eff_id = jnp.where(is_comp, child, material_id)
        eff_u1 = jnp.where(is_comp, u1_re, u1)
        s = _bsdf_sample_leaf(table, eff_id, wi, u2, eff_u1, albedo, uv)
        # composite weight: (w_k * f_child) / (p_k * pdf_child) summed over
        # lobes via full eval/pdf for MIS correctness
        fcos = bsdf_eval(table, material_id, wi, s["wo"], albedo, uv)
        pdf = bsdf_pdf(table, material_id, wi, s["wo"])
        w_comp = fcos / jnp.maximum(pdf, 1e-9)[:, None]
        for key, comp_val in (("weight", w_comp), ("pdf", pdf)):
            sel = is_comp[:, None] if s[key].ndim == 2 else is_comp
            s[key] = jnp.where(sel, comp_val, s[key])
        s["valid"] = jnp.where(is_comp, (pdf > 1e-10) & ~s["delta"], s["valid"])
        return s
    return _bsdf_sample_leaf(table, material_id, wi, u2, u1, albedo, uv)


def _bsdf_sample_leaf(table: MaterialTable, material_id, wi, u2, u1,
                      albedo=None, uv=None):
    """Sample wo ~ BSDF; returns the merged per-lane sample dict
    (reference BSDF::sampleCos)."""
    p = _resolve(table.gather(material_id), albedo, uv)
    fl = _flip_mask(p, wi)
    wi_f = _flip(wi, fl)
    out = md._zero_sample(wi, p["reflectance"].shape[-1])
    for kind, dist in table.kinds_present:
        pk = dict(p, _dist_static=dist)
        mask = p["kind"] == kind
        if kind in (ROUGH_CONDUCTOR, ROUGH_GLASS):
            mask = mask & (p["dist_type"] == dist)
        use_wi = wi if kind in _NO_FLIP_KINDS else wi_f
        s = _MODELS[kind][2](pk, use_wi, u2, u1)
        if kind not in _NO_FLIP_KINDS:
            s = dict(s, wo=_flip(s["wo"], fl))
        for key in out:
            sel = mask[..., None] if out[key].ndim > mask.ndim else mask
            out[key] = jnp.where(sel, s[key], out[key])
    return out
