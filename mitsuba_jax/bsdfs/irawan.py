"""Irawan & Marschner woven-cloth BRDF — the real yarn-scattering model.

Re-expresses the reference's per-ray recursive evaluation
(/root/reference/src/bsdfs/irawan.cpp:107-249 f(), :292-371
evalFilamentIntegrand / evalStapleIntegrand, :373-483
radiusOfCurvature / vonMises / seeliger; yarn + pattern data model
src/bsdfs/irawan.h:41-276), vectorized:

  * every cloth material's weave pattern + yarn segments live in small
    padded SoA tables shared by the whole wavefront (`pack_patterns`);
  * eval is fully branchless: BOTH integrands (filament for psi == 0,
    staple for twisted yarns) are evaluated on every lane and selected
    with `where`, as are the four conic-section branches of the
    radius-of-curvature — no per-lane control flow anywhere;
  * the reference's seeded-PRNG intensity variation and correlated
    (Perlin) umax noise become counter-based hashes of the same yarn
    segment keys — deterministic, order-independent, vectorized.

The von Mises normalization uses the standard Abramowitz & Stegun I0
polynomials (the same published approximation the reference uses).
Sampling is cosine-weighted like the reference (irawan.cpp:245-263:
"Lacking a better sampling method").
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core import math as m
from mitsuba_jax.core import warp
from mitsuba_jax.core.noise import perlin_noise
from mitsuba_jax.io.weave import EWARP, EWEFT, WeavePattern, Yarn

_EPS = 1e-7

# globals-vector layout (one row per cloth material)
(G_ALPHA, G_BETA, G_SS, G_HWIDTH, G_WARPAREA, G_WEFTAREA,
 G_DWP_DWP, G_DWP_DWF, G_DWF_DWP, G_DWF_DWF,
 G_PERIOD, G_FINENESS, G_REPU, G_REPV, G_KDMULT, G_KSMULT,
 G_TILEW, G_TILEH, G_NGLOBALS) = range(19)

# yarn-vector layout (one row per yarn segment)
(Y_TYPE, Y_PSI, Y_UMAX, Y_KAPPA, Y_WIDTH, Y_LENGTH, Y_CU, Y_CV,
 Y_NFIELDS) = range(9)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack_patterns(specs):
    """Pack cloth specs into shared SoA tables.

    specs: list of dicts with keys pattern (WeavePattern), repeat_u,
    repeat_v, kd_mult, ks_mult. Returns a dict of jnp arrays padded to
    the max tile size / yarn count across all cloth materials:
      grid (NC, THmax, TWmax) i32 0-based yarn index
      yarn (NC, Ymax, Y_NFIELDS) f32, kd/ks (NC, Ymax, 3) f32
      gl   (NC, G_NGLOBALS) f32
    """
    if not specs:
        return None
    nc = len(specs)
    twm = max(s["pattern"].tileWidth for s in specs)
    thm = max(s["pattern"].tileHeight for s in specs)
    ym = max(len(s["pattern"].yarns) for s in specs)
    grid = np.zeros((nc, thm, twm), np.int32)
    yarn = np.zeros((nc, ym, Y_NFIELDS), np.float32)
    kd = np.zeros((nc, ym, 3), np.float32)
    ks = np.zeros((nc, ym, 3), np.float32)
    gl = np.zeros((nc, G_NGLOBALS), np.float32)
    for i, s in enumerate(specs):
        w = s["pattern"]
        g = w.grid()
        # tile the real pattern into the padded grid so modulo lookups
        # against the REAL dims (stored in gl) stay in range
        grid[i, :g.shape[0], :g.shape[1]] = g
        for j, y in enumerate(w.yarns):
            yarn[i, j] = (y.type, y.psi, y.umax, y.kappa, y.width,
                          y.length, y.centerU, y.centerV)
            kd[i, j] = y.kd
            ks[i, j] = y.ks
        gl[i] = (w.alpha, w.beta, w.ss, w.hWidth, w.warpArea, w.weftArea,
                 w.dWarpUmaxOverDWarp, w.dWarpUmaxOverDWeft,
                 w.dWeftUmaxOverDWarp, w.dWeftUmaxOverDWeft,
                 w.period, w.fineness, s["repeat_u"], s["repeat_v"],
                 s["kd_mult"], s["ks_mult"], w.tileWidth, w.tileHeight)
    return dict(grid=jnp.asarray(grid), yarn=jnp.asarray(yarn),
                kd=jnp.asarray(kd), ks=jnp.asarray(ks),
                gl=jnp.asarray(gl))


def procedural_pattern(kind: str = "plain", warp_kd=(0.3, 0.27, 0.25),
                       weft_kd=(0.6, 0.1, 0.1), ks=(0.2, 0.2, 0.2)):
    """Synthesize a WeavePattern for the procedural plain/twill modes
    (a capability extension: the reference requires a pattern file).
    One staple yarn segment per tile cell, centered in its cell."""
    if kind == "twill":
        tw = th = 4
        is_warp = [[(x - y) % 4 < 2 for x in range(tw)] for y in range(th)]
    else:
        tw = th = 2
        is_warp = [[(x + y) % 2 == 0 for x in range(tw)] for y in range(th)]
    w = WeavePattern(name=f"procedural-{kind}", tileWidth=tw, tileHeight=th,
                     alpha=0.05, beta=2.0, ss=0.3, hWidth=0.5,
                     warpArea=0.5, weftArea=0.5, fineness=0.0, period=0.0)
    deg = np.pi / 180.0
    for y in range(th):
        for x in range(tw):
            warp_cell = is_warp[y][x]
            w.pattern.append(len(w.yarns) + 1)
            w.yarns.append(Yarn(
                type=EWARP if warp_cell else EWEFT,
                psi=30.0 * deg, umax=35.0 * deg, kappa=0.0,
                width=1.0, length=1.2,
                centerU=(x + 0.5) / tw, centerV=1.0 - (y + 0.5) / th,
                kd=tuple(warp_kd) if warp_cell else tuple(weft_kd),
                ks=tuple(ks)))
    return w


# ---------------------------------------------------------------------------
# model pieces (vectorized, branchless)
# ---------------------------------------------------------------------------

def _safe_div(a, b, eps=1e-9):
    """a / b with |b| clamped away from 0, keeping b's sign."""
    s = jnp.where(b >= 0, 1.0, -1.0)
    return a / (s * jnp.maximum(jnp.abs(b), eps))


def _von_mises(cos_x, b):
    """exp(b cos x) / (2 pi I0(b)), log-domain for large-b stability
    (reference irawan.cpp:489 vonMises; A&S 9.8.1/9.8.2 polynomials)."""
    ab = jnp.abs(b)
    t = (ab / 3.75) ** 2
    i0_small = 1.0 + t * (3.5156229 + t * (3.0899424 + t * (1.2067492
        + t * (0.2659732 + t * (0.0360768 + t * 0.0045813)))))
    tl = 3.75 / jnp.maximum(ab, 3.75)
    p_large = 0.39894228 + tl * (0.01328592 + tl * (0.00225319
        + tl * (-0.00157565 + tl * (0.00916281 + tl * (-0.02057706
        + tl * (0.02635537 + tl * (-0.01647633 + tl * 0.00392377)))))))
    log_i0 = jnp.where(
        ab <= 3.75,
        jnp.log(jnp.maximum(i0_small, 1e-30)),
        ab - 0.5 * jnp.log(jnp.maximum(ab, 1e-9))
        + jnp.log(jnp.maximum(p_large, 1e-30)))
    return jnp.exp(b * cos_x - log_i0) / (2.0 * jnp.pi)


def _seeliger(cos1, cos2):
    """Lommel-Seeliger attenuation with albedo 1 (irawan.cpp:510,
    called with sg_a=0, sg_s=1)."""
    c1 = jnp.maximum(cos1, 0.0)
    c2 = jnp.maximum(cos2, 0.0)
    prod = c1 * c2
    return jnp.where(prod > 0.0,
                     prod / (4.0 * jnp.pi * jnp.maximum(c1 + c2, _EPS)),
                     0.0)


def _smooth_step(x):
    t = jnp.clip(x, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _radius_of_curvature(u, umax, kappa, w, l):
    """Spine radius of curvature at inclination u: the yarn spine is an
    ellipse / parabola / hyperbola / circle segment depending on
    rhat = 1 + kappa (1 + 1/tan umax) (irawan.cpp:455, thesis section
    5.3). All four conics evaluated, selected branchlessly."""
    rhat = 1.0 + kappa * (1.0 + 1.0 / jnp.tan(jnp.maximum(umax, 1e-4)))
    a = 0.5 * w
    sin_umax = jnp.sin(umax)
    arc = 0.5 * l - a * sin_umax            # common numerator
    # circle (rhat == 1)
    r_circ = _safe_div(arc, sin_umax)
    # ellipse (rhat > 0): t = atan(rhat tan u)
    rh_pos = jnp.maximum(rhat, 1e-6)
    tmax_e = jnp.arctan(rh_pos * jnp.tan(umax))
    bhat_e = _safe_div(arc, jnp.sin(tmax_e))
    ahat_e = bhat_e / rh_pos
    t_e = jnp.arctan(rh_pos * jnp.tan(u))
    ct, st = jnp.cos(t_e), jnp.sin(t_e)
    r_ell = _safe_div((bhat_e ** 2 * ct * ct
                       + ahat_e ** 2 * st * st) ** 1.5, ahat_e * bhat_e)
    # hyperbola (rhat < 0): t = -atanh(rhat tan u)
    rh_neg = jnp.minimum(rhat, -1e-6)
    arg_m = jnp.clip(rh_neg * jnp.tan(umax), -1.0 + 1e-6, 1.0 - 1e-6)
    tmax_h = -jnp.arctanh(arg_m)
    bhat_h = _safe_div(arc, jnp.sinh(tmax_h))
    ahat_h = bhat_h / rh_neg
    arg_u = jnp.clip(rh_neg * jnp.tan(u), -1.0 + 1e-6, 1.0 - 1e-6)
    t_h = -jnp.arctanh(arg_u)
    ch, sh = jnp.cosh(t_h), jnp.sinh(t_h)
    r_hyp = -_safe_div((bhat_h ** 2 * ch * ch
                        + ahat_h ** 2 * sh * sh) ** 1.5, ahat_h * bhat_h)
    # parabola (rhat == 0)
    tmax_p = jnp.tan(umax)
    ahat_p = _safe_div(arc, 2.0 * tmax_p)
    t_p = jnp.tan(u)
    r_par = 2.0 * ahat_p * (1.0 + t_p * t_p) ** 1.5
    return jnp.where(
        jnp.abs(rhat - 1.0) < 1e-6, r_circ,
        jnp.where(rhat > 1e-6, r_ell,
                  jnp.where(rhat < -1e-6, r_hyp, r_par)))


def _filament_integrand(u, v, om_i, om_r, alpha, beta, ss, umax, kappa,
                        w, l, h_width):
    """Specular integrand for untwisted filament yarns
    (irawan.cpp:292-357 evalFilamentIntegrand): the reflecting fiber
    inclination u(v) comes from the half vector; the highlight is a
    constant-width band delta_y in the segment's length direction."""
    ok = ((ss >= 0.0) & (ss < 1.0) & (w * jnp.sin(umax) < l)
          & (kappa >= -1.0))
    h = m.normalize(om_i + om_r)
    u_of_v = jnp.arctan(_safe_div(h[..., 1], h[..., 2]))
    in_rng = jnp.abs(u_of_v) < umax
    cu, su = jnp.cos(u_of_v), jnp.sin(u_of_v)
    cv, sv = jnp.cos(v), jnp.sin(v)
    n = m.normalize(jnp.stack([sv, su * cv, cu * cv], -1))
    # fiber tangent t = (0, cos u, -sin u), unit by construction
    r_curv = _radius_of_curvature(
        jnp.minimum(jnp.abs(u_of_v), (1.0 - ss) * umax),
        (1.0 - ss) * umax, kappa, w, l)
    a = 0.5 * w
    len_ior = jnp.linalg.norm(om_i + om_r, axis=-1)
    # cross(t, h).x = t.y h.z - t.z h.y
    txh_x = cu * h[..., 2] + su * h[..., 1]
    g_u = _safe_div(a * (r_curv + a * cv),
                    len_ior * jnp.maximum(jnp.abs(txh_x), _EPS))
    fc = alpha + _von_mises(-m.dot(om_i, om_r), beta)
    att = _seeliger(m.dot(n, om_i), m.dot(n, om_r))
    smooth = 1.0 - _smooth_step(
        _safe_div(jnp.abs(u_of_v) - (1.0 - ss) * umax,
                  ss * jnp.maximum(umax, 1e-6)))
    att_s = jnp.where(ss > 0.0, att * smooth, att)
    fs = g_u * fc * att_s * jnp.pi * l
    delta_y = l * h_width
    y_of_v = jnp.clip(u_of_v * 0.5 * l / jnp.maximum(umax, 1e-6),
                      0.5 * (delta_y - l), 0.5 * (l - delta_y))
    on_hl = jnp.abs(
        y_of_v - u * 0.5 * l / jnp.maximum(umax, 1e-6)) < 0.5 * delta_y
    return jnp.where(ok & in_rng & on_hl,
                     _safe_div(fs, delta_y), 0.0)


def _staple_integrand(u, v, om_i, om_r, alpha, beta, psi, umax, kappa,
                      w, l, h_width):
    """Specular integrand for twisted staple yarns
    (irawan.cpp:373-441 evalStapleIntegrand): the reflecting azimuth
    v(u) solves the twisted-fiber mirror condition; highlight is a
    constant-width band delta_x across the segment."""
    ok = (w * jnp.sin(umax) < l) & (kappa >= -1.0)
    h = m.normalize(om_i + om_r)
    cu, su = jnp.cos(u), jnp.sin(u)
    hy, hz = h[..., 1], h[..., 2]
    denom = jnp.sqrt(h[..., 0] ** 2 + (hy * su + hz * cu) ** 2)
    tan_psi = jnp.tan(psi)
    d_val = _safe_div(hy * cu - hz * su,
                      denom * jnp.where(jnp.abs(tan_psi) > _EPS,
                                        tan_psi, 1.0))
    v_of_u = (jnp.arctan2(-hy * su - hz * cu, h[..., 0])
              + jnp.arccos(jnp.clip(d_val, -1.0, 1.0)))
    in_rng = (jnp.abs(d_val) < 1.0) & (jnp.abs(v_of_u) < jnp.pi / 2.0)
    cvu, svu = jnp.cos(v_of_u), jnp.sin(v_of_u)
    n = m.normalize(jnp.stack([svu, su * cvu, cu * cvu], -1))
    r_curv = _radius_of_curvature(jnp.abs(u), umax, kappa, w, l)
    a = 0.5 * w
    len_ior = jnp.linalg.norm(om_i + om_r, axis=-1)
    g_v = _safe_div(
        a * (r_curv + a * cvu),
        len_ior * m.dot(n, h)
        * jnp.maximum(jnp.abs(jnp.sin(psi)), _EPS))
    fc = alpha + _von_mises(-m.dot(om_i, om_r), beta)
    att = _seeliger(m.dot(n, om_i), m.dot(n, om_r))
    fs = g_v * fc * att * 2.0 * w * umax
    delta_x = w * h_width
    x_of_u = jnp.clip(v_of_u * w / jnp.pi,
                      0.5 * (delta_x - w), 0.5 * (w - delta_x))
    on_hl = jnp.abs(x_of_u - v * w / jnp.pi) < 0.5 * delta_x
    return jnp.where(ok & in_rng & on_hl, _safe_div(fs, delta_x), 0.0)


# ---------------------------------------------------------------------------
# counter-based hashes (replace the reference's seeded PRNGs)
# ---------------------------------------------------------------------------

def _hash01(x):
    """uint32 -> uniform (0, 1) via a PCG output permutation."""
    x = x.astype(jnp.uint32) * jnp.uint32(747796405) + jnp.uint32(2891336453)
    sh = (x >> jnp.uint32(28)) + jnp.uint32(4)
    x = ((x >> sh) ^ x) * jnp.uint32(277803737)
    x = (x >> jnp.uint32(22)) ^ x
    return ((x >> jnp.uint32(8)).astype(jnp.float32) + 0.5) * (1.0 / 16777216.0)


# ---------------------------------------------------------------------------
# BSDF interface (per-lane, wavefront)
# ---------------------------------------------------------------------------

def irawan_eval(p, wi, wo):
    """fCos of the Irawan cloth model (irawan.cpp:107 f() * cos).

    Needs p['_cloth'] (tables from pack_patterns), p['_cloth_slot']
    (per-lane pattern index) and p['_uv'] (per-lane hit uv)."""
    c = p.get("_cloth")
    uv = p.get("_uv")
    upper = (m.cos_theta(wi) > 0) & (m.cos_theta(wo) > 0)
    if c is None or uv is None:
        # no pattern tables (shouldn't happen via the table builder)
        return jnp.zeros(wi.shape[:-1] + (3,))
    slot = jnp.clip(p["_cloth_slot"], 0, c["gl"].shape[0] - 1)
    gl = c["gl"][slot]                               # (N, G)
    tw = gl[..., G_TILEW]
    th = gl[..., G_TILEH]
    x = uv[..., 0] * gl[..., G_REPU] * tw
    y = (1.0 - uv[..., 1]) * gl[..., G_REPV] * th
    ix = jnp.floor(x)
    iy = jnp.floor(y)
    lx = jnp.mod(ix, tw).astype(jnp.int32)
    ly = jnp.mod(iy, th).astype(jnp.int32)
    yid = c["grid"][slot, ly, lx]                    # (N,)
    yarn = c["yarn"][slot, yid]                      # (N, Y_NFIELDS)
    kd = c["kd"][slot, yid]
    ks = c["ks"][slot, yid]
    is_weft = yarn[..., Y_TYPE] > 0.5
    # segment-centered coordinates (irawan.cpp:121-131)
    center_x = jnp.floor(x / tw) * tw + yarn[..., Y_CU] * tw
    center_y = jnp.floor(y / th) * th + (1.0 - yarn[..., Y_CV]) * th
    xx = x - center_x
    yy = -(y - center_y)
    # weft segments: rotate frame and directions pi/2 about z
    xx, yy = (jnp.where(is_weft, -yy, xx), jnp.where(is_weft, xx, yy))

    def rot(v):
        return jnp.where(is_weft[..., None],
                         jnp.stack([-v[..., 1], v[..., 0], v[..., 2]], -1),
                         v)

    om_i = rot(wi)
    om_r = rot(wo)
    psi = yarn[..., Y_PSI]
    umax = yarn[..., Y_UMAX]
    kappa = yarn[..., Y_KAPPA]
    w_seg = yarn[..., Y_WIDTH]
    l_seg = yarn[..., Y_LENGTH]
    d_wp = jnp.where(is_weft, gl[..., G_DWF_DWP], gl[..., G_DWP_DWP])
    d_wf = jnp.where(is_weft, gl[..., G_DWF_DWF], gl[..., G_DWP_DWF])
    # correlated umax noise per yarn segment (irawan.cpp:165-184);
    # counter-based hashes stand in for the seeded PRNG offsets
    period = gl[..., G_PERIOD]
    safe_period = jnp.maximum(period, 1e-6)
    seed_p = (center_x.astype(jnp.int32).astype(jnp.uint32)
              * (th * gl[..., G_REPV]).astype(jnp.int32).astype(jnp.uint32)
              + center_y.astype(jnp.int32).astype(jnp.uint32))
    r1 = _hash01(seed_p)
    r2 = _hash01(seed_p ^ jnp.uint32(0x9E3779B9))
    pn1 = perlin_noise(jnp.stack(
        [(center_x * (th * gl[..., G_REPV] + r1) + center_y) / safe_period,
         jnp.zeros_like(r1), jnp.zeros_like(r1)], -1))
    pn2 = perlin_noise(jnp.stack(
        [(center_y * (tw * gl[..., G_REPU] + r2) + center_x) / safe_period,
         jnp.zeros_like(r2), jnp.zeros_like(r2)], -1))
    umax = umax + jnp.where(period > 0.0, pn1 * d_wp + pn2 * d_wf, 0.0)
    # parametric spot on the segment (irawan.cpp:187-189)
    u = yy / (0.5 * l_seg) * umax
    v = xx * jnp.pi / w_seg
    fil = _filament_integrand(u, v, om_i, om_r, gl[..., G_ALPHA],
                              gl[..., G_BETA], gl[..., G_SS], umax, kappa,
                              w_seg, l_seg, gl[..., G_HWIDTH])
    stp = _staple_integrand(u, v, om_i, om_r, gl[..., G_ALPHA],
                            gl[..., G_BETA], psi, umax, kappa,
                            w_seg, l_seg, gl[..., G_HWIDTH])
    integrand = jnp.where(psi != 0.0, stp, fil)
    # specular intensity variation (irawan.cpp:203-216): Exp(1) noise
    # per fineness cell, clamped at 10
    fine = gl[..., G_FINENESS]
    i1 = jnp.floor((center_x + xx) * fine).astype(jnp.int32)
    i2 = jnp.floor((center_y + yy) * fine).astype(jnp.int32)
    kf = (th * gl[..., G_REPV] * fine).astype(jnp.int32)
    xi = _hash01((i1 * kf + i2).astype(jnp.uint32))
    ivar = jnp.where(fine > 0.0,
                     jnp.minimum(-jnp.log(xi), 10.0), 1.0)
    area_w = gl[..., G_WARPAREA]
    area_f = gl[..., G_WEFTAREA]
    ratio = _safe_div(area_w + area_f,
                      jnp.where(is_weft, area_f, area_w))
    spec = ks * (ivar * gl[..., G_KSMULT] * integrand * ratio)[..., None]
    f_val = spec + kd * gl[..., G_KDMULT][..., None]
    co = jnp.maximum(m.cos_theta(wo), 0.0)
    return jnp.where(upper[..., None], f_val * co[..., None], 0.0)


def irawan_pdf(p, wi, wo):
    """Cosine-hemisphere pdf (irawan.cpp:239)."""
    valid = (m.cos_theta(wi) > 0) & (m.cos_theta(wo) > 0)
    return jnp.where(valid, m.cos_theta(wo) * m.INV_PI, 0.0)


def irawan_sample(p, wi, u2, u1):
    """Cosine-weighted sampling (irawan.cpp:245)."""
    from mitsuba_jax.bsdfs.models import _mask3, _zero_sample

    wo = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    valid = (m.cos_theta(wi) > 0) & (pdf > 0)
    fcos = irawan_eval(p, wi, wo)
    s = _zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, fcos / jnp.maximum(pdf, 1e-9)[..., None]),
        pdf=jnp.where(valid, pdf, 0.0),
        valid=valid,
    )
    return s


def irawan_diffuse_reflectance(p):
    """kd * kdMultiplier of the hit segment (irawan.cpp:227
    getDiffuseReflectance) — per-lane, uv-dependent."""
    c = p.get("_cloth")
    uv = p.get("_uv")
    if c is None or uv is None:
        return p["reflectance"]
    slot = jnp.clip(p["_cloth_slot"], 0, c["gl"].shape[0] - 1)
    gl = c["gl"][slot]
    tw = gl[..., G_TILEW]
    th = gl[..., G_TILEH]
    x = uv[..., 0] * gl[..., G_REPU] * tw
    y = (1.0 - uv[..., 1]) * gl[..., G_REPV] * th
    lx = jnp.mod(jnp.floor(x), tw).astype(jnp.int32)
    ly = jnp.mod(jnp.floor(y), th).astype(jnp.int32)
    yid = c["grid"][slot, ly, lx]
    return c["kd"][slot, yid] * gl[..., G_KDMULT][..., None]
