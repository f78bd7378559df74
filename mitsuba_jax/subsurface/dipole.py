"""Dipole BSSRDF subsurface scattering (Jensen et al. 2001).

Capability parity with reference src/subsurface/dipole.cpp:362-468 (+ the
parallel irradiance sampling process irrproc.cpp and the octree gather
irrtree.cpp).  Wavefront re-design:

  * irradiance sample points: area-weighted surface samples, ALL points'
    irradiance estimated in one vectorized NEE batch (the reference runs an
    `IrradianceSamplingProcess` over worker threads);
  * the octree hierarchy (irrtree.cpp) is replaced by a dense
    (hits × samples) contraction: Lo(x) = Ft/π Σ_i Rd(|x-xi|) E_i A_i —
    a large elementwise+reduction map that XLA tiles well; for big M use
    chunked scan.  No pointer-chasing, no hierarchy.

The adipole/multipole variants (src/subsurface/{adipole,multipole}.cpp)
share this machinery with a different Rd profile; `dipole_rd` is the
classic isotropic profile.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core import math as m
from mitsuba_jax.core import warp
from mitsuba_jax.core.fresnel import fresnel
from mitsuba_jax.core.types import pytree_dataclass, static_field
from mitsuba_jax.emitters import sample_direct
from mitsuba_jax.render.intersect import ray_test
from mitsuba_jax.render.records import Ray


@pytree_dataclass
class DipoleParams:
    sigma_s: jnp.ndarray      # (3,) scattering
    sigma_a: jnp.ndarray      # (3,) absorption
    g: jnp.ndarray            # () HG anisotropy (reduces sigma_s)
    eta: jnp.ndarray          # () relative IOR
    # derived (build-time)
    sigma_tr: jnp.ndarray     # (3,) effective transport coefficient
    zr: jnp.ndarray           # (3,) real source depth
    zv: jnp.ndarray           # (3,) virtual source depth
    alpha_p: jnp.ndarray      # (3,) reduced albedo
    fdr: jnp.ndarray = None   # () diffuse Fresnel reflectance
    fdt: jnp.ndarray = None   # () 1 - fdr


def make_dipole(sigma_s, sigma_a, g: float = 0.0, eta: float = 1.33) -> DipoleParams:
    ss = jnp.asarray(sigma_s, jnp.float32)
    sa = jnp.asarray(sigma_a, jnp.float32)
    ss_p = ss * (1.0 - g)                       # reduced scattering
    st_p = ss_p + sa
    alpha_p = ss_p / jnp.maximum(st_p, 1e-9)
    sigma_tr = jnp.sqrt(3.0 * sa * st_p)
    # boundary condition (reference dipole.cpp configure)
    fdr = -1.440 / eta ** 2 + 0.710 / eta + 0.668 + 0.0636 * eta
    a_bc = (1.0 + fdr) / (1.0 - fdr)
    zr = 1.0 / jnp.maximum(st_p, 1e-9)
    zv = zr * (1.0 + 4.0 / 3.0 * a_bc)
    return DipoleParams(
        sigma_s=ss, sigma_a=sa, g=jnp.asarray(g, jnp.float32),
        eta=jnp.asarray(eta, jnp.float32),
        sigma_tr=sigma_tr, zr=zr, zv=zv, alpha_p=alpha_p,
        fdr=jnp.asarray(fdr, jnp.float32),
        fdt=jnp.asarray(1.0 - fdr, jnp.float32),
    )


def dipole_rd(p: DipoleParams, r):
    """Diffuse reflectance profile Rd(r) (Jensen dipole; reference
    dipole.cpp Rd evaluation). r: (...,) distances → (..., 3)."""
    r = jnp.maximum(r, 1e-4)[..., None]
    dr = jnp.sqrt(r * r + p.zr ** 2)
    dv = jnp.sqrt(r * r + p.zv ** 2)
    c1 = p.zr * (p.sigma_tr + 1.0 / dr)
    c2 = p.zv * (p.sigma_tr + 1.0 / dv)
    rd = (p.alpha_p / (4.0 * jnp.pi)) * (
        c1 * jnp.exp(-p.sigma_tr * dr) / (dr * dr)
        + c2 * jnp.exp(-p.sigma_tr * dv) / (dv * dv)
    )
    return jnp.maximum(rd, 0.0)


def sample_irradiance_points(mesh_or_geom, n_points: int, seed: int = 0,
                             shape_id: int | None = None):
    """Area-weighted surface sample points (host side).

    mesh_or_geom: GeometryTables; optionally restrict to one shape id.
    Returns (points (M,3), normals (M,3), area_per_point ())."""
    v0 = np.asarray(mesh_or_geom.v0)
    e1 = np.asarray(mesh_or_geom.e1)
    e2 = np.asarray(mesh_or_geom.e2)
    sid = np.asarray(mesh_or_geom.shape_id)
    if shape_id is not None:
        mask = sid == shape_id
        v0, e1, e2 = v0[mask], e1[mask], e2[mask]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    total = areas.sum()
    rng = np.random.default_rng(seed)
    ti = rng.choice(len(areas), size=n_points, p=areas / total)
    u = rng.uniform(size=(n_points, 2))
    a = np.sqrt(np.maximum(1.0 - u[:, 0], 0.0))
    b0 = 1.0 - a
    b1 = a * u[:, 1]
    pts = v0[ti] + e1[ti] * b0[:, None] + e2[ti] * b1[:, None]
    nrm = np.cross(e1[ti], e2[ti])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    return (
        jnp.asarray(pts, jnp.float32), jnp.asarray(nrm, jnp.float32),
        jnp.asarray(total / n_points, jnp.float32),
    )


def compute_irradiance(scene, points, normals, n_samples: int = 8,
                       seed: int = 0, indirect_depth: int = 3,
                       n_indirect: int = 4):
    """Irradiance estimate at every sample point, vectorized.

    Direct part: NEE toward the scene's emitters (the reference's
    IrradianceSamplingProcess, irrproc.cpp:44-120). Indirect part
    (reference dipole.cpp:362-468 samples irradiance *via the scene's
    integrator*, indirect included): cosine-sampled hemisphere rays
    evaluated with the wavefront path tracer, with the depth-0
    emitter-hit/env terms gated off (PathConfig.skip_direct_emission)
    so direct light is not double-counted; E_ind = pi * mean L. Set
    indirect_depth=0 for the old direct-only estimate."""
    m_pts = points.shape[0]
    e_total = jnp.zeros((m_pts, 3))
    for s in range(n_samples):
        k = jax.random.fold_in(jax.random.key(seed), s)
        u1 = jax.random.uniform(jax.random.fold_in(k, 1), (m_pts,))
        u2 = jax.random.uniform(jax.random.fold_in(k, 2), (m_pts, 2))
        ds = sample_direct(scene.emitters, scene.geom, points, u1, u2)
        cos_i = jnp.maximum(jnp.sum(normals * ds.d, axis=-1), 0.0)
        eps = m.EPSILON * jnp.maximum(1.0, jnp.abs(points).max(-1))
        shadow = Ray.make(points, ds.d, mint=eps, maxt=ds.dist * (1 - 1e-3))
        occ = ray_test(scene.geom, shadow)
        ok = ds.valid & ~occ & (ds.pdf > 0)
        contrib = ds.value * (cos_i / jnp.maximum(ds.pdf, 1e-20))[:, None]
        e_total = e_total + jnp.where(ok[:, None], contrib, 0.0)
    e_total = e_total / n_samples
    if indirect_depth > 0 and n_indirect > 0:
        e_total = e_total + _indirect_irradiance(
            scene, points, normals, n_indirect, indirect_depth, seed)
    return e_total


def _indirect_irradiance(scene, points, normals, n_ind: int,
                         depth: int, seed: int):
    """pi * E_cos[L_indirect]: cosine-hemisphere rays from each cache
    point traced with the full path integrator (NEE inside), first-
    vertex emission gated off. The scene is stripped of its subsurface
    table: cache points must not gather through the cache being built
    (the reference likewise excludes self-subsurface, dipole.cpp)."""
    import dataclasses as _dc

    from mitsuba_jax.core.types import replace as _replace
    from mitsuba_jax.core.warp import square_to_cosine_hemisphere
    from mitsuba_jax.integrators.path import PathConfig, path_trace
    from mitsuba_jax.render.sampler import Sampler

    m_pts = points.shape[0]
    scene_ni = _replace(scene, subsurface=None)
    cfg = PathConfig(max_depth=depth, spp=1, remat=False,
                     skip_direct_emission=True)
    fr_s, fr_t = _frame_tangents(normals)
    acc = jnp.zeros((m_pts, 3))
    eps = m.EPSILON * jnp.maximum(1.0, jnp.abs(points).max(-1))
    for s in range(n_ind):
        k = jax.random.fold_in(jax.random.key(seed ^ 0x5A5A), s)
        u2 = jax.random.uniform(jax.random.fold_in(k, 3), (m_pts, 2))
        d_loc = square_to_cosine_hemisphere(u2)
        d = (fr_s * d_loc[:, 0:1] + fr_t * d_loc[:, 1:2]
             + normals * d_loc[:, 2:3])
        ray = Ray.make(points, d, mint=eps)
        sampler = Sampler(seed * 131 + 7 + s, jnp.arange(m_pts),
                          jnp.zeros(m_pts, jnp.int32))
        L, _aux = path_trace(scene_ni, ray, sampler, cfg)
        acc = acc + L
    # cosine-weighted estimator: E = pi * mean(L) (pdf = cos/pi)
    return jnp.pi * acc / n_ind


def _frame_tangents(n):
    """Orthonormal tangents for normals n (N, 3)."""
    fr = m.Frame.from_normal(n)
    return fr.s, fr.t


@pytree_dataclass
class DipoleCache:
    params: DipoleParams
    points: jnp.ndarray       # (M, 3)
    irradiance: jnp.ndarray   # (M, 3)
    area: jnp.ndarray         # () per-point area


def prepare_dipole(scene, params: DipoleParams, n_points: int = 1024,
                   n_irr_samples: int = 8, seed: int = 0,
                   shape_id: int | None = None) -> DipoleCache:
    pts, nrm, area = sample_irradiance_points(
        scene.geom, n_points, seed=seed, shape_id=shape_id
    )
    irr = compute_irradiance(scene, pts, nrm, n_samples=n_irr_samples, seed=seed)
    return DipoleCache(params=params, points=pts, irradiance=irr, area=area)


def dipole_lo(cache: DipoleCache, x, wo_cos, chunk: int = 512):
    """Outgoing subsurface radiance at hit points x (N,3) with |cos| of the
    outgoing direction (for the Fresnel transmission term).

    Lo = Ft(wo)/pi * Σ_i Rd(|x - p_i|) E_i A_i  (reference dipole.cpp Lo).
    The Σ runs as a scan over sample chunks — dense, vectorized, no octree.
    """
    p = cache.params
    n_pts = cache.points.shape[0]
    pad = (-n_pts) % chunk
    pts = jnp.pad(cache.points, ((0, pad), (0, 0)))
    irr = jnp.pad(cache.irradiance, ((0, pad), (0, 0)))
    pts_c = pts.reshape(-1, chunk, 3)
    irr_c = irr.reshape(-1, chunk, 3)

    def step(acc, ci):
        cp, ce = ci
        d = jnp.linalg.norm(x[:, None, :] - cp[None, :, :], axis=-1)  # (N, C)
        rd = dipole_rd(p, d)                                          # (N, C, 3)
        return acc + jnp.sum(rd * ce[None, :, :], axis=1), None

    acc0 = jnp.zeros((x.shape[0], 3))
    mo, _ = jax.lax.scan(step, acc0, (pts_c, irr_c))
    ft = 1.0 - fresnel(wo_cos, jnp.ones_like(p.eta), p.eta)
    return mo * cache.area * (ft * m.INV_PI)[..., None]


# ---------------------------------------------------------------------------
# Profile variants: multipole (thin slabs) and adipole (anisotropic)
# (reference src/subsurface/multipole.cpp, adipole.cpp — both share the
# sample-point machinery above with a different Rd)
# ---------------------------------------------------------------------------

def multipole_rd(p: DipoleParams, r, thickness: float, n_poles: int = 3):
    """Thin-slab multipole Rd: mirror image sources across both slab
    boundaries (Donner & Jensen 2005; reference multipole.cpp).

    thickness: slab thickness in the same units as r."""
    r = jnp.maximum(r, 1e-4)[..., None]
    d_slab = thickness + p.zv - p.zr   # effective extrapolated slab depth
    total = jnp.zeros(r.shape[:-1] + (3,))
    for i in range(-n_poles, n_poles + 1):
        zri = 2.0 * i * d_slab + p.zr
        zvi = 2.0 * i * d_slab - p.zv
        dr = jnp.sqrt(r * r + zri ** 2)
        dv = jnp.sqrt(r * r + zvi ** 2)
        # signed depths: for i=0, zvi = -zv so the -c2 term reduces to the
        # dipole's +zv virtual-source contribution
        c1 = zri * (p.sigma_tr + 1.0 / dr)
        c2 = zvi * (p.sigma_tr + 1.0 / dv)
        total = total + (p.alpha_p / (4.0 * jnp.pi)) * (
            c1 * jnp.exp(-p.sigma_tr * dr) / (dr * dr)
            - c2 * jnp.exp(-p.sigma_tr * dv) / (dv * dv)
        )
    return jnp.maximum(total, 0.0)


def adipole_rd(p: DipoleParams, r_vec, aniso_dir, aniso_ratio: float = 2.0):
    """Anisotropic dipole (fork's adipole.cpp capability): the diffusion
    length differs along a preferred surface direction — distances are
    measured in a stretched metric.

    r_vec: (..., 3) surface offset vectors (not just radii);
    aniso_dir: unit direction of slower diffusion."""
    along = jnp.sum(r_vec * aniso_dir, axis=-1)
    perp = r_vec - along[..., None] * aniso_dir
    r_eff = jnp.sqrt(
        (along / aniso_ratio) ** 2 + jnp.sum(perp * perp, axis=-1)
    )
    return dipole_rd(p, r_eff)


# ---------------------------------------------------------------------------
# Scene integration: stacked per-entry tables consumed by the path tracer
# (reference interface include/mitsuba/render/subsurface.h: Subsurface
# plugins attach to shapes, preprocess() builds irradiance samples,
# Lo() is called from the integrator — here the analog is a pytree on
# Scene and a masked Lo term in integrators/path.py.)
# ---------------------------------------------------------------------------


@pytree_dataclass
class SceneSubsurface:
    """All subsurface entries of a scene, stacked: S entries x K points.

    Profiles are unified as pole sums (dipole = 1 pole pair, multipole =
    2·n_poles+1 pairs with mirrored depths; reference multipole.cpp) over
    an anisotropically stretched distance metric (adipole.cpp capability;
    ratio 1 = isotropic). Unused pole slots sit at _PAD_DEPTH where their
    contribution underflows to zero."""
    sigma_tr: jnp.ndarray     # (S, 3)
    zri: jnp.ndarray          # (S, P, 3) real-source depths per pole
    zvi: jnp.ndarray          # (S, P, 3) virtual-source depths (signed)
    alpha_p: jnp.ndarray      # (S, 3)
    eta: jnp.ndarray          # (S,)
    fdr: jnp.ndarray          # (S,)
    fdt: jnp.ndarray          # (S,)
    ss_factor: jnp.ndarray    # (S, 3)
    aniso_dir: jnp.ndarray    # (S, 3) slow-diffusion direction (adipole)
    aniso_ratio: jnp.ndarray  # (S,) metric stretch along aniso_dir (1=iso)
    points: jnp.ndarray       # (S, K, 3)
    normals: jnp.ndarray      # (S, K, 3)
    area: jnp.ndarray         # (S,) area per point
    mat_ss: jnp.ndarray       # (n_materials,) material -> entry id or -1
    irradiance: jnp.ndarray = None  # (S, K, 3), filled at render start

    @property
    def n_entries(self):
        return self.points.shape[0]


_PAD_DEPTH = 1e6   # pole padding depth; exp(-sigma_tr * 1e6) == 0


def _entry_poles(p: DipoleParams, profile: str, thickness: float,
                 n_poles: int):
    """Per-entry (zri, zvi) pole-pair lists (numpy, shape (P, 3))."""
    import numpy as _np

    zr = _np.asarray(p.zr)
    zv = _np.asarray(p.zv)
    if profile == "multipole":
        d_slab = thickness + zv - zr
        pairs = [(2.0 * i * d_slab + zr, 2.0 * i * d_slab - zv)
                 for i in range(-n_poles, n_poles + 1)]
    else:   # dipole / adipole: single pair, zvi = -zv (see multipole_rd)
        pairs = [(zr, -zv)]
    return (_np.stack([a for a, _ in pairs]),
            _np.stack([b for _, b in pairs]))


def build_scene_subsurface(entries, n_materials: int,
                           geom, n_points: int = 512):
    """Host-side build. entries: list of dicts with keys material_id,
    sigma_s, sigma_a, g, eta, ss_factor. Points are sampled area-weighted
    on the triangles carrying each entry's material."""
    import numpy as _np

    mat_ss = _np.full(n_materials, -1, _np.int32)
    rows = dict(sigma_tr=[], alpha_p=[], eta=[], fdr=[],
                fdt=[], ss_factor=[], aniso_dir=[], aniso_ratio=[])
    zri_all, zvi_all = [], []
    pts_all, nrm_all, area_all = [], [], []
    v0 = _np.asarray(geom.v0)
    e1 = _np.asarray(geom.e1)
    e2 = _np.asarray(geom.e2)
    mid_tri = _np.asarray(geom.material_id)
    for si, e in enumerate(entries):
        mat_ss[e["material_id"]] = si
        p = make_dipole(e["sigma_s"], e["sigma_a"], g=e.get("g", 0.0),
                        eta=e.get("eta", 1.33))
        profile = e.get("profile", "dipole")
        zri, zvi = _entry_poles(p, profile,
                                float(e.get("thickness", 1.0)),
                                int(e.get("n_poles", 3)))
        zri_all.append(zri)
        zvi_all.append(zvi)
        if profile == "adipole":
            ad = _np.asarray(e.get("aniso_dir", (1.0, 0.0, 0.0)),
                             _np.float32)
            ad = ad / max(float(_np.linalg.norm(ad)), 1e-12)
            rows["aniso_dir"].append(jnp.asarray(ad))
            rows["aniso_ratio"].append(
                jnp.asarray(float(e.get("aniso_ratio", 2.0))))
        else:
            rows["aniso_dir"].append(jnp.asarray([1.0, 0.0, 0.0]))
            rows["aniso_ratio"].append(jnp.asarray(1.0))
        rows["sigma_tr"].append(p.sigma_tr)
        rows["alpha_p"].append(p.alpha_p)
        rows["eta"].append(p.eta)
        rows["fdr"].append(p.fdr)
        rows["fdt"].append(p.fdt)
        rows["ss_factor"].append(
            jnp.asarray(e.get("ss_factor", (1.0, 1.0, 1.0)), jnp.float32))
        mask = mid_tri == e["material_id"]
        if not mask.any():
            raise ValueError(
                f"subsurface entry {si}: no triangles with material "
                f"{e['material_id']}")
        mv0, me1, me2 = v0[mask], e1[mask], e2[mask]
        areas = 0.5 * _np.linalg.norm(_np.cross(me1, me2), axis=-1)
        total = float(areas.sum())
        rng = _np.random.default_rng(123 + si)
        ti = rng.choice(len(areas), size=n_points, p=areas / areas.sum())
        u = rng.uniform(size=(n_points, 2))
        a = _np.sqrt(_np.maximum(1.0 - u[:, 0], 0.0))
        b0, b1 = 1.0 - a, a * u[:, 1]
        pts = mv0[ti] + me1[ti] * b0[:, None] + me2[ti] * b1[:, None]
        nrm = _np.cross(me1[ti], me2[ti])
        nrm /= _np.maximum(_np.linalg.norm(nrm, axis=-1, keepdims=True),
                           1e-20)
        pts_all.append(pts)
        nrm_all.append(nrm)
        area_all.append(total / n_points)
    # pad pole arrays to a common P (padded poles at _PAD_DEPTH -> zero)
    p_max = max(z.shape[0] for z in zri_all)
    zri_all = [_np.concatenate(
        [z, _np.full((p_max - z.shape[0], 3), _PAD_DEPTH)]) for z in zri_all]
    zvi_all = [_np.concatenate(
        [z, _np.full((p_max - z.shape[0], 3), _PAD_DEPTH)]) for z in zvi_all]
    return SceneSubsurface(
        **{k: jnp.stack(v) for k, v in rows.items()},
        zri=jnp.asarray(_np.stack(zri_all), jnp.float32),
        zvi=jnp.asarray(_np.stack(zvi_all), jnp.float32),
        points=jnp.asarray(_np.stack(pts_all), jnp.float32),
        normals=jnp.asarray(_np.stack(nrm_all), jnp.float32),
        area=jnp.asarray(_np.asarray(area_all), jnp.float32),
        mat_ss=jnp.asarray(mat_ss),
    )


def prepare_scene_irradiance(scene, n_samples: int = 8, seed: int = 7):
    """Fill SceneSubsurface.irradiance via the vectorized estimator
    (the reference irrproc.cpp analog; direct NEE plus the default-on
    indirect bounce estimate, see compute_irradiance(indirect_depth=3))."""
    ss = scene.subsurface
    S, K, _ = ss.points.shape
    pts = ss.points.reshape(S * K, 3)
    nrm = ss.normals.reshape(S * K, 3)
    irr = compute_irradiance(scene, pts, nrm, n_samples=n_samples,
                             seed=seed)
    from mitsuba_jax.core.types import replace as _replace
    return _replace(ss, irradiance=irr.reshape(S, K, 3))


def scene_ss_lo(ss: SceneSubsurface, s: int, x, wo_cos, chunk: int = 256):
    """Outgoing dipole radiance of entry `s` at hit points x (N,3).

    Reference dipole.cpp Lo: Mo = sum_i Rd(|x-p_i|) E_i A_i Fdt;
    Lo = Mo * ssFactor / pi * (eta==1 ? 1 : Ft(cos_o)/Fdr).
    Rd is the generic pole sum over the entry's (zri, zvi) pairs in the
    anisotropically stretched metric — dipole (1 pair, ratio 1),
    multipole (2·n_poles+1 pairs; multipole.cpp) and adipole (stretched
    metric; adipole.cpp) all evaluate through this one path."""
    sigma_tr = ss.sigma_tr[s]
    alpha_p = ss.alpha_p[s]
    zri = ss.zri[s]                      # (P, 3)
    zvi = ss.zvi[s]
    eta = ss.eta[s]
    fdr = ss.fdr[s]
    adir = ss.aniso_dir[s]
    aratio = ss.aniso_ratio[s]
    K = ss.points.shape[1]
    pad = (-K) % chunk
    pts = jnp.pad(ss.points[s], ((0, pad), (0, 0)))
    irr = jnp.pad(ss.irradiance[s], ((0, pad), (0, 0)))
    pts_c = pts.reshape(-1, chunk, 3)
    irr_c = irr.reshape(-1, chunk, 3)

    def rd_poles(r):
        """Pole-sum Rd; r: (...,) stretched distances -> (..., 3)."""
        r = jnp.maximum(r, 1e-4)[..., None]
        total = jnp.zeros(r.shape[:-1] + (3,))
        for pi in range(zri.shape[0]):
            dr = jnp.sqrt(r * r + zri[pi] ** 2)
            dv = jnp.sqrt(r * r + zvi[pi] ** 2)
            c1 = zri[pi] * (sigma_tr + 1.0 / dr)
            c2 = zvi[pi] * (sigma_tr + 1.0 / dv)
            total = total + (alpha_p / (4.0 * jnp.pi)) * (
                c1 * jnp.exp(-sigma_tr * dr) / (dr * dr)
                - c2 * jnp.exp(-sigma_tr * dv) / (dv * dv))
        return jnp.maximum(total, 0.0)

    def step(acc, ci):
        cp, ce = ci
        rv = x[:, None, :] - cp[None, :, :]
        along = jnp.sum(rv * adir, axis=-1)
        r_eff = jnp.sqrt(jnp.maximum(
            jnp.sum(rv * rv, axis=-1)
            + (1.0 / (aratio * aratio) - 1.0) * along * along, 0.0))
        rd = rd_poles(r_eff)
        return acc + jnp.sum(rd * ce[None, :, :], axis=1), None

    mo, _ = jax.lax.scan(step, jnp.zeros((x.shape[0], 3)), (pts_c, irr_c))
    mo = mo * ss.area[s] * ss.fdt[s]
    ft = 1.0 - fresnel(wo_cos, jnp.ones_like(eta), eta)
    bdy = jnp.where(jnp.abs(eta - 1.0) < 1e-4, 1.0,
                    ft / jnp.maximum(fdr, 1e-4))
    return mo * ss.ss_factor[s] * m.INV_PI * bdy[..., None]


def scene_ss_lo_hier(ss: SceneSubsurface, s: int, x, wo_cos,
                     solid_angle_eps: float = 0.05):
    """Host-side hierarchical Lo via the irradiance octree (reference
    src/subsurface/irrtree.h IrradianceOctree::execute): far clusters
    contribute Rd(|x - centroid|) * sum(E_i) instead of per-point terms —
    O(log K) per query vs scene_ss_lo's O(K) scan. Numpy-only: per-query
    tree descent is divergent per lane, so the device render
    path keeps the chunked scan; this serves preview/CPU evaluation and
    cross-checks the scan in tests. Isotropic profiles only (the
    adipole's stretched metric breaks radial clustering — the reference
    irrtree likewise gathers isotropic Rd)."""
    import numpy as np

    from mitsuba_jax.core.octree import Octree

    if abs(float(ss.aniso_ratio[s]) - 1.0) > 1e-6:
        raise ValueError("hierarchical gather supports isotropic profiles"
                         " (aniso_ratio == 1)")
    sigma_tr = np.asarray(ss.sigma_tr[s], np.float64)
    alpha_p = np.asarray(ss.alpha_p[s], np.float64)
    zri = np.asarray(ss.zri[s], np.float64)
    zvi = np.asarray(ss.zvi[s], np.float64)
    eta = float(ss.eta[s])
    fdr = np.asarray(ss.fdr[s], np.float64)
    tree = Octree(np.asarray(ss.points[s]), np.asarray(ss.irradiance[s]),
                  leaf_size=8)

    def rd(r):
        """Pole-sum Rd, per channel: radii (...,) -> (..., 3)."""
        r = np.maximum(np.asarray(r, np.float64), 1e-4)[..., None]
        total = np.zeros(r.shape[:-1] + (3,))
        for pi in range(zri.shape[0]):
            dr = np.sqrt(r * r + zri[pi] ** 2)
            dv = np.sqrt(r * r + zvi[pi] ** 2)
            c1 = zri[pi] * (sigma_tr + 1.0 / dr)
            c2 = zvi[pi] * (sigma_tr + 1.0 / dv)
            total = total + (alpha_p / (4.0 * np.pi)) * (
                c1 * np.exp(-sigma_tr * dr) / (dr * dr)
                - c2 * np.exp(-sigma_tr * dv) / (dv * dv))
        return np.maximum(total, 0.0)

    x = np.atleast_2d(np.asarray(x, np.float64))
    mo = np.stack([tree.gather(xi, rd, solid_angle_eps) for xi in x])
    mo = mo * float(ss.area[s]) * np.asarray(ss.fdt[s])
    ft = 1.0 - np.asarray(fresnel(
        jnp.atleast_1d(jnp.asarray(wo_cos)),
        jnp.ones_like(jnp.atleast_1d(jnp.asarray(wo_cos))),
        jnp.full_like(jnp.atleast_1d(jnp.asarray(wo_cos)), eta)))
    bdy = np.ones_like(ft) if abs(eta - 1.0) < 1e-4 else \
        ft / max(float(fdr.mean()), 1e-4)
    return mo * np.asarray(ss.ss_factor[s], np.float64) / np.pi \
        * bdy[..., None]
