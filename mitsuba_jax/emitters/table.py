"""Emitters (luminaires): SoA table + direct-illumination sampling.

Capability parity with reference src/luminaires/ (area/point/spot/
directional/collimated/constant; envmap & sky in emitters/envmap.py) and the
scene-level power-weighted luminaire selection
(src/librender/scene.cpp:319-330 CDF build, scene.cpp:396 sampleLuminaire,
scene.cpp:381 pdfLuminaire).

Design: one *record* per sampling target —
  records 0..T-1   : every triangle of every area emitter (weight ∝ area×power)
  records T..T+E-1 : each non-area emitter (point/spot/directional/...)
A single global CDF over records replaces the reference's two-level
"choose luminaire, then let it sample a point" scheme with one flat,
gather-friendly choice; the MIS pdf of hitting an area emitter with a BSDF
ray comes from the per-triangle area pdf table.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core import math as m
from mitsuba_jax.core import warp
from mitsuba_jax.core.spectrum import luminance
from mitsuba_jax.core.types import pytree_dataclass, static_field
from mitsuba_jax.render.records import DirectSample

AREA, POINT, SPOT, DIRECTIONAL, COLLIMATED, CONSTANT, ENVMAP, SKY, \
    SPHERE = range(9)

DELTA_KINDS = (POINT, SPOT, DIRECTIONAL, COLLIMATED)


@pytree_dataclass
class EmitterTable:
    # per-emitter data (E rows)
    kind: jnp.ndarray        # (E,) int32
    radiance: jnp.ndarray    # (E,3) radiance (area/constant) or intensity (point/spot)
    position: jnp.ndarray    # (E,3) point/spot/collimated origin
    direction: jnp.ndarray   # (E,3) spot/directional/collimated axis (unit)
    cutoff_cos: jnp.ndarray  # (E,) spot cos(total cutoff)
    falloff_cos: jnp.ndarray # (E,) spot cos(falloff start)
    # per-triangle area-emitter tables (T rows, aligned with GeometryTables)
    tri_pdf_area: jnp.ndarray  # (T,) selection-prob × (1/area) for NEE; 0 if not emissive
    # sampling records: R = T_emissive + E_other. The triangle range is
    # COMPACTED to emissive triangles only — the reference's scene-level
    # CDF also spans only luminaires (scene.cpp:319-330); a record per
    # scene triangle forced every NEE sample through a log2(n_tris)
    # searchsorted gather chain when n_rec > 128, for rows that could
    # never be sampled
    rec_cdf: jnp.ndarray       # (R,) CDF over records
    rec_pmf: jnp.ndarray       # (R,)
    rec_emitter: jnp.ndarray   # (R,) emitter id per record
    rec_prim: jnp.ndarray = None  # (R,) triangle id of each tri record
                                  # (records >= n_tri_records carry 0)
    radius: jnp.ndarray = None  # (E,) analytic sphere emitter radius
    # environment map tables (lat-long; sky is baked to the same form)
    env_image: jnp.ndarray = None      # (He, We, 3)
    env_prob: jnp.ndarray = None       # (He*We,) alias-table keep prob
    env_alias: jnp.ndarray = None      # (He*We,) alias-table partner
    env_pdf_img: jnp.ndarray = None    # (He, We) solid-angle pdf
    env_to_world: jnp.ndarray = None   # (4,4) env-frame -> world rotation
    env_to_env: jnp.ndarray = None     # (4,4) inverse
    n_tri_records: int = static_field(default=0)
    kinds_present: tuple = static_field(default=())
    env_id: int = static_field(default=-1)   # constant/env emitter id or -1
    env_kind: int = static_field(default=-1)  # CONSTANT/ENVMAP/SKY or -1

    @property
    def n_emitters(self):
        return self.kind.shape[0]

    @property
    def has_surface_emitters(self) -> bool:
        """Static: any emitter a BSDF ray can HIT (area triangles or
        analytic spheres). When False the emitter-hit MIS term is
        identically zero — callers skip its gathers at trace time
        (env-only scenes would pay an all-zero le + a tri_pdf_area
        gather of zeros every bounce)."""
        return AREA in self.kinds_present or SPHERE in self.kinds_present


class EmitterBuilder:
    """Host-side accumulation of emitters; area emitters bind to shapes."""

    def __init__(self):
        self.rows = []           # per-emitter dicts
        self.area_shapes = []    # (emitter_idx, mesh) for area lights

    def _add(self, **kw):
        d = dict(
            kind=AREA, radiance=(1.0, 1.0, 1.0), position=(0, 0, 0),
            direction=(0, 0, 1), cutoff_cos=np.cos(np.deg2rad(20.0)),
            falloff_cos=np.cos(np.deg2rad(15.0)),
        )
        d.update(kw)
        self.rows.append(d)
        return len(self.rows) - 1

    def area(self, mesh, radiance):
        """Area luminaire attached to a mesh (src/luminaires/area.cpp)."""
        e = self._add(kind=AREA, radiance=radiance)
        self.area_shapes.append((e, mesh))
        return e

    def point(self, position, intensity):
        return self._add(kind=POINT, position=position, radiance=intensity)

    def sphere_area(self, center, radius, radiance):
        """Analytic sphere area emitter, sampled by solid angle (reference
        src/shapes/sphere.cpp:359 sampleSolidAngle — cone sampling toward
        the sphere; far lower variance than area-sampling a tessellated
        ball and exact)."""
        return self._add(kind=SPHERE, position=center, radiance=radiance,
                         radius=float(radius))

    def spot(self, position, direction, intensity, cutoff_deg=20.0, falloff_deg=15.0):
        d = np.asarray(direction, np.float64)
        return self._add(
            kind=SPOT, position=position, direction=d / np.linalg.norm(d),
            radiance=intensity,
            cutoff_cos=np.cos(np.deg2rad(cutoff_deg)),
            falloff_cos=np.cos(np.deg2rad(falloff_deg)),
        )

    def directional(self, direction, irradiance):
        d = np.asarray(direction, np.float64)
        return self._add(kind=DIRECTIONAL, direction=d / np.linalg.norm(d),
                         radiance=irradiance)

    def constant(self, radiance):
        """Constant environment luminaire (src/luminaires/constant.cpp)."""
        return self._add(kind=CONSTANT, radiance=radiance)

    def collimated(self, position, direction, radiance, radius: float = 0.01):
        """Collimated disk beam (src/luminaires/collimated.cpp:29-32):
        parallel light of the given radiance within a cylinder of `radius`
        around the axis position + t*direction. `cutoff_cos` row slot
        stores the beam radius."""
        d = np.asarray(direction, np.float64)
        return self._add(
            kind=COLLIMATED, position=position, direction=d / np.linalg.norm(d),
            radiance=radiance, cutoff_cos=float(radius),
        )

    def envmap(self, image, to_world=None, scale: float = 1.0):
        """Lat-long environment map (src/luminaires/envmap.cpp)."""
        img = np.asarray(image, np.float32)[:, :, :3] * scale
        self._env_image = img
        self._env_to_world = np.asarray(to_world, np.float32) if to_world is not None else np.eye(4, dtype=np.float32)
        mean_rad = img.reshape(-1, 3).mean(0)
        return self._add(kind=ENVMAP, radiance=tuple(mean_rad))

    def sky(self, turbidity: float = 3.0, sun_dir=(0.0, 1.0, 0.0),
            scale: float = 1.0, resolution: int = 128, extend_below=True):
        """Preetham sun/sky (src/luminaires/sky.cpp) baked to a lat-long
        map so it shares the envmap importance sampler."""
        import jax.numpy as _jnp
        from mitsuba_jax.emitters.envmap import latlong_uv_to_dir, preetham_sky

        h, w = resolution, resolution * 2
        uu, vv = np.meshgrid(
            (np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h
        )
        # lat-long frame: +z pole; rotate so zenith (+y world) maps to pole
        d = np.asarray(latlong_uv_to_dir(_jnp.asarray(np.stack([uu, vv], -1))))
        d_world = np.stack([d[..., 0], d[..., 2], d[..., 1]], -1)  # z<->y swap
        img = np.asarray(
            preetham_sky(_jnp.asarray(d_world.reshape(-1, 3)),
                         sun_dir, turbidity, scale, extend_below)
        ).reshape(h, w, 3)
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float32).T
        self._env_image = img.astype(np.float32)
        self._env_to_world = rot
        return self._add(kind=SKY, radiance=tuple(img.reshape(-1, 3).mean(0)))

    def build(self, tri_emitter_id, tri_areas) -> EmitterTable:
        """tri_emitter_id: (T,) per-triangle emitter binding (-1 none) in BVH
        order; tri_areas: (T,) triangle areas."""
        if not self.rows:
            # no emitters: single dummy row, zero CDF
            self.rows.append(
                dict(kind=POINT, radiance=(0, 0, 0), position=(0, 0, 0),
                     direction=(0, 0, 1), cutoff_cos=0.0, falloff_cos=0.0)
            )
        e = len(self.rows)
        kind = np.array([r["kind"] for r in self.rows], np.int32)
        # spectral rendering: widen radiance rows to the widest channel
        # count (uniform grays broadcast; cf. MaterialBuilder.build)
        c = max(len(np.atleast_1d(r["radiance"])) for r in self.rows)
        if c != 3:
            for r in self.rows:
                v = np.asarray(r["radiance"], np.float32).reshape(-1)
                if v.shape[0] != c:
                    if not np.all(v == v[0]):
                        raise ValueError(
                            f"emitter radiance width {v.shape[0]} cannot "
                            f"widen to {c} spectral channels (non-uniform)")
                    v = np.full(c, v[0], np.float32)
                r["radiance"] = v
        radiance = np.array([r["radiance"] for r in self.rows], np.float32)
        t = int(tri_emitter_id.shape[0])
        tri_emitter_id = np.asarray(tri_emitter_id)
        tri_areas = np.asarray(tri_areas, np.float64)

        # record weights: emissive triangles weighted by area × luminance
        # (BT.709 luminance for RGB; channel mean for n-bin spectra —
        # selection weights only need relative brightness)
        if radiance.shape[-1] == 3:
            lum = np.maximum(
                0.212671 * radiance[:, 0] + 0.71516 * radiance[:, 1]
                + 0.072169 * radiance[:, 2], 0.0)
        else:
            lum = np.maximum(radiance.mean(axis=-1), 0.0)
        tri_w = np.where(
            tri_emitter_id >= 0,
            tri_areas * lum[np.clip(tri_emitter_id, 0, e - 1)],
            0.0,
        )
        radius_arr = np.array([float(r.get("radius", 0.0))
                               for r in self.rows], np.float32)
        other_ids = [i for i in range(e) if kind[i] != AREA and lum[i] > 0]
        other_w = [lum[i] * (4.0 * np.pi * radius_arr[i] ** 2
                             if kind[i] == SPHERE else 4.0 * np.pi)
                   for i in other_ids]
        # compact the triangle range to emissive triangles (see the
        # EmitterTable field comment): selection is unchanged — zero-
        # weight records never altered the CDF mapping — but n_rec drops
        # from n_tris+E to n_emissive_tris+E, keeping sample_direct on
        # the linear compare-sum path for typical scenes
        emissive = np.nonzero((tri_w > 0) & (tri_areas > 0))[0]
        t_rec = int(emissive.shape[0])
        rec_w = np.concatenate([tri_w[emissive],
                                np.asarray(other_w, np.float64)])
        total = rec_w.sum()
        pmf = rec_w / total if total > 0 else np.zeros_like(rec_w)
        if pmf.size == 0:       # no emitters at all: one dead record
            pmf = np.zeros(1)
            rec_w = np.zeros(1)
        cdf = np.cumsum(pmf)
        rec_emitter = np.concatenate(
            [np.clip(tri_emitter_id, 0, e - 1)[emissive],
             np.asarray(other_ids, np.int64)]).astype(np.int32)
        if rec_emitter.size == 0:
            rec_emitter = np.zeros(1, np.int32)
        rec_prim = np.zeros(rec_emitter.size, np.int32)
        rec_prim[:t_rec] = emissive

        # per-triangle NEE area pdf: P(pick tri) / area  (0 for
        # non-emissive) — stays full (T,) width, indexed by prim id in
        # pdf_direct_area (the MIS counterweight for BSDF rays)
        tri_pdf_area = np.zeros(t)
        if t_rec:
            tri_pdf_area[emissive] = pmf[:t_rec] / np.maximum(
                tri_areas[emissive], 1e-20)

        env_id = -1
        env_kind = -1
        for i in range(e):
            if kind[i] in (CONSTANT, ENVMAP, SKY):
                env_id = i
                env_kind = int(kind[i])
        env_image = getattr(self, "_env_image", None)
        if env_image is not None:
            from mitsuba_jax.emitters.envmap import build_env_cdfs

            prob, alias, pdf_img = build_env_cdfs(env_image)
            env_to_world = getattr(self, "_env_to_world", np.eye(4, dtype=np.float32))
            env_fields = dict(
                env_image=jnp.asarray(env_image),
                env_prob=jnp.asarray(prob),
                env_alias=jnp.asarray(alias),
                env_pdf_img=jnp.asarray(pdf_img),
                env_to_world=jnp.asarray(env_to_world),
                env_to_env=jnp.asarray(np.linalg.inv(env_to_world)),
            )
        else:
            env_fields = dict(
                env_image=jnp.zeros((1, 1, 3)),
                env_prob=jnp.ones((1,)),
                env_alias=jnp.zeros((1,), jnp.int32),
                env_pdf_img=jnp.full((1, 1), 0.25 / np.pi, np.float32),
                env_to_world=jnp.eye(4),
                env_to_env=jnp.eye(4),
            )
        return EmitterTable(
            **env_fields,
            env_kind=env_kind,
            kind=jnp.asarray(kind),
            radiance=jnp.asarray(radiance),
            position=jnp.asarray(
                np.array([r["position"] for r in self.rows], np.float32)
            ),
            direction=jnp.asarray(
                np.array([r["direction"] for r in self.rows], np.float32)
            ),
            cutoff_cos=jnp.asarray(
                np.array([r["cutoff_cos"] for r in self.rows], np.float32)
            ),
            falloff_cos=jnp.asarray(
                np.array([r["falloff_cos"] for r in self.rows], np.float32)
            ),
            radius=jnp.asarray(radius_arr),
            tri_pdf_area=jnp.asarray(tri_pdf_area, jnp.float32),
            rec_cdf=jnp.asarray(cdf, jnp.float32),
            rec_pmf=jnp.asarray(pmf, jnp.float32),
            rec_emitter=jnp.asarray(rec_emitter),
            rec_prim=jnp.asarray(rec_prim),
            n_tri_records=t_rec,
            kinds_present=tuple(sorted(set(int(k) for k in kind))),
            env_id=env_id,
        )


# ---------------------------------------------------------------------------
# Direct sampling (NEE) — reference Scene::sampleLuminaire (scene.cpp:396)
# ---------------------------------------------------------------------------

def sample_direct(em: EmitterTable, geom, p_ref, u_select, u_pos) -> DirectSample:
    """Sample a direction toward the scene's emitters from points p_ref.

    geom: GeometryTables (for area-emitter triangle data).
    u_select: (N,) uniform for record selection; u_pos: (N,2) position sample.
    Returns DirectSample with pdf in solid-angle measure and
    value = emitted radiance (NOT divided by pdf — caller divides).
    """
    n = p_ref.shape[0]
    n_rec = em.rec_pmf.shape[0]
    small = n_rec <= 128
    if small:
        # small record sets: linear compare-sum beats searchsorted's gather
        # loop
        rec = jnp.sum(
            (u_select[:, None] > em.rec_cdf[None, :]).astype(jnp.int32), axis=1
        )
    else:
        rec = jnp.searchsorted(em.rec_cdf, u_select, side="right")
    rec = jnp.clip(rec, 0, n_rec - 1).astype(jnp.int32)
    pmf = em.rec_pmf[rec]
    eid = em.rec_emitter[rec]
    kind = em.kind[eid]
    is_tri = rec < em.n_tri_records

    n_ch = em.radiance.shape[-1]
    out_d = jnp.zeros((n, 3))
    out_dist = jnp.full((n,), jnp.inf)
    out_n = jnp.zeros((n, 3))
    out_value = jnp.zeros((n, n_ch))
    out_pdf = jnp.zeros((n,))
    out_delta = jnp.zeros((n,), bool)
    valid = pmf > 0

    kinds = em.kinds_present
    if AREA in kinds:
        ti = em.rec_prim[jnp.clip(rec, 0, em.rec_prim.shape[0] - 1)]
        v0_s, e1_s, e2_s = geom.v0[ti], geom.e1[ti], geom.e2[ti]
        pdf_area = em.tri_pdf_area[ti]
        bary = warp.square_to_uniform_triangle(u_pos)
        pos = v0_s + e1_s * bary[:, :1] + e2_s * bary[:, 1:2]
        nrm = m.normalize(jnp.cross(e1_s, e2_s))
        to_l = pos - p_ref
        dist2 = jnp.maximum(m.squared_length(to_l), 1e-12)
        dist = jnp.sqrt(dist2)
        d = to_l / dist[:, None]
        cos_l = m.dot(nrm, -d)              # one-sided: emits on normal side
        pdf_sa = pdf_area * dist2 / jnp.maximum(cos_l, 1e-8)
        ok = is_tri & (cos_l > 1e-6) & (pdf_area > 0)
        out_d = jnp.where(ok[:, None], d, out_d)
        out_dist = jnp.where(ok, dist, out_dist)
        out_n = jnp.where(ok[:, None], nrm, out_n)
        out_value = jnp.where(ok[:, None], em.radiance[eid], out_value)
        out_pdf = jnp.where(ok, pdf_sa, out_pdf)
        valid = valid & jnp.where(is_tri, ok, True)

    sel_other = ~is_tri
    if SPHERE in kinds:
        # solid-angle (cone) sampling toward the sphere
        # (reference sphere.cpp:359): pdf = 1/(2 pi (1 - cos_max))
        mask = sel_other & (kind == SPHERE)
        c = em.position[eid]
        r = em.radius[eid]
        dc_v = c - p_ref
        dc2 = jnp.maximum(m.squared_length(dc_v), 1e-12)
        dc = jnp.sqrt(dc2)
        outside = dc > r * (1.0 + 1e-5)
        sin2_max = jnp.clip(r * r / dc2, 0.0, 1.0 - 1e-7)
        cos_max = jnp.sqrt(1.0 - sin2_max)
        cos_t = 1.0 - u_pos[:, 0] * (1.0 - cos_max)
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        phi = 2.0 * jnp.pi * u_pos[:, 1]
        axis = dc_v / dc[:, None]
        fr = m.Frame.from_normal(axis)
        d = fr.to_world(jnp.stack(
            [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1))
        disc = jnp.maximum(r * r - dc2 * (1.0 - cos_t * cos_t), 0.0)
        dist = dc * cos_t - jnp.sqrt(disc)
        nrm = m.normalize(p_ref + d * dist[:, None] - c)
        # selection pmf folds into the solid-angle pdf (same convention as
        # the triangle records' pdf_area = pmf/area)
        pdf_sa = pmf / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_max), 1e-9)
        ok = mask & outside
        out_d = jnp.where(ok[:, None], d, out_d)
        out_dist = jnp.where(ok, dist, out_dist)
        out_n = jnp.where(ok[:, None], nrm, out_n)
        out_value = jnp.where(ok[:, None], em.radiance[eid], out_value)
        out_pdf = jnp.where(ok, pdf_sa, out_pdf)
        valid = valid & jnp.where(mask, ok, True)
        sel_other = sel_other & (kind != SPHERE)

    if POINT in kinds:
        mask = sel_other & (kind == POINT)
        to_l = em.position[eid] - p_ref
        dist2 = jnp.maximum(m.squared_length(to_l), 1e-12)
        dist = jnp.sqrt(dist2)
        d = to_l / dist[:, None]
        # value = intensity / dist^2 ; pdf folded as discrete (delta)
        out_d = jnp.where(mask[:, None], d, out_d)
        out_dist = jnp.where(mask, dist, out_dist)
        out_value = jnp.where(
            mask[:, None], em.radiance[eid] / dist2[:, None], out_value
        )
        out_pdf = jnp.where(mask, pmf, out_pdf)
        out_delta = out_delta | mask
    if SPOT in kinds:
        mask = sel_other & (kind == SPOT)
        to_l = em.position[eid] - p_ref
        dist2 = jnp.maximum(m.squared_length(to_l), 1e-12)
        dist = jnp.sqrt(dist2)
        d = to_l / dist[:, None]
        cos_a = m.dot(em.direction[eid], -d)
        cc, fc = em.cutoff_cos[eid], em.falloff_cos[eid]
        fall = jnp.clip((cos_a - cc) / jnp.maximum(fc - cc, 1e-6), 0.0, 1.0)
        inten = em.radiance[eid] * fall[:, None]
        inside = cos_a > cc
        out_d = jnp.where(mask[:, None], d, out_d)
        out_dist = jnp.where(mask, dist, out_dist)
        out_value = jnp.where(
            (mask & inside)[:, None], inten / dist2[:, None], out_value
        )
        out_pdf = jnp.where(mask, pmf, out_pdf)
        out_delta = out_delta | mask
        valid = valid & jnp.where(mask, inside, True)
    if DIRECTIONAL in kinds:
        mask = sel_other & (kind == DIRECTIONAL)
        d = -em.direction[eid]
        out_d = jnp.where(mask[:, None], d, out_d)
        out_dist = jnp.where(mask, 1e7, out_dist)
        out_value = jnp.where(mask[:, None], em.radiance[eid], out_value)
        out_pdf = jnp.where(mask, pmf, out_pdf)
        out_delta = out_delta | mask
    if COLLIMATED in kinds:
        mask = sel_other & (kind == COLLIMATED)
        axis = em.direction[eid]
        rel = p_ref - em.position[eid]
        t_ax = m.dot(rel, axis)
        radial = rel - t_ax[:, None] * axis
        inside = (m.length(radial) <= em.cutoff_cos[eid]) & (t_ax > 0)
        d = -axis
        out_d = jnp.where(mask[:, None], d, out_d)
        out_dist = jnp.where(mask, t_ax, out_dist)
        out_value = jnp.where(
            (mask & inside)[:, None], em.radiance[eid], out_value
        )
        out_pdf = jnp.where(mask, pmf, out_pdf)
        out_delta = out_delta | mask
        valid = valid & jnp.where(mask, inside, True)
    if CONSTANT in kinds:
        mask = sel_other & (kind == CONSTANT)
        d = warp.square_to_uniform_sphere(u_pos)
        out_d = jnp.where(mask[:, None], d, out_d)
        out_dist = jnp.where(mask, 1e7, out_dist)
        out_value = jnp.where(mask[:, None], em.radiance[eid], out_value)
        out_pdf = jnp.where(mask, pmf * m.INV_FOURPI, out_pdf)
    if (ENVMAP in kinds) or (SKY in kinds):
        from mitsuba_jax.emitters.envmap import env_sample

        mask = sel_other & ((kind == ENVMAP) | (kind == SKY))
        # radiance comes straight from the sampled texel (one flat
        # gather): the sampled direction is the texel center, where the
        # bilinear env_eval reduces exactly to the texel value
        d, pdf_dir, val = env_sample(
            em.env_prob, em.env_alias, em.env_pdf_img, u_pos,
            from_env=em.env_to_world, image=em.env_image,
        )
        out_d = jnp.where(mask[:, None], d, out_d)
        out_dist = jnp.where(mask, 1e7, out_dist)
        out_value = jnp.where(mask[:, None], val, out_value)
        out_pdf = jnp.where(mask, pmf * pdf_dir, out_pdf)

    return DirectSample(
        d=out_d,
        dist=out_dist,
        n=out_n,
        value=out_value,
        pdf=out_pdf,
        emitter_id=eid,
        delta=out_delta,
        valid=valid & (out_pdf > 0),
    )


def pdf_direct_area(em: EmitterTable, prim_id, p_ref, p_hit, n_hit,
                    emitter_id=None):
    """Solid-angle NEE pdf of having sampled the area-emitter point p_hit on
    triangle prim_id from p_ref — the MIS counterweight when a BSDF ray hits
    a luminaire (reference Scene::pdfLuminaire, scene.cpp:381). Pass
    emitter_id to cover analytic sphere emitters (cone-sampling pdf,
    sphere.cpp pdfSolidAngle) — identified by emitter kind, since their
    prim ids live past the triangle range."""
    ti = jnp.clip(prim_id, 0, em.tri_pdf_area.shape[0] - 1)
    pdf_area = em.tri_pdf_area[ti]
    to_l = p_hit - p_ref
    dist2 = jnp.maximum(m.squared_length(to_l), 1e-12)
    d = to_l / jnp.sqrt(dist2)[:, None]
    cos_l = m.dot(n_hit, -d)
    pdf = jnp.where(cos_l > 1e-6,
                    pdf_area * dist2 / jnp.maximum(cos_l, 1e-8), 0.0)
    if emitter_id is not None and SPHERE in em.kinds_present:
        eid = jnp.clip(emitter_id, 0, em.n_emitters - 1)
        is_sph = (emitter_id >= 0) & (em.kind[eid] == SPHERE)
        # record-selection pmf of this sphere's record
        rec_pmf_sph = _sphere_rec_pmf(em, eid)
        c = em.position[eid]
        r = em.radius[eid]
        dc2 = jnp.maximum(m.squared_length(c - p_ref), 1e-12)
        sin2_max = jnp.clip(r * r / dc2, 0.0, 1.0 - 1e-7)
        cos_max = jnp.sqrt(1.0 - sin2_max)
        pdf_sph = rec_pmf_sph / jnp.maximum(
            2.0 * jnp.pi * (1.0 - cos_max), 1e-9)
        pdf_sph = jnp.where(dc2 > r * r, pdf_sph, 0.0)
        pdf = jnp.where(is_sph, pdf_sph, pdf)
    return pdf


def _sphere_rec_pmf(em: EmitterTable, eid):
    """Selection pmf of the record belonging to emitter eid (records past
    the triangle range map 1:1 to non-area emitters)."""
    n_other = em.rec_pmf.shape[0] - em.n_tri_records
    if n_other <= 0:
        return jnp.zeros(eid.shape)
    match = eid[:, None] == em.rec_emitter[em.n_tri_records:][None, :]
    rec = em.n_tri_records + jnp.argmax(match, axis=1)
    return jnp.where(jnp.any(match, axis=1), em.rec_pmf[rec], 0.0)


def eval_emitter_hit(em: EmitterTable, emitter_id, wi_world, n_hit):
    """Radiance emitted toward wi_world when a ray hits an area emitter
    (reference AreaLuminaire::Le — one-sided on the normal side)."""
    eid = jnp.clip(emitter_id, 0, em.n_emitters - 1)
    vis = (emitter_id >= 0) & (m.dot(n_hit, wi_world) > 0)
    return jnp.where(vis[:, None], em.radiance[eid], 0.0)


def eval_environment(em: EmitterTable, d_world):
    """Background radiance for escaped rays (reference Scene::LeBackground)."""
    if em.env_id < 0:
        return jnp.zeros(d_world.shape[:-1] + (em.radiance.shape[-1],))
    if em.env_kind in (ENVMAP, SKY):
        from mitsuba_jax.emitters.envmap import env_eval

        return env_eval(em.env_image, d_world, to_env=em.env_to_env)
    return jnp.broadcast_to(em.radiance[em.env_id],
                            d_world.shape[:-1] + (em.radiance.shape[-1],))


def eval_and_pdf_environment(em: EmitterTable, d_world):
    """Fused eval_environment + pdf_environment — one dir→uv trig pass
    and shared index math (the path integrator's escape block needs
    both for every lane every bounce). Bit-identical results."""
    if em.env_id < 0:
        return (jnp.zeros(d_world.shape[:-1] + (em.radiance.shape[-1],)),
                jnp.zeros(d_world.shape[:-1]))
    rec_ids = em.rec_emitter[em.n_tri_records:]
    mask = rec_ids == em.env_id
    pmf_env = jnp.sum(jnp.where(mask, em.rec_pmf[em.n_tri_records:], 0.0))
    if em.env_kind in (ENVMAP, SKY):
        from mitsuba_jax.emitters.envmap import env_eval_pdf

        val, pdf = env_eval_pdf(em.env_image, em.env_pdf_img, d_world,
                                to_env=em.env_to_env)
        return val, pmf_env * pdf
    val = jnp.broadcast_to(em.radiance[em.env_id],
                           d_world.shape[:-1] + (em.radiance.shape[-1],))
    return val, jnp.full(d_world.shape[:-1], pmf_env * m.INV_FOURPI)


def pdf_environment(em: EmitterTable, d_world):
    """NEE solid-angle pdf of sampling direction d toward the environment."""
    if em.env_id < 0:
        return jnp.zeros(d_world.shape[:-1])
    # env emitters are appended after the triangle records; locate by id
    rec_ids = em.rec_emitter[em.n_tri_records:]
    mask = rec_ids == em.env_id
    pmf_env = jnp.sum(jnp.where(mask, em.rec_pmf[em.n_tri_records:], 0.0))
    if em.env_kind in (ENVMAP, SKY):
        from mitsuba_jax.emitters.envmap import env_pdf

        return pmf_env * env_pdf(em.env_pdf_img, d_world, to_env=em.env_to_env)
    return jnp.full(d_world.shape[:-1], pmf_env * m.INV_FOURPI)
