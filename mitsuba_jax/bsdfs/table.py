"""SoA material table: the parameter union of all BSDF kinds.

One row per scene material; `kinds_present` is static so jit traces only the
models actually used (the analog of the reference loading only the plugin
DLLs a scene names).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core.types import pytree_dataclass, static_field
from mitsuba_jax.core import microfacet as mf

LAMBERTIAN = 0      # src/bsdfs/lambertian.cpp
MIRROR = 1          # src/bsdfs/mirror.cpp
DIELECTRIC = 2      # src/bsdfs/dielectric.cpp (smooth glass)
ROUGH_CONDUCTOR = 3 # src/bsdfs/roughmetal.cpp + microfacet specular lobe
PHONG = 4           # src/bsdfs/phong.cpp (diffuse+specular phong)
WARD = 5            # src/bsdfs/ward.cpp (anisotropic)
ROUGH_GLASS = 6     # src/bsdfs/roughglass.cpp
DIFF_TRANS = 7      # src/bsdfs/difftrans.cpp (diffuse transmitter)
WISCOMBE = 8        # src/bsdfs/wiscombe.cpp (fork: snow BRDF)
HANRAHAN_KRUEGER = 9  # src/bsdfs/hanrahan-krueger.cpp
COMPOSITE = 10      # src/bsdfs/composite.cpp (N weighted lobes)
CLOTH = 11          # src/bsdfs/irawan.cpp (woven cloth, procedural weave)
MAX_COMPOSITE_LOBES = 4

KIND_NAMES = {
    LAMBERTIAN: "lambertian",
    MIRROR: "mirror",
    DIELECTRIC: "dielectric",
    ROUGH_CONDUCTOR: "roughconductor",
    PHONG: "phong",
    WARD: "ward",
    ROUGH_GLASS: "roughglass",
    DIFF_TRANS: "difftrans",
    WISCOMBE: "wiscombe",
    HANRAHAN_KRUEGER: "hk",
    COMPOSITE: "composite",
    CLOTH: "irawan",
}


@pytree_dataclass
class MaterialTable:
    kind: jnp.ndarray           # (M,) int32
    reflectance: jnp.ndarray    # (M,3) diffuse albedo / specular tint
    specular: jnp.ndarray       # (M,3) specular reflectance (phong/ward/mirror)
    transmittance: jnp.ndarray  # (M,3) specular transmittance (dielectric)
    eta: jnp.ndarray            # (M,) interior/exterior IOR ratio
    cond_eta: jnp.ndarray       # (M,3) conductor eta
    cond_k: jnp.ndarray         # (M,3) conductor absorption
    alpha_u: jnp.ndarray        # (M,) roughness (u axis for ward)
    alpha_v: jnp.ndarray        # (M,) roughness v axis
    exponent: jnp.ndarray       # (M,) phong exponent
    dist_type: jnp.ndarray      # (M,) microfacet distribution code
    tex_id: jnp.ndarray         # (M,) reflectance texture index, -1 = constant
    two_sided: jnp.ndarray      # (M,) bool — twosided adapter applied
    opacity: jnp.ndarray        # (M,) mask adapter: 1 = opaque
    child_ids: jnp.ndarray = None      # (M, 4) composite child rows, -1 pad
    child_weights: jnp.ndarray = None  # (M, 4) composite lobe weights
    cloth_slot: jnp.ndarray = None     # (M,) index into cloth tables, -1
    cloth: dict = None                 # shared weave tables (irawan.py)
    kinds_present: tuple = static_field(default=((LAMBERTIAN, 0),))
    has_composite: bool = static_field(default=False)

    @property
    def n_materials(self):
        return self.kind.shape[0]

    def gather(self, material_id):
        """Gather per-lane parameter rows (clamped; id<0 ⇒ row 0, callers
        mask). Plain indexed gathers: exact on every backend. Color fields
        are (M, C) with C = SPECTRUM_SAMPLES of the scene (3 for RGB, n for
        spectral rendering — reference spectrum.h:27's compile-time knob as
        a table shape); conductor eta/k stay RGB."""
        i = jnp.clip(material_id, 0, self.n_materials - 1)
        out = {
            "kind": self.kind[i],
            "reflectance": self.reflectance[i],
            "specular": self.specular[i],
            "transmittance": self.transmittance[i],
            "eta": self.eta[i],
            "cond_eta": self.cond_eta[i],
            "cond_k": self.cond_k[i],
            "alpha_u": self.alpha_u[i],
            "alpha_v": self.alpha_v[i],
            "exponent": self.exponent[i],
            "dist_type": self.dist_type[i],
            "tex_id": self.tex_id[i],
            "two_sided": self.two_sided[i],
            "opacity": self.opacity[i],
        }
        if self.cloth is not None:
            out["_cloth"] = self.cloth
            out["_cloth_slot"] = self.cloth_slot[i]
        return out


class MaterialBuilder:
    """Accumulates material rows host-side, emits a MaterialTable."""

    def __init__(self):
        self.rows = []
        self.cloth_specs = []

    def _add(self, **kw):
        defaults = dict(
            child_ids=(-1,) * MAX_COMPOSITE_LOBES,
            child_weights=(0.0,) * MAX_COMPOSITE_LOBES,
            cloth_slot=-1,
            kind=LAMBERTIAN,
            reflectance=(0.5, 0.5, 0.5),
            specular=(1.0, 1.0, 1.0),
            transmittance=(1.0, 1.0, 1.0),
            eta=1.5,
            cond_eta=(0.2, 0.9, 1.4),
            cond_k=(3.9, 2.5, 2.1),
            alpha_u=0.1,
            alpha_v=0.1,
            exponent=30.0,
            dist_type=mf.BECKMANN,
            tex_id=-1,
            two_sided=False,
            opacity=1.0,
        )
        defaults.update(kw)
        self.rows.append(defaults)
        return len(self.rows) - 1

    def lambertian(self, reflectance=(0.5, 0.5, 0.5), tex_id=-1):
        return self._add(kind=LAMBERTIAN, reflectance=reflectance, tex_id=tex_id)

    def null(self):
        """Index-matched pass-through boundary (reference: shapes without a
        BSDF are non-occluders, Shape::isOccluder(); used for shapes that
        only delimit participating media). Implemented as an opacity-0 mask
        over a black lambertian: sampling passes straight through with
        weight 1, eval/pdf are 0, and shadow-ray transmittance walks treat
        opacity<1 surfaces as non-blocking."""
        return self._add(kind=LAMBERTIAN, reflectance=(0.0, 0.0, 0.0),
                         opacity=0.0)

    def mirror(self, specular=(1.0, 1.0, 1.0)):
        return self._add(kind=MIRROR, specular=specular)

    def dielectric(self, int_ior=1.5, ext_ior=1.0, specular=(1, 1, 1), transmittance=(1, 1, 1)):
        return self._add(
            kind=DIELECTRIC, eta=int_ior / ext_ior, specular=specular,
            transmittance=transmittance,
        )

    def rough_conductor(self, alpha=0.1, cond_eta=(0.2, 0.9, 1.4), cond_k=(3.9, 2.5, 2.1),
                        specular=(1, 1, 1), dist=mf.BECKMANN):
        return self._add(
            kind=ROUGH_CONDUCTOR, alpha_u=alpha, alpha_v=alpha,
            cond_eta=cond_eta, cond_k=cond_k, specular=specular, dist_type=dist,
        )

    def phong(self, diffuse=(0.5, 0.5, 0.5), specular=(0.2, 0.2, 0.2), exponent=30.0, tex_id=-1):
        return self._add(
            kind=PHONG, reflectance=diffuse, specular=specular, exponent=exponent,
            tex_id=tex_id,
        )

    def ward(self, diffuse=(0.5, 0.5, 0.5), specular=(0.2, 0.2, 0.2),
             alpha_u=0.1, alpha_v=0.1):
        return self._add(
            kind=WARD, reflectance=diffuse, specular=specular,
            alpha_u=alpha_u, alpha_v=alpha_v,
        )

    def rough_glass(self, alpha=0.1, int_ior=1.5, ext_ior=1.0,
                    specular=(1, 1, 1), transmittance=(1, 1, 1), dist=mf.GGX):
        return self._add(
            kind=ROUGH_GLASS, alpha_u=alpha, alpha_v=alpha, eta=int_ior / ext_ior,
            specular=specular, transmittance=transmittance, dist_type=dist,
        )

    def diff_trans(self, transmittance=(0.5, 0.5, 0.5)):
        return self._add(kind=DIFF_TRANS, transmittance=transmittance)

    def wiscombe(self, g=0.874, w0=(0.99, 0.99, 0.99),
                 sigma_t=(16.4967, 6.0957, 4.6547), depth=1.0):
        """Wiscombe-Warren snow BRDF (fork feature). Precomputes the
        delta-Eddington constants (reference wiscombe.cpp configure())."""
        g = float(g)
        w0 = np.asarray(w0, np.float64)
        g_sq = g * g
        w_star = ((1 - g_sq) * w0) / (1 - g_sq * w0)
        g_star = g / (1 + g)
        b_star = g_star / (1 - w_star * g_star)
        xi = np.sqrt(3.0 * (1 - w_star * g_star) * (1 - w_star))
        p_const = (2 * xi) / ((1 - w_star * g_star) * 3)
        a_const = w_star / (1 + p_const)
        return self._add(
            kind=WISCOMBE, reflectance=tuple(a_const), specular=tuple(xi),
            transmittance=tuple(b_star), alpha_u=g,
        )

    def _add_cloth(self, pattern, repeat_u, repeat_v, kd_mult, ks_mult):
        """Register a weave pattern and a material row pointing at it.
        The row's scalar fields keep segment-averaged colors so generic
        consumers (e.g. albedo previews) see something sensible; eval
        uses the full per-segment tables (bsdfs/irawan.py)."""
        from mitsuba_jax.io.weave import EWARP

        warp_yarns = [y for y in pattern.yarns if y.type == EWARP] \
            or pattern.yarns
        mean = lambda ys, f: tuple(np.mean([getattr(y, f) for y in ys],
                                           axis=0))
        slot = len(self.cloth_specs)
        self.cloth_specs.append(dict(
            pattern=pattern, repeat_u=float(repeat_u),
            repeat_v=float(repeat_v), kd_mult=float(kd_mult),
            ks_mult=float(ks_mult)))
        return self._add(
            kind=CLOTH,
            reflectance=mean(warp_yarns, "kd"),
            specular=mean(pattern.yarns, "ks"),
            cloth_slot=slot,
        )

    def irawan(self, warp_kd=(0.3, 0.27, 0.25), weft_kd=(0.6, 0.1, 0.1),
               ks=(0.2, 0.2, 0.2), repeat_u=10.0, repeat_v=10.0,
               pattern: str = "plain", kd_mult=1.0, ks_mult=1.0, **_legacy):
        """Woven cloth with a procedural plain/twill pattern (capability
        extension: the reference irawan.cpp requires a pattern file).
        Routes through the full yarn model via a synthesized pattern."""
        from mitsuba_jax.bsdfs.irawan import procedural_pattern

        w = procedural_pattern(pattern, warp_kd, weft_kd, ks)
        return self._add_cloth(w, repeat_u, repeat_v, kd_mult, ks_mult)

    def irawan_file(self, path: str, props: dict | None = None,
                    repeat_u: float = 10.0, repeat_v: float = 10.0,
                    kd_mult: float = 1.0, ks_mult: float = 1.0):
        """Woven cloth from a weave-pattern file (reference irawan.cpp:64
        loads the same grammar via io/weave.py). The full yarn-segment
        model (filament/staple integrands) evaluates from packed SoA
        tables — see bsdfs/irawan.py."""
        from mitsuba_jax.io.weave import load_weave

        props = props or {}
        w = load_weave(path, props)
        return self._add_cloth(
            w, repeat_u, repeat_v,
            float(props.get("kdMultiplier", kd_mult)),
            float(props.get("ksMultiplier", ks_mult)))

    def composite(self, children, weights):
        """N-weighted-lobe combiner (reference composite.cpp, up to 4
        lobes): children = material row ids (must not be composites),
        weights sum to <= 1 (reference verifies energy conservation)."""
        assert len(children) == len(weights) <= MAX_COMPOSITE_LOBES
        for c in children:
            assert self.rows[c]["kind"] != COMPOSITE, "no nested composites"
        cid = list(children) + [-1] * (MAX_COMPOSITE_LOBES - len(children))
        cw = list(weights) + [0.0] * (MAX_COMPOSITE_LOBES - len(weights))
        return self._add(kind=COMPOSITE, child_ids=cid, child_weights=cw)

    def hanrahan_krueger(self, sigma_a=(0.032, 0.17, 0.48),
                         sigma_s=(0.74, 0.88, 1.01), g=0.0,
                         eta_int=1.32, eta_ext=1.0, ss_factor=(1.0,) * 3,
                         dr_factor=(1.0,) * 3, use_diffuse=True):
        """Hanrahan-Krueger thin-slab BRDF: single scattering + dipole-ish
        diffuse term (reference hanrahan-krueger.cpp configure())."""
        sa = np.asarray(sigma_a, np.float64)
        ss = np.asarray(sigma_s, np.float64)
        st = sa + ss
        st = np.maximum(st, 1e-9)
        ss_albedo = ss / st
        ss_red = ss * (1 - g)
        st_red = sa + ss_red
        red_albedo = ss_red / np.maximum(st_red, 1e-9)
        eta = eta_int / eta_ext
        if eta == 1.0:
            fdr, fdt = 0.0, 1.0
        else:
            fdr = -1.440 / eta ** 2 + 0.710 / eta + 0.668 + 0.0636 * eta
            fdt = 1.0 - fdr
        a_bc = (1 + fdr) / fdt
        var1 = -np.sqrt(3.0 * (1 - red_albedo))
        dr = (red_albedo / 2.0) * (1 + np.exp((4.0 / 3.0) * a_bc * var1)) * np.exp(var1)
        dr = dr * np.asarray(dr_factor, np.float64)
        if not use_diffuse:
            dr = dr * 0.0
        return self._add(
            kind=HANRAHAN_KRUEGER,
            reflectance=tuple(ss_albedo * np.asarray(ss_factor, np.float64)),
            transmittance=tuple(dr), eta=eta, alpha_u=g,
        )

    def build(self) -> MaterialTable:
        if not self.rows:
            self.lambertian()
        # spectral rendering: color fields widen to the widest row's
        # channel count C (SPECTRUM_SAMPLES as a value); 3-wide uniform
        # grays broadcast, anything else must be given at full width
        c = max(len(np.atleast_1d(r[k])) for r in self.rows
                for k in ("reflectance", "specular", "transmittance"))

        def _widen(v):
            v = np.asarray(v, np.float32).reshape(-1)
            if v.shape[0] == c:
                return v
            if np.all(v == v[0]):
                return np.full(c, v[0], np.float32)
            raise ValueError(
                f"color field of width {v.shape[0]} cannot widen to the "
                f"scene's {c} spectral channels unless it is uniform")

        if c != 3:
            for r in self.rows:
                for k in ("reflectance", "specular", "transmittance"):
                    r[k] = _widen(r[k])
        f32 = lambda k: jnp.asarray(np.array([r[k] for r in self.rows], np.float32))
        i32 = lambda k: jnp.asarray(np.array([r[k] for r in self.rows], np.int32))
        # (kind, dist) pairs: microfacet distribution is a static trace-time
        # choice, so each distinct combination is dispatched separately.
        # Composite rows dispatch through their children, which are already
        # listed; the COMPOSITE kind itself is handled by the wrapper layer.
        kinds_present = tuple(
            sorted({(int(r["kind"]), int(r["dist_type"])) for r in self.rows
                    if r["kind"] != COMPOSITE})
        )
        has_composite = any(r["kind"] == COMPOSITE for r in self.rows)
        cloth = None
        if self.cloth_specs:
            from mitsuba_jax.bsdfs.irawan import pack_patterns

            cloth = pack_patterns(self.cloth_specs)
        return MaterialTable(
            kind=i32("kind"),
            reflectance=f32("reflectance"),
            specular=f32("specular"),
            transmittance=f32("transmittance"),
            eta=f32("eta"),
            cond_eta=f32("cond_eta"),
            cond_k=f32("cond_k"),
            alpha_u=f32("alpha_u"),
            alpha_v=f32("alpha_v"),
            exponent=f32("exponent"),
            dist_type=i32("dist_type"),
            tex_id=i32("tex_id"),
            two_sided=jnp.asarray(np.array([r["two_sided"] for r in self.rows], bool)),
            opacity=f32("opacity"),
            child_ids=i32("child_ids"),
            child_weights=f32("child_weights"),
            cloth_slot=i32("cloth_slot"),
            cloth=cloth,
            kinds_present=kinds_present,
            has_composite=has_composite,
        )
