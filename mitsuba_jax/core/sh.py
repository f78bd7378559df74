"""Real spherical harmonics: evaluation, projection, rotation (z), sampling.

Capability parity with reference include/mitsuba/core/shvector.h
(SHVector eval/project/rotation, SHSampler:362) and shvector4d.h
(SHVector4D — a theta/phi grid of SH vectors).  Coefficient layout matches
the reference: index(l, m) = l*(l+1) + m, m in [-l, l].

Evaluation is fully vectorized over direction batches; projection uses a
lat-long quadrature grid (the reference's SHVector::project uses the same
equal-angle double sum); sampling mirrors SHSampler's hierarchical CDF idea
with a dense 2-D CDF over a (res x 2res) grid.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core import math as m


def n_coeffs(bands: int) -> int:
    return bands * bands


def sh_index(l: int, mm: int) -> int:
    return l * (l + 1) + mm


def _legendre_batch(bands, ct):
    """Associated Legendre P_l^m(cos_theta) for all (l, m>=0), vectorized.
    Returns dict[(l,m)] -> array like ct."""
    p = {}
    p[(0, 0)] = jnp.ones_like(ct)
    if bands == 1:
        return p
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))
    for mm in range(bands):
        if mm > 0:
            # P_m^m = (-1)^m (2m-1)!! (1-x^2)^{m/2}
            dfact = 1.0
            for k in range(1, 2 * mm, 2):
                dfact *= k
            p[(mm, mm)] = ((-1.0) ** mm) * dfact * st ** mm
        if mm + 1 < bands:
            p[(mm + 1, mm)] = ct * (2 * mm + 1) * p[(mm, mm)]
        for l in range(mm + 2, bands):
            p[(l, mm)] = (
                (2 * l - 1) * ct * p[(l - 1, mm)] - (l + mm - 1) * p[(l - 2, mm)]
            ) / (l - mm)
    return p


def _K(l, mm):
    return math.sqrt(
        (2 * l + 1) * math.factorial(l - mm) / (4 * math.pi * math.factorial(l + mm))
    )


def eval_basis(bands: int, d):
    """All SH basis functions at unit directions d (..., 3) → (..., bands²).

    Real SH with the reference's (Condon-Shortley-free) convention:
    y_l^m = sqrt(2) K cos(m phi) P_l^m   (m>0)
          = sqrt(2) K sin(|m| phi) P_l^|m| (m<0), y_l^0 = K P_l^0.
    """
    ct = d[..., 2]
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    p = _legendre_batch(bands, ct)
    out = []
    for l in range(bands):
        for mm in range(-l, l + 1):
            am = abs(mm)
            base = p[(l, am)] * ((-1.0) ** am)   # undo Condon-Shortley
            if mm == 0:
                out.append(_K(l, 0) * base)
            elif mm > 0:
                out.append(math.sqrt(2.0) * _K(l, am) * jnp.cos(am * phi) * base)
            else:
                out.append(math.sqrt(2.0) * _K(l, am) * jnp.sin(am * phi) * base)
    return jnp.stack(out, axis=-1)


def eval_sh(coeffs, d):
    """Evaluate an SH expansion at directions d. coeffs: (..., n_coeffs)."""
    bands = int(math.isqrt(coeffs.shape[-1]))
    return jnp.sum(coeffs * eval_basis(bands, d), axis=-1)


def project(fn, bands: int, res: int = 64):
    """Project a spherical function onto SH (reference SHVector::project:
    equal-angle theta/phi double sum with sin(theta) weights)."""
    theta = (jnp.arange(res) + 0.5) / res * jnp.pi
    phi = (jnp.arange(2 * res) + 0.5) / (2 * res) * 2 * jnp.pi
    tt, pp = jnp.meshgrid(theta, phi, indexing="ij")
    d = m.spherical_direction(tt, pp)
    vals = fn(d)
    basis = eval_basis(bands, d)
    w = jnp.sin(tt) * (jnp.pi / res) * (2 * jnp.pi / (2 * res))
    return jnp.sum(vals[..., None] * basis * w[..., None], axis=(0, 1))


def rotate_z(coeffs, angle):
    """Rotation about z (reference SHVector::rotateZ): block-diagonal
    cos/sin mixing of ±m pairs."""
    bands = int(math.isqrt(coeffs.shape[-1]))
    out = list(jnp.moveaxis(coeffs, -1, 0))
    ca = {mm: jnp.cos(mm * angle) for mm in range(bands)}
    sa = {mm: jnp.sin(mm * angle) for mm in range(bands)}
    res = [None] * coeffs.shape[-1]
    for l in range(bands):
        res[sh_index(l, 0)] = out[sh_index(l, 0)]
        for mm in range(1, l + 1):
            cp = out[sh_index(l, mm)]     # cos(m phi) coefficient
            cm = out[sh_index(l, -mm)]    # sin(m phi) coefficient
            res[sh_index(l, mm)] = ca[mm] * cp - sa[mm] * cm
            res[sh_index(l, -mm)] = sa[mm] * cp + ca[mm] * cm
    return jnp.stack(res, axis=-1)


class SHSampler:
    """Importance sampling of a non-negative SH expansion via a dense 2-D
    CDF (reference SHSampler builds a hierarchical table; a flat table is
    the vectorized equivalent)."""

    def __init__(self, bands: int, res: int = 64):
        self.bands = bands
        self.res = res
        theta = (np.arange(res) + 0.5) / res * np.pi
        phi = (np.arange(2 * res) + 0.5) / (2 * res) * 2 * np.pi
        tt, pp = np.meshgrid(theta, phi, indexing="ij")
        self._dirs = jnp.asarray(
            np.stack(
                [np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)], -1
            ),
            jnp.float32,
        )
        self._sin_t = jnp.asarray(np.sin(tt), jnp.float32)

    def sample(self, coeffs, u2):
        """Returns (directions, pdf) ~ max(f,0) normalized."""
        vals = jnp.maximum(eval_sh(coeffs, self._dirs), 0.0) * self._sin_t
        flat = vals.reshape(-1)
        total = jnp.maximum(flat.sum(), 1e-20)
        cdf = jnp.cumsum(flat) / total
        idx = jnp.clip(
            jnp.searchsorted(cdf, u2[..., 0], side="right"), 0, flat.shape[0] - 1
        )
        res = self.res
        ti = idx // (2 * res)
        pi_ = idx % (2 * res)
        # jitter inside the cell: theta from u2[...,1], phi by rescaling
        # u2[...,0] within the chosen CDF bin (sample-reuse, pdf.h:128 idea)
        lo = jnp.where(idx > 0, cdf[jnp.maximum(idx - 1, 0)], 0.0)
        pbin = jnp.maximum(flat[idx] / total, 1e-20)
        u_re = jnp.clip((u2[..., 0] - lo) / pbin, 0.0, 1.0 - 1e-6)
        dt = jnp.pi / res
        dp = 2 * jnp.pi / (2 * res)
        theta = (ti + u2[..., 1]) * dt
        phi = (pi_ + u_re) * dp
        d = m.spherical_direction(theta, phi)
        cell_sa = dt * dp * jnp.sin(jnp.maximum(theta, 1e-4))
        pdf = (flat[idx] / total) / jnp.maximum(cell_sa, 1e-10)
        return d, pdf


# ---------------------------------------------------------------------------
# SHVector4D: a (theta_i, phi_i) grid of SH expansions of f(wi, .)
# (reference shvector4d.h:35 — used to tabulate 4-D scattering functions)
# ---------------------------------------------------------------------------

def _grid_dirs(res_theta: int, res_phi: int):
    ti = (np.arange(res_theta) + 0.5) / res_theta * np.pi
    pi_ = (np.arange(res_phi) + 0.5) / res_phi * (2 * np.pi)
    tt, pp = np.meshgrid(ti, pi_, indexing="ij")
    st = np.sin(tt)
    return np.stack([st * np.cos(pp), st * np.sin(pp), np.cos(tt)], -1)


def project_4d(fn, bands: int, res_theta: int = 8, res_phi: int = 16,
               res: int = 32):
    """Tabulate f(wi, wo) as a grid of SH vectors over incident directions
    (reference SHVector4D::project, shvector4d.h).  fn(wi (3,), wo (M,3))
    -> (M,).  Returns (res_theta, res_phi, n_coeffs(bands))."""
    dirs = _grid_dirs(res_theta, res_phi)
    out = np.zeros((res_theta, res_phi, n_coeffs(bands)), np.float32)
    for a in range(res_theta):
        for b in range(res_phi):
            wi = jnp.asarray(dirs[a, b], jnp.float32)
            out[a, b] = np.asarray(
                project(lambda wo: fn(wi, wo), bands, res=res)
            )
    return jnp.asarray(out)


def eval_sh_4d(grid, wi, wo):
    """Evaluate the tabulated 4-D function: bilinear over the (theta, phi)
    incident grid, SH eval in wo (reference SHVector4D::lookup).

    grid: (T, P, C); wi, wo: (N, 3) -> (N,)."""
    t_res, p_res, n_c = grid.shape
    bands = int(round(math.sqrt(n_c)))
    theta = jnp.arccos(jnp.clip(wi[:, 2], -1.0, 1.0))
    phi = jnp.arctan2(wi[:, 1], wi[:, 0]) % (2 * jnp.pi)
    ft = theta / jnp.pi * t_res - 0.5
    fp = phi / (2 * jnp.pi) * p_res - 0.5
    t0 = jnp.floor(ft)
    p0 = jnp.floor(fp)
    wt = (ft - t0)[:, None]
    wp = (fp - p0)[:, None]
    t0i = jnp.clip(t0, 0, t_res - 1).astype(jnp.int32)
    t1i = jnp.clip(t0 + 1, 0, t_res - 1).astype(jnp.int32)
    p0i = jnp.mod(p0, p_res).astype(jnp.int32)
    p1i = jnp.mod(p0 + 1, p_res).astype(jnp.int32)
    c = (grid[t0i, p0i] * (1 - wt) * (1 - wp)
         + grid[t0i, p1i] * (1 - wt) * wp
         + grid[t1i, p0i] * wt * (1 - wp)
         + grid[t1i, p1i] * wt * wp)          # (N, C)
    basis = eval_basis(bands, wo)             # (N, C)
    return jnp.sum(c * basis, axis=-1)
