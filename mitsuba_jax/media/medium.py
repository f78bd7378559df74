"""Participating media: homogeneous closed-form + heterogeneous grids with
Woodcock (delta) tracking.

Capability parity with reference src/medium/homogeneous.cpp (closed-form
sampleDistance/getTransmittance) and src/medium/heterogeneous.cpp:79-96,317
(grid densities + Woodcock tracking), and the grid volume data sources
(src/volume/gridvolume.cpp, constvolume.cpp).

A scene carries ONE ambient medium table (v1 scope: the medium fills space;
shape-interior binding is tracked for a later round).  All functions are
batched over the wavefront and differentiable in sigma_s/sigma_a.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core.types import pytree_dataclass, static_field
from mitsuba_jax.media.phase import HG, ISOTROPIC

HOMOGENEOUS, HETEROGENEOUS = 0, 1


@pytree_dataclass
class MediumTable:
    sigma_s: jnp.ndarray        # (3,) scattering coefficient
    sigma_a: jnp.ndarray        # (3,) absorption
    phase_g: jnp.ndarray        # () HG anisotropy / gaussian-flake stddev
    density: jnp.ndarray        # (D, H, W) density grid (hetero) or (1,1,1)
    world_to_grid: jnp.ndarray  # (4, 4)
    density_scale: jnp.ndarray  # ()
    max_density: jnp.ndarray    # () Woodcock majorant
    # oriented media (reference heterogeneous.cpp orientation volume +
    # microflake sigmaDir): fiber directions per cell, and the fitted
    # sin-power σ_t expansion of the gaussian flake distribution
    orientation: jnp.ndarray = None  # (D,H,W,3) grid or (1,1,1,3) const
    flake_coeffs: jnp.ndarray = None  # (10,) fit_fiber_sigma_t output
    kind: int = static_field(default=HOMOGENEOUS)
    phase_kind: int = static_field(default=ISOTROPIC)
    enabled: bool = static_field(default=False)

    @property
    def sigma_t(self):
        return self.sigma_s + self.sigma_a

    @property
    def oriented(self):
        return self.orientation is not None


def no_medium() -> MediumTable:
    return MediumTable(
        sigma_s=jnp.zeros(3), sigma_a=jnp.zeros(3),
        phase_g=jnp.zeros(()), density=jnp.ones((1, 1, 1)),
        world_to_grid=jnp.eye(4), density_scale=jnp.ones(()),
        max_density=jnp.zeros(()), kind=HOMOGENEOUS,
        phase_kind=ISOTROPIC, enabled=False,
    )


def make_homogeneous(sigma_s, sigma_a, g: float = 0.0,
                     phase_kind: int = None,
                     flake_stddev: float = None,
                     orientation=None) -> MediumTable:
    pk = HG if (phase_kind is None and g != 0.0) else (
        phase_kind if phase_kind is not None else ISOTROPIC
    )
    geff = g
    flake_coeffs = None
    if flake_stddev is not None:
        from mitsuba_jax.media.phase import (
            MICROFLAKE_GAUSS, fit_fiber_sigma_t,
        )

        pk = MICROFLAKE_GAUSS
        geff = float(flake_stddev)
        coeffs, _err = fit_fiber_sigma_t(float(flake_stddev))
        flake_coeffs = jnp.asarray(coeffs)
    orient = None
    if orientation is not None:
        import numpy as _np

        o = _np.asarray(orientation, _np.float32).reshape(1, 1, 1, 3)
        orient = jnp.asarray(o / max(float(_np.linalg.norm(o)), 1e-20))
    return MediumTable(
        sigma_s=jnp.asarray(sigma_s, jnp.float32),
        sigma_a=jnp.asarray(sigma_a, jnp.float32),
        phase_g=jnp.asarray(geff, jnp.float32),
        density=jnp.ones((1, 1, 1)),
        world_to_grid=jnp.eye(4),
        density_scale=jnp.ones(()),
        max_density=jnp.ones(()),
        orientation=orient,
        flake_coeffs=flake_coeffs,
        kind=HOMOGENEOUS, phase_kind=pk, enabled=True,
    )


def make_heterogeneous(density_grid, world_to_grid, sigma_s, sigma_a,
                       density_scale: float = 1.0, g: float = 0.0,
                       orientation=None, flake_stddev: float = None,
                       phase_kind: int = None) -> MediumTable:
    """density_grid: (D, H, W) densities; world_to_grid maps world points to
    grid index space [0,D)x[0,H)x[0,W) (z,y,x order).

    orientation: optional fiber-direction field — (3,) constant axis or
    (D,H,W,3) grid (reference heterogeneous.cpp orientation volume).
    flake_stddev: gaussian microflake stddev; sets MICROFLAKE_GAUSS phase
    with directionally-varying extinction sigmaDir = 2 σ_t(cosθ)
    (microflake.cpp:155)."""
    grid = jnp.asarray(density_grid, jnp.float32)
    pk = phase_kind
    flake_coeffs = None
    geff = g
    if flake_stddev is not None:
        from mitsuba_jax.media.phase import (
            MICROFLAKE_GAUSS, fit_fiber_sigma_t,
        )

        pk = MICROFLAKE_GAUSS
        geff = float(flake_stddev)
        coeffs, _err = fit_fiber_sigma_t(float(flake_stddev))
        flake_coeffs = jnp.asarray(coeffs)
    if pk is None:
        pk = HG if g != 0.0 else ISOTROPIC
    orient = None
    if orientation is not None:
        import numpy as _np

        o = _np.asarray(orientation, _np.float32)
        if o.ndim == 1:
            o = o.reshape(1, 1, 1, 3)
        n = _np.linalg.norm(o, axis=-1, keepdims=True)
        orient = jnp.asarray(o / _np.maximum(n, 1e-20))
    # directional majorant: sigmaDir peaks at cosθ=0 (sinθ=1), where the
    # sin-power expansion sums its coefficients
    dir_max = 1.0 if flake_coeffs is None else \
        2.0 * float(jnp.sum(flake_coeffs))
    return MediumTable(
        sigma_s=jnp.asarray(sigma_s, jnp.float32),
        sigma_a=jnp.asarray(sigma_a, jnp.float32),
        phase_g=jnp.asarray(geff, jnp.float32),
        density=grid,
        world_to_grid=jnp.asarray(world_to_grid, jnp.float32),
        density_scale=jnp.asarray(density_scale, jnp.float32),
        max_density=jnp.max(grid) * density_scale * dir_max,
        orientation=orient,
        flake_coeffs=flake_coeffs,
        kind=HETEROGENEOUS,
        phase_kind=pk,
        enabled=True,
    )


def lookup_orientation(med: MediumTable, p):
    """Fiber axis at world points p (N,3): trilinear-interpolated and
    renormalized (reference volume.h lookupVector). Falls back to +z
    where the field is degenerate or absent."""
    zaxis = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), p.shape)
    if med.orientation is None:
        return zaxis
    if med.orientation.shape[:3] == (1, 1, 1):
        return jnp.broadcast_to(med.orientation[0, 0, 0], p.shape)
    from mitsuba_jax.core import transform as tf

    g = tf.apply_point(med.world_to_grid, p)
    d, h, w, _ = med.orientation.shape
    x = jnp.clip(g[..., 0], 0.0, w - 1.0)
    y = jnp.clip(g[..., 1], 0.0, h - 1.0)
    z = jnp.clip(g[..., 2], 0.0, d - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, max(w - 2, 0))
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, max(h - 2, 0))
    z0 = jnp.clip(jnp.floor(z).astype(jnp.int32), 0, max(d - 2, 0))
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    fz = (z - z0)[..., None]
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    z1 = jnp.minimum(z0 + 1, d - 1)
    oo = med.orientation
    v = (oo[z0, y0, x0] * (1 - fx) * (1 - fy) * (1 - fz)
         + oo[z0, y0, x1] * fx * (1 - fy) * (1 - fz)
         + oo[z0, y1, x0] * (1 - fx) * fy * (1 - fz)
         + oo[z0, y1, x1] * fx * fy * (1 - fz)
         + oo[z1, y0, x0] * (1 - fx) * (1 - fy) * fz
         + oo[z1, y0, x1] * fx * (1 - fy) * fz
         + oo[z1, y1, x0] * (1 - fx) * fy * fz
         + oo[z1, y1, x1] * fx * fy * fz)
    ln = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    return jnp.where(ln > 1e-6, v / jnp.maximum(ln, 1e-20), zaxis)


def sigma_dir_factor(med: MediumTable, d, p):
    """Directionally-varying extinction factor sigmaDir(cos(d, axis)) =
    2 σ_t(cosθ) for gaussian-flake media, 1 otherwise (reference
    microflake.cpp:152 sigmaDir; 'scaled such that replacing an isotropic
    phase with an isotropic microflake causes no changes')."""
    if med.flake_coeffs is None:
        return jnp.ones(p.shape[:-1])
    from mitsuba_jax.media.phase import gauss_fiber_sigma_t

    axis = lookup_orientation(med, p)
    cos_t = jnp.sum(d * axis, axis=-1)
    return 2.0 * gauss_fiber_sigma_t(cos_t, med.flake_coeffs)


def lookup_density(med: MediumTable, p):
    """Trilinear density lookup at world points p (N,3). 0 outside the grid
    (reference gridvolume.cpp lookupFloat)."""
    if med.kind == HOMOGENEOUS:
        return jnp.ones(p.shape[:-1]) * med.density_scale
    from mitsuba_jax.core import transform as tf

    g = tf.apply_point(med.world_to_grid, p)   # (N,3) in (x,y,z) grid coords
    d, h, w = med.density.shape
    x, y, z = g[..., 0], g[..., 1], g[..., 2]
    inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1) & (z >= 0) & (z <= d - 1)
    x = jnp.clip(x, 0.0, w - 1.0)
    y = jnp.clip(y, 0.0, h - 1.0)
    z = jnp.clip(z, 0.0, d - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 2) if w > 1 else jnp.zeros_like(x, jnp.int32)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, h - 2) if h > 1 else jnp.zeros_like(y, jnp.int32)
    z0 = jnp.clip(jnp.floor(z).astype(jnp.int32), 0, d - 2) if d > 1 else jnp.zeros_like(z, jnp.int32)
    fx = x - x0
    fy = y - y0
    fz = z - z0
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    z1 = jnp.minimum(z0 + 1, d - 1)
    dd = med.density
    c = (
        dd[z0, y0, x0] * (1 - fx) * (1 - fy) * (1 - fz)
        + dd[z0, y0, x1] * fx * (1 - fy) * (1 - fz)
        + dd[z0, y1, x0] * (1 - fx) * fy * (1 - fz)
        + dd[z0, y1, x1] * fx * fy * (1 - fz)
        + dd[z1, y0, x0] * (1 - fx) * (1 - fy) * fz
        + dd[z1, y0, x1] * fx * (1 - fy) * fz
        + dd[z1, y1, x0] * (1 - fx) * fy * fz
        + dd[z1, y1, x1] * fx * fy * fz
    )
    return jnp.where(inside, c * med.density_scale, 0.0)


def medium_transmittance(med: MediumTable, o, d, dist, u=None, n_steps: int = 32):
    """Transmittance along segments [o, o + d*dist] (reference
    Medium::getTransmittance, medium.h:141).

    Homogeneous: exp(-sigma_t·dist) exactly.  Heterogeneous: ratio tracking
    with a fixed step budget (unbiased in expectation given u; falls back to
    quadrature ray marching when u is None)."""
    if not med.enabled:
        return jnp.ones(o.shape[:-1] + (3,))
    if med.kind == HOMOGENEOUS:
        return jnp.exp(-med.sigma_t[None, :] * dist[..., None])
    # heterogeneous: composite midpoint ray marching of optical depth
    # (reference heterogeneous.cpp ray marching branch); oriented flake
    # media scale local extinction by sigmaDir(cos(d, axis(x)))
    ts = (jnp.arange(n_steps) + 0.5) / n_steps     # (S,)
    pts = o[:, None, :] + d[:, None, :] * (dist[:, None] * ts[None, :])[..., None]
    flat = pts.reshape(-1, 3)
    rho = lookup_density(med, flat)
    if med.flake_coeffs is not None:
        dd = jnp.repeat(d, n_steps, axis=0)
        rho = rho * sigma_dir_factor(med, dd, flat)
    rho = rho.reshape(o.shape[0], n_steps)
    tau = rho.sum(axis=1) * (dist / n_steps)
    return jnp.exp(-med.sigma_t[None, :] * tau[..., None])


def sample_distance(med: MediumTable, o, d, max_dist, u_channel, u_dist,
                    key=None, n_woodcock: int = 64):
    """Sample a medium interaction along rays (reference
    Medium::sampleDistance, medium.h:110).

    Returns dict(valid: interacted before max_dist, t, p, weight (3,),
    surface_weight (3,)): `weight` multiplies throughput on a medium event
    (sigma_s/pdf already folded: = sigma_s/sigma_t for the analog schemes);
    `surface_weight` multiplies throughput when the surface is reached
    (accounts for transmittance/pdf ratio = 1 for analog sampling).
    """
    n = o.shape[0]
    if not med.enabled:
        return dict(
            valid=jnp.zeros(n, bool), t=max_dist, p=o + d * max_dist[:, None],
            weight=jnp.ones((n, 3)), surface_weight=jnp.ones((n, 3)),
        )
    sigma_t = med.sigma_t
    if med.kind == HOMOGENEOUS:
        # channel-stratified exponential sampling (reference homogeneous.cpp
        # strategy EBalance): pick channel uniformly, pdf = mean over channels
        ch = jnp.clip((u_channel * 3).astype(jnp.int32), 0, 2)
        st_ch = sigma_t[ch]
        # branch-safe divisor: max(st, eps) has an O(1/eps^2) partial that
        # overflows to inf for vacuum lanes, and 0-cotangent * inf = NaN in
        # reverse mode — divide by 1 there instead (result masked anyway)
        st_div = jnp.where(st_ch > 0, st_ch, 1.0)
        t_raw = -jnp.log(jnp.maximum(1.0 - u_dist, 1e-20)) / st_div
        t = jnp.where(st_ch > 0, t_raw, max_dist)
        valid = (t < max_dist) & (st_ch > 0)
        t_clamped = jnp.minimum(t, max_dist)
        tr = jnp.exp(-sigma_t[None, :] * t_clamped[:, None])       # (N,3)
        # pdf of sampling t (medium event): mean_c sigma_c exp(-sigma_c t)
        pdf_t = jnp.mean(sigma_t[None, :] * tr, axis=1)
        # prob of exceeding max_dist: mean_c exp(-sigma_c·max)
        tr_max = jnp.exp(-sigma_t[None, :] * max_dist[:, None])
        pdf_surf = jnp.mean(tr_max, axis=1)
        weight = med.sigma_s[None, :] * tr / jnp.maximum(pdf_t, 1e-20)[:, None]
        surface_weight = tr_max / jnp.maximum(pdf_surf, 1e-20)[:, None]
        return dict(
            valid=valid, t=t_clamped, p=o + d * t_clamped[:, None],
            weight=weight, surface_weight=surface_weight,
        )
    # ---- heterogeneous: Woodcock / delta tracking (heterogeneous.cpp:317)
    assert key is not None, "woodcock tracking needs a PRNG key"
    # majorant: max channel extinction × max grid density (already scaled;
    # for oriented flake media max_density includes the sigmaDir peak)
    sig_m = jnp.maximum(jnp.max(sigma_t) * med.max_density, 1e-6)

    def body(i, state):
        t, done, accept, k = state
        k, k1, k2 = jax.random.split(k, 3)
        step = -jnp.log(jnp.maximum(1.0 - jax.random.uniform(k1, (n,)), 1e-20)) / sig_m
        t_new = t + step
        escaped = t_new >= max_dist
        p = o + d * jnp.minimum(t_new, max_dist)[:, None]
        rho = lookup_density(med, p)   # includes density_scale
        if med.flake_coeffs is not None:
            rho = rho * sigma_dir_factor(med, d, p)
        real = jax.random.uniform(k2, (n,)) < (rho * jnp.max(sigma_t) / sig_m)
        newly_escaped = ~done & escaped
        newly_real = ~done & ~escaped & real
        t = jnp.where(done, t, t_new)
        accept = accept | newly_real
        done = done | newly_escaped | newly_real
        return t, done, accept, k

    t0 = jnp.zeros(n)
    done0 = jnp.zeros(n, bool)
    acc0 = jnp.zeros(n, bool)
    t, done, accept, _ = jax.lax.fori_loop(0, n_woodcock, body, (t0, done0, acc0, key))
    t = jnp.where(accept, t, max_dist)
    valid = accept
    # analog delta tracking: weight = sigma_s/sigma_t (single-channel gray
    # assumption for the spectral shape; exact for gray media)
    weight = jnp.broadcast_to(
        med.sigma_s / jnp.maximum(jnp.max(sigma_t), 1e-8), (n, 3)
    )
    return dict(
        valid=valid, t=t, p=o + d * t[:, None],
        weight=weight, surface_weight=jnp.ones((n, 3)),
    )


# ---------------------------------------------------------------------------
# Shape-attached interior media (reference: Shape::setInteriorMedium /
# BSDF boundaries in volpath.cpp; media bind to shapes in the scene XML).
# Wavefront re-design: a small SoA stack of media; every lane carries its
# current medium index (-1 = vacuum/ambient), parameters are fetched
# with a one-hot gather, and the closed-form homogeneous sampling runs
# per-lane on the gathered sigmas.  Media may carry a density grid
# (reference heterogeneous.cpp:79-96 data-source-driven media attached to
# shapes): grids are padded to a common shape and stacked, lanes gather
# per-medium grid ids, Woodcock tracking uses per-lane majorants.
# ---------------------------------------------------------------------------

@pytree_dataclass
class MediumStack:
    sigma_s: jnp.ndarray      # (K, 3)
    sigma_a: jnp.ndarray      # (K, 3)
    phase_g: jnp.ndarray      # (K,)
    # heterogeneous support (None-free static layout: NG=0 when unused)
    grid_id: jnp.ndarray = None       # (K,) i32: index into grids, -1 = homo
    grids: jnp.ndarray = None         # (NG, D, H, W) padded density stack
    grid_dims: jnp.ndarray = None     # (NG, 3) true (D,H,W) before padding
    world_to_grid: jnp.ndarray = None  # (NG, 4, 4)
    density_scale: jnp.ndarray = None  # (NG,)
    max_density: jnp.ndarray = None    # (NG,) scaled Woodcock majorant
    has_hetero: bool = static_field(default=False)

    @property
    def n_media(self):
        return self.sigma_s.shape[0]


def make_medium_stack(media) -> MediumStack:
    """media: list of (sigma_s, sigma_a, g) triples or dicts
    {sigma_s, sigma_a, g, density(D,H,W), world_to_grid, density_scale}."""
    import numpy as _np

    if not media:
        return MediumStack(
            sigma_s=jnp.zeros((0, 3)), sigma_a=jnp.zeros((0, 3)),
            phase_g=jnp.zeros((0,)),
        )
    norm = []
    for m_ in media:
        if isinstance(m_, dict):
            norm.append(m_)
        else:
            norm.append(dict(sigma_s=m_[0], sigma_a=m_[1], g=m_[2]))
    ss = jnp.asarray([m_["sigma_s"] for m_ in norm], jnp.float32)
    sa = jnp.asarray([m_["sigma_a"] for m_ in norm], jnp.float32)
    g = jnp.asarray([m_.get("g", 0.0) for m_ in norm], jnp.float32)
    het = [m_ for m_ in norm if m_.get("density") is not None]
    if not het:
        return MediumStack(sigma_s=ss, sigma_a=sa, phase_g=g)
    gid = _np.full(len(norm), -1, _np.int32)
    dims = _np.asarray([_np.asarray(m_["density"]).shape for m_ in het])
    dmax, hmax, wmax = dims.max(axis=0)
    grids = _np.zeros((len(het), dmax, hmax, wmax), _np.float32)
    w2g = _np.zeros((len(het), 4, 4), _np.float32)
    scale = _np.zeros(len(het), _np.float32)
    maxd = _np.zeros(len(het), _np.float32)
    j = 0
    for i, m_ in enumerate(norm):
        if m_.get("density") is None:
            continue
        dgrid = _np.asarray(m_["density"], _np.float32)
        dz, dy, dx = dgrid.shape
        grids[j, :dz, :dy, :dx] = dgrid
        w2g[j] = _np.asarray(m_["world_to_grid"], _np.float32)
        sc = float(m_.get("density_scale", 1.0))
        scale[j] = sc
        maxd[j] = float(dgrid.max()) * sc
        gid[i] = j
        j += 1
    return MediumStack(
        sigma_s=ss, sigma_a=sa, phase_g=g,
        grid_id=jnp.asarray(gid), grids=jnp.asarray(grids),
        grid_dims=jnp.asarray(dims, jnp.int32),
        world_to_grid=jnp.asarray(w2g),
        density_scale=jnp.asarray(scale),
        max_density=jnp.asarray(maxd), has_hetero=True,
    )


def stack_lookup_density(stack: MediumStack, cur, p):
    """Per-lane density multiplier at world points p (N,3): 1 for
    homogeneous/vacuum lanes, trilinear grid lookup (0 outside) for lanes
    inside a grid medium."""
    n = cur.shape[0]
    if not stack.has_hetero:
        return jnp.ones(n)
    kc = jnp.clip(cur, 0, stack.n_media - 1)
    gid = jnp.where(cur >= 0, stack.grid_id[kc], -1)
    gc = jnp.clip(gid, 0, stack.grids.shape[0] - 1)
    m44 = stack.world_to_grid[gc]                       # (N, 4, 4)
    gpt = jnp.einsum("nij,nj->ni", m44[:, :3, :3], p,
                     precision=jax.lax.Precision.HIGHEST) + m44[:, :3, 3]
    dims = stack.grid_dims[gc].astype(jnp.float32)      # (N, 3) (D,H,W)
    x, y, z = gpt[:, 0], gpt[:, 1], gpt[:, 2]
    wd, ht, dp = dims[:, 2], dims[:, 1], dims[:, 0]
    inside = ((x >= 0) & (x <= wd - 1) & (y >= 0) & (y <= ht - 1)
              & (z >= 0) & (z <= dp - 1))
    x = jnp.clip(x, 0.0, wd - 1.0)
    y = jnp.clip(y, 0.0, ht - 1.0)
    z = jnp.clip(z, 0.0, dp - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0,
                  jnp.maximum(wd.astype(jnp.int32) - 2, 0))
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0,
                  jnp.maximum(ht.astype(jnp.int32) - 2, 0))
    z0 = jnp.clip(jnp.floor(z).astype(jnp.int32), 0,
                  jnp.maximum(dp.astype(jnp.int32) - 2, 0))
    fx, fy, fz = x - x0, y - y0, z - z0
    x1 = jnp.minimum(x0 + 1, wd.astype(jnp.int32) - 1)
    y1 = jnp.minimum(y0 + 1, ht.astype(jnp.int32) - 1)
    z1 = jnp.minimum(z0 + 1, dp.astype(jnp.int32) - 1)
    G = stack.grids

    def at(zz, yy, xx):
        return G[gc, zz, yy, xx]

    c = (at(z0, y0, x0) * (1 - fx) * (1 - fy) * (1 - fz)
         + at(z0, y0, x1) * fx * (1 - fy) * (1 - fz)
         + at(z0, y1, x0) * (1 - fx) * fy * (1 - fz)
         + at(z0, y1, x1) * fx * fy * (1 - fz)
         + at(z1, y0, x0) * (1 - fx) * (1 - fy) * fz
         + at(z1, y0, x1) * fx * (1 - fy) * fz
         + at(z1, y1, x0) * (1 - fx) * fy * fz
         + at(z1, y1, x1) * fx * fy * fz)
    rho = jnp.where(inside, c * stack.density_scale[gc], 0.0)
    return jnp.where(gid >= 0, rho, 1.0)


def stack_is_hetero(stack: MediumStack, cur):
    """Per-lane bool: lane's current medium is grid-driven."""
    if stack is None or not stack.has_hetero:
        return jnp.zeros(cur.shape[0], bool)
    kc = jnp.clip(cur, 0, stack.n_media - 1)
    return (cur >= 0) & (stack.grid_id[kc] >= 0)


def stack_params(stack: MediumStack, cur):
    """Per-lane (sigma_s, sigma_a, g, inside) for medium index cur (N,)
    (-1 = vacuum -> zeros)."""
    n = cur.shape[0]
    if stack is None or stack.n_media == 0:
        z = jnp.zeros((n, 3))
        return z, z, jnp.zeros(n), jnp.zeros(n, bool)
    kc = jnp.clip(cur, 0, stack.n_media - 1)
    inside = cur >= 0
    # cotangent firewall: the gather's transpose sums EVERY lane's
    # cotangent into the parameter gradient, including garbage from masked
    # vacuum lanes (inf partials x zero values -> NaN). Gating with where()
    # kills masked-lane cotangents before they reach the gather.
    gate = inside[:, None]
    ss = jnp.where(gate, stack.sigma_s[kc], 0.0)
    sa = jnp.where(gate, stack.sigma_a[kc], 0.0)
    g = jnp.where(inside, stack.phase_g[kc], 0.0)
    return ss, sa, g, inside


def stack_sample_distance(ss, sa, max_dist, u_channel, u_dist):
    """Per-lane closed-form homogeneous distance sampling (same estimator
    as sample_distance's HOMOGENEOUS branch, with (N,3) sigmas).

    Detached-sampling convention (matches the surface estimator): the
    sampled distance and the sampling pdfs are stop-gradiented DECISIONS;
    sigma-dependence flows only through the differentiable re-evaluation
    of sigma_s·Tr.  This is also what keeps reverse-mode clean — the
    decision chains (positions, loop geometry) carry no sigma partials."""
    detach = jax.lax.stop_gradient
    st = ss + sa
    ch = jnp.clip((u_channel * 3).astype(jnp.int32), 0, 2)
    st_ch = jnp.take_along_axis(st, ch[:, None], axis=1)[:, 0]
    # branch-safe divisor: avoids 0 * inf = NaN in reverse mode on vacuum
    st_div = jnp.where(st_ch > 0, st_ch, 1.0)
    t_raw = -jnp.log(jnp.maximum(1.0 - u_dist, 1e-20)) / st_div
    t = jnp.where(st_ch > 0, t_raw, max_dist)
    max_d = detach(max_dist)
    t_cl = detach(jnp.minimum(t, max_d))
    valid = detach(t < max_d) & (st_ch > 0)
    tr = jnp.exp(-st * t_cl[:, None])
    pdf_t = detach(jnp.mean(st * tr, axis=1))
    tr_max = jnp.exp(-st * max_d[:, None])
    pdf_surf = detach(jnp.mean(tr_max, axis=1))
    weight = ss * tr / jnp.maximum(pdf_t, 1e-20)[:, None]
    surface_weight = tr_max / jnp.maximum(pdf_surf, 1e-20)[:, None]
    return dict(valid=valid, t=t_cl, weight=weight,
                surface_weight=surface_weight)


def stack_transmittance(ss, sa, dist):
    """exp(-(sigma_t) * dist) per lane (homogeneous closed form)."""
    return jnp.exp(-(ss + sa) * dist[:, None])


def stack_sample_distance_het(stack: MediumStack, cur, ss, sa, o, d,
                              max_dist, u_channel, u_dist, key,
                              n_woodcock: int = 64):
    """stack_sample_distance with grid-medium support: homogeneous lanes
    keep the closed form; lanes inside a grid medium run Woodcock/delta
    tracking with a per-lane majorant (reference heterogeneous.cpp:317,
    here per-shape instead of ambient). Analog tracking: weight =
    sigma_s / max-channel sigma_t (gray-majorant assumption, exact for
    gray media — same convention as sample_distance's ambient branch)."""
    base = stack_sample_distance(ss, sa, max_dist, u_channel, u_dist)
    if stack is None or not stack.has_hetero:
        return base
    detach = jax.lax.stop_gradient
    n = cur.shape[0]
    is_het = stack_is_hetero(stack, cur)
    kc = jnp.clip(cur, 0, stack.n_media - 1)
    gid = jnp.where(cur >= 0, stack.grid_id[kc], -1)
    gc = jnp.clip(gid, 0, stack.grids.shape[0] - 1)
    st = ss + sa
    st_max = jnp.max(detach(st), axis=1)
    sig_m = jnp.maximum(st_max * stack.max_density[gc], 1e-6)
    max_d = detach(max_dist)

    def body(i, state):
        t, done, accept, k = state
        k, k1, k2 = jax.random.split(k, 3)
        step = -jnp.log(jnp.maximum(
            1.0 - jax.random.uniform(k1, (n,)), 1e-20)) / sig_m
        t_new = t + step
        escaped = t_new >= max_d
        p = o + d * jnp.minimum(t_new, max_d)[:, None]
        rho = detach(stack_lookup_density(stack, cur, p))
        real = jax.random.uniform(k2, (n,)) < (rho * st_max / sig_m)
        newly_escaped = ~done & escaped
        newly_real = ~done & ~escaped & real
        t = jnp.where(done, t, t_new)
        accept = accept | newly_real
        done = done | newly_escaped | newly_real
        return t, done, accept, k

    t0 = jnp.zeros(n)
    z = jnp.zeros(n, bool)
    t, done, accept, _ = jax.lax.fori_loop(
        0, n_woodcock, body, (t0, z, z, key))
    t = detach(jnp.where(accept, t, max_d))
    w_het = ss / jnp.maximum(st_max, 1e-8)[:, None]
    return dict(
        valid=jnp.where(is_het, accept, base["valid"]),
        t=jnp.where(is_het, t, base["t"]),
        weight=jnp.where(is_het[:, None], w_het, base["weight"]),
        surface_weight=jnp.where(is_het[:, None], 1.0,
                                 base["surface_weight"]),
    )


def stack_transmittance_het(stack: MediumStack, cur, ss, sa, o, d, dist,
                            n_steps: int = 16):
    """stack_transmittance with grid support: grid lanes integrate optical
    depth by composite-midpoint ray marching over their density grid
    (reference heterogeneous.cpp ray-marching branch)."""
    base = stack_transmittance(ss, sa, dist)
    if stack is None or not stack.has_hetero:
        return base
    is_het = stack_is_hetero(stack, cur)
    ts = (jnp.arange(n_steps) + 0.5) / n_steps
    pts = o[:, None, :] + d[:, None, :] * (dist[:, None] * ts[None, :])[..., None]
    ncur = jnp.repeat(cur, n_steps)
    rho = stack_lookup_density(stack, ncur, pts.reshape(-1, 3)).reshape(
        o.shape[0], n_steps)
    tau = rho.mean(axis=1) * dist
    het_tr = jnp.exp(-(ss + sa) * tau[:, None])
    return jnp.where(is_het[:, None], het_tr, base)
