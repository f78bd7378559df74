"""MIP-map pyramid with trilinear and anisotropic (EWA-style) filtering.

Capability parity with reference include/mitsuba/render/mipmap.h (EWA at
mipmap.h:110, getTexel/getValue, 379 LoC mipmap.cpp; 3-D variant
mipmap3d.h is covered by core/kdtree.HashGrid + io/volio grids).

Wavefront re-design:
  * the pyramid is a tuple of (H_l, W_l, 3) arrays (static level count) —
    per-lane level selection is masked multi-eval over the ~log2(N)
    levels, the same idiom as BSDF dispatch: every level does one
    bilinear fetch for all lanes, then a compare-select.  No
    data-dependent shapes.
  * true EWA integrates over a data-dependent elliptical footprint
    (mipmap.h:110 loops over a bounding box of texels) — impossible to
    tile statically.  We use fixed-count footprint assembly instead:
    N taps spaced along the ellipse's MAJOR axis, each tap trilinear at
    the lod chosen from the MINOR axis.  This is how hardware aniso
    units approximate EWA, is fully static, and converges to the same
    result as the tap count grows.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core.types import pytree_dataclass, static_field


@pytree_dataclass
class MIPMap:
    levels: tuple                      # tuple of (H_l, W_l, 3), level 0 finest
    n_levels: int = static_field(default=1)

    @property
    def shape(self):
        return self.levels[0].shape


def build_mipmap(image) -> MIPMap:
    """Box-filtered power-of-two pyramid (reference mipmap.cpp constructor
    resamples to pow2 then repeatedly 2x2-averages)."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    h = 1 << max(int(np.ceil(np.log2(img.shape[0]))), 0)
    w = 1 << max(int(np.ceil(np.log2(img.shape[1]))), 0)
    if (h, w) != img.shape[:2]:
        # bilinear resample to pow2 (host-side, build time)
        ys = (np.arange(h) + 0.5) * img.shape[0] / h - 0.5
        xs = (np.arange(w) + 0.5) * img.shape[1] / w - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, img.shape[0] - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, img.shape[1] - 1)
        y1 = np.clip(y0 + 1, 0, img.shape[0] - 1)
        x1 = np.clip(x0 + 1, 0, img.shape[1] - 1)
        fy = (ys - y0)[:, None, None]
        fx = (xs - x0)[None, :, None]
        img = ((img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx) * (1 - fy)
               + (img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx) * fy)
    levels = [img]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        cur = levels[-1]
        nh, nw = max(cur.shape[0] // 2, 1), max(cur.shape[1] // 2, 1)
        if cur.shape[0] > 1 and cur.shape[1] > 1:
            ds = cur.reshape(nh, 2, nw, 2, -1).mean(axis=(1, 3))
        elif cur.shape[0] > 1:
            ds = cur.reshape(nh, 2, 1, -1).mean(axis=1)
        else:
            ds = cur.reshape(1, nw, 2, -1).mean(axis=2)
        levels.append(ds.reshape(nh, nw, cur.shape[2]))
    return MIPMap(levels=tuple(jnp.asarray(l) for l in levels),
                  n_levels=len(levels))


def _bilinear_level(img, uv, clamp_wrap: bool):
    """Bilinear fetch on one level (same conventions as texture._bilinear:
    v flipped, half-texel centers)."""
    h, w = img.shape[0], img.shape[1]
    x = uv[..., 0] * w - 0.5
    y = (1.0 - uv[..., 1]) * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def wrap(i, n):
        if clamp_wrap:
            return jnp.clip(i, 0, n - 1).astype(jnp.int32)
        return jnp.mod(i, n).astype(jnp.int32)

    x0i, x1i = wrap(x0, w), wrap(x0 + 1, w)
    y0i, y1i = wrap(y0, h), wrap(y0 + 1, h)
    return (img[y0i, x0i] * (1 - fx) * (1 - fy)
            + img[y0i, x1i] * fx * (1 - fy)
            + img[y1i, x0i] * (1 - fx) * fy
            + img[y1i, x1i] * fx * fy)


def eval_trilinear(mip: MIPMap, uv, lod, clamp_wrap: bool = False):
    """Trilinear lookup: bilinear on floor(lod)/ceil(lod), lerped.
    lod: (...,) continuous level (0 = finest).  Masked multi-eval over
    the static level tuple."""
    l_max = mip.n_levels - 1
    lod = jnp.clip(lod, 0.0, float(l_max))
    l0 = jnp.floor(lod)
    frac = (lod - l0)[..., None]
    out0 = jnp.zeros(uv.shape[:-1] + (3,))
    out1 = jnp.zeros(uv.shape[:-1] + (3,))
    for li, img in enumerate(mip.levels):
        v = _bilinear_level(img, uv, clamp_wrap)
        out0 = jnp.where((l0 == li)[..., None], v, out0)
        out1 = jnp.where((jnp.minimum(l0 + 1, l_max) == li)[..., None], v, out1)
    return out0 * (1 - frac) + out1 * frac


def lod_from_duv(mip: MIPMap, duv_dx, duv_dy):
    """Isotropic lod from the uv footprint (reference getValue's
    minorRadius/majorRadius setup): log2 of the larger gradient in
    texel units."""
    h, w = mip.levels[0].shape[:2]
    sx = jnp.sqrt((duv_dx[..., 0] * w) ** 2 + (duv_dx[..., 1] * h) ** 2)
    sy = jnp.sqrt((duv_dy[..., 0] * w) ** 2 + (duv_dy[..., 1] * h) ** 2)
    width = jnp.maximum(jnp.maximum(sx, sy), 1e-8)
    return jnp.log2(width)


def eval_aniso(mip: MIPMap, uv, duv_dx, duv_dy, taps: int = 8,
               max_aniso: float = 16.0, clamp_wrap: bool = False):
    """Anisotropic filtering (EWA equivalent, mipmap.h:110): `taps`
    trilinear samples along the major footprint axis, lod from the minor
    axis clamped to max_aniso eccentricity."""
    h, w = mip.levels[0].shape[:2]
    scale = jnp.asarray([w, h], jnp.float32)
    vx = duv_dx * scale   # texel-space footprint axes
    vy = duv_dy * scale
    lx = jnp.sqrt(jnp.sum(vx * vx, axis=-1))
    ly = jnp.sqrt(jnp.sum(vy * vy, axis=-1))
    major_is_x = lx >= ly
    major = jnp.where(major_is_x[..., None], duv_dx, duv_dy)
    l_major = jnp.maximum(jnp.where(major_is_x, lx, ly), 1e-8)
    l_minor = jnp.maximum(jnp.where(major_is_x, ly, lx), 1e-8)
    # clamp eccentricity: widen the minor axis if too elongated
    l_minor = jnp.maximum(l_minor, l_major / max_aniso)
    lod = jnp.log2(l_minor)
    acc = jnp.zeros(uv.shape[:-1] + (3,))
    for i in range(taps):
        t = (i + 0.5) / taps - 0.5          # [-0.5, 0.5) along major axis
        acc = acc + eval_trilinear(mip, uv + major * t, lod, clamp_wrap)
    return acc / taps
