"""Film: sample accumulation with reconstruction-filter weighting.

Replaces the reference ImageBlock filter splat
(include/mitsuba/render/imageblock.h:80 putSample — scatter with border
regions) with a data-parallel *gather* formulation: the per-pixel sample
tensor (H, W, spp) is combined over a (2R+1)² neighborhood with `jnp.roll`
shifts, so there is no scatter contention and the op fuses cleanly.
Weighted by sum-of-weights per pixel exactly like putImageBlock's
weight channel.
"""
from __future__ import annotations

import math

import jax.numpy as jnp

from mitsuba_jax.render.rfilter import RFilter, make_box


def develop(L, offsets, spp: int, height: int, width: int,
            rfilter: RFilter | None = None):
    """Reconstruct an (H, W, 3) image from per-lane radiance.

    L: (N, 3) with N = H*W*spp, lane-major (pixel*spp + sample).
    offsets: (N, 2) sub-pixel sample offsets in [0,1)² (x, y).
    """
    c = L.shape[-1]
    if rfilter is None or rfilter.name == "box":
        return L.reshape(height, width, spp, c).mean(axis=2)

    r = int(math.ceil(rfilter.radius - 0.5))
    lv = L.reshape(height, width, spp, c)
    off = offsets.reshape(height, width, spp, 2)

    acc = jnp.zeros((height, width, c))
    wacc = jnp.zeros((height, width, 1))
    # Gather: pixel (i, j) collects samples of pixel (i+dy, j+dx); a sample
    # at position (j+dx + ox, i+dy + oy) is at distance
    # (dx + ox - 0.5, dy + oy - 0.5) from the center of pixel (i, j).
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            ls = jnp.roll(lv, shift=(-dy, -dx), axis=(0, 1))
            os_ = jnp.roll(off, shift=(-dy, -dx), axis=(0, 1))
            w = rfilter(dx + os_[..., 0] - 0.5) * rfilter(dy + os_[..., 1] - 0.5)
            # mask out-of-bounds wrap-around
            iy = jnp.arange(height)[:, None, None] + dy
            ix = jnp.arange(width)[None, :, None] + dx
            ok = ((iy >= 0) & (iy < height) & (ix >= 0) & (ix < width))
            w = jnp.where(ok, w, 0.0)
            acc = acc + (ls * w[..., None]).sum(axis=2)
            wacc = wacc + w.sum(axis=2)[..., None]
    return acc / jnp.maximum(wacc, 1e-8)


def develop_with_variance(L, spp: int, height: int, width: int):
    """Box-filtered image + per-pixel sample variance + count — the MFilm
    capability (src/films/mfilm.cpp) used by the statistical test harness."""
    lv = L.reshape(height, width, spp, L.shape[-1])
    mean = lv.mean(axis=2)
    var = lv.var(axis=2, ddof=1) if spp > 1 else jnp.zeros_like(mean)
    n = jnp.full((height, width), spp, jnp.int32)
    return mean, var, n
