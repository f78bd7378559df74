"""Textures: checkerboard, grid, bitmap (LDR/EXR), vertex colors.

Capability parity with reference src/textures/ (property names from
checkerboard.cpp:32, gridtexture.cpp:32-34, ldrtexture.cpp:40-48,
exrtexture.cpp:37).  Procedural textures are closed-form; bitmap textures
sample a per-slot image with bilinear filtering and repeat/clamp wrap.
Evaluation is masked multi-eval over the texture slots present (the same
dispatch idiom as BSDFs) — each slot's image is a separate array so sizes
stay exact (no atlas padding).

uv convention follows the reference: uvscale/uvoffset applied as
uv * scale + offset; bitmap v axis flipped (image row 0 = v 1).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core.spectrum import from_srgb
from mitsuba_jax.core.types import pytree_dataclass, static_field

CONSTANT, CHECKERBOARD, GRID, BITMAP, VERTEXCOLORS = range(5)


@pytree_dataclass
class TextureTable:
    kind: jnp.ndarray          # (K,) int32
    color0: jnp.ndarray        # (K,3) bright / constant color
    color1: jnp.ndarray        # (K,3) dark color
    line_width: jnp.ndarray    # (K,) grid line width
    uv_scale: jnp.ndarray      # (K,2)
    uv_offset: jnp.ndarray     # (K,2)
    image_slot: jnp.ndarray    # (K,) index into images tuple, -1 if none
    images: tuple = ()         # tuple of (H,W,3) float arrays (pytree leaves)
    wrap_clamp: jnp.ndarray = None  # (K,) bool: clamp instead of repeat
    mips: tuple = ()           # tuple of MIPMap, parallel to images ((), if off)
    kinds_present: tuple = static_field(default=())

    @property
    def n_textures(self):
        return int(self.kind.shape[0]) if self.kind is not None else 0


def _bilinear(img, uv, clamp_wrap):
    h, w = img.shape[0], img.shape[1]
    u = uv[..., 0]
    v = 1.0 - uv[..., 1]
    x = u * w - 0.5
    y = v * h - 0.5
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
    c00 = img[y0i, x0i]
    c01 = img[y0i, x1i]
    c10 = img[y1i, x0i]
    c11 = img[y1i, x1i]
    return (
        c00 * (1 - fx) * (1 - fy)
        + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy
        + c11 * fx * fy
    )


def eval_texture(tex: TextureTable, tex_id, uv, vertex_color=None,
                 duv_dx=None, duv_dy=None, aniso: bool = False):
    """Per-lane texture lookup. tex_id: (N,) int (-1 handled by caller).
    vertex_color: optional (N,3) interpolated vertex colors.
    duv_dx/duv_dy: optional (N,2) uv footprint derivatives — when given
    (and the builder created MIP pyramids) bitmap lookups are trilinear
    MIP-filtered; aniso=True instead runs EWA-style anisotropic filtering
    along the major footprint axis (reference mipmap.h:110 eval(),
    MIPMap::EWA)."""
    n = uv.shape[0]
    out = jnp.zeros((n, 3))
    if tex.n_textures == 0:
        return out
    ti = jnp.clip(tex_id, 0, tex.n_textures - 1)
    kind = tex.kind[ti]
    uv_t = uv * tex.uv_scale[ti] + tex.uv_offset[ti]
    c0 = tex.color0[ti]
    c1 = tex.color1[ti]
    for k in tex.kinds_present:
        if k == CONSTANT:
            val = c0
        elif k == CHECKERBOARD:
            ix = jnp.floor(uv_t[..., 0] * 2.0).astype(jnp.int32)
            iy = jnp.floor(uv_t[..., 1] * 2.0).astype(jnp.int32)
            even = (ix + iy) % 2 == 0
            val = jnp.where(even[..., None], c0, c1)
        elif k == GRID:
            lw = tex.line_width[ti]
            fx = uv_t[..., 0] - jnp.floor(uv_t[..., 0]) - 0.5
            fy = uv_t[..., 1] - jnp.floor(uv_t[..., 1]) - 0.5
            on_line = (jnp.abs(fx) < lw) | (jnp.abs(fy) < lw)
            val = jnp.where(on_line[..., None], c1, c0)
        elif k == VERTEXCOLORS:
            val = vertex_color if vertex_color is not None else c0
        elif k == BITMAP:
            use_mip = (duv_dx is not None and duv_dy is not None
                       and len(tex.mips) == len(tex.images) > 0)
            val = jnp.zeros((n, 3))
            for si, img in enumerate(tex.images):
                sel = (tex.image_slot[ti] == si)
                if use_mip and aniso:
                    from mitsuba_jax.render.mipmap import eval_aniso

                    mip = tex.mips[si]
                    sc = tex.uv_scale[ti]
                    bi_r = eval_aniso(mip, uv_t, duv_dx * sc, duv_dy * sc,
                                      clamp_wrap=False)
                    bi_c = eval_aniso(mip, uv_t, duv_dx * sc, duv_dy * sc,
                                      clamp_wrap=True)
                elif use_mip:
                    from mitsuba_jax.render.mipmap import (
                        eval_trilinear, lod_from_duv,
                    )

                    mip = tex.mips[si]
                    sc = tex.uv_scale[ti]
                    lod = lod_from_duv(mip, duv_dx * sc, duv_dy * sc)
                    bi_r = eval_trilinear(mip, uv_t, lod, clamp_wrap=False)
                    bi_c = eval_trilinear(mip, uv_t, lod, clamp_wrap=True)
                else:
                    # evaluate each image for all lanes, select (few images)
                    bi_r = _bilinear(img, uv_t, clamp_wrap=False)
                    bi_c = _bilinear(img, uv_t, clamp_wrap=True)
                bi = jnp.where(tex.wrap_clamp[ti][..., None], bi_c, bi_r)
                val = jnp.where(sel[..., None], bi * c0, val)
        else:
            continue
        out = jnp.where((kind == k)[..., None], val, out)
    return out


class TextureBuilder:
    def __init__(self, build_mips: bool = False):
        self.rows = []
        self.images = []
        self.mips = []
        self.build_mips = build_mips

    def _add(self, **kw):
        d = dict(
            kind=CONSTANT, color0=(1.0, 1.0, 1.0), color1=(0.0, 0.0, 0.0),
            line_width=0.01, uv_scale=(1.0, 1.0), uv_offset=(0.0, 0.0),
            image_slot=-1, wrap_clamp=False,
        )
        d.update(kw)
        self.rows.append(d)
        return len(self.rows) - 1

    def constant(self, color):
        return self._add(kind=CONSTANT, color0=color)

    def checkerboard(self, bright=(0.4,) * 3, dark=(0.2,) * 3,
                     uv_scale=(1.0, 1.0), uv_offset=(0.0, 0.0)):
        return self._add(kind=CHECKERBOARD, color0=bright, color1=dark,
                         uv_scale=uv_scale, uv_offset=uv_offset)

    def grid(self, bright=(0.4,) * 3, dark=(0.2,) * 3, line_width=0.01,
             uv_scale=(1.0, 1.0), uv_offset=(0.0, 0.0)):
        return self._add(kind=GRID, color0=bright, color1=dark,
                         line_width=line_width, uv_scale=uv_scale,
                         uv_offset=uv_offset)

    def vertex_colors(self):
        return self._add(kind=VERTEXCOLORS)

    def bitmap(self, image, gamma: float = -1.0, tint=(1.0, 1.0, 1.0),
               wrap: str = "repeat", uv_scale=(1.0, 1.0), uv_offset=(0.0, 0.0)):
        """image: (H,W,C) uint8/uint16/float. gamma=-1 -> sRGB decode
        (reference ldrtexture.cpp:41)."""
        img = np.asarray(image)
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] == 1:
            img = np.repeat(img, 3, 2)
        img = img[:, :, :3]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        elif img.dtype == np.uint16:
            img = img.astype(np.float32) / 65535.0
        else:
            img = img.astype(np.float32)
        if gamma == -1.0:
            img = np.asarray(from_srgb(jnp.asarray(img)))
        elif gamma not in (0.0, 1.0):
            img = np.power(np.maximum(img, 0.0), gamma)
        slot = len(self.images)
        self.images.append(jnp.asarray(img))
        if self.build_mips:
            from mitsuba_jax.render.mipmap import build_mipmap

            self.mips.append(build_mipmap(img))
        return self._add(kind=BITMAP, color0=tint, image_slot=slot,
                         wrap_clamp=(wrap == "clamp"), uv_scale=uv_scale,
                         uv_offset=uv_offset)

    def build(self) -> TextureTable:
        if not self.rows:
            return TextureTable(
                kind=jnp.zeros((0,), jnp.int32),
                color0=jnp.zeros((0, 3)),
                color1=jnp.zeros((0, 3)),
                line_width=jnp.zeros((0,)),
                uv_scale=jnp.zeros((0, 2)),
                uv_offset=jnp.zeros((0, 2)),
                image_slot=jnp.zeros((0,), jnp.int32),
                images=(),
                wrap_clamp=jnp.zeros((0,), bool),
                kinds_present=(),
            )
        f32 = lambda k: jnp.asarray(np.array([r[k] for r in self.rows], np.float32))
        i32 = lambda k: jnp.asarray(np.array([r[k] for r in self.rows], np.int32))
        return TextureTable(
            kind=i32("kind"),
            color0=f32("color0"),
            color1=f32("color1"),
            line_width=f32("line_width"),
            uv_scale=f32("uv_scale"),
            uv_offset=f32("uv_offset"),
            image_slot=i32("image_slot"),
            images=tuple(self.images),
            mips=tuple(self.mips) if self.build_mips else (),
            wrap_clamp=jnp.asarray(np.array([r["wrap_clamp"] for r in self.rows], bool)),
            kinds_present=tuple(sorted({int(r["kind"]) for r in self.rows})),
        )
