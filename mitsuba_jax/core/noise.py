"""Procedural noise: Perlin gradient noise + fbm / turbulence.

Capability parity with reference src/librender/noise.cpp (render/noise.h):
`perlinNoise`, `fbm`, `turbulence` used by procedural textures.

Wavefront re-design: the reference walks a 256-entry permutation table per
lookup with scalar loads.  Here the hash is computed arithmetically
(integer mix, no table) so the whole evaluation is a fused elementwise
pipeline over arbitrarily-shaped point batches — no gathers at all, which
beats a permutation-table gather per lookup.
"""
from __future__ import annotations

import jax.numpy as jnp


def _hash3(ix, iy, iz):
    """Integer lattice hash -> uint32.  Arithmetic replacement for the
    reference's shuffled permutation table (noise.cpp NoisePerm)."""
    h = (ix.astype(jnp.uint32) * jnp.uint32(0x9E3779B1)
         ^ iy.astype(jnp.uint32) * jnp.uint32(0x85EBCA77)
         ^ iz.astype(jnp.uint32) * jnp.uint32(0xC2B2AE3D))
    h ^= h >> 15
    h *= jnp.uint32(0x2C1B3C6D)
    h ^= h >> 12
    h *= jnp.uint32(0x297A2D39)
    h ^= h >> 15
    return h


def _grad(ix, iy, iz, dx, dy, dz):
    """Gradient dot product at a lattice corner (the 16-direction scheme
    of Perlin's improved noise, matching noise.cpp Grad)."""
    h = _hash3(ix, iy, iz) & jnp.uint32(15)
    u = jnp.where(h < 8, dx, dy)
    v = jnp.where(h < 4, dy, jnp.where((h == 12) | (h == 14), dx, dz))
    return (jnp.where(h & jnp.uint32(1) == 0, u, -u)
            + jnp.where(h & jnp.uint32(2) == 0, v, -v))


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin_noise(p):
    """Improved Perlin noise.  p: (..., 3) points -> (...,) in ~[-1, 1]."""
    p = jnp.asarray(p, jnp.float32)
    pi = jnp.floor(p)
    pf = p - pi
    ix = pi[..., 0].astype(jnp.int32)
    iy = pi[..., 1].astype(jnp.int32)
    iz = pi[..., 2].astype(jnp.int32)
    dx, dy, dz = pf[..., 0], pf[..., 1], pf[..., 2]
    u, v, w = _fade(dx), _fade(dy), _fade(dz)

    def lerp(t, a, b):
        return a + t * (b - a)

    g = _grad
    x00 = lerp(u, g(ix, iy, iz, dx, dy, dz),
               g(ix + 1, iy, iz, dx - 1, dy, dz))
    x10 = lerp(u, g(ix, iy + 1, iz, dx, dy - 1, dz),
               g(ix + 1, iy + 1, iz, dx - 1, dy - 1, dz))
    x01 = lerp(u, g(ix, iy, iz + 1, dx, dy, dz - 1),
               g(ix + 1, iy, iz + 1, dx - 1, dy, dz - 1))
    x11 = lerp(u, g(ix, iy + 1, iz + 1, dx, dy - 1, dz - 1),
               g(ix + 1, iy + 1, iz + 1, dx - 1, dy - 1, dz - 1))
    return lerp(w, lerp(v, x00, x10), lerp(v, x01, x11))


def fbm(p, omega: float = 0.5, max_octaves: int = 8):
    """Fractional Brownian motion: sum of octaves of Perlin noise
    (reference noise.cpp fbm).  Static octave count (XLA unroll)."""
    p = jnp.asarray(p, jnp.float32)
    total = jnp.zeros(p.shape[:-1], jnp.float32)
    lam, o = 1.0, 1.0
    for _ in range(max_octaves):
        total = total + o * perlin_noise(p * lam)
        lam *= 1.99  # slightly off 2 to decorrelate lattice alignment
        o *= omega
    return total


def turbulence(p, omega: float = 0.5, max_octaves: int = 8):
    """Like fbm but sums |noise| — the classic marble/fire turbulence
    (reference noise.cpp turbulence)."""
    p = jnp.asarray(p, jnp.float32)
    total = jnp.zeros(p.shape[:-1], jnp.float32)
    lam, o = 1.0, 1.0
    for _ in range(max_octaves):
        total = total + o * jnp.abs(perlin_noise(p * lam))
        lam *= 1.99
        o *= omega
    return total
