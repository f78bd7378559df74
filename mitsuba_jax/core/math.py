"""Vector math, frames, spherical coordinates.

Vectorized counterpart of the reference's vector/frame headers
(include/mitsuba/core/{vector,normal,frame}.h).  Vectors are jnp arrays with
a trailing axis of size 3; everything broadcasts over arbitrary leading
(wavefront) axes.
"""
from __future__ import annotations

import jax.numpy as jnp

EPSILON = 1e-4          # ray epsilon, cf. reference Epsilon (mitsuba.h)
INV_PI = 1.0 / jnp.pi
INV_TWOPI = 1.0 / (2.0 * jnp.pi)
INV_FOURPI = 1.0 / (4.0 * jnp.pi)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length(v):
    return jnp.sqrt(jnp.maximum(dot(v, v), 0.0))


def squared_length(v):
    return dot(v, v)


def normalize(v, eps: float = 1e-20):
    return v / jnp.sqrt(jnp.maximum(dot(v, v), eps))[..., None]


def safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def safe_rcp(x, eps: float = 1e-20):
    """Reciprocal clamped away from inf; sign-preserving (0 treated as +0)."""
    mag = jnp.maximum(jnp.abs(x), eps)
    return jnp.where(x >= 0, 1.0, -1.0) / mag


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def coordinate_system(n):
    """Build an orthonormal basis (s, t) around unit normal n.

    Duff et al. branchless formulation — fully vectorized, unlike the
    reference's branching `coordinateSystem` (src/libcore/util.cpp).
    Returns (s, t) with [s, t, n] right-handed orthonormal.
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = jnp.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], axis=-1)
    t = jnp.stack([b, sign + ny * ny * a, -ny], axis=-1)
    return s, t


class Frame:
    """A batched shading frame (reference include/mitsuba/core/frame.h).

    Stored as three direction arrays (s, t, n). Local frame convention:
    +z = n, so cos_theta(w_local) = w_local.z.
    """

    __slots__ = ("s", "t", "n")

    def __init__(self, s, t, n):
        self.s, self.t, self.n = s, t, n

    @staticmethod
    def from_normal(n):
        s, t = coordinate_system(n)
        return Frame(s, t, n)

    @staticmethod
    def from_normal_tangent(n, tangent):
        """Frame whose s axis follows the (projected) tangent — used with
        the true parametric dp_du so anisotropic BSDFs and footprint
        mapping are uv-aligned (reference Intersection::computeShadingFrame
        analog). Falls back to from_normal where the tangent degenerates."""
        s = tangent - n * jnp.sum(n * tangent, axis=-1, keepdims=True)
        l2 = jnp.sum(s * s, axis=-1, keepdims=True)
        ok = l2 > 1e-18
        s_fb, _ = coordinate_system(n)
        s = jnp.where(ok, s / jnp.sqrt(jnp.where(ok, l2, 1.0)), s_fb)
        t = jnp.cross(n, s)
        return Frame(s, t, n)

    def to_local(self, v):
        return jnp.stack([dot(v, self.s), dot(v, self.t), dot(v, self.n)], axis=-1)

    def to_world(self, v):
        return (v[..., 0:1] * self.s + v[..., 1:2] * self.t + v[..., 2:3] * self.n)


# -- local-frame trig helpers (reference frame.h:99-142) ---------------------

def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return jnp.abs(w[..., 2])


def sin_theta2(w):
    return jnp.maximum(0.0, 1.0 - w[..., 2] * w[..., 2])


def sin_theta(w):
    return jnp.sqrt(sin_theta2(w))


def tan_theta(w):
    return sin_theta(w) / jnp.where(w[..., 2] == 0, 1e-20, w[..., 2])


def sin_phi(w):
    st = sin_theta(w)
    return jnp.where(st == 0, 0.0, jnp.clip(w[..., 1] / jnp.where(st == 0, 1.0, st), -1.0, 1.0))


def cos_phi(w):
    st = sin_theta(w)
    return jnp.where(st == 0, 1.0, jnp.clip(w[..., 0] / jnp.where(st == 0, 1.0, st), -1.0, 1.0))


def spherical_direction(theta, phi):
    """Spherical coords → direction (reference util.cpp sphericalDirection)."""
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)


def to_spherical(v):
    """Direction → (theta, phi) with phi in [0, 2pi)."""
    theta = jnp.arccos(jnp.clip(v[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(v[..., 1], v[..., 0])
    phi = jnp.where(phi < 0, phi + 2.0 * jnp.pi, phi)
    return theta, phi


def reflect_local(w):
    """Mirror reflection in the local frame: (x,y,z) -> (-x,-y,z)."""
    return jnp.stack([-w[..., 0], -w[..., 1], w[..., 2]], axis=-1)


def reflect(w, n):
    """Reflect direction w (pointing away from surface) about normal n.

    Matches reference util.cpp `reflect` up to the wi convention: here both
    input and output point away from the surface.
    """
    return 2.0 * dot(w, n)[..., None] * n - w


def refract(wi, n, rel_eta):
    """Refract wi (pointing away from the interface) through normal n.

    rel_eta = IOR(transmitted side) / IOR(incident side) for this crossing.
    Handles incidence from either side of n. Returns
    (wt, total_internal_reflection_mask); wt points away from the interface
    on the transmitted side.
    """
    cos_i = dot(wi, n)
    rel_eta = jnp.asarray(rel_eta)
    inv = 1.0 / rel_eta
    sin2_t = inv * inv * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    coef = inv * cos_i - jnp.sign(cos_i) * cos_t
    wt = -wi * jnp.expand_dims(jnp.broadcast_to(inv, cos_i.shape), -1) + \
        jnp.expand_dims(coef, -1) * n
    return normalize(wt), tir
