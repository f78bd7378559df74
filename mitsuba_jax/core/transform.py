"""4x4 homogeneous transforms (reference include/mitsuba/core/transform.h).

Transforms are plain (4,4) jnp arrays. Application helpers broadcast over
wavefront axes. Normal transformation uses the inverse-transpose rule.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def identity():
    return jnp.eye(4)


def translate(v):
    m = np.eye(4)
    m[:3, 3] = np.asarray(v)
    return jnp.asarray(m)


def scale(v):
    v = np.broadcast_to(np.asarray(v, np.float64), (3,))
    return jnp.asarray(np.diag([v[0], v[1], v[2], 1.0]))


def rotate(axis, angle_deg):
    """Rotation about an arbitrary axis, angle in degrees (like the XML loader)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    s, c = np.sin(np.deg2rad(angle_deg)), np.cos(np.deg2rad(angle_deg))
    x, y, z = axis
    k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    r = np.eye(3) * c + s * k + (1 - c) * np.outer(axis, axis)
    m = np.eye(4)
    m[:3, :3] = r
    return jnp.asarray(m)


def look_at(origin, target, up):
    """Camera-to-world: +z looks at target, y ~ up.

    Matches reference transform.cpp:174 lookAt exactly:
    x = cross(dir, up), y = cross(x, dir), z = dir (columns).
    """
    origin = np.asarray(origin, np.float64)
    d = np.asarray(target, np.float64) - origin
    d = d / np.linalg.norm(d)
    right = np.cross(d, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    new_up = np.cross(right, d)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return jnp.asarray(m)


def perspective(fov_deg, near, far):
    """Perspective projection (reference transform.cpp glPerspective variant)."""
    recip = 1.0 / (far - near)
    cot = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = cot
    m[1, 1] = cot
    m[2, 2] = far * recip
    m[2, 3] = -near * far * recip
    m[3, 2] = 1.0
    return jnp.asarray(m)


def compose(*mats):
    """compose(A, B, C) == A @ B @ C (applied right-to-left)."""
    out = jnp.eye(4)
    for m in mats:
        out = jnp.matmul(out, m, precision=jax.lax.Precision.HIGHEST)
    return out


def inverse(m):
    return jnp.linalg.inv(m)


def apply_point(m, p):
    r = jnp.einsum("ij,...j->...i", m[:3, :3], p,
                   precision=jax.lax.Precision.HIGHEST) + m[:3, 3]
    return r


def apply_vector(m, v):
    return jnp.einsum("ij,...j->...i", m[:3, :3], v, precision=jax.lax.Precision.HIGHEST)


def apply_normal(m, n):
    inv_t = jnp.linalg.inv(m[:3, :3]).T
    return jnp.einsum("ij,...j->...i", inv_t, n, precision=jax.lax.Precision.HIGHEST)
