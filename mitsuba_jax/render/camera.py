"""Cameras: perspective (thin-lens) and orthographic.

Capability parity with reference src/cameras/{perspective,orthographic}.cpp
(PerspectiveCamera at include/mitsuba/render/camera.h:239): film-plane
ray generation with depth of field and shutter interval.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core import math as m
from mitsuba_jax.core import transform as tf
from mitsuba_jax.core import warp
from mitsuba_jax.core.registry import register_plugin
from mitsuba_jax.core.types import pytree_dataclass, static_field
from mitsuba_jax.render.records import Ray

PERSPECTIVE, ORTHOGRAPHIC = 0, 1


@pytree_dataclass
class Camera:
    to_world: jnp.ndarray        # (4,4) camera-to-world
    tan_half_fov_x: jnp.ndarray  # ()
    tan_half_fov_y: jnp.ndarray  # ()
    aperture_radius: jnp.ndarray # () thin-lens
    focus_distance: jnp.ndarray  # ()
    shutter_open: jnp.ndarray    # ()
    shutter_time: jnp.ndarray    # ()
    ortho_scale: jnp.ndarray     # () half-width for orthographic
    kind: int = static_field(default=PERSPECTIVE)

    def sample_ray(self, film_uv, aperture_sample=None):
        """film_uv: (N,2) in [0,1)^2 (x right, y down, origin top-left).

        Returns world-space camera rays. Perspective matches the reference's
        mapToSphere convention: +z forward, x right, y down on the film.
        """
        # film v grows downward; world camera y is up -> flip v
        ndc_x = (2.0 * film_uv[..., 0] - 1.0) * self.tan_half_fov_x
        ndc_y = (1.0 - 2.0 * film_uv[..., 1]) * self.tan_half_fov_y
        n = film_uv.shape[:-1]
        if self.kind == PERSPECTIVE:
            d_local = m.normalize(
                jnp.stack([ndc_x, ndc_y, jnp.ones(n)], axis=-1)
            )
            o_local = jnp.zeros(n + (3,))
            if aperture_sample is not None:
                # thin-lens DoF (reference perspective.cpp apertureRadius)
                p_lens = (
                    warp.square_to_uniform_disk_concentric(aperture_sample)
                    * self.aperture_radius
                )
                ft = self.focus_distance / jnp.maximum(d_local[..., 2], 1e-6)
                p_focus = d_local * ft[..., None]
                o_local = jnp.concatenate(
                    [p_lens, jnp.zeros(n + (1,))], axis=-1
                )
                d_local = m.normalize(p_focus - o_local)
        else:
            o_local = jnp.stack(
                [ndc_x * self.ortho_scale, ndc_y * self.ortho_scale, jnp.zeros(n)],
                axis=-1,
            )
            d_local = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), n + (3,))
        o = tf.apply_point(self.to_world, o_local)
        d = m.normalize(tf.apply_vector(self.to_world, d_local))
        return Ray.make(o, d)


def make_perspective(
    to_world,
    fov_deg: float,
    aspect: float,
    fov_axis: str = "x",
    aperture_radius: float = 0.0,
    focus_distance: float = 1.0,
    shutter_open: float = 0.0,
    shutter_time: float = 0.0,
) -> Camera:
    tan_half = float(np.tan(np.deg2rad(fov_deg) / 2.0))
    if fov_axis == "larger":
        fov_axis = "x" if aspect >= 1 else "y"
    elif fov_axis == "smaller":
        fov_axis = "y" if aspect >= 1 else "x"
    if fov_axis == "x":
        tx, ty = tan_half, tan_half / aspect
    elif fov_axis == "y":
        tx, ty = tan_half * aspect, tan_half
    elif fov_axis == "diagonal":
        diag = tan_half / np.sqrt(1.0 + 1.0 / (aspect * aspect))
        tx, ty = diag, diag / aspect
    else:
        tx, ty = tan_half, tan_half / aspect
    return Camera(
        to_world=jnp.asarray(to_world, jnp.float32),
        tan_half_fov_x=jnp.asarray(tx, jnp.float32),
        tan_half_fov_y=jnp.asarray(ty, jnp.float32),
        aperture_radius=jnp.asarray(aperture_radius, jnp.float32),
        focus_distance=jnp.asarray(focus_distance, jnp.float32),
        shutter_open=jnp.asarray(shutter_open, jnp.float32),
        shutter_time=jnp.asarray(shutter_time, jnp.float32),
        ortho_scale=jnp.asarray(1.0, jnp.float32),
        kind=PERSPECTIVE,
    )


def make_orthographic(to_world, scale: float = 1.0, aspect: float = 1.0) -> Camera:
    return Camera(
        to_world=jnp.asarray(to_world, jnp.float32),
        tan_half_fov_x=jnp.asarray(1.0, jnp.float32),
        tan_half_fov_y=jnp.asarray(1.0 / aspect, jnp.float32),
        aperture_radius=jnp.asarray(0.0, jnp.float32),
        focus_distance=jnp.asarray(1.0, jnp.float32),
        shutter_open=jnp.asarray(0.0, jnp.float32),
        shutter_time=jnp.asarray(0.0, jnp.float32),
        ortho_scale=jnp.asarray(scale, jnp.float32),
        kind=ORTHOGRAPHIC,
    )


@register_plugin("camera", "perspective")
def _make_perspective_plugin(props, aspect=1.0):
    return make_perspective(
        to_world=props.get("toWorld", tf.identity()),
        fov_deg=float(props.get("fov", 49.13)),
        aspect=float(props.get("aspect", aspect)),
        fov_axis=props.get("fovAxis", "x"),
        aperture_radius=float(props.get("apertureRadius", 0.0)),
        focus_distance=float(props.get("focusDistance", 1.0)),
        shutter_open=float(props.get("shutterOpen", 0.0)),
        shutter_time=float(props.get("shutterClose", 0.0)) - float(props.get("shutterOpen", 0.0)),
    )


@register_plugin("camera", "orthographic")
def _make_ortho_plugin(props, aspect=1.0):
    return make_orthographic(
        to_world=props.get("toWorld", tf.identity()),
        scale=float(props.get("scale", 1.0)),
        aspect=float(props.get("aspect", aspect)),
    )
