"""Batched SoA records flowing through the wavefront renderer.

Batched counterparts of the reference's per-ray structs:
  Ray            <- include/mitsuba/core/ray.h:34
  Intersection   <- include/mitsuba/render/shape.h:57 (fields :142-166)
  DirectSample   <- LuminaireSamplingRecord (include/mitsuba/render/records.inl)
  BSDFSample     <- BSDFQueryRecord (include/mitsuba/render/bsdf.h:154)

Every field is an array with a leading wavefront axis N; records are pytrees
and pass through jit/scan/shard_map.
"""
from __future__ import annotations

import jax.numpy as jnp

from mitsuba_jax.core.types import pytree_dataclass
from mitsuba_jax.core import math as m


@pytree_dataclass
class Ray:
    o: jnp.ndarray       # (N, 3)
    d: jnp.ndarray       # (N, 3) normalized
    mint: jnp.ndarray    # (N,)
    maxt: jnp.ndarray    # (N,)

    @staticmethod
    def make(o, d, mint=None, maxt=None):
        n = o.shape[:-1]
        if mint is None:
            mint = jnp.full(n, m.EPSILON, o.dtype)
        if maxt is None:
            maxt = jnp.full(n, jnp.inf, o.dtype)
        return Ray(o=o, d=d, mint=jnp.broadcast_to(mint, n), maxt=jnp.broadcast_to(maxt, n))

    def at(self, t):
        return self.o + self.d * t[..., None]


@pytree_dataclass
class Intersection:
    valid: jnp.ndarray      # (N,) bool — hit anything?
    t: jnp.ndarray          # (N,) ray distance
    p: jnp.ndarray          # (N, 3) hit position
    geo_n: jnp.ndarray      # (N, 3) geometric normal
    sh_n: jnp.ndarray       # (N, 3) shading normal
    uv: jnp.ndarray         # (N, 2)
    dp_du: jnp.ndarray      # (N, 3) tangent (also frame s axis after orthonormalization)
    wi: jnp.ndarray         # (N, 3) incident dir in *local shading frame* (toward viewer)
    prim_id: jnp.ndarray    # (N,) triangle index (-1 = none/analytic)
    shape_id: jnp.ndarray   # (N,) shape index
    material_id: jnp.ndarray  # (N,) index into scene material table
    emitter_id: jnp.ndarray   # (N,) index into scene emitter table, -1 if not emissive

    def frame(self) -> m.Frame:
        """Shading frame with s following dp_du — MUST match the frame the
        intersector used to produce wi (to_world(bsdf wo) and wi share it);
        from_normal_tangent reproduces from_normal when dp_du is already
        that frame's s axis (the fused-kernel path)."""
        return m.Frame.from_normal_tangent(self.sh_n, self.dp_du)

    def to_world(self, v_local):
        return self.frame().to_world(v_local)

    def to_local(self, v_world):
        return self.frame().to_local(v_world)


@pytree_dataclass
class DirectSample:
    """A sample toward an emitter (NEE)."""
    d: jnp.ndarray          # (N, 3) unit direction from ref point toward emitter
    dist: jnp.ndarray       # (N,) distance to the emitter sample
    n: jnp.ndarray          # (N, 3) emitter-side normal (0 for delta emitters)
    value: jnp.ndarray      # (N, S) emitted radiance / pdf  (like lRec.value)
    pdf: jnp.ndarray        # (N,) solid-angle pdf at the ref point
    emitter_id: jnp.ndarray # (N,)
    delta: jnp.ndarray      # (N,) bool — delta emitter (no MIS vs BSDF)
    valid: jnp.ndarray      # (N,) bool


@pytree_dataclass
class BSDFSample:
    wo: jnp.ndarray         # (N, 3) sampled direction, local frame
    weight: jnp.ndarray     # (N, S) f*cos/pdf (spectral)
    pdf: jnp.ndarray        # (N,) solid-angle pdf (1 for delta lobes' discrete prob)
    delta: jnp.ndarray      # (N,) bool — delta (specular) component sampled
    transmission: jnp.ndarray  # (N,) bool — transmission lobe sampled (RR exemption)
    eta: jnp.ndarray        # (N,) relative IOR of the sampled event
    valid: jnp.ndarray      # (N,) bool
