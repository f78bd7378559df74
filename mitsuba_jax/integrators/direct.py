"""Direct-illumination integrator with BSDF×emitter MIS.

Functional parity with reference `MIDirectIntegrator`
(src/integrators/direct/direct.cpp:30): single scattering only, both
strategies combined with the power heuristic.  Implemented as a depth-2
restriction of the wavefront loop.
"""
from __future__ import annotations

from mitsuba_jax.integrators import path as path_mod


def direct_trace(scene, ray, sampler, rr_depth: int = 100):
    cfg = path_mod.PathConfig(max_depth=2, rr_depth=rr_depth, remat=False)
    return path_mod.path_trace(scene, ray, sampler, cfg)
