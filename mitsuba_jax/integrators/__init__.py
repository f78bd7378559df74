from mitsuba_jax.integrators.path import PathConfig, path_trace, render
from mitsuba_jax.integrators.direct import direct_trace
from mitsuba_jax.integrators.vpl import VPLSet, generate_vpls, render_vpl
from mitsuba_jax.integrators.bre import (
    beam_radiance_estimate, bre_render, shoot_photons_media,
)
from mitsuba_jax.integrators.photonmap import (
    photonmap_render, photonmapper_render, ppm_render,
)

__all__ = ["PathConfig", "path_trace", "render", "direct_trace",
           "VPLSet", "generate_vpls", "render_vpl",
           "beam_radiance_estimate", "bre_render", "shoot_photons_media",
           "photonmap_render", "photonmapper_render", "ppm_render"]
