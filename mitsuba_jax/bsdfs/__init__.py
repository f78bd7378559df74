"""BSDF models + wavefront dispatch.

The reference dispatches per-ray through virtual `BSDF::fCos/sampleCos/pdf`
on plugin objects (include/mitsuba/render/bsdf.h:149).  Here all materials
live in one SoA `MaterialTable`; per-bounce the dispatcher gathers each
lane's parameters and evaluates every BSDF *kind present in the scene* on
all lanes, selecting results by mask — branchless and fully vectorized, the
Data-parallel replacement for virtual dispatch.

Conventions (local shading frame, +z = shading normal):
  wi — direction toward the viewer (reference its.wi), unit, local frame
  wo — direction toward the light / next vertex, unit, local frame
  eval(...)  returns f(wi,wo) * |cos_theta(wo)|   (reference fCos)
  pdf(...)   solid-angle density of sample() given wi (smooth lobes only)
  sample(...) returns BSDFSample with weight = fCos/pdf (spectral)
"""
from __future__ import annotations

import jax.numpy as jnp

from mitsuba_jax.bsdfs.table import (
    MaterialTable,
    MaterialBuilder,
    LAMBERTIAN,
    MIRROR,
    DIELECTRIC,
    ROUGH_CONDUCTOR,
    PHONG,
    WARD,
    ROUGH_GLASS,
    DIFF_TRANS,
    WISCOMBE,
    HANRAHAN_KRUEGER,
    KIND_NAMES,
)
from mitsuba_jax.bsdfs.dispatch import bsdf_eval, bsdf_pdf, bsdf_sample

__all__ = [
    "MaterialTable",
    "MaterialBuilder",
    "bsdf_eval",
    "bsdf_pdf",
    "bsdf_sample",
    "LAMBERTIAN",
    "MIRROR",
    "DIELECTRIC",
    "ROUGH_CONDUCTOR",
    "PHONG",
    "WARD",
    "ROUGH_GLASS",
    "DIFF_TRANS",
    "WISCOMBE",
    "HANRAHAN_KRUEGER",
    "KIND_NAMES",
]
