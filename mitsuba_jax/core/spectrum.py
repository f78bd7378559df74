"""Spectral power distributions (RGB fast path, 3 channels) + color
conversions.

Capability parity with reference include/mitsuba/core/spectrum.h compiled
with SPECTRUM_SAMPLES=3: RGB<->XYZ, luminance, sRGB gamma, blackbody.
A spectrum is simply a jnp array with trailing axis SPECTRUM_SAMPLES.
For SPECTRUM_SAMPLES != 3 (the reference's compile-time n-bin mode,
spectrum.h:27) see core/spectral.py: `SpectralBins(n)` feeds n-channel
material/emitter tables and the wavefront loop runs n-channel end to end
(gated by the n=8 furnace render in tests/test_spectral.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

SPECTRUM_SAMPLES = 3

# ITU-R Rec. BT.709 linear RGB <-> CIE XYZ (same matrices as the reference's
# fromXYZ/toXYZ, src/libcore/spectrum.cpp).
_RGB_TO_XYZ = jnp.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)
_XYZ_TO_RGB = jnp.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ]
)


def from_scalar(x):
    return jnp.broadcast_to(jnp.asarray(x)[..., None], jnp.shape(x) + (SPECTRUM_SAMPLES,))


def luminance(s):
    """CIE Y of a linear-RGB spectrum (reference spectrum.cpp getLuminance)."""
    return s[..., 0] * 0.212671 + s[..., 1] * 0.715160 + s[..., 2] * 0.072169


def to_xyz(s):
    return jnp.einsum("ij,...j->...i", _RGB_TO_XYZ, s, precision=jax.lax.Precision.HIGHEST)


def from_xyz(xyz):
    return jnp.einsum("ij,...j->...i", _XYZ_TO_RGB, xyz, precision=jax.lax.Precision.HIGHEST)


def to_srgb(s):
    """Linear → sRGB gamma encoding (reference bitmap/pngfilm gamma path)."""
    s = jnp.clip(s, 0.0, 1.0)
    return jnp.where(
        s <= 0.0031308, 12.92 * s, 1.055 * jnp.power(jnp.maximum(s, 1e-12), 1.0 / 2.4) - 0.055
    )


def from_srgb(s):
    return jnp.where(s <= 0.04045, s / 12.92, jnp.power((s + 0.055) / 1.055, 2.4))


def blackbody(temperature_k, wavelengths_nm=None):
    """Planck's law spectral radiance, normalized RGB approximation.

    The reference stores per-wavelength Planck emission
    (spectrum.cpp fromBlackBody); with RGB rendering we evaluate Planck at
    representative wavelengths (611/549/465 nm) like its 3-sample build.
    Returns linear RGB radiance in W/(m^2 sr nm).
    """
    if wavelengths_nm is None:
        wavelengths_nm = jnp.array([611.0, 549.0, 465.0])
    h = 6.62607015e-34
    c = 2.99792458e8
    kb = 1.380649e-23
    lam = wavelengths_nm * 1e-9
    t = jnp.asarray(temperature_k)[..., None]
    i = (2.0 * h * c * c) / (lam ** 5) / (jnp.exp(h * c / (lam * kb * t)) - 1.0)
    return i * 1e-9  # per nm


def is_black(s, eps: float = 0.0):
    return jnp.all(s <= eps, axis=-1)


def max_component(s):
    return jnp.max(s, axis=-1)
