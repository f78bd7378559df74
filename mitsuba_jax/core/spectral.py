"""n-channel spectral power distributions (SPECTRUM_SAMPLES != 3).

Capability parity with the reference's compile-time n-sample Spectrum
(include/mitsuba/core/spectrum.h:27 SPECTRUM_SAMPLES, bins spanning
SPECTRUM_MIN_WAVELENGTH..SPECTRUM_MAX_WAVELENGTH = 360..830 nm;
fromContinuousSpectrum / toXYZ in src/libcore/spectrum.cpp). The
reference fixes the channel count at compile time; here it is a value —
a `SpectralBins(n)` config feeds array shapes, so any n works in one
process (JAX shapes are trace-time constants, the natural analog of a
C++ template parameter).

Color conversion uses the Wyman/Sloan/Shirley multi-lobe Gaussian fit of
the CIE 1931 2-deg matching functions ("Simple Analytic Approximations
to the CIE XYZ Color Matching Functions", JCGT 2013) instead of the
reference's embedded 5-nm CIE table — analytic, resolution-independent,
and accurate to ~1% of peak.

RGB -> spectrum upsampling solves the 3x3 system that makes the
round trip rgb -> bins -> XYZ -> rgb EXACT by construction (a linear
basis correction; Smits-1999-style smooth bases, exactly invertible).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

LAMBDA_MIN = 360.0      # nm (reference spectrum.h SPECTRUM_MIN_WAVELENGTH)
LAMBDA_MAX = 830.0


def _gauss_piece(lam, mu, s1, s2):
    s = np.where(lam < mu, s1, s2)
    t = (lam - mu) / s
    return np.exp(-0.5 * t * t)


def cie_xyz_bar(lam):
    """CIE 1931 2-deg x̄/ȳ/z̄ at wavelengths lam (nm) — Wyman et al. fit.
    Returns (..., 3)."""
    lam = np.asarray(lam, np.float64)
    x = (1.056 * _gauss_piece(lam, 599.8, 37.9, 31.0)
         + 0.362 * _gauss_piece(lam, 442.0, 16.0, 26.7)
         - 0.065 * _gauss_piece(lam, 501.1, 20.4, 26.2))
    y = (0.821 * _gauss_piece(lam, 568.8, 46.9, 40.5)
         + 0.286 * _gauss_piece(lam, 530.9, 16.3, 31.1))
    z = (1.217 * _gauss_piece(lam, 437.0, 11.8, 36.0)
         + 0.681 * _gauss_piece(lam, 459.0, 26.0, 13.8))
    return np.stack([x, y, z], axis=-1)


# sRGB primaries (linear), same matrix as core/spectrum.py
_XYZ_TO_RGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ]
)
_RGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)


@dataclass(frozen=True)
class SpectralBins:
    """Uniform wavelength bins over [lambda_min, lambda_max) — the
    reference's Spectrum discretization with n a VALUE, not a compile
    flag. Precomputes the bin->XYZ integration matrix and the exact
    rgb->bins upsampling basis."""
    n: int
    lambda_min: float = LAMBDA_MIN
    lambda_max: float = LAMBDA_MAX

    @property
    def edges(self):
        return np.linspace(self.lambda_min, self.lambda_max, self.n + 1)

    @property
    def centers(self):
        e = self.edges
        return 0.5 * (e[:-1] + e[1:])

    def _xyz_weights(self, oversample: int = 32):
        """(3, n): column j integrates x̄/ȳ/z̄ over bin j, normalized so a
        flat unit spectrum maps to Y = 1 (the reference normalizes by the
        ȳ integral the same way, spectrum.cpp toXYZ)."""
        e = self.edges
        lam = np.linspace(self.lambda_min, self.lambda_max,
                          self.n * oversample, endpoint=False)
        lam = lam + 0.5 * (lam[1] - lam[0])
        bar = cie_xyz_bar(lam)                       # (n*os, 3)
        w = bar.reshape(self.n, oversample, 3).mean(axis=1)   # per-bin avg
        y_total = w[:, 1].sum()
        return (w / max(y_total, 1e-12)).T           # (3, n)

    def to_xyz_matrix(self):
        return jnp.asarray(self._xyz_weights(), jnp.float32)

    def _rgb_basis(self):
        """(n, 3) basis B with rgb_to_bins(rgb) = B @ rgb such that
        to_rgb(B @ rgb) == rgb exactly: start from smooth Smits-style
        red/green/blue bumps, then right-multiply by the inverse of the
        3x3 round-trip matrix."""
        c = self.centers
        # smooth primaries: logistic-edged bands (Smits' smooth bases)
        def band(lo, hi):
            k = 0.08
            return 1.0 / (1.0 + np.exp(-k * (c - lo))) \
                * 1.0 / (1.0 + np.exp(k * (c - hi)))

        b = np.stack([band(575.0, 700.0),            # red
                      band(490.0, 575.0),            # green
                      band(380.0, 490.0)], axis=-1)  # blue  (n, 3)
        m = _XYZ_TO_RGB @ self._xyz_weights() @ b    # rgb->rgb round trip
        return b @ np.linalg.inv(m)

    def rgb_basis(self):
        return jnp.asarray(self._rgb_basis(), jnp.float32)


def to_xyz(bins, spec: SpectralBins):
    """(..., n) spectral bins -> (..., 3) CIE XYZ."""
    return jnp.einsum("cn,...n->...c", spec.to_xyz_matrix(),
                      jnp.asarray(bins), precision=jax.lax.Precision.HIGHEST)


def to_rgb(bins, spec: SpectralBins):
    return jnp.einsum("ij,...j->...i", jnp.asarray(_XYZ_TO_RGB,
                                                   jnp.float32),
                      to_xyz(bins, spec), precision=jax.lax.Precision.HIGHEST)


def from_rgb(rgb, spec: SpectralBins):
    """(..., 3) linear RGB -> (..., n) smooth spectrum with an exact
    round trip through to_rgb (reference fromLinearRGB analog)."""
    return jnp.einsum("nc,...c->...n", spec.rgb_basis(), jnp.asarray(rgb),
                      precision=jax.lax.Precision.HIGHEST)


def luminance(bins, spec: SpectralBins):
    """CIE Y of an n-bin spectrum."""
    return to_xyz(bins, spec)[..., 1]


def from_continuous(fn, spec: SpectralBins, oversample: int = 16):
    """Discretize a continuous SPD fn(lambda_nm)->power into n bins by
    per-bin averaging (reference Spectrum::fromContinuousSpectrum)."""
    lam = np.linspace(spec.lambda_min, spec.lambda_max,
                      spec.n * oversample, endpoint=False)
    lam = lam + 0.5 * (lam[1] - lam[0])
    v = np.asarray(fn(lam), np.float64)
    return jnp.asarray(v.reshape(spec.n, oversample).mean(axis=1),
                       jnp.float32)


def blackbody(temperature_k, spec: SpectralBins):
    """Planck spectral radiance discretized into the bins
    (reference spectrum.cpp fromBlackBody), W/(m^2 sr nm)."""
    h = 6.62607015e-34
    c = 2.99792458e8
    kb = 1.380649e-23

    def planck(lam_nm):
        lam = lam_nm * 1e-9
        return (2.0 * h * c * c) / (lam ** 5) \
            / (np.exp(h * c / (lam * kb * float(temperature_k))) - 1.0) \
            * 1e-9
    return from_continuous(planck, spec)
