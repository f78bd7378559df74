"""Reconstruction filters (reference src/rfilters/: box, gaussian,
mitchell, catmullrom, wsinc; include/mitsuba/render/rfilter.h:66
TabulatedFilter).

Filters are evaluated as separable 1-D profiles f(x)·f(y), vectorized; the
film (render/film.py) gathers them over a (2R+1)² pixel neighborhood.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core.registry import register_plugin


class RFilter:
    """name + radius + vectorized 1-D profile."""

    def __init__(self, name, radius, fn):
        self.name = name
        self.radius = float(radius)
        self.fn = fn

    def __call__(self, x):
        return jnp.where(jnp.abs(x) <= self.radius, self.fn(jnp.abs(x)), 0.0)


def make_box():
    return RFilter("box", 0.5, lambda x: jnp.ones_like(x))


def make_gaussian(stddev: float = 0.5):
    # reference gaussian.cpp: truncated at 4 sigma... uses radius 4*stddev/2;
    # mitsuba 0.2 uses windowed gaussian radius = 4*stddev? it uses 2 by default
    r = 2.0 * stddev * 2.0
    alpha = 1.0 / (2.0 * stddev * stddev)
    offset = np.exp(-alpha * r * r)
    return RFilter("gaussian", r, lambda x: jnp.maximum(jnp.exp(-alpha * x * x) - offset, 0.0))


def _mitchell_1d(x, b, c):
    x = jnp.abs(x)
    x2, x3 = x * x, x * x * x
    p1 = ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2 + (6 - 2 * b)) / 6.0
    p2 = ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2 + (-12 * b - 48 * c) * x
          + (8 * b + 24 * c)) / 6.0
    return jnp.where(x < 1, p1, jnp.where(x < 2, p2, 0.0))


def make_mitchell(b: float = 1.0 / 3.0, c: float = 1.0 / 3.0):
    return RFilter("mitchell", 2.0, lambda x: _mitchell_1d(x, b, c))


def make_catmullrom():
    return RFilter("catmullrom", 2.0, lambda x: _mitchell_1d(x, 0.0, 0.5))


def make_wsinc(radius: float = 3.0, tau: float = 3.0):
    def f(x):
        sinc = jnp.sinc(x)           # sin(pi x)/(pi x)
        window = jnp.sinc(x / tau)
        return sinc * window
    return RFilter("wsinc", radius, f)


def make_tent():
    return RFilter("tent", 1.0, lambda x: jnp.maximum(1.0 - jnp.abs(x), 0.0))


_FACTORIES = {
    "box": make_box,
    "gaussian": make_gaussian,
    "mitchell": make_mitchell,
    "catmullrom": make_catmullrom,
    "wsinc": make_wsinc,
    "tent": make_tent,
}


def make_rfilter(name: str, **kw) -> RFilter:
    if name not in _FACTORIES:
        raise KeyError(f"unknown rfilter '{name}'; known: {sorted(_FACTORIES)}")
    return _FACTORIES[name](**kw)


for _n in _FACTORIES:
    register_plugin("rfilter", _n)(lambda props, _n=_n: make_rfilter(_n))
