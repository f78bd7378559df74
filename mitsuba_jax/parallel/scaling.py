"""Multi-chip scaling-efficiency measurement.

BASELINE.json north star: >=85% rays/s scaling efficiency from 1 chip to
N >= 2 hosts. This harness runs the sharded render at a fixed per-device
wavefront (weak scaling) over 1..N devices of the current platform and
reports efficiency = (rays/s at N) / (N x rays/s at 1).

On the single-chip environment this runs over virtual CPU devices — it
validates the sharding mechanism and the measurement plumbing; the real
numbers come from a pod slice.  There is no communication inside the render
loop (scene replicated, lanes independent) so the expected efficiency on
real ICI is ~100% minus film-assembly collectives.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.integrators.path import PathConfig
from mitsuba_jax.parallel.mesh import make_mesh, render_sharded
from mitsuba_jax.core.types import replace


def measure_scaling(scene, cfg: PathConfig, device_counts=None,
                    rows_per_device: int = 32, rounds: int = 2, seed: int = 0):
    """Returns {n_devices: rays_per_sec} with a weak-scaling layout:
    image height = rows_per_device * n_devices."""
    devices = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8) if n <= len(devices)]
    results = {}
    for nd in device_counts:
        mesh = make_mesh(devices[:nd])
        sc = replace(scene, height=rows_per_device * nd)
        # warm up (compile)
        img, aux = render_sharded(sc, cfg, seed=seed, mesh=mesh)
        _ = float(np.asarray(img).ravel()[0])
        best = float("inf")
        for r in range(rounds):
            t0 = time.perf_counter()
            img, aux = render_sharded(sc, cfg, seed=seed + r + 1, mesh=mesh)
            _ = float(np.asarray(img).ravel()[0])
            best = min(best, time.perf_counter() - t0)
        results[nd] = float(aux["rays_traced"]) / best
    return results


def scaling_efficiency(results: dict) -> dict:
    """Per-device-count efficiency relative to perfect weak scaling."""
    base = results[min(results)]
    n0 = min(results)
    return {
        nd: results[nd] / (base * nd / n0) for nd in sorted(results)
    }
