"""Time the brute-force Triton intersector (ops/brute_triton.py) against
the plain XLA version it replaces, on the GPU, in one process:

  (a) the fused closest-hit + shadow query alone on 1,048,576 rays
      (Cornell 256x256 x 16 camera rays, shadow rays = one cosine bounce),
      for several (block, num_warps) choices;
  (b) `render` end to end at BASELINE config 1 (Cornell 256x256, 16 spp,
      depth 5), jitted once per variant.

Variants alternate (plain, kernel, kernel, plain, ...) so drift in the
card's clocks hits both. A run times REPS back-to-back calls (dispatch is
asynchronous, so host launch overhead overlaps device work) and reports
the time per call. Every run is printed, then medians, with the card's
name and power limit. Finally one call of each render variant is traced
with jax.profiler and the device time is summed per operation; traces go
to chiprun_out/brute_ab_trace/.

    python scripts/brute_kernel_ab.py [--runs 7]
"""
from __future__ import annotations

import argparse
import collections
import functools
import glob
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mitsuba_jax.core import warp  # noqa: E402
from mitsuba_jax.integrators.path import PathConfig, render  # noqa: E402
from mitsuba_jax.ops import brute_triton as bt  # noqa: E402
from mitsuba_jax.render import intersect as I  # noqa: E402
from mitsuba_jax.render.records import Ray  # noqa: E402
from mitsuba_jax.render.sampler import Sampler  # noqa: E402
from mitsuba_jax.render.scene import cornell_box  # noqa: E402
from mitsuba_jax.utils.compile_cache import enable_compile_cache  # noqa: E402
from mitsuba_jax.utils.device import (  # noqa: E402
    card_name_and_power_limit, require_gpu,
)

W, SPP = 256, 16
SWEEP = ((64, 2), (128, 4), (128, 2), (256, 8), (256, 4), (512, 8))
REPS = 20
TRACE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chiprun_out", "brute_ab_trace")


def query_rays(scene):
    n = W * W * SPP
    lane = jnp.arange(n)
    pix = lane // SPP
    smp = Sampler(0, pix, (lane % SPP).astype(jnp.int32))
    j = smp.next_2d()
    cam = scene.camera.sample_ray(jnp.stack(
        [(pix % W + j[:, 0]) / W, (pix // W + j[:, 1]) / W], -1))
    its, _ = I._brute_plain(scene.geom, cam, None)
    wo = its.to_world(warp.square_to_cosine_hemisphere(smp.next_2d()))
    return cam, Ray.make(its.p, wo, mint=jnp.full(n, 1e-2),
                         maxt=jnp.where(its.valid, jnp.inf, -1.0))


def run_alternating(fns, args, runs):
    """{name: [seconds...]}: each round runs every variant once, the order
    reversed on odd rounds."""
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(runs):
        for k in (names if r % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            for _ in range(REPS):
                out = fns[k](*args)
            jax.block_until_ready(out)
            times[k].append((time.perf_counter() - t0) / REPS)
    return times


def device_time_by_op(trace_dir, top=10):
    """Sum the device durations of the events of a jax.profiler trace, per
    line of each GPU plane and per event name. Returns printable lines."""
    path = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                         "*", "*.xplane.pb")))[-1]
    out = []
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            per = collections.Counter()
            for ev in line.events:
                per[ev.name] += ev.duration_ns
            total = sum(per.values())
            out.append(f"  {plane.name} / {line.name}: {len(per)} names, "
                       f"{total / 1e6:.3f} ms total")
            for name, ns in per.most_common(top):
                out.append(f"    {ns / 1e6:9.3f} ms  {100 * ns / total:5.1f}%"
                           f"  {name[:110]}")
    return out


def report(title, times):
    print(title)
    for k, v in times.items():
        print(f"  {k:>24}: median {1e3 * statistics.median(v):.3f} ms; "
              f"runs " + " ".join(f"{1e3 * x:.3f}" for x in v))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=7)
    args = ap.parse_args(argv)

    device = require_gpu()
    card = card_name_and_power_limit()
    enable_compile_cache()
    print(f"device: {device}; nvidia-smi: {card}")
    scene = cornell_box(W, W)
    cam, bounce = jax.jit(query_rays)(scene)

    def rows(r):
        return bt.pack_rays(r.o, r.d, r.mint, r.maxt)

    # (a) the query alone
    fns = {"plain": jax.jit(lambda g, r, s: (I._closest_brute(g, r),
                                             I._any_brute(g, s)))}
    for block, warps in SWEEP:
        fns[f"kernel b{block} w{warps}"] = jax.jit(
            lambda g, r, s, b=block, nw=warps: bt.brute_hits(
                g.tri_packed, g.shade_pack, rows(r), rows(s), block=b,
                num_warps=nw))
    qargs = (scene.geom, cam, bounce)
    for f in fns.values():                      # compile + warm up
        jax.block_until_ready(f(*qargs))
    times = run_alternating(fns, qargs, args.runs)
    report(f"(a) closest + shadow query, {W * W * SPP} rays", times)
    best = min((k for k in times if k != "plain"),
               key=lambda k: statistics.median(times[k]))
    block, warps = SWEEP[[f"kernel b{b} w{w}" for b, w in SWEEP].index(best)]

    # (b) render end to end; the variant is fixed when render is traced
    cfg = PathConfig(max_depth=5, spp=SPP, remat=False)
    variants = {"plain": (I._brute_plain, {}),
                f"kernel b{bt.BLOCK} w{bt.NUM_WARPS}": (I._brute_kernel, {})}
    if (block, warps) != (bt.BLOCK, bt.NUM_WARPS):
        variants[best] = (I._brute_kernel, dict(block=block,
                                                num_warps=warps))
    dispatch, brute_hits = I._brute, bt.brute_hits
    rfns = {}
    for name, (impl, kw) in variants.items():
        I._brute = impl
        bt.brute_hits = functools.partial(brute_hits, **kw)
        rfns[name] = jax.jit(functools.partial(render, cfg=cfg, seed=0)) \
            .lower(scene).compile()
    I._brute, bt.brute_hits = dispatch, brute_hits
    rays = float(rfns["plain"](scene)[1]["rays_traced"])
    times = run_alternating(rfns, (scene,), args.runs)
    report(f"(b) render, Cornell {W}x{W} x {SPP} spp, depth 5, "
           f"{rays:.0f} rays traced", times)
    for k, v in times.items():
        print(f"  {k:>24}: {rays / statistics.median(v) / 1e6:.3f} Mrays/s")
    for k, fn in rfns.items():
        d = os.path.join(TRACE_DIR, k.replace(" ", "_"))
        with jax.profiler.trace(d):
            jax.block_until_ready(fn(scene))
        print(f"(b) device time by op, one traced call, {k}:")
        print("\n".join(device_time_by_op(d)))
    print(f"nvidia-smi: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
