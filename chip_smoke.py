"""Smoke test of the renderer on an NVIDIA GPU: the main path once, through
the entry points a user calls, at the bench's sizes, in ONE process (a
second JAX process on the card would fail for want of memory).

    python chip_smoke.py          # one card: phases 0-5
    python chip_smoke.py --four   # four cards: render_sharded and
                                  # training_step_sharded on a 4-device mesh
                                  # against devices[:1]; no other phase

Phases
  0  device: JAX must report a GPU; prints versions and the cache directory
  1  the Triton brute-force intersector against the plain XLA reference at
     1,048,576 rays (Cornell camera rays + one cosine bounce)
  2  CLI render of scenes/cornell.xml (BASELINE config 1) to an EXR, and
     the 64 px golden gate
  3  specular Cornell 512x512x4 spp, and its golden gate
  4  102,400-triangle mesh scene on the cluster backend (the XLA BVH walk)
     at 512x512x4 spp, its golden gate, and the walk's trip count for the
     camera bounce
  5  inverse rendering: three training_step_sharded steps on a one-device
     mesh (the loss must fall) and a central finite-difference check of
     d(loss)/d(reflectance)

Each phase prints one line: wall time, compile time, peak device memory
(process-wide) and, for renders, rays/s as a smoke reading (not a
benchmark) labelled with the card. Any failure raises and the exit code is
non-zero; the last line of stdout, {"ok": true, "device": {...}}, appears
only when every phase passed. Images go to chiprun_out/chip_smoke/.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# Sizes: BASELINE configs 1-4 as the bench runs them. Goldens are 64 px.
SIZE = dict(
    rays=(256, 16),      # phase 1: 256x256 pixels x 16 = 1,048,576 rays
    cli=(256, 64),       # phase 2: BASELINE config 1, 4.2M lanes
    specular=(512, 4),   # phase 3
    mesh=(512, 4),       # phase 4
    train=(256, 16),     # phase 5: three steps
    fd=(64, 16),         # phase 5: finite difference
    golden=64,
)

# Phase 1 tolerances. The kernel and XLA's fusion of the reference do the
# same float32 Möller–Trumbore arithmetic (no matrix product anywhere), but
# the GPU compilers contract multiply-adds into FMAs and order the sums
# differently: hits near an edge or a grazing angle may flip.
AGREE_FRAC = 0.9999       # valid and occluded agree on this share of lanes
T_REL = 1e-4              # |dt| <= T_REL * t where both hit the same prim
UV_ABS = 1e-4             # |du|, |dv| where both hit the same prim

TRAIN_LR = 2.0            # the mean-squared image loss has small gradients


class Phases:
    """Runs named phases, printing wall and compile time and peak device
    memory for each; compile time is XLA's backend compile duration."""

    def __init__(self, jax, card):
        self.jax = jax
        self.card = card
        self.compile_s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.compile_s += duration

    def run(self, name, fn):
        c0 = self.compile_s
        t0 = time.perf_counter()
        info = fn() or {}
        wall = time.perf_counter() - t0
        peak = (self.jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use")
        extra = "".join(f", {k} {v}" for k, v in info.items())
        print(f"phase {name}: wall {wall:.3f} s, compile "
              f"{self.compile_s - c0:.3f} s, peak_bytes_in_use {peak}{extra}",
              flush=True)

    def rate(self, rays, seconds):
        return (f"{rays / seconds:.6g} rays/s (smoke reading, not a "
                f"benchmark; {self.card.splitlines()[0]})")


def timed(jax, fn, *args):
    """(result, seconds) of fn(*args), waiting for the device."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def render_jit(jax, scene, cfg, seed=0):
    """Compile, then run once: (image, aux, run seconds)."""
    from mitsuba_jax.integrators.path import render

    fn = jax.jit(functools.partial(render, cfg=cfg, seed=seed)).lower(
        scene).compile()
    (img, aux), s = timed(jax, fn, scene)
    return img, aux, s


def check_image(np, img, shape):
    img = np.asarray(img)
    assert img.shape == shape, img.shape
    assert np.isfinite(img).all() and img.mean() > 0, "bad image"
    return img


def gate(golden, make_scene, block=8, rel_max=0.10):
    import bench

    g = SIZE["golden"]
    rel = bench.golden_rel_rmse(make_scene(g, g), golden, block=block)
    assert rel <= rel_max, f"{golden}: rel RMSE {rel:.4f} > {rel_max}"
    return f"{rel:.4f} <= {rel_max}"


# ---------------------------------------------------------------- phases

def phase1(jax, jnp, np, ph):
    """Triton kernel vs the XLA reference on camera + bounce rays."""
    from mitsuba_jax.core import warp
    from mitsuba_jax.ops import brute_triton as bt
    from mitsuba_jax.render import intersect as I
    from mitsuba_jax.render.records import Ray
    from mitsuba_jax.render.sampler import Sampler
    from mitsuba_jax.render.scene import cornell_box

    w, spp = SIZE["rays"]
    h = w
    scene = cornell_box(w, h)
    geom = scene.geom
    n = w * h * spp

    @jax.jit
    def make_rays(scene):
        lane = jnp.arange(n)
        pix = lane // spp
        smp = Sampler(0, pix, (lane % spp).astype(jnp.int32))
        j = smp.next_2d()
        uv = jnp.stack([(pix % w + j[:, 0]) / w, (pix // w + j[:, 1]) / h],
                       -1)
        cam = scene.camera.sample_ray(uv)
        its, _ = I._brute_plain(scene.geom, cam, None)
        wo = its.to_world(warp.square_to_cosine_hemisphere(smp.next_2d()))
        bounce = Ray.make(its.p, wo, mint=jnp.full(n, 1e-2),
                          maxt=jnp.where(its.valid, jnp.inf, -1.0))
        return cam, bounce

    cam, bounce = make_rays(scene)

    def rows(r):
        return bt.pack_rays(r.o, r.d, r.mint, r.maxt)

    kernel = jax.jit(lambda g, r, s: bt.brute_hits(
        g.tri_packed, g.shade_pack, rows(r), rows(s)))

    def plain(g, r, s):
        return I._closest_brute(g, r), I._any_brute(g, s)
    plain = jax.jit(plain)

    worst = {}
    for name, (r, s) in (("camera", (cam, bounce)), ("bounce", (bounce, cam))):
        rec_f, rec_i, occ = (np.asarray(x) for x in kernel(geom, r, s))
        (t0, u0, v0, p0, ok0), occ0 = jax.tree_util.tree_map(
            np.asarray, plain(geom, r, s))
        t1, u1, v1, p1, ok1 = rec_f[0], rec_f[1], rec_f[2], rec_i[0], \
            rec_i[0] >= 0
        valid_agree = (ok1 == ok0).mean()
        occ_agree = (occ == occ0).mean()
        both = ok0 & ok1
        same = both & (p0 == p1)
        dt = np.abs(t1[same] - t0[same]) / t0[same]
        duv = np.maximum(np.abs(u1[same] - u0[same]),
                         np.abs(v1[same] - v0[same]))
        swap = both & (p0 != p1)
        swap_bad = int((np.abs(t1[swap] - t0[swap]) > T_REL * t0[swap]).sum())
        assert valid_agree >= AGREE_FRAC, (name, "valid", valid_agree)
        assert occ_agree >= AGREE_FRAC, (name, "occluded", occ_agree)
        assert dt.max(initial=0) <= T_REL, (name, "t", dt.max())
        assert duv.max(initial=0) <= UV_ABS, (name, "uv", duv.max())
        assert swap_bad == 0, (name, "prim swaps with distinct t", swap_bad)
        worst[name] = (f"valid {valid_agree:.6f} occ {occ_agree:.6f} "
                       f"max rel dt {dt.max(initial=0):.3g} max duv "
                       f"{duv.max(initial=0):.3g} prim swaps "
                       f"{int(swap.sum())}")

    # (a) the intersection call alone: fused closest + shadow, 1M rays
    times = {}
    for label, fn in (("kernel", kernel), ("plain", plain)):
        runs = [timed(jax, fn, geom, cam, bounce)[1] for _ in range(5)]
        times[label] = f"{1e3 * float(np.median(runs)):.3f} ms"
    return {**{f"[{k}]": v for k, v in worst.items()},
            "rays": n,
            f"median of 5, closest+shadow ({ph.card.splitlines()[0]})": times}


def phase2(jax, jnp, np, ph):
    """CLI render of BASELINE config 1, then the golden gate."""
    from mitsuba_jax import cli
    from mitsuba_jax.integrators import PathConfig
    from mitsuba_jax.io import bitmap
    from mitsuba_jax.io.xml import load_scene
    from mitsuba_jax.render.scene import cornell_box

    w, spp = SIZE["cli"]
    xml = os.path.join(ROOT, "scenes", "cornell.xml")
    exr = os.path.join(OUT, f"cornell_{w}x{w}_{spp}spp.exr")
    params = dict(width=str(w), height=str(w), spp=str(spp), depth="5")
    defs = [a for k, v in params.items() for a in ("-D", f"{k}={v}")]
    rc = cli.main([xml, *defs, "-o", exr, "-q"])
    assert rc == 0, f"cli.main returned {rc}"
    check_image(np, bitmap.read_exr(exr), (w, w, 3))
    # the same scene, jitted and warm: its ray count gives the smoke rate
    scene, _ = load_scene(xml, params=params)
    _, aux, s = render_jit(jax, scene, PathConfig(
        max_depth=5, spp=spp, remat=False))
    return {"exr": os.path.relpath(exr, ROOT), "lanes": w * w * spp,
            "rate": ph.rate(float(aux["rays_traced"]), s),
            "golden bench_cfg1": gate("bench_cfg1", cornell_box)}


def phase3(jax, jnp, np, ph):
    from mitsuba_jax.integrators import PathConfig
    from mitsuba_jax.render.scene import cornell_box_specular

    w, spp = SIZE["specular"]
    scene = cornell_box_specular(w, w, backend="auto")
    img, aux, s = render_jit(jax, scene, PathConfig(max_depth=5, spp=spp,
                                                     remat=False))
    check_image(np, img, (w, w, 3))
    return {"rate": ph.rate(float(aux["rays_traced"]), s),
            "golden bench_cfg2": gate(
                "bench_cfg2", functools.partial(cornell_box_specular,
                                                backend="auto"),
                block=16, rel_max=0.15)}


def phase4(jax, jnp, np, ph):
    from mitsuba_jax.integrators import PathConfig
    from mitsuba_jax.render.intersect import bvh_walk
    from mitsuba_jax.render.scene import textured_mesh_scene

    w, spp = SIZE["mesh"]
    h = w
    scene = textured_mesh_scene(w, h, backend="cluster")
    img, aux, s = render_jit(jax, scene, PathConfig(max_depth=5, spp=spp,
                                                     remat=False))
    check_image(np, img, (h, w, 3))

    @jax.jit
    def camera_walk_steps(scene):
        lane = jnp.arange(w * h * spp)
        pix = lane // spp
        uv = jnp.stack([(pix % w + 0.5) / w, (pix // w + 0.5) / h], -1)
        return bvh_walk(scene.geom, scene.camera.sample_ray(uv))[5]

    return {"triangles": scene.geom.n_tris,
            "rate": ph.rate(float(aux["rays_traced"]), s),
            "camera-bounce walk trip count": int(camera_walk_steps(scene)),
            "golden bench_cfg3": gate(
                "bench_cfg3", functools.partial(textured_mesh_scene,
                                                backend="cluster"))}


def _with_reflectance(scene, refl):
    from mitsuba_jax.core.types import replace

    return replace(scene, materials=replace(scene.materials,
                                            reflectance=refl))


def phase5(jax, jnp, np, ph):
    from mitsuba_jax.integrators import PathConfig
    from mitsuba_jax.integrators.path import render
    from mitsuba_jax.parallel import make_mesh, training_step_sharded
    from mitsuba_jax.render.scene import cornell_box

    w, spp = SIZE["train"]
    scene = cornell_box(w, w)
    cfg = PathConfig(max_depth=5, spp=spp, remat=True)
    refl = scene.materials.reflectance
    # target: the same box with known albedos (greyer walls, bluer blocks)
    known = refl.at[0].set(jnp.asarray([0.5, 0.5, 0.5]))
    target, _, _ = render_jit(jax, _with_reflectance(scene, known), cfg,
                              seed=1)

    def apply(sc, p):
        return _with_reflectance(sc, p["reflectance"])

    params = {"reflectance": refl}
    mesh = make_mesh(jax.devices()[:1])
    losses = []
    for _ in range(3):
        params, loss = training_step_sharded(scene, cfg, target, params,
                                             apply, seed=0, mesh=mesh,
                                             lr=TRAIN_LR)
        losses.append(float(loss))
    assert losses[2] < losses[1] < losses[0], ("loss did not fall", losses)

    # central finite difference of mean(image) in one reflectance entry
    w, spp = SIZE["fd"]
    small = cornell_box(w, w)
    cfg_fd = PathConfig(max_depth=5, spp=spp, remat=True)
    loss = jax.jit(lambda r: jnp.mean(render(_with_reflectance(small, r),
                                             cfg_fd, seed=0)[0]))
    r0 = small.materials.reflectance
    g = float(jax.jit(jax.grad(lambda r: loss(r)))(r0)[0, 0])
    eps = 2e-3          # tests/test_grad.py's step and tolerance
    e = jnp.zeros_like(r0).at[0, 0].set(1.0)
    fd = (float(loss(r0 + eps * e)) - float(loss(r0 - eps * e))) / (2 * eps)
    rel = abs(fd - g) / max(abs(fd), abs(g), 1e-6)
    assert rel < 2e-2, ("finite difference", fd, g)
    return {"losses": " > ".join(f"{x:.6g}" for x in losses),
            "d loss/d refl[0,0]": f"AD {g:.6g} FD {fd:.6g} rel {rel:.3g}"}



def four(jax, jnp, np, ph):
    """render_sharded and training_step_sharded on 4 devices vs 1, at
    cfg-1 scale; tests/test_parallel.py's tolerance."""
    from mitsuba_jax.integrators import PathConfig
    from mitsuba_jax.parallel import (
        make_mesh, render_sharded, training_step_sharded,
    )
    from mitsuba_jax.render.scene import cornell_box

    devs = jax.devices()
    assert len(devs) == 4, f"--four needs 4 devices, JAX sees {len(devs)}"
    w, spp = SIZE["rays"]
    scene = cornell_box(w, w)
    meshes = {k: make_mesh(devs[:k]) for k in (1, 4)}
    cfg = PathConfig(max_depth=5, spp=spp, remat=False)
    img = {k: np.asarray(timed(jax, render_sharded, scene, cfg, 3, m)[0][0])
           for k, m in meshes.items()}
    np.testing.assert_allclose(img[4], img[1], rtol=2e-5, atol=1e-7)

    tcfg = PathConfig(max_depth=5, spp=spp, remat=True)
    target = jnp.asarray(img[1]) * 0.8

    def apply(sc, p):
        return _with_reflectance(sc, p["reflectance"])

    out = {}
    for k, m in meshes.items():
        p, loss = training_step_sharded(
            scene, tcfg, target, {"reflectance": scene.materials.reflectance},
            apply, seed=0, mesh=m, lr=TRAIN_LR)
        out[k] = (np.asarray(p["reflectance"]), float(loss))
    np.testing.assert_allclose(out[4][1], out[1][1], rtol=2e-5)
    np.testing.assert_allclose(out[4][0], out[1][0], rtol=2e-5, atol=1e-7)
    return {"image max |4-1|": float(np.abs(img[4] - img[1]).max()),
            "loss 1 vs 4": f"{out[1][1]:.9g} {out[4][1]:.9g}",
            "params max |4-1|": float(np.abs(out[4][0] - out[1][0]).max())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="only the four-card sharded path and its "
                         "one-card comparison")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import jaxlib
    import numpy as np

    sys.path.insert(0, ROOT)
    from mitsuba_jax.utils.compile_cache import enable_compile_cache
    from mitsuba_jax.utils.device import (
        card_name_and_power_limit, require_gpu,
    )

    device = require_gpu()
    card = card_name_and_power_limit()
    cache = enable_compile_cache()
    os.makedirs(OUT, exist_ok=True)
    ph = Phases(jax, card)
    print(f"phase 0 device: {device['platform']} {device['kind']} "
          f"x{device['count']}; jax {jax.__version__} jaxlib "
          f"{jaxlib.__version__}; compile cache {cache}", flush=True)
    mods = (jax, jnp, np, ph)
    if args.four:
        ph.run("four-card sharded vs one card", lambda: four(*mods))
    else:
        ph.run("1 brute intersector: Triton kernel vs XLA reference",
               lambda: phase1(*mods))
        ph.run("2 CLI render, BASELINE config 1", lambda: phase2(*mods))
        ph.run("3 specular Cornell 512x512x4", lambda: phase3(*mods))
        ph.run("4 mesh scene, cluster backend", lambda: phase4(*mods))
        ph.run("5 inverse rendering", lambda: phase5(*mods))
    print(f"nvidia-smi: {card}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
