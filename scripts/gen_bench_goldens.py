"""Generate the bench validity goldens (VERDICT round-4 #5): low-res
CPU-reference renders of bench configs 1-3, committed to
tests/goldens/bench_cfg{1,2,3}.npz. bench.py re-renders the same
scene/seed/spp on the bench device and refuses to report a throughput
when the per-pixel RMSE exceeds the gate — a sign-flipped or half-black
render scores ~50-100% RMSE where fp/kernel-order wobble stays <1%.

Regenerate ONLY after an intentional estimator or scene change (and say so
in the commit message): python scripts/gen_bench_goldens.py [name ...]
(no names: all three)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

RES = 64
SPP = 16
DEPTH = 5
SEED = 0
DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "goldens")


def scenes():
    from mitsuba_jax.render.scene import (
        cornell_box, cornell_box_specular, textured_mesh_scene,
    )

    yield "bench_cfg1", cornell_box(RES, RES, backend="brute")
    yield "bench_cfg2", cornell_box_specular(RES, RES, backend="auto")
    yield "bench_cfg3", textured_mesh_scene(RES, RES, backend="cluster")


def main(names=()):
    from mitsuba_jax.integrators.path import PathConfig, render

    cfg = PathConfig(max_depth=DEPTH, spp=SPP)
    for name, scene in scenes():
        if names and name not in names:
            continue
        img, _ = render(scene, cfg, seed=SEED)
        img = np.asarray(img)
        np.savez_compressed(os.path.join(DIR, name + ".npz"), mean=img)
        print(f"{name}: mean={img.mean():.4f} -> {name}.npz", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
