"""Progressive preview rendering.

Capability parity with the reference's interactive preview stack (libhw +
PreviewThread, qtgui/preview.h:40 — VPL/OpenGL or coherent-SSE passes that
refine while you watch): here the forward renderer simply accumulates
low-spp passes and hands each refined image to a callback. There is no
separate GPU path — the production kernels ARE the preview (SURVEY.md §1/L2
notes this is the intended wavefront translation).
"""
from __future__ import annotations

import time

from mitsuba_jax.integrators.path import PathConfig, render
from mitsuba_jax.utils.checkpoint import FilmCheckpoint


def progressive_render(scene, cfg: PathConfig, n_passes: int = 16,
                       callback=None, seed: int = 0,
                       checkpoint: FilmCheckpoint | None = None,
                       guided: bool = False, guide_res: int = 16):
    """Accumulate `n_passes` renders of cfg.spp each; callback(image, i,
    spp_total, dt) fires after every pass. Resumes from `checkpoint`.

    guided=True: each pass samples from the guide accumulated by all
    previous passes while depositing new learning (integrators/guiding) —
    long progressive renders converge with continuously improving
    importance sampling at no extra ray cost."""
    fc = checkpoint or FilmCheckpoint(scene.height, scene.width)
    start_pass = fc.count // max(cfg.spp, 1)
    guide = None
    if guided:
        import numpy as np

        from mitsuba_jax.integrators.guiding import make_guide

        v0 = np.asarray(scene.geom.v0)
        ext = v0.max(0) - v0.min(0)
        guide = make_guide(v0.min(0) - 0.01 * ext, v0.max(0) + 0.01 * ext,
                           res=guide_res)
    for i in range(start_pass, start_pass + n_passes):
        t0 = time.time()
        if guided:
            # first pass: pure learning (guide is empty); later passes
            # sample AND keep learning
            img, aux = render(scene, cfg, seed=seed * 7919 + i,
                              guide=guide, learn_guide=True,
                              guide_sampling=i > start_pass)
            guide = aux["guide"]
        else:
            img, _ = render(scene, cfg, seed=seed * 7919 + i)
        fc.add_pass(img, cfg.spp)
        if callback is not None:
            callback(fc.image, i, fc.count, time.time() - t0)
    return fc.image, fc


def vpl_preview(scene, spp: int = 1, n_paths: int = 48, vpl_depth: int = 2,
                clamp_dist_frac: float = 0.05, seed: int = 0):
    """One fast VPL direct-lighting pass — the reference PreviewWorker's
    picture (qtgui/preview.cpp: VPL passes refine the viewport).  A single
    deterministic frame: Le + clamped direct lighting from a small VPL set,
    suitable as the first image while progressive_render refines."""
    import numpy as np

    from mitsuba_jax.integrators.path import PathConfig
    from mitsuba_jax.integrators.vpl import render_vpl

    v0 = np.asarray(scene.geom.v0)
    extent = float(np.linalg.norm(v0.max(0) - v0.min(0)) + 1e-6)
    img, _ = render_vpl(
        scene, PathConfig(max_depth=2, spp=spp, remat=False),
        n_paths=n_paths, vpl_depth=vpl_depth,
        clamp_dist=clamp_dist_frac * extent, seed=seed,
    )
    return img
