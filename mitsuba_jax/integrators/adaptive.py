"""Adaptive-sampling meta-integrator — errctrl parity.

Functional parity with reference `ErrorControl` (src/integrators/misc/
errctrl.cpp:39): keep adding sample passes until the pixel estimates reach
a relative-error bound with the requested confidence (Student-t quantile on
the per-pixel sample variance), capped at maxSampleFactor× the base
sample count.

Wavefront re-design: the reference re-renders individual 32×32 blocks; here every
pass renders the full wavefront (lanes are free — what matters is when we
can STOP), accumulating per-pixel mean/M2 via Welford.  The host loop reads
one scalar per pass (fraction unconverged) and exits early — host-side
control flow around jitted passes, the idiomatic replacement for the
reference's per-block scheduler feedback.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.integrators.path import PathConfig, path_trace
from mitsuba_jax.render.sampler import Sampler, sample_position
from mitsuba_jax.core.spectrum import luminance


def adaptive_render(
    scene,
    cfg: PathConfig,
    max_error: float = 0.05,
    quantile: float = 1.96,        # reference pValue -> normal quantile
    max_sample_factor: int = 16,
    min_passes: int = 2,
    seed: int = 0,
    verbose: bool = False,
):
    """Render with per-pixel adaptive sample counts.

    Returns (image, aux) where aux includes per-pixel sample counts and the
    pass count actually used."""
    w, h, spp = scene.width, scene.height, cfg.spp
    n = w * h * spp

    @jax.jit
    def one_pass(scene, pass_seed):
        lane = jnp.arange(n)
        pixel_id = lane // spp
        sample_id = (lane % spp).astype(jnp.int32)
        px = (pixel_id % w).astype(jnp.float32)
        py = (pixel_id // w).astype(jnp.float32)
        sampler = Sampler(pass_seed, pixel_id, sample_id)
        jitter = sampler.next_2d()
        offset = sample_position(cfg.pattern, sample_id, spp, jitter)
        uv = jnp.stack([(px + offset[:, 0]) / w, (py + offset[:, 1]) / h], -1)
        ray = scene.camera.sample_ray(uv)
        L, _ = path_trace(scene, ray, sampler, cfg)
        lv = L.reshape(h, w, spp, 3)
        return lv.sum(axis=2), (lv ** 2).sum(axis=2)

    sum1 = jnp.zeros((h, w, 3))
    sum2 = jnp.zeros((h, w, 3))
    count = jnp.zeros((h, w), jnp.int32)
    active = np.ones((h, w), bool)
    passes = 0
    while passes < max_sample_factor:
        s1, s2 = one_pass(scene, seed * 7919 + passes)
        # only accumulate for unconverged pixels (their extra samples would
        # otherwise bias nothing, but counting matters for the estimate)
        mask = jnp.asarray(active)[..., None]
        sum1 = sum1 + jnp.where(mask, s1, 0.0)
        sum2 = sum2 + jnp.where(mask, s2, 0.0)
        count = count + jnp.where(jnp.asarray(active), spp, 0)
        passes += 1
        cnt = jnp.maximum(count, 1)[..., None].astype(jnp.float32)
        mean = sum1 / cnt
        var = jnp.maximum(sum2 / cnt - mean ** 2, 0.0) * cnt / jnp.maximum(cnt - 1, 1)
        # Convergence decided per BLOCK (reference errctrl works on 32x32
        # blocks): pooling avoids the zero-variance trap where a pixel whose
        # few samples all missed the light looks "converged" at the wrong
        # value. Block size 8 here (our images are smaller).
        blk = 8
        hb = max(h // blk, 1)
        wb = max(w // blk, 1)
        lum_px = luminance(mean)
        var_px = luminance(var)
        cnt_px = jnp.maximum(count, 1).astype(jnp.float32)
        lum_b = lum_px[: hb * blk, : wb * blk].reshape(hb, blk, wb, blk).mean((1, 3))
        var_b = var_px[: hb * blk, : wb * blk].reshape(hb, blk, wb, blk).mean((1, 3))
        cnt_b = cnt_px[: hb * blk, : wb * blk].reshape(hb, blk, wb, blk).sum((1, 3))
        stderr_b = jnp.sqrt(var_b / jnp.maximum(cnt_b, 1.0))
        rel_b = quantile * stderr_b / jnp.maximum(lum_b, 1e-3)
        rel = jnp.repeat(jnp.repeat(rel_b, blk, 0), blk, 1)[:h, :w]
        if passes >= min_passes:
            active = np.asarray(rel > max_error)
            frac = float(active.mean())
            if verbose:
                print(f"pass {passes}: {frac*100:.1f}% unconverged")
            if frac == 0.0:
                break
        else:
            active = np.ones((h, w), bool)

    img = sum1 / jnp.maximum(count, 1)[..., None].astype(jnp.float32)
    return img, {"sample_count": count, "passes": passes}
