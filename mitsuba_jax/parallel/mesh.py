"""Multi-device rendering over a jax.sharding device mesh.

Replacement for the reference's entire distribution stack — the
pthread `Scheduler` with work-unit queues (include/mitsuba/core/sched.h:323),
the `RemoteWorker` TCP protocol (sched_remote.h:44,195-214) and the spiral
block decomposition (src/librender/imageproc.cpp:44).  Here:

  * the wavefront lane axis is sharded across a 1-D mesh axis "shard"
    (the analog of handing 32x32 blocks to workers — but with zero
    scheduling machinery): each device path-traces its own lanes under
    shard_map, so custom kernels on the path (which XLA cannot
    partition) see only local lanes,
  * the scene pytree is replicated into every device's memory (the
    analog of scheduler "resources" broadcast once per node,
    sched.h:364),
  * film assembly is a reshape on sharded output; parameter gradients in
    the training step are `psum`ed by XLA automatically,
  * counter-based RNG (render/sampler.py) makes the sample streams
    identical for ANY device count (images match up to float-reassociation
    ulps) — the distributed==local property the reference farm could not
    offer.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mitsuba_jax.integrators import path as path_mod
from mitsuba_jax.render.sampler import Sampler, sample_position


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), ("shard",))


def shard_lanes(mesh: Mesh, arr):
    """Place a lane-major array so its leading axis is split across chips."""
    return jax.device_put(arr, NamedSharding(mesh, P("shard")))


def replicate(mesh: Mesh, tree):
    return jax.device_put(tree, NamedSharding(mesh, P()))


def _lane_setup(scene, cfg, seed):
    """Lane -> (pixel, sample) assignment. MUST match integrators.path
    render()'s layout exactly (including the Morton pixel order used for
    the work-list cluster backend) so sharded and single-device renders
    stay bitwise comparable. Returns (n, pixel_id, sample_id, inv_lane)
    with inv_lane the permutation restoring scanline lane order (None
    when the layout is already scanline)."""
    w, h, spp = scene.width, scene.height, cfg.spp
    n = w * h * spp
    lane = jnp.arange(n)
    if scene.geom.backend == "cluster":
        perm_px = path_mod.pixel_morton_perm(w, h)
        pixel_id = jnp.asarray(perm_px, jnp.int32)[lane // spp]
        lane_tgt = perm_px[np.arange(n) // spp] * spp + np.arange(n) % spp
        inv_lane = jnp.asarray(np.argsort(lane_tgt), jnp.int32)
    else:
        pixel_id = lane // spp
        inv_lane = None
    sample_id = (lane % spp).astype(jnp.int32)
    return n, pixel_id, sample_id, inv_lane


def _trace_lanes(scene, cfg, seed, pixel_id, sample_id):
    """Pure lane-parallel radiance estimation (no cross-lane communication
    until the final film reshape)."""
    w = scene.width
    px = (pixel_id % w).astype(jnp.float32)
    py = (pixel_id // w).astype(jnp.float32)
    sampler = Sampler(seed, pixel_id, sample_id)
    jitter = sampler.next_2d()
    offset = sample_position(cfg.pattern, sample_id, cfg.spp, jitter)
    uv = jnp.stack(
        [(px + offset[:, 0]) / w, (py + offset[:, 1]) / scene.height], axis=-1
    )
    ray = scene.camera.sample_ray(uv)
    return path_mod.path_trace(scene, ray, sampler, cfg)


def _trace_sharded(mesh, scene, cfg, seed, pixel_id, sample_id):
    """_trace_lanes with every device tracing its own lane shard. Returns
    (L sharded over lanes, aux reduced over the mesh)."""

    def local(scene, pixel_id, sample_id):
        L, aux = _trace_lanes(scene, cfg, seed, pixel_id, sample_id)
        rays = jax.lax.psum(aux["rays_traced"], "shard")
        return L, {
            "avg_path_length": jax.lax.pmean(aux["avg_path_length"],
                                             "shard"),
            "rays_traced": rays,
            "pred_hit_frac": jax.lax.psum(
                aux["pred_hit_frac"] * aux["rays_traced"], "shard")
            / jnp.maximum(rays, 1.0),
        }

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P("shard"), P("shard")),
        out_specs=(P("shard"), P()),
        # the bounce scan's carry starts replicated and becomes
        # lane-varying; replication is not tracked through it
        check_vma=False)(scene, pixel_id, sample_id)


def render_sharded(scene, cfg, seed: int = 0, mesh: Mesh | None = None):
    """Render with lanes sharded over the mesh; returns ((H,W,3) image, aux).

    Matches single-device `integrators.render` up to float reassociation:
    all randomness is counter-based per (pixel, sample).
    """
    mesh = mesh or make_mesh()
    if scene.geom.backend == "cluster" and not cfg.sort_rays:
        # mirror integrators.path.render's cfg normalization so the
        # sharded program matches the single-device one
        import dataclasses
        cfg = dataclasses.replace(cfg, sort_rays=True)
    n, pixel_id, sample_id, inv_lane = _lane_setup(scene, cfg, seed)
    n_dev = mesh.devices.size
    assert n % n_dev == 0, (
        f"lane count {n} (w*h*spp) must be divisible by device count {n_dev}"
    )
    pixel_id = shard_lanes(mesh, pixel_id)
    sample_id = shard_lanes(mesh, sample_id)
    scene_r = replicate(mesh, scene)

    @partial(jax.jit, static_argnums=(1,), out_shardings=None)
    def run(scene, cfg, pixel_id, sample_id, inv_lane):
        L, aux = _trace_sharded(mesh, scene, cfg, seed, pixel_id, sample_id)
        if inv_lane is not None:
            # restore scanline lane order (Morton layout; one cross-shard
            # gather before the film reshape)
            L = L[inv_lane]
        img = L.reshape(scene.height, scene.width, cfg.spp, 3).mean(axis=2)
        return img, aux

    return run(scene_r, cfg, pixel_id, sample_id, inv_lane)


def training_step_sharded(scene, cfg, target_img, param_tree, apply_params,
                          seed: int = 0, mesh: Mesh | None = None,
                          lr: float = 0.05):
    """One differentiable inverse-rendering step over the mesh.

    param_tree: pytree of optimizable arrays; apply_params(scene, params) ->
    scene with the parameters substituted.  Loss = MSE(render, target).
    Lanes sharded, scene+params replicated; XLA psums the parameter grads.
    Returns (new_params, loss).
    """
    mesh = mesh or make_mesh()
    n, pixel_id, sample_id, inv_lane = _lane_setup(scene, cfg, seed)
    assert n % mesh.devices.size == 0
    pixel_id = shard_lanes(mesh, pixel_id)
    sample_id = shard_lanes(mesh, sample_id)
    scene_r = replicate(mesh, scene)
    params_r = replicate(mesh, param_tree)
    target_r = replicate(mesh, target_img)

    @partial(jax.jit, static_argnums=(1,))
    def step(scene, cfg, params, target, pixel_id, sample_id):
        def loss_fn(params):
            sc = apply_params(scene, params)
            L, _ = _trace_sharded(mesh, sc, cfg, seed, pixel_id, sample_id)
            if inv_lane is not None:
                L = L[inv_lane]
            img = L.reshape(scene.height, scene.width, cfg.spp, 3).mean(axis=2)
            return jnp.mean((img - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        new_params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
        return new_params, loss

    return step(scene_r, cfg, params_r, target_r, pixel_id, sample_id)
