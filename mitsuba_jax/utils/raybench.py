"""Ray-throughput microbenchmark — the kdbench analog.

Capability parity with src/utils/kdbench.cpp:210-237: trace N random
incoherent rays through a scene's acceleration structure, best-of-3 MRays/s.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.render.intersect import ray_intersect, ray_test
from mitsuba_jax.render.records import Ray


def random_rays_in_aabb(key, n, bmin, bmax, scale=1.5):
    center = (np.asarray(bmin) + np.asarray(bmax)) * 0.5
    extent = (np.asarray(bmax) - np.asarray(bmin)) * 0.5 * scale
    k1, k2 = jax.random.split(key)
    o = jnp.asarray(center) + (jax.random.uniform(k1, (n, 3)) * 2 - 1) * jnp.asarray(extent)
    d = jax.random.normal(k2, (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return Ray.make(o, d)


def bench_rays(geom, n: int = 5_000_000, rounds: int = 3, shadow: bool = False,
               seed: int = 0):
    """Returns (mrays_per_sec, best_time). Mirrors kdbench: 5M incoherent
    rays, best of `rounds`."""
    bmin = np.asarray(jnp.min(geom.v0, axis=0))
    bmax = np.asarray(
        jnp.max(geom.v0 + jnp.maximum(geom.e1, 0) + jnp.maximum(geom.e2, 0), axis=0)
    )
    ray = random_rays_in_aabb(jax.random.key(seed), n, bmin, bmax)
    fn = jax.jit(lambda g, r: (ray_test(g, r) if shadow else ray_intersect(g, r).t))
    out = fn(geom, ray)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        out = fn(geom, ray)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return n / best / 1e6, best


def _count_walk(geom, ray):
    """Instrumented skip-link walk: per-lane (node_steps, tri_tests).

    A phased walk (one node or one triangle per lane per step, as
    intersect._hair_walk does) with two counters; used only by
    find_costs."""
    import jax.lax as lax

    from mitsuba_jax.core import math as m
    from mitsuba_jax.render.intersect import MAX_LEAF, _mt_hit, _slab_test

    n = ray.o.shape[0]
    m_nodes = geom.bvh_min.shape[0]
    inv_d = m.safe_rcp(ray.d)
    nodes = geom.bvh_packed
    tris = geom.tri_packed
    cap = (MAX_LEAF + 1) * m_nodes + 8

    def cond(st):
        node, lf, lc, lk, steps, t_best, cn, ct = st
        return jnp.any((node < m_nodes) | (lk < lc)) & (steps < cap)

    def body(st):
        node, lf, lc, lk, steps, t_best, cn, ct = st
        in_leaf = lk < lc
        ti = jnp.minimum(lf + jnp.minimum(lk, MAX_LEAF - 1),
                         geom.n_tris - 1)
        trow = tris[ti]
        t, _u, _v, hit = _mt_hit(ray.o, ray.d, trow[:, 0:3], trow[:, 3:6],
                                 trow[:, 6:9], ray.mint,
                                 jnp.minimum(ray.maxt, t_best))
        t_best = jnp.where(in_leaf & hit & (t < t_best), t, t_best)
        ct = ct + in_leaf.astype(jnp.int32)
        lk = jnp.where(in_leaf, lk + 1, lk)
        do_node = ~in_leaf & (node < m_nodes)
        nd = jnp.minimum(node, m_nodes - 1)
        row = nodes[nd]
        first = row[:, 6].astype(jnp.int32)
        count = row[:, 7].astype(jnp.int32)
        skip = row[:, 8].astype(jnp.int32)
        box_hit = do_node & _slab_test(row[:, 0:3], row[:, 3:6], ray.o,
                                       inv_d, ray.mint,
                                       jnp.minimum(ray.maxt, t_best))
        cn = cn + do_node.astype(jnp.int32)
        is_leaf = count > 0
        enter = box_hit & is_leaf
        lf = jnp.where(enter, first, lf)
        lc = jnp.where(enter, jnp.minimum(count, MAX_LEAF), lc)
        lk = jnp.where(enter, 0, lk)
        node = jnp.where(do_node,
                         jnp.where(box_hit & ~is_leaf, nd + 1, skip), node)
        return node, lf, lc, lk, steps + 1, t_best, cn, ct

    z = jnp.zeros(n, jnp.int32)
    st = (z, z, z, z, jnp.zeros((), jnp.int32), jnp.full(n, jnp.inf),
          z, z)
    st = lax.while_loop(cond, body, st)
    return st[6], st[7]


def find_costs(geom, n: int = 100_000, batches: int = 10, seed: int = 0):
    """SAH cost auto-fit — the findCosts analog
    (reference include/mitsuba/render/sahkdtree3.h:575-661, invoked by
    kdbench -f, src/utils/kdbench.cpp:242-246).

    The reference regresses per-ray rdtsc counts against per-ray
    (traversals, intersections) to find the two SAH constants. A wavefront
    walk is lock-step; in the PHASED model every while-iteration issues one node
    gather and one triangle gather for the whole batch no matter which
    phase each lane is in, so a node step and a triangle test cost the
    same and the batch's wall time is set by its slowest lane:
        time_k = c0 + c_step * max_lane(nodeSteps + triTests)_k .
    We fit (c0, c_step) by least squares over `batches` batches of
    random incoherent rays and return the SAH constants this hardware
    actually implies: traversal_cost == intersection_cost == c_step,
    rescaled so traversal_cost == 10.0 like the reference. The fit dict
    carries the raw microsecond costs and the residual."""
    bmin = np.asarray(jnp.min(geom.v0, axis=0))
    bmax = np.asarray(
        jnp.max(geom.v0 + jnp.maximum(geom.e1, 0)
                + jnp.maximum(geom.e2, 0), axis=0))
    walk = jax.jit(lambda g, r: _closest_time_probe(g, r))
    count = jax.jit(_count_walk)
    A = np.zeros((batches, 2))
    b = np.zeros(batches)
    for k in range(batches):
        key = jax.random.key(seed * 1000 + k)
        ray = random_rays_in_aabb(key, n, bmin, bmax,
                                  scale=0.5 + 0.3 * k)
        cn, ct = count(geom, ray)
        out = walk(geom, ray)
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(walk(geom, ray))
            best = min(best, time.perf_counter() - t0)
        A[k] = (1.0, float(jnp.max(cn + ct)))
        b[k] = best * 1e6
    x, _res, _rank, _sv = np.linalg.lstsq(A, b, rcond=None)
    resid = float(np.abs(A @ x - b).mean())
    c_step = float(x[1])
    return 10.0, 10.0, {
        "constant_us": float(x[0]), "step_us": c_step,
        "traversal_us": c_step, "intersection_us": c_step,
        "mean_residual_us": resid}


def _closest_time_probe(geom, ray):
    from mitsuba_jax.render.intersect import _closest_bvh

    return _closest_bvh(geom, ray)[0]
