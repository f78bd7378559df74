"""Brute-force ray–triangle kernel for NVIDIA GPUs (Pallas, Triton route).

The plain XLA query (render/intersect.py::_closest_brute) forms (N, T)
Möller–Trumbore intermediates and reads them back to pick each ray's
winner. Here one program takes a block of BLOCK rays and loops over the
T triangle rows: every thread reads the same row (a broadcast load served
from cache) and keeps its ray's best (t, u, v, prim), and its shadow ray's
occlusion bit, in registers. After the loop one `shade_pack` row-gather
for the winning triangle yields the shading record, interpolated in the
kernel. Device memory sees only rays in and records out.

Closest hit and shadow any-hit share the triangle loop (the fused form the
path tracer's deferred NEE feeds). Nothing is carried between programs.

Layouts (all float32):
  tri    (T, 9)   v0 | e1 | e2                 (GeometryTables.tri_packed)
  shade  (T, 24)  GeometryTables.shade_pack; ids bit-cast into the last 3
  rays   (8, N)   ox oy oz dx dy dz mint maxt   (see pack_rays)
Closest-hit records come back as REC_F float rows and REC_I int rows.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK = 128       # rays per program (power of two)
NUM_WARPS = 2       # swept on the H100 (PERF.md): 2 beat 4 at BLOCK 128
_DET_EPS = 1e-9   # must equal render/intersect.py::_DET_EPS

# rows of the float record: t, u, v, geo_n xyz, sh_n xyz, uv, dp_du xyz
REC_F = 14
# rows of the int record: prim (-1 on miss), material, emitter, shape id
REC_I = 4


def pack_rays(o, d, mint, maxt):
    """(N,3),(N,3),(N,),(N,) ray fields -> the kernel's (8, N) rows."""
    return jnp.concatenate([o.T, d.T, mint[None], maxt[None]],
                           axis=0).astype(jnp.float32)


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalize(a):
    inv = 1.0 / jnp.sqrt(jnp.maximum(_dot(a, a), 1e-20))
    return tuple(x * inv for x in a)


def _mt_hit(tri_ref, j, ray):
    """Möller–Trumbore of triangle row j against a block of rays, in the
    operation order of render/intersect.py::_mt_hit. Returns (t, u, v, hit)."""
    o, d, mint, maxt = ray
    v0 = tuple(tri_ref[j, k] for k in range(0, 3))
    e1 = tuple(tri_ref[j, k] for k in range(3, 6))
    e2 = tuple(tri_ref[j, k] for k in range(6, 9))
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    det_ok = jnp.abs(det) > _DET_EPS
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvec = tuple(oc - vc for oc, vc in zip(o, v0))
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > mint) & (t < maxt))
    return t, u, v, hit


def _shade(shade_ref, prim, u, v):
    """Shading record of the winning triangle, as in the plain path's
    render/intersect.py::_shade: geometric and interpolated shading normal,
    texture uv, parametric dp/du, ids."""
    p = jnp.maximum(prim, 0)
    row = [shade_ref[p, k] for k in range(24)]
    e1, e2 = tuple(row[0:3]), tuple(row[3:6])
    n0, n1, n2 = tuple(row[6:9]), tuple(row[9:12]), tuple(row[12:15])
    uv0, uv1, uv2 = row[15:17], row[17:19], row[19:21]
    w = 1.0 - u - v
    geo_n = _normalize(_cross(e1, e2))
    sh_n = _normalize(tuple(w * a + u * b + v * c
                            for a, b, c in zip(n0, n1, n2)))
    uv = tuple(w * a + u * b + v * c for a, b, c in zip(uv0, uv1, uv2))
    duv1 = (uv1[0] - uv0[0], uv1[1] - uv0[1])
    duv2 = (uv2[0] - uv0[0], uv2[1] - uv0[1])
    det_uv = duv1[0] * duv2[1] - duv1[1] * duv2[0]
    ok_uv = jnp.abs(det_uv) > 1e-12
    inv_uv = 1.0 / jnp.where(ok_uv, det_uv, 1.0)
    dp_du = tuple(jnp.where(ok_uv, (duv2[1] * a - duv1[1] * b) * inv_uv, a)
                  for a, b in zip(e1, e2))
    ids = tuple(jax.lax.bitcast_convert_type(x, jnp.int32) for x in row[21:24])
    return (*geo_n, *sh_n, *uv, *dp_du), ids


def _kernel(*refs, n, n_tris, block, closest, shadow):
    refs = iter(refs)
    tri_ref = next(refs)
    shade_ref = next(refs) if closest else None
    ray_ref = next(refs) if closest else None
    sray_ref = next(refs) if shadow else None
    recf_ref = next(refs) if closest else None
    reci_ref = next(refs) if closest else None
    occ_ref = next(refs) if shadow else None

    start = pl.program_id(0) * block
    lanes = pl.ds(start, block)
    live = start + jnp.arange(block) < n

    def load_rays(ref):
        # masked tail: dead lanes get maxt = -1 < mint and never hit
        f = [plgpu.load(ref.at[k, lanes], mask=live, other=0.0)
             for k in range(7)]
        maxt = plgpu.load(ref.at[7, lanes], mask=live, other=-1.0)
        return tuple(f[0:3]), tuple(f[3:6]), f[6], maxt

    ray = load_rays(ray_ref) if closest else None
    sray = load_rays(sray_ref) if shadow else None

    def body(j, carry):
        t_b, u_b, v_b, p_b, occ = carry
        if closest:
            t, u, v, hit = _mt_hit(tri_ref, j, ray)
            closer = hit & (t < t_b)
            t_b = jnp.where(closer, t, t_b)
            u_b = jnp.where(closer, u, u_b)
            v_b = jnp.where(closer, v, v_b)
            p_b = jnp.where(closer, j, p_b)
        if shadow:
            occ = occ | _mt_hit(tri_ref, j, sray)[3].astype(jnp.int32)
        return t_b, u_b, v_b, p_b, occ

    zero = jnp.zeros((block,), jnp.float32)
    init = (jnp.full((block,), jnp.inf, jnp.float32), zero, zero,
            jnp.full((block,), -1, jnp.int32), jnp.zeros((block,), jnp.int32))
    t_b, u_b, v_b, p_b, occ = jax.lax.fori_loop(0, n_tris, body, init)

    if closest:
        rec_f, ids = _shade(shade_ref, p_b, u_b, v_b)
        for k, x in enumerate((t_b, u_b, v_b) + rec_f):
            plgpu.store(recf_ref.at[k, lanes], x, mask=live)
        for k, x in enumerate((p_b,) + ids):
            plgpu.store(reci_ref.at[k, lanes], x, mask=live)
    if shadow:
        plgpu.store(occ_ref.at[lanes], occ, mask=live)


@functools.partial(jax.jit, static_argnames=("block", "num_warps",
                                             "interpret"))
def brute_hits(tri, shade, rays=None, srays=None, *, block: int = BLOCK,
               num_warps: int = NUM_WARPS, interpret: bool = False):
    """Closest hit + shading record of `rays` and/or occlusion of `srays`
    (either may be None; both are (8, N) from pack_rays, with one N).

    Returns (rec_f (REC_F, N) | None, rec_i (REC_I, N) | None,
    occluded (N,) bool | None). rec_i[0] is -1 on a miss; rec_f rows other
    than t are then meaningless (t is +inf).
    """
    closest, shadow = rays is not None, srays is not None
    if closest and shadow and rays.shape != srays.shape:
        raise ValueError(f"rays {rays.shape} and shadow rays {srays.shape} "
                         "must have one shape")
    n = (rays if closest else srays).shape[1]
    out_shape = []
    if closest:
        out_shape += [jax.ShapeDtypeStruct((REC_F, n), jnp.float32),
                      jax.ShapeDtypeStruct((REC_I, n), jnp.int32)]
    if shadow:
        out_shape.append(jax.ShapeDtypeStruct((n,), jnp.int32))
    ins = [tri] + ([shade, rays] if closest else []) \
        + ([srays] if shadow else [])
    outs = pl.pallas_call(
        functools.partial(_kernel, n=n, n_tris=tri.shape[0], block=block,
                          closest=closest, shadow=shadow),
        grid=(pl.cdiv(n, block),),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="brute_hits",
    )(*ins)
    rec_f = outs[0] if closest else None
    rec_i = outs[1] if closest else None
    occ = outs[-1].astype(bool) if shadow else None
    return rec_f, rec_i, occ
