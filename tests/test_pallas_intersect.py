"""Brute-force Triton intersector (ops/brute_triton.py) vs the plain XLA
reference (_closest_brute/_any_brute and the record _brute_plain builds).

On the CPU the kernel runs in Pallas interpret mode; the compiled kernel
runs on a card under the `gpu` marker. The kernel sums each Möller–Trumbore
dot product left to right where XLA may reduce the reference's (N, T, 3)
arrays in another order, and a ray grazing some triangle makes that
difference large in t, u and v: hence the 1e-4 tolerances (the same the
card is held to in chip_smoke.py) on rays that do not graze their target."""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_jax.core.types import replace
from mitsuba_jax.ops import brute_triton as bt
from mitsuba_jax.render import intersect as I
from mitsuba_jax.render import mesh as mesh_mod
from mitsuba_jax.render.intersect import _any_brute, _closest_brute, build_geometry
from mitsuba_jax.render.records import Ray

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(seed, n_tris):
    """Well-shaped random triangles (two 0.5-long edges at 60 degrees,
    random orientation) around the origin."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.5, 1.5, (n_tris, 1, 3))
    q, _ = np.linalg.qr(rng.normal(size=(n_tris, 3, 3)))
    e = 0.5 * np.stack([np.zeros(3), [1.0, 0, 0],
                        [0.5, np.sqrt(0.75), 0]])
    v = c + np.einsum("tij,kj->tki", q, e)
    return mesh_mod.TriMesh(v.reshape(-1, 3).astype(np.float32),
                            np.arange(3 * n_tris, dtype=np.int32)
                            .reshape(-1, 3))


def _aimed_rays(geom, seed, n):
    """Rays toward random points of random triangles, each from within 60
    degrees of its target's normal (no grazing hits on the target)."""
    rng = np.random.default_rng(seed)
    ti = rng.integers(0, geom.n_tris, n)
    b = rng.dirichlet((1.0, 1.0, 1.0), n).astype(np.float32)
    v0, e1, e2 = (np.asarray(x)[ti] for x in (geom.v0, geom.e1, geom.e2))
    tgt = v0 + b[:, 1:2] * e1 + b[:, 2:3] * e2
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    w = np.where(np.sum(w * nrm, -1, keepdims=True) < 0.5, nrm + w, w)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    o = (tgt + w * rng.uniform(2.0, 4.0, (n, 1))).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return Ray.make(jnp.asarray(o), jnp.asarray(d))


def _kernel(geom, ray=None, sray=None):
    rows = [None if r is None else bt.pack_rays(r.o, r.d, r.mint, r.maxt)
            for r in (ray, sray)]
    return bt.brute_hits(geom.tri_packed, geom.shade_pack, *rows,
                         interpret=True)


@pytest.mark.parametrize("n_tris", [1, 12, 64])
@pytest.mark.parametrize("n_rays", [1, 127, 129, 1000])
def test_kernel_matches_plain(n_rays, n_tris):
    geom = build_geometry([(_mesh(n_tris, n_tris), 3, 1)], backend="brute")
    ray = _aimed_rays(geom, 2 * n_rays, n_rays)
    rng = np.random.default_rng(n_rays)
    sray = replace(_aimed_rays(geom, 2 * n_rays + 1, n_rays),
                   maxt=jnp.asarray(rng.uniform(0.5, 6.0, n_rays),
                                    jnp.float32))
    t0, u0, v0, p0, ok0 = (np.asarray(x) for x in _closest_brute(geom, ray))
    occ0 = np.asarray(_any_brute(geom, sray))
    rec_f, rec_i, occ = (np.asarray(x) for x in _kernel(geom, ray, sray))
    np.testing.assert_array_equal(rec_i[0] >= 0, ok0)
    np.testing.assert_array_equal(occ, occ0)
    hit = ok0
    np.testing.assert_array_equal(rec_i[0][hit], p0[hit])
    np.testing.assert_allclose(rec_f[0][hit], t0[hit], rtol=1e-4)
    np.testing.assert_allclose(rec_f[1][hit], u0[hit], atol=1e-4)
    np.testing.assert_allclose(rec_f[2][hit], v0[hit], atol=1e-4)

    # the Intersection record, against the one the plain path builds
    its0, _ = I._brute_plain(geom, ray, None)
    its1, _ = I._brute_kernel(geom, ray, None, interpret=True)
    for f in ("valid", "prim_id", "material_id", "emitter_id", "shape_id"):
        np.testing.assert_array_equal(np.asarray(getattr(its1, f)),
                                      np.asarray(getattr(its0, f)))
    # +inf on misses in both
    np.testing.assert_allclose(np.asarray(its1.t), np.asarray(its0.t),
                               rtol=1e-4)
    for f in ("p", "geo_n", "sh_n", "uv", "dp_du", "wi"):
        np.testing.assert_allclose(np.asarray(getattr(its1, f))[hit],
                                   np.asarray(getattr(its0, f))[hit],
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    if hit.any():
        assert (np.asarray(its1.material_id)[hit] == 3).all()


def test_pallas_respects_mint_maxt():
    from mitsuba_jax.render import mesh as mesh_mod

    box = mesh_mod.make_box([-1, -1, -1], [1, 1, 1])
    geom = build_geometry([(box, 0, -1)], backend="brute")
    o = jnp.zeros((3, 3))
    d = jnp.asarray([[1.0, 0, 0]] * 3)
    # wall at t = 1: skipped by mint 1.5, cut off by maxt 0.5, hit inside
    ray = Ray(o=o, d=d, mint=jnp.asarray([1.5, 1e-4, 1e-4]),
              maxt=jnp.asarray([jnp.inf, 0.5, 2.0]))
    _, rec_i, occ = _kernel(geom, ray, ray)
    assert np.asarray(rec_i[0] >= 0).tolist() == [False, False, True]
    assert np.asarray(occ).tolist() == [False, False, True]


def test_kernel_rejects_mismatched_ray_sets():
    from mitsuba_jax.render.scene import cornell_box

    geom = cornell_box(8, 8).geom
    ray = _aimed_rays(geom, 0, 64)
    sray = _aimed_rays(geom, 1, 32)
    with pytest.raises(ValueError, match="one shape"):
        _kernel(geom, ray, sray)


def test_kernel_dead_lanes_never_hit():
    """maxt = -1 marks a dead lane (the deferred-NEE carry's empty shadow
    ray): it neither hits nor occludes, and a tail block shorter than
    BLOCK leaves no lane unwritten."""
    from mitsuba_jax.render.scene import cornell_box

    geom = cornell_box(8, 8).geom
    n = bt.BLOCK + 3
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.uniform(50, 500, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    alive = np.arange(n) % 2 == 0
    ray = Ray.make(o, d, maxt=jnp.where(alive, jnp.inf, -1.0))
    rec_f, rec_i, occ = (np.asarray(x) for x in _kernel(geom, ray, ray))
    hit = rec_i[0] >= 0
    assert not hit[~alive].any() and not occ[~alive].any()
    assert np.isinf(rec_f[0][~alive]).all()
    _, _, _, p0, ok0 = _closest_brute(geom, ray)
    np.testing.assert_array_equal(hit, np.asarray(ok0))
    np.testing.assert_array_equal(rec_i[0][hit], np.asarray(p0)[hit])
    np.testing.assert_array_equal(occ, np.asarray(_any_brute(geom, ray)))
    assert hit[alive].mean() > 0.5


def test_kernel_gradient_matches_plain(monkeypatch):
    """d(render)/d(reflectance) through the kernel equals the plain path's:
    the kernel's inputs carry no tangent under the detached estimator."""
    from mitsuba_jax.integrators import PathConfig, render
    from mitsuba_jax.render.scene import cornell_box

    scene = cornell_box(8, 8)
    cfg = PathConfig(max_depth=2, spp=2, remat=True)

    def loss(refl):
        sc = replace(scene, materials=replace(scene.materials,
                                              reflectance=refl))
        return jnp.mean(render(sc, cfg, seed=1)[0])

    refl = scene.materials.reflectance
    g_plain = np.asarray(jax.grad(loss)(refl))
    monkeypatch.setattr(I, "_brute",
                        functools.partial(I._brute_kernel, interpret=True))
    g_kernel = np.asarray(jax.grad(loss)(refl))
    assert np.abs(g_plain).max() > 0
    np.testing.assert_allclose(g_kernel, g_plain, rtol=1e-4, atol=1e-7)


def _lowered(platform):
    geom = build_geometry([(_mesh(0, 8), 0, -1)], backend="brute")
    ray = _aimed_rays(geom, 0, 64)
    f = jax.jit(lambda g, r, s: I._brute(g, r, s))
    return f.trace(geom, ray, ray).lower(
        lowering_platforms=(platform,)).as_text()


def test_cpu_lowering_picks_plain():
    assert "triton" not in _lowered("cpu")


def test_cuda_lowering_emits_triton_kernel():
    """The kernel lowers to Triton IR for CUDA (no card needed to lower);
    what the GPU's compiler then makes of it shows only on the card."""
    txt = _lowered("cuda")
    assert "triton" in txt and "brute_hits" in txt


@pytest.mark.gpu
def test_compiled_kernel_matches_plain_on_gpu(gpu):
    """The compiled kernel against the plain path on the card, in a child
    process (this one is held to the CPU)."""
    code = """
import numpy as np, jax, jax.numpy as jnp
from mitsuba_jax.render import intersect as I
from mitsuba_jax.render import mesh as mesh_mod
from mitsuba_jax.render.records import Ray
from mitsuba_jax.render.scene import cornell_box
assert jax.devices()[0].platform == "gpu"
geom = cornell_box(8, 8).geom
rng = np.random.default_rng(0)
n = 65536
o = jnp.asarray(rng.uniform(50, 500, (n, 3)), jnp.float32)
d = rng.normal(size=(n, 3))
d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
ray = Ray.make(o, d)
a, oa = jax.jit(I._brute_plain)(geom, ray, ray)
b, ob = jax.jit(I._brute_kernel)(geom, ray, ray)
assert (np.asarray(a.valid) == np.asarray(b.valid)).mean() >= 0.9999
assert (np.asarray(oa) == np.asarray(ob)).mean() >= 0.9999
ok = np.asarray(a.valid & b.valid)
np.testing.assert_allclose(np.asarray(b.t)[ok], np.asarray(a.t)[ok],
                           rtol=1e-4)
"""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_NUM_CPU_DEVICES")}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
