"""Hair tubes, height-span maps, instancing."""
import numpy as np
import pytest

from mitsuba_jax.io.hairio import load_hair, load_hspan, tessellate_fiber
from mitsuba_jax.io.xml import load_scene_string


def test_hair_tube(tmp_path):
    p = str(tmp_path / "strand.hair")
    with open(p, "w") as f:
        f.write("0 0 0\n0 1 0\n0.3 2 0\n\n1 0 0\n1 1 0.2\n")
    mesh = load_hair(p, radius=0.1, n_sides=6)
    assert mesh.n_faces == (2 + 1) * 6 * 2  # (2+1) segments x 6 sides x 2 tris
    # vertices lie within radius of the polylines
    assert np.isfinite(mesh.vertices).all()
    assert mesh.normals is not None


def test_fiber_frames_continuous():
    pts = np.stack([np.zeros(20), np.linspace(0, 5, 20),
                    np.sin(np.linspace(0, 3, 20))], -1)
    mesh = tessellate_fiber(pts, 0.05, 8)
    # tube radius respected
    assert np.isfinite(mesh.vertices).all()
    assert mesh.n_faces == 19 * 8 * 2


def test_hspan_v2(tmp_path):
    p = str(tmp_path / "snow.hspans2")
    lines = []
    for x in range(4):
        for y in range(4):
            h = 1.0 + 0.1 * (x + y)
            lines.append(f"{x} {y} 0.0 {h} 1 0 1 0 1 0 1 0")
    with open(p, "w") as f:
        f.write("\n".join(lines))
    mesh = load_hspan(p)
    assert mesh.n_faces == 3 * 3 * 2
    # heights increase along +x/+y
    assert mesh.vertices[:, 1].max() > mesh.vertices[:, 1].min()


def test_instance_flattening():
    scene, _ = load_scene_string("""
<scene>
 <shape type="shapegroup" id="grp">
   <shape type="sphere"><float name="radius" value="0.5"/>
     <bsdf type="lambertian"/></shape>
 </shape>
 <shape type="instance"><ref id="grp"/>
   <transform name="toWorld"><translate x="2"/></transform></shape>
 <shape type="instance"><ref id="grp"/>
   <transform name="toWorld"><translate x="-2"/></transform></shape>
</scene>""")
    # spheres are analytic primitives now — instances place two of them
    assert scene.geom.n_spheres == 2
    cx = np.asarray(scene.geom.sph_c)[:, 0]
    assert cx.max() > 1.9 and cx.min() < -1.9


def _rand_fibers_file(path, n_fibers=12, n_pts=8, seed=3):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n_fibers):
        start = rng.uniform(-1, 1, 3)
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        pts = start[None] + np.outer(np.linspace(0, 1.5, n_pts), d) \
            + rng.normal(scale=0.05, size=(n_pts, 3)).cumsum(0)
        lines.extend(" ".join(f"{x:.6f}" for x in p) for p in pts)
        lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def test_hair_segment_walk_matches_brute(tmp_path):
    """Segment-BVH walk vs brute-force min over all segments
    (reference hair.cpp:173 per-segment cylinder tests)."""
    import jax
    import jax.numpy as jnp

    from mitsuba_jax.io.hairio import load_hair_segments
    from mitsuba_jax.render.intersect import (
        GeometryTables, _cyl_seg_hit, _hair_walk, _pack_hair,
        build_geometry)
    from mitsuba_jax.render.mesh import make_quad
    from mitsuba_jax.render.records import Ray

    p = str(tmp_path / "f.hair")
    _rand_fibers_file(p)
    seg = load_hair_segments(p, radius=0.04)
    h = seg["a"].shape[0]
    seg["mid"] = np.zeros(h, np.int32)
    seg["eid"] = np.full(h, -1, np.int32)
    seg["sid"] = np.ones(h, np.int32)
    quad = make_quad((-9, -9, -5), (9, -9, -5), (9, 9, -5), (-9, 9, -5))
    geom = build_geometry([(quad, 0, -1)], backend="bvh", hair=seg)
    assert geom.n_hair == h

    rng = np.random.default_rng(0)
    n = 2048
    o = jnp.asarray(rng.uniform(-3, 3, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True),
                    jnp.float32)
    ray = Ray.make(o, d)
    t, frac, prim, valid = jax.jit(
        lambda g, r: _hair_walk(g, r, False))(geom, ray)

    # brute oracle over the PACKED segment order
    rows = geom.hair_segs
    tb = jnp.full(n, jnp.inf)
    pb = jnp.zeros(n, jnp.int32)
    for s in range(h):
        row = jnp.broadcast_to(rows[s], (n, 16))
        ts, _f, ok = _cyl_seg_hit(ray.o, ray.d, row, ray.mint, tb)
        closer = ok & (ts < tb)
        tb = jnp.where(closer, ts, tb)
        pb = jnp.where(closer, s, pb)
    vb = jnp.isfinite(tb)
    assert bool(jnp.all(valid == vb))
    assert np.allclose(np.where(valid, t, 0.0), np.where(vb, tb, 0.0),
                       rtol=1e-4, atol=1e-5)


def test_hair_analytic_matches_tessellated_render(tmp_path):
    """<shape type=hair> analytic segments vs tessellate=true tubes:
    same scene renders within a loose pixel tolerance (silhouettes are
    polygonized in the tessellated version, so means must agree)."""
    import jax.numpy as jnp

    from mitsuba_jax.integrators.path import PathConfig, render

    p = str(tmp_path / "f.hair")
    _rand_fibers_file(p, n_fibers=6)
    from mitsuba_jax.io.xml import load_scene_string

    base = """
<scene>
 <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
 <camera type="perspective">
   <float name="fov" value="40"/>
   <transform name="toWorld">
     <lookAt ox="0" oy="0" oz="8" tx="0" ty="0" tz="0" ux="0" uy="1" uz="0"/>
   </transform>
   <sampler type="independent"><integer name="sampleCount" value="4"/></sampler>
   <film type="pngfilm"><integer name="width" value="48"/>
     <integer name="height" value="48"/></film>
 </camera>
 <luminaire type="constant"><spectrum name="intensity" value="1.0"/></luminaire>
 <shape type="hair">
   <string name="filename" value="{path}"/>
   <float name="radius" value="0.08"/>
   {extra}
   <bsdf type="lambertian"><spectrum name="reflectance" value="0.7"/></bsdf>
 </shape>
</scene>"""
    s_a, _ = load_scene_string(base.format(path=p, extra=""))
    s_t, _ = load_scene_string(base.format(
        path=p, extra='<boolean name="tessellate" value="true"/>'))
    assert s_a.geom.n_hair > 0
    assert s_t.geom.n_hair == 0 and s_t.geom.n_tris > 100
    cfg = PathConfig(max_depth=3, spp=8)
    img_a, _ = render(s_a, cfg, seed=0)
    img_t, _ = render(s_t, cfg, seed=0)
    ma = float(jnp.mean(img_a))
    mt = float(jnp.mean(img_t))
    assert np.isfinite(ma) and np.isfinite(mt)
    # tubes circumscribe; images agree to a few percent in the mean
    assert abs(ma - mt) / max(mt, 1e-6) < 0.08
