"""XML scene loader tests: tag semantics vs the reference SceneHandler
(src/librender/scenehandler.cpp), file-format round trips, and a full
Cornell-box load-and-render cross-check against the programmatic scene."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

import mitsuba_jax.render.camera  # register camera plugins
import mitsuba_jax.render.sampler  # register sampler plugins
from mitsuba_jax.core import transform as tf
from mitsuba_jax.integrators import PathConfig, render
from mitsuba_jax.io import meshio
from mitsuba_jax.io.xml import load_scene, load_scene_string
from mitsuba_jax.render import mesh as mesh_mod
from mitsuba_jax.render.scene import cornell_box

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_props_and_refs():
    scene, cfg = load_scene_string(
        """
<scene>
 <integrator type="path"><integer name="maxDepth" value="7"/></integrator>
 <camera type="perspective">
  <float name="fov" value="45"/>
  <transform name="toWorld">
    <translate x="1" y="2" z="3"/>
  </transform>
  <sampler type="stratified"><integer name="sampleCount" value="9"/></sampler>
  <film type="pngfilm">
    <integer name="width" value="32"/><integer name="height" value="16"/>
  </film>
 </camera>
 <bsdf id="m" type="lambertian"><rgb name="reflectance" value="#ff0000"/></bsdf>
 <shape type="sphere">
   <point name="center" x="0" y="0" z="5"/>
   <float name="radius" value="1"/>
   <ref id="m"/>
 </shape>
</scene>"""
    )
    assert cfg["maxDepth"] == 7
    assert cfg["sampleCount"] == 9
    assert cfg["pattern"] == "stratified"
    assert (cfg["width"], cfg["height"]) == (32, 16)
    np.testing.assert_allclose(
        np.asarray(scene.camera.to_world)[:3, 3], [1, 2, 3], atol=1e-6
    )
    # hex red
    np.testing.assert_allclose(
        np.asarray(scene.materials.reflectance)[0], [1, 0, 0], atol=1e-6
    )


def test_transform_composition_order():
    """Reference semantics: listed transforms apply in order
    (new * current), so <translate/><scale/> = scale AFTER translate."""
    scene, _ = load_scene_string(
        """
<scene>
 <camera type="perspective">
  <transform name="toWorld"><translate x="1"/><scale value="2"/></transform>
  <film type="exrfilm"><integer name="width" value="8"/><integer name="height" value="8"/></film>
 </camera>
 <shape type="sphere"><float name="radius" value="1"/>
  <bsdf type="lambertian"/></shape>
</scene>"""
    )
    m = np.asarray(scene.camera.to_world)
    # scale(2) @ translate(1,0,0) applied to origin -> (2,0,0)
    np.testing.assert_allclose(m[:3, 3], [2, 0, 0], atol=1e-6)


def test_variable_substitution():
    scene, cfg = load_scene_string(
        """
<scene>
 <integrator type="path"><integer name="maxDepth" value="$d"/></integrator>
 <shape type="sphere"><float name="radius" value="$r"/>
  <bsdf type="lambertian"/></shape>
</scene>""",
        params={"d": 3, "r": 2.5},
    )
    assert cfg["maxDepth"] == 3


def test_undefined_variable_raises():
    with pytest.raises(Exception):
        load_scene_string(
            "<scene><integrator type='path'>"
            "<integer name='maxDepth' value='$nope'/></integrator>"
            "<shape type='sphere'><bsdf type='lambertian'/></shape></scene>"
        )


def test_bsdf_types_map():
    scene, _ = load_scene_string(
        """
<scene>
 <shape type="sphere"><bsdf type="dielectric">
   <float name="intIOR" value="1.33"/></bsdf></shape>
 <shape type="sphere"><bsdf type="roughmetal">
   <float name="alphaB" value="0.2"/></bsdf></shape>
 <shape type="sphere"><bsdf type="twosided">
   <bsdf type="lambertian"/></bsdf></shape>
</scene>"""
    )
    kinds = np.asarray(scene.materials.kind)
    from mitsuba_jax.bsdfs import DIELECTRIC, LAMBERTIAN, ROUGH_CONDUCTOR

    assert list(kinds) == [DIELECTRIC, ROUGH_CONDUCTOR, LAMBERTIAN]
    np.testing.assert_allclose(float(scene.materials.eta[0]), 1.33, atol=1e-5)
    assert bool(scene.materials.two_sided[2])


def test_obj_roundtrip(tmp_path):
    m = mesh_mod.make_sphere_mesh([1, 2, 3], 2.0, 8, 12)
    p = str(tmp_path / "s.obj")
    meshio.save_obj(p, m)
    m2 = meshio.load_obj(p)
    # loader re-welds vertices in face order: compare geometric invariants
    assert m2.faces.shape == m.faces.shape
    np.testing.assert_allclose(m2.face_areas().sum(), m.face_areas().sum(), rtol=1e-5)
    np.testing.assert_allclose(m2.vertices.min(0), m.vertices.min(0), atol=1e-5)
    np.testing.assert_allclose(m2.vertices.max(0), m.vertices.max(0), atol=1e-5)
    # shading normals survive: compare area-weighted normal sum per mesh
    np.testing.assert_allclose(
        (m2.face_normals() * m2.face_areas()[:, None]).sum(0),
        (m.face_normals() * m.face_areas()[:, None]).sum(0),
        atol=1e-4,
    )


def test_serialized_roundtrip(tmp_path):
    m = mesh_mod.make_box([0, 0, 0], [1, 2, 3])
    p = str(tmp_path / "m.serialized")
    meshio.save_serialized(p, m)
    m2 = meshio.load_serialized(p)
    np.testing.assert_allclose(m2.vertices, m.vertices, atol=1e-6)
    np.testing.assert_array_equal(m2.faces, m.faces)


def test_ply_ascii(tmp_path):
    ply = """ply
format ascii 1.0
element vertex 4
property float x
property float y
property float z
element face 2
property list uchar int vertex_indices
end_header
0 0 0
1 0 0
1 1 0
0 1 0
3 0 1 2
3 0 2 3
"""
    p = str(tmp_path / "q.ply")
    with open(p, "w") as f:
        f.write(ply)
    m = meshio.load_ply(p)
    assert m.vertices.shape == (4, 3)
    assert m.faces.shape == (2, 3)


def test_reference_bunny_ply_loads():
    """The reference ships data/tests/bunny.ply — binary PLY."""
    bunny = "/root/reference/data/tests/bunny.ply"
    if not os.path.exists(bunny):
        pytest.skip("no reference bunny")
    m = meshio.load_ply(bunny)
    assert m.n_faces > 1000
    assert np.isfinite(m.vertices).all()


def test_cornell_xml_matches_programmatic():
    scene_x, cfg = load_scene(
        os.path.join(REPO, "scenes", "cornell.xml"),
        params={"depth": 4, "spp": 8, "width": 24, "height": 24},
    )
    assert cfg["maxDepth"] == 4 and cfg["sampleCount"] == 8
    scene_p = cornell_box(24, 24)
    rcfg = PathConfig(max_depth=4, spp=8, remat=False)
    img_x, _ = render(scene_x, rcfg, seed=0)
    img_p, _ = render(scene_p, rcfg, seed=0)
    ix, ip = np.asarray(img_x), np.asarray(img_p)
    # same geometry & materials; sampling sequences differ only through
    # material/lane ordering -> means must agree statistically
    assert abs(ix.mean() - ip.mean()) / ip.mean() < 0.05
    assert np.isfinite(ix).all()


def test_file_resolver(tmp_path, monkeypatch):
    """FileResolver parity (reference fresolver.h:40): search-path order,
    absolute pass-through, and MITSUBA_JAX_PATH pickup."""
    import os

    from mitsuba_jax.io import resolver as R

    d1 = tmp_path / "a"
    d2 = tmp_path / "b"
    d1.mkdir(); d2.mkdir()
    (d2 / "mesh.obj").write_text("o x\n")
    r = R.FileResolver([str(d1), str(d2)])
    assert r.resolve("mesh.obj") == str(d2 / "mesh.obj")
    (d1 / "mesh.obj").write_text("o y\n")
    assert r.resolve("mesh.obj") == str(d1 / "mesh.obj")  # order matters
    assert r.resolve("absent.obj") == "absent.obj"        # fallback
    absp = str(d2 / "mesh.obj")
    assert r.resolve(absp) == absp                        # absolute untouched
    r2 = r.clone(); r2.prepend(str(d2))
    assert r2.resolve("mesh.obj") == str(d2 / "mesh.obj")
    assert r.paths[0] == str(d1)                          # clone is detached
    # env search path feeds the default resolver
    monkeypatch.setenv("MITSUBA_JAX_PATH", str(d2))
    R._default = None
    assert R.default_resolver().resolve("mesh.obj") == str(d2 / "mesh.obj")
    R._default = None


def test_xml_mesh_found_via_search_path(tmp_path, monkeypatch):
    """A scene whose meshes are NOT next to the XML still loads when the
    mesh dir is on MITSUBA_JAX_PATH."""
    import os
    import shutil

    from mitsuba_jax.io import resolver as R
    from mitsuba_jax.io.xml import load_scene_string

    meshdir = tmp_path / "assets"
    meshdir.mkdir()
    src = os.path.join(os.path.dirname(__file__), "..", "scenes", "meshes",
                       "cbox_walls.obj")
    shutil.copy(src, meshdir / "walls.obj")
    monkeypatch.setenv("MITSUBA_JAX_PATH", str(meshdir))
    R._default = None
    xml = """<scene>
      <camera type="perspective">
        <transform name="toWorld">
          <lookAt ox="0" oy="1" oz="4" tx="0" ty="1" tz="0" ux="0" uy="1" uz="0"/>
        </transform>
        <film type="exrfilm">
          <integer name="width" value="4"/><integer name="height" value="4"/>
        </film>
      </camera>
      <shape type="obj">
        <string name="filename" value="walls.obj"/>
        <bsdf type="lambertian"/>
      </shape>
    </scene>"""
    scene, cfg = load_scene_string(xml, base_dir=str(tmp_path))
    assert scene.geom.v0.shape[0] > 0
    R._default = None


def test_snow_showcase_scene():
    """scenes/snow.xml: the fork's research stack (wiscombe snow BRDF +
    Preetham sky + analytic spheres) loads and renders through the
    public XML path."""
    import numpy as np

    from mitsuba_jax.integrators import PathConfig, render
    from mitsuba_jax.io.xml import load_scene

    scene, cfg = load_scene(
        os.path.join(os.path.dirname(__file__), "..", "scenes", "snow.xml"),
        params=dict(depth=3, spp=2, width=32, height=24))
    img, _ = render(scene, PathConfig(max_depth=3, spp=2))
    img = np.asarray(img)
    assert np.isfinite(img).all()
    # snow field (bottom rows) must read brighter than the sky's blue
    # channel dominance — i.e. scene is lit and the BRDF reflects
    assert img[-6:].mean() > 0.3
