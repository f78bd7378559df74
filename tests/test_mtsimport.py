"""mtsimport converter: OBJ and COLLADA -> XML + .serialized round trip
(reference src/converter/collada.cpp, obj.cpp)."""
import os

import numpy as np

from mitsuba_jax.io import meshio
from mitsuba_jax.io.xml import load_scene
from mitsuba_jax.render import mesh as mesh_mod
from mitsuba_jax.utils.mtsimport import convert, load_collada

DAE = """<?xml version="1.0"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
 <library_geometries>
  <geometry id="box" name="box">
   <mesh>
    <source id="pos"><float_array id="pa" count="12">
      0 0 0  1 0 0  1 1 0  0 1 0</float_array></source>
    <vertices id="verts"><input semantic="POSITION" source="#pos"/></vertices>
    <triangles count="2">
     <input semantic="VERTEX" source="#verts" offset="0"/>
     <p>0 1 2 0 2 3</p>
    </triangles>
   </mesh>
  </geometry>
 </library_geometries>
</COLLADA>
"""

# node hierarchy + material + per-corner normals/uvs (collada.cpp features)
DAE_FULL = """<?xml version="1.0"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
 <asset><unit meter="0.01"/><up_axis>Y_UP</up_axis></asset>
 <library_images>
  <image id="img0"><init_from>checker.png</init_from></image>
 </library_images>
 <library_effects>
  <effect id="fx_red"><profile_COMMON><technique sid="t">
   <lambert><diffuse><color>0.8 0.1 0.1 1</color></diffuse></lambert>
  </technique></profile_COMMON></effect>
 </library_effects>
 <library_materials>
  <material id="mat_red"><instance_effect url="#fx_red"/></material>
 </library_materials>
 <library_geometries>
  <geometry id="quad" name="quad">
   <mesh>
    <source id="pos"><float_array id="pa" count="12">
      0 0 0  1 0 0  1 1 0  0 1 0</float_array>
     <technique_common><accessor source="#pa" count="4" stride="3"/></technique_common>
    </source>
    <source id="nrm"><float_array id="na" count="3">0 0 1</float_array>
     <technique_common><accessor source="#na" count="1" stride="3"/></technique_common>
    </source>
    <source id="uv"><float_array id="ua" count="8">
      0 0  1 0  1 1  0 1</float_array>
     <technique_common><accessor source="#ua" count="4" stride="2"/></technique_common>
    </source>
    <vertices id="verts"><input semantic="POSITION" source="#pos"/></vertices>
    <triangles count="2" material="m0">
     <input semantic="VERTEX" source="#verts" offset="0"/>
     <input semantic="NORMAL" source="#nrm" offset="1"/>
     <input semantic="TEXCOORD" source="#uv" offset="2"/>
     <p>0 0 0 1 0 1 2 0 2 0 0 0 2 0 2 3 0 3</p>
    </triangles>
   </mesh>
  </geometry>
 </library_geometries>
 <library_visual_scenes>
  <visual_scene id="vs">
   <node id="root">
    <translate>10 0 0</translate>
    <node id="child">
     <scale>2 2 2</scale>
     <instance_geometry url="#quad">
      <bind_material><technique_common>
       <instance_material symbol="m0" target="#mat_red"/>
      </technique_common></bind_material>
     </instance_geometry>
    </node>
   </node>
  </visual_scene>
 </library_visual_scenes>
</COLLADA>
"""


def test_collada_minimal(tmp_path):
    p = str(tmp_path / "m.dae")
    with open(p, "w") as f:
        f.write(DAE)
    meshes = load_collada(p)
    assert len(meshes) == 1
    name, m, mat = meshes[0]
    # corners are expanded per (pos, normal, uv) index tuple
    assert m.faces.shape == (2, 3)
    assert m.vertices.shape[0] == 6
    assert mat == {}


def test_collada_hierarchy_materials_uv(tmp_path):
    p = str(tmp_path / "full.dae")
    with open(p, "w") as f:
        f.write(DAE_FULL)
    meshes = load_collada(p)
    assert len(meshes) == 1
    name, m, mat = meshes[0]
    assert mat["diffuse"] == (0.8, 0.1, 0.1)
    # transform chain: unit 0.01 * (translate 10 then scale 2)
    # corner (1,1,0) -> ((10,0,0) + 2*(1,1,0)) * 0.01 = (0.12, 0.02, 0)
    v = np.asarray(m.vertices)
    np.testing.assert_allclose(v.max(0), [0.12, 0.02, 0.0], atol=1e-6)
    np.testing.assert_allclose(v.min(0), [0.10, 0.0, 0.0], atol=1e-6)
    # normals rotated (identity here) + uvs carried per corner
    assert m.normals is not None and m.uvs is not None
    np.testing.assert_allclose(np.abs(np.asarray(m.normals)[:, 2]), 1.0,
                               atol=1e-5)
    assert set(map(tuple, np.asarray(m.uvs))) == {
        (0, 0), (1, 0), (1, 1), (0, 1)}


def test_collada_zup(tmp_path):
    dae = DAE_FULL.replace("Y_UP", "Z_UP")
    p = str(tmp_path / "z.dae")
    with open(p, "w") as f:
        f.write(dae)
    name, m, mat = load_collada(p)[0]
    # Z-up source: the quad's +z normal maps to the renderer's +y
    nz = np.asarray(m.normals)
    np.testing.assert_allclose(np.abs(nz[:, 1]), 1.0, atol=1e-5)


def test_convert_dae_to_scene(tmp_path):
    p = str(tmp_path / "full.dae")
    with open(p, "w") as f:
        f.write(DAE_FULL)
    out = str(tmp_path / "conv")
    xml = convert(p, out, quiet=True)
    with open(xml) as f:
        txt = f.read()
    assert "0.8 0.1 0.1" in txt          # material carried into the XML
    scene, cfg = load_scene(xml, backend="bvh")
    assert scene.geom.n_tris == 2


def test_convert_obj_and_render(tmp_path):
    obj = str(tmp_path / "s.obj")
    meshio.save_obj(obj, mesh_mod.make_sphere_mesh([0, 0, 3], 1.0, 12, 24))
    out = str(tmp_path / "converted")
    xml = convert(obj, out, quiet=True)
    assert os.path.exists(os.path.join(out, "meshes.serialized"))
    scene, cfg = load_scene(xml, backend="bvh")
    assert scene.geom.n_tris > 100
    assert cfg["integrator"] == "path"
