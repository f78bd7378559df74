"""Scene importer — mtsimport parity.

Capability parity with the reference converter (src/converter/converter.h:23
GeometryConverter, collada.cpp, obj.cpp): converts OBJ and COLLADA (.dae)
inputs into a mitsuba-format XML scene plus compressed `.serialized` meshes
(io/meshio.py writes the same zlib container the reference reads).

COLLADA coverage (mirrors collada.cpp's converter passes):
  * asset unit scale + up-axis handling (Y_UP / Z_UP);
  * library_effects/materials: common-profile diffuse color or texture
    (library_images resolves texture file paths);
  * mesh primitives (<triangles>/<polylist>) with per-corner POSITION /
    NORMAL / TEXCOORD indexing (vertices are expanded per unique corner
    tuple, the same un-indexing the reference performs);
  * library_visual_scenes node hierarchy: <matrix>, <translate>,
    <rotate>, <scale> accumulated down the tree, instance_geometry with
    bind_material (collada.cpp loadNode/instance handling).

    python -m mitsuba_jax.utils.mtsimport input.{obj,dae} out_dir/
"""
from __future__ import annotations

import os
import sys
import xml.etree.ElementTree as ET

import numpy as np

from mitsuba_jax.io import meshio
from mitsuba_jax.render.mesh import TriMesh

_NS = "{http://www.collada.org/2005/11/COLLADASchema}"


def _tag(el):
    return el.tag.split("}")[-1]


def _floats(text):
    return np.fromiter((float(x) for x in text.split()), np.float64)


def _ints(text):
    return np.fromiter((int(x) for x in text.split()), np.int64)


def _parse_sources(mesh_el):
    sources = {}
    for src in mesh_el.findall(f"{_NS}source"):
        arr = src.find(f"{_NS}float_array")
        acc = src.find(f"{_NS}technique_common/{_NS}accessor")
        if arr is None or not arr.text:
            continue
        data = _floats(arr.text)
        stride = int(acc.get("stride", 3)) if acc is not None else 3
        sources["#" + src.get("id")] = data.reshape(-1, stride)
    return sources


def _node_transform(node):
    """Accumulate a node's own transform elements in document order
    (collada.cpp applies them sequentially)."""
    m = np.eye(4)
    for el in node:
        t = _tag(el)
        if t == "matrix":
            m = m @ _floats(el.text).reshape(4, 4)
        elif t == "translate":
            v = _floats(el.text)
            tm = np.eye(4)
            tm[:3, 3] = v[:3]
            m = m @ tm
        elif t == "scale":
            v = _floats(el.text)
            m = m @ np.diag([v[0], v[1], v[2], 1.0])
        elif t == "rotate":
            v = _floats(el.text)
            ax = v[:3] / max(np.linalg.norm(v[:3]), 1e-12)
            a = np.deg2rad(v[3])
            c, s = np.cos(a), np.sin(a)
            x, y, z = ax
            r = np.array([
                [c + x * x * (1 - c), x * y * (1 - c) - z * s,
                 x * z * (1 - c) + y * s],
                [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                 y * z * (1 - c) - x * s],
                [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                 c + z * z * (1 - c)],
            ])
            rm = np.eye(4)
            rm[:3, :3] = r
            m = m @ rm
    return m


def _parse_effects(root):
    """effect id -> dict(diffuse=(r,g,b) | texture=image_id)."""
    images = {}
    for img in root.iter(f"{_NS}image"):
        init = img.find(f"{_NS}init_from")
        if init is not None and init.text:
            images[img.get("id")] = init.text.strip()
    effects = {}
    for eff in root.iter(f"{_NS}effect"):
        d = {}
        for dif in eff.iter(f"{_NS}diffuse"):
            col = dif.find(f"{_NS}color")
            tex = dif.find(f"{_NS}texture")
            if col is not None and col.text:
                d["diffuse"] = tuple(_floats(col.text)[:3])
            elif tex is not None:
                # texture attr references a sampler/surface param chain or
                # an image id directly; resolve through newparams
                ref = tex.get("texture")
                img = images.get(ref)
                if img is None:
                    for np_el in eff.iter(f"{_NS}newparam"):
                        if np_el.get("sid") == ref:
                            src = np_el.find(f"{_NS}sampler2D/{_NS}source")
                            if src is not None:
                                for np2 in eff.iter(f"{_NS}newparam"):
                                    if np2.get("sid") == src.text:
                                        s2 = np2.find(
                                            f"{_NS}surface/{_NS}init_from")
                                        if s2 is not None:
                                            img = images.get(s2.text)
                d["texture"] = img
        effects[eff.get("id")] = d
    materials = {}
    for mat in root.iter(f"{_NS}material"):
        inst = mat.find(f"{_NS}instance_effect")
        if inst is not None:
            materials[mat.get("id")] = effects.get(
                inst.get("url", "").lstrip("#"), {})
    return materials


def _parse_geometries(root):
    """geometry id -> list of (material_symbol, TriMesh) with per-corner
    position/normal/uv expansion."""
    geoms = {}
    for geom in root.iter(f"{_NS}geometry"):
        gid = geom.get("id")
        name = geom.get("name") or gid or "mesh"
        mesh_el = geom.find(f"{_NS}mesh")
        if mesh_el is None:
            continue
        sources = _parse_sources(mesh_el)
        vert_map = {}
        for v in mesh_el.findall(f"{_NS}vertices"):
            for inp in v.findall(f"{_NS}input"):
                if inp.get("semantic") == "POSITION":
                    vert_map["#" + v.get("id")] = inp.get("source")
        prims = []
        for prim in (list(mesh_el.findall(f"{_NS}triangles"))
                     + list(mesh_el.findall(f"{_NS}polylist"))):
            inputs = prim.findall(f"{_NS}input")
            if not inputs:
                continue
            stride = max(int(i.get("offset", 0)) for i in inputs) + 1
            chans = {}
            for inp in inputs:
                sem = inp.get("semantic")
                src = inp.get("source")
                if sem == "VERTEX":
                    sem, src = "POSITION", vert_map.get(src, src)
                if src in sources:
                    chans[sem] = (int(inp.get("offset", 0)), sources[src])
            if "POSITION" not in chans:
                continue
            p_el = prim.find(f"{_NS}p")
            if p_el is None or not p_el.text:
                continue
            idx = _ints(p_el.text)
            vcount_el = prim.find(f"{_NS}vcount")
            if vcount_el is not None:
                vcounts = _ints(vcount_el.text)
            else:
                vcounts = np.full(len(idx) // (3 * stride), 3, np.int64)
            # expand corners: fan-triangulate each polygon
            corners = []          # rows of per-channel indices
            cursor = 0
            for vc in vcounts:
                base = [idx[cursor + k * stride: cursor + k * stride
                            + stride] for k in range(vc)]
                for k in range(1, vc - 1):
                    corners.extend([base[0], base[k], base[k + 1]])
                cursor += vc * stride
            corners = np.asarray(corners)        # (3T, stride)
            n_c = corners.shape[0]
            pos_off, pos_src = chans["POSITION"]
            verts = pos_src[corners[:, pos_off]][:, :3].astype(np.float32)
            faces = np.arange(n_c, dtype=np.int32).reshape(-1, 3)
            normals = None
            uvs = None
            if "NORMAL" in chans:
                off, src = chans["NORMAL"]
                normals = src[corners[:, off]][:, :3].astype(np.float32)
            if "TEXCOORD" in chans:
                off, src = chans["TEXCOORD"]
                uvs = src[corners[:, off]][:, :2].astype(np.float32)
            mesh = TriMesh(verts, faces, normals=normals, uvs=uvs,
                           name=name)
            if normals is None:
                mesh.compute_vertex_normals()
            prims.append((prim.get("material"), mesh))
        geoms[gid] = prims
    return geoms


def load_collada(path: str):
    """COLLADA reader. Returns [(name, TriMesh, material_dict)] with
    node transforms baked into vertices (mirrors the reference
    converter's world-space export, collada.cpp loadNode)."""
    root = ET.parse(path).getroot()
    # unit + up axis
    scale = 1.0
    up = "Y_UP"
    asset = root.find(f"{_NS}asset")
    if asset is not None:
        unit = asset.find(f"{_NS}unit")
        if unit is not None:
            scale = float(unit.get("meter", 1.0))
        upel = asset.find(f"{_NS}up_axis")
        if upel is not None and upel.text:
            up = upel.text.strip()
    world = np.eye(4) * scale
    world[3, 3] = 1.0
    if up == "Z_UP":
        # rotate Z-up to the renderer's Y-up convention
        rot = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0],
                        [0, 0, 0, 1]], np.float64)
        world = world @ rot

    materials = _parse_effects(root)
    geoms = _parse_geometries(root)

    out = []

    def walk(node, xf, bindings):
        xf = xf @ _node_transform(node)
        binds = dict(bindings)
        for inst in node.findall(f"{_NS}instance_geometry"):
            for im in inst.iter(f"{_NS}instance_material"):
                binds[im.get("symbol")] = im.get("target", "").lstrip("#")
            gid = inst.get("url", "").lstrip("#")
            for sym, mesh in geoms.get(gid, []):
                mat = materials.get(binds.get(sym, ""), {})
                out.append((mesh.name, mesh.transformed(xf), mat))
        for child in node.findall(f"{_NS}node"):
            walk(child, xf, binds)

    scenes = root.find(f"{_NS}library_visual_scenes")
    if scenes is not None:
        for vs in scenes.findall(f"{_NS}visual_scene"):
            for node in vs.findall(f"{_NS}node"):
                walk(node, world, {})
    if not out:
        # no scene graph: flat geometry dump
        for gid, prims in geoms.items():
            for sym, mesh in prims:
                out.append((mesh.name, mesh.transformed(world), {}))
    return out


def convert(input_path: str, out_dir: str, quiet: bool = False) -> str:
    """Convert an OBJ/DAE file into out_dir/{scene.xml, meshes.serialized}.
    Returns the XML path."""
    os.makedirs(out_dir, exist_ok=True)
    ext = os.path.splitext(input_path)[1].lower()
    if ext == ".obj":
        meshes = [(os.path.basename(input_path), meshio.load_obj(input_path),
                   {})]
    elif ext == ".dae":
        meshes = load_collada(input_path)
    else:
        raise ValueError(f"unsupported input format: {input_path}")
    if not meshes:
        raise ValueError(f"{input_path}: no geometry found")

    ser_path = os.path.join(out_dir, "meshes.serialized")
    meshio.save_serialized(ser_path, [m for _, m, _ in meshes])

    scene = ET.Element("scene")
    integ = ET.SubElement(scene, "integrator", type="path")
    ET.SubElement(integ, "integer", name="maxDepth", value="5")
    cam = ET.SubElement(scene, "camera", type="perspective")
    ET.SubElement(cam, "float", name="fov", value="45")
    samp = ET.SubElement(cam, "sampler", type="independent")
    ET.SubElement(samp, "integer", name="sampleCount", value="16")
    film = ET.SubElement(cam, "film", type="exrfilm")
    ET.SubElement(film, "integer", name="width", value="512")
    ET.SubElement(film, "integer", name="height", value="512")
    for i, (name, _, mat) in enumerate(meshes):
        shape = ET.SubElement(scene, "shape", type="serialized")
        ET.SubElement(shape, "string", name="filename",
                      value="meshes.serialized")
        ET.SubElement(shape, "integer", name="shapeIndex", value=str(i))
        bsdf = ET.SubElement(shape, "bsdf", type="lambertian")
        if mat.get("texture"):
            tex = ET.SubElement(bsdf, "texture", name="reflectance",
                                type="ldrtexture")
            ET.SubElement(tex, "string", name="filename",
                          value=mat["texture"])
        else:
            rgb = mat.get("diffuse", (0.5, 0.5, 0.5))
            ET.SubElement(bsdf, "rgb", name="reflectance",
                          value=f"{rgb[0]} {rgb[1]} {rgb[2]}")
    lum = ET.SubElement(scene, "luminaire", type="constant")
    ET.SubElement(lum, "rgb", name="intensity", value="1 1 1")

    xml_path = os.path.join(out_dir, "scene.xml")
    ET.indent(ET.ElementTree(scene))
    ET.ElementTree(scene).write(xml_path, encoding="unicode")
    if not quiet:
        print(f"wrote {xml_path} + {ser_path} ({len(meshes)} mesh(es))")
    return xml_path


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("usage: python -m mitsuba_jax.utils.mtsimport input.{obj,dae} out_dir/")
        return 1
    convert(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
