"""Mesh file loaders: Wavefront OBJ, Stanford PLY, Mitsuba .serialized.

Capability parity with the reference shape plugins
(src/shapes/obj.cpp, src/shapes/ply.cpp + src/shapes/ply/*,
src/shapes/serialized.cpp — zlib-compressed TriMesh dumps produced by
mtsimport, format written in src/librender/trimesh.cpp:serialize).
Pure-numpy implementations; no external deps.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from mitsuba_jax.render.mesh import TriMesh


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------

def load_obj(path: str, name: str | None = None) -> TriMesh:
    """Wavefront OBJ with v/vn/vt + polygonal faces (fan-triangulated).

    Per-corner normals/uvs are welded per (v,vt,vn) tuple like the
    reference's OBJ vertex deduplication (obj.cpp).
    """
    positions, normals, uvs = [], [], []
    vert_map = {}
    out_v, out_n, out_uv, faces = [], [], [], []

    def corner(spec: str) -> int:
        if spec in vert_map:
            return vert_map[spec]
        parts = (spec.split("/") + ["", ""])[:3]
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = None
        if parts[1]:
            t = int(parts[1])
            ti = t - 1 if t > 0 else len(uvs) + t
        ni = None
        if parts[2]:
            nn = int(parts[2])
            ni = nn - 1 if nn > 0 else len(normals) + nn
        idx = len(out_v)
        out_v.append(positions[vi])
        out_uv.append(uvs[ti] if ti is not None else (0.0, 0.0))
        out_n.append(normals[ni] if ni is not None else None)
        vert_map[spec] = idx
        return idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] in "#\n":
                continue
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                positions.append(tuple(float(x) for x in tok[1:4]))
            elif tok[0] == "vn":
                normals.append(tuple(float(x) for x in tok[1:4]))
            elif tok[0] == "vt":
                uvs.append(tuple(float(x) for x in tok[1:3]))
            elif tok[0] == "f":
                idx = [corner(s) for s in tok[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))

    v = np.asarray(out_v, np.float32)
    f_arr = np.asarray(faces, np.int32)
    has_n = all(n is not None for n in out_n) and len(out_n) > 0
    mesh = TriMesh(
        v, f_arr,
        normals=np.asarray(out_n, np.float32) if has_n else None,
        uvs=np.asarray(out_uv, np.float32),
        name=name or path,
    )
    if mesh.normals is None:
        mesh.compute_vertex_normals()
    return mesh


# ---------------------------------------------------------------------------
# PLY (ascii + binary little/big endian)
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str, name: str | None = None) -> TriMesh:
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype, is_list, count_dtype)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tok = line.decode("ascii", "replace").split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    elements[-1][2].append((tok[4], _PLY_TYPES[tok[3]], True, _PLY_TYPES[tok[2]]))
                else:
                    elements[-1][2].append((tok[2], _PLY_TYPES[tok[1]], False, None))
            elif tok[0] == "end_header":
                break

        verts = normals = uvs = None
        faces = []
        if fmt == "ascii":
            for ename, count, props in elements:
                rows = []
                for _ in range(count):
                    rows.append(f.readline().split())
                if ename == "vertex":
                    names = [p[0] for p in props]
                    arr = np.asarray(rows, np.float64)
                    def col(nm):
                        return arr[:, names.index(nm)] if nm in names else None
                    verts = np.stack([col("x"), col("y"), col("z")], -1)
                    if "nx" in names:
                        normals = np.stack([col("nx"), col("ny"), col("nz")], -1)
                    if "u" in names:
                        uvs = np.stack([col("u"), col("v")], -1)
                    elif "s" in names:
                        uvs = np.stack([col("s"), col("t")], -1)
                elif ename == "face":
                    for r in rows:
                        n = int(r[0])
                        idx = [int(x) for x in r[1 : 1 + n]]
                        for k in range(1, n - 1):
                            faces.append((idx[0], idx[k], idx[k + 1]))
        else:
            endian = "<" if "little" in fmt else ">"
            for ename, count, props in elements:
                if ename == "vertex" and not any(p[2] for p in props):
                    dt = np.dtype([(p[0], endian + p[1]) for p in props])
                    data = np.frombuffer(f.read(dt.itemsize * count), dt)
                    verts = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float64)
                    nm = data.dtype.names
                    if "nx" in nm:
                        normals = np.stack([data["nx"], data["ny"], data["nz"]], -1)
                    if "u" in nm:
                        uvs = np.stack([data["u"], data["v"]], -1)
                    elif "s" in nm:
                        uvs = np.stack([data["s"], data["t"]], -1)
                else:
                    # element with list property: parse per row
                    for _ in range(count):
                        out = {}
                        for pname, dtype, is_list, cnt_dtype in props:
                            if is_list:
                                cdt = np.dtype(endian + cnt_dtype)
                                n = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
                                idt = np.dtype(endian + dtype)
                                vals = np.frombuffer(f.read(idt.itemsize * n), idt)
                                out[pname] = vals
                            else:
                                idt = np.dtype(endian + dtype)
                                out[pname] = np.frombuffer(f.read(idt.itemsize), idt)[0]
                        if ename == "face":
                            key = "vertex_indices" if "vertex_indices" in out else (
                                "vertex_index" if "vertex_index" in out else list(out)[0]
                            )
                            idx = out[key]
                            for k in range(1, len(idx) - 1):
                                faces.append((int(idx[0]), int(idx[k]), int(idx[k + 1])))
    mesh = TriMesh(
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
        normals=np.asarray(normals, np.float32) if normals is not None else None,
        uvs=np.asarray(uvs, np.float32) if uvs is not None else None,
        name=name or path,
    )
    if mesh.normals is None:
        mesh.compute_vertex_normals()
    return mesh


# ---------------------------------------------------------------------------
# Mitsuba .serialized (reference src/librender/trimesh.cpp serialize format,
# written by mtsimport: zlib streams, one per shape index)
# ---------------------------------------------------------------------------

MTS_FILEFORMAT_HEADER = 0x041C
MTS_V3 = 0x0003   # format version used by mitsuba 0.2.x

_FLAG_VNORMALS = 0x0001
_FLAG_UV = 0x0002
_FLAG_VCOLORS = 0x0008


def load_serialized(path: str, shape_index: int = 0, name: str | None = None) -> TriMesh:
    """Mitsuba `.serialized` mesh container.

    Layout per shape (reference trimesh.cpp TriMesh(Stream) + shape offsets
    at EOF): uint16 header magic, uint16 version, then a zlib stream of
    [uint32 flags][uint64 vertexCount][uint64 triangleCount][data...]
    with doubles (v3) or floats (v4) — the 0.2.x tree writes Float (single).
    """
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<HH", data, 0)
    if magic != MTS_FILEFORMAT_HEADER:
        raise ValueError(f"{path}: bad magic 0x{magic:04x}")
    # locate shape offsets: the file may contain multiple shapes; each starts
    # with the magic. For robustness scan for headers.
    starts = []
    off = 0
    while True:
        idx = data.find(struct.pack("<HH", magic, version), off)
        if idx < 0:
            break
        starts.append(idx)
        off = idx + 4
    if shape_index >= len(starts):
        raise IndexError(f"shape {shape_index} not in {path} ({len(starts)} shapes)")
    payload = data[starts[shape_index] + 4 :]
    raw = zlib.decompress(payload, zlib.MAX_WBITS)
    off = 0
    (flags,) = struct.unpack_from("<I", raw, off)
    off += 4
    vcount, tcount = struct.unpack_from("<QQ", raw, off)
    off += 16
    ftype = np.float64 if version <= MTS_V3 else np.float32
    fsize = np.dtype(ftype).itemsize

    def take(n, dtype, dsize):
        nonlocal off
        arr = np.frombuffer(raw, dtype, count=n, offset=off)
        off += n * dsize
        return arr

    v = take(3 * vcount, ftype, fsize).reshape(-1, 3)
    normals = None
    if flags & _FLAG_VNORMALS:
        normals = take(3 * vcount, ftype, fsize).reshape(-1, 3)
    uvs = None
    if flags & _FLAG_UV:
        uvs = take(2 * vcount, ftype, fsize).reshape(-1, 2)
    if flags & _FLAG_VCOLORS:
        take(3 * vcount, ftype, fsize)
    faces = take(3 * tcount, np.uint32, 4).reshape(-1, 3)
    mesh = TriMesh(
        np.asarray(v, np.float32),
        np.asarray(faces, np.int32),
        normals=np.asarray(normals, np.float32) if normals is not None else None,
        uvs=np.asarray(uvs, np.float32) if uvs is not None else None,
        name=name or path,
    )
    if mesh.normals is None:
        mesh.compute_vertex_normals()
    return mesh


def save_serialized(path: str, meshes) -> None:
    """Write meshes in the reference .serialized layout (v3, doubles)."""
    if isinstance(meshes, TriMesh):
        meshes = [meshes]
    with open(path, "wb") as f:
        for mesh in meshes:
            f.write(struct.pack("<HH", MTS_FILEFORMAT_HEADER, MTS_V3))
            flags = 0
            chunks = []
            if mesh.normals is not None:
                flags |= _FLAG_VNORMALS
            if mesh.uvs is not None:
                flags |= _FLAG_UV
            chunks.append(struct.pack("<I", flags))
            chunks.append(struct.pack("<QQ", mesh.vertices.shape[0], mesh.faces.shape[0]))
            chunks.append(np.asarray(mesh.vertices, np.float64).tobytes())
            if mesh.normals is not None:
                chunks.append(np.asarray(mesh.normals, np.float64).tobytes())
            if mesh.uvs is not None:
                chunks.append(np.asarray(mesh.uvs, np.float64).tobytes())
            chunks.append(np.asarray(mesh.faces, np.uint32).tobytes())
            f.write(zlib.compress(b"".join(chunks)))


def save_obj(path: str, mesh: TriMesh) -> None:
    """Minimal OBJ writer (debug/testing + scene fixture generation)."""
    with open(path, "w") as f:
        f.write(f"# mitsuba_jax OBJ export: {mesh.name}\n")
        for v in mesh.vertices:
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        if mesh.uvs is not None:
            for t in mesh.uvs:
                f.write(f"vt {t[0]:.9g} {t[1]:.9g}\n")
        if mesh.normals is not None:
            for n in mesh.normals:
                f.write(f"vn {n[0]:.9g} {n[1]:.9g} {n[2]:.9g}\n")
        has_t = mesh.uvs is not None
        has_n = mesh.normals is not None
        for face in mesh.faces:
            idx = []
            for vi in face:
                i = vi + 1
                if has_t and has_n:
                    idx.append(f"{i}/{i}/{i}")
                elif has_n:
                    idx.append(f"{i}//{i}")
                elif has_t:
                    idx.append(f"{i}/{i}")
                else:
                    idx.append(str(i))
            f.write("f " + " ".join(idx) + "\n")
