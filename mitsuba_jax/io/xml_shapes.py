"""XML shape/luminaire-node assembly into the SceneBuilder.

Shapes (reference src/shapes/): obj, ply, serialized (file meshes), sphere,
cylinder (analytic in the reference — tessellated here; property names match
sphere.cpp:46, cylinder.cpp:43, obj.cpp:69, serialized.cpp:33).
Luminaires (src/luminaires/): area attached to shapes (area.cpp:40
"intensity"), scene-level point/spot/directional/constant.
"""
from __future__ import annotations

import os

import numpy as np

from mitsuba_jax.core import transform as tf
from mitsuba_jax.emitters import table as em_table
from mitsuba_jax.io import meshio
from mitsuba_jax.render import mesh as mesh_mod


def _spec(props, name, default):
    v = props.get(name, default)
    if isinstance(v, (int, float)):
        return (float(v),) * 3
    return tuple(v)


def _find(node, category):
    for c in node["children"]:
        if c["category"] == category:
            return c
    return None


def _make_cylinder_mesh(p1, p2, radius, n_phi=64):
    """Capless cylinder between p1 and p2 (reference cylinder.cpp is
    open-ended as well)."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    axis = p2 - p1
    length = np.linalg.norm(axis)
    z = axis / length
    # build orthonormal frame
    a = np.array([1.0, 0, 0]) if abs(z[0]) < 0.9 else np.array([0, 1.0, 0])
    x = np.cross(a, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    phi = np.linspace(0, 2 * np.pi, n_phi + 1)
    ring = (np.cos(phi)[:, None] * x + np.sin(phi)[:, None] * y) * radius
    v0 = p1 + ring
    v1 = p2 + ring
    verts = np.concatenate([v0, v1]).astype(np.float32)
    normals = np.concatenate([ring, ring]) / radius
    faces = []
    w = n_phi + 1
    for i in range(n_phi):
        faces.append([i, i + 1, w + i + 1])
        faces.append([i, w + i + 1, w + i])
    return mesh_mod.TriMesh(
        verts, np.asarray(faces, np.int32),
        normals=np.asarray(normals, np.float32), name="cylinder",
    )


def _resolve(base_dir, name):
    """Scene-relative first, then the process search path (reference
    FileResolver semantics, fresolver.h:40)."""
    from mitsuba_jax.io.resolver import default_resolver

    r = default_resolver().clone()
    r.prepend(base_dir)
    return r.resolve(name)


def load_shape_mesh(shape_node, base_dir):
    t = shape_node["type"]
    p = shape_node["props"]
    if t == "obj":
        mesh = meshio.load_obj(_resolve(base_dir, p["filename"]))
        if p.get("faceNormals", False):
            mesh.normals = None
    elif t == "ply":
        mesh = meshio.load_ply(_resolve(base_dir, p["filename"]))
    elif t == "serialized":
        mesh = meshio.load_serialized(
            _resolve(base_dir, p["filename"]), int(p.get("shapeIndex", 0))
        )
    elif t == "sphere":
        center = p.get("center", (0.0, 0.0, 0.0))
        radius = float(p.get("radius", 1.0))
        mesh = mesh_mod.make_sphere_mesh(center, radius, 48, 96)
        if p.get("inverted", False):
            mesh.faces = mesh.faces[:, ::-1].copy()
            mesh.normals = -mesh.normals
    elif t == "cylinder":
        mesh = _make_cylinder_mesh(
            p.get("p1", (0, 0, 0)), p.get("p2", (0, 0, 1)),
            float(p.get("radius", 1.0)),
        )
    elif t == "hair":
        from mitsuba_jax.io.hairio import load_hair

        mesh = load_hair(
            _resolve(base_dir, p["filename"]),
            radius=float(p.get("radius", 0.05)),
        )
    elif t == "hspan":
        from mitsuba_jax.io.hairio import load_hspan

        mesh = load_hspan(_resolve(base_dir, p["filename"]))
    else:
        raise ValueError(f"unsupported shape type '{t}'")
    to_world = p.get("toWorld")
    if to_world is not None:
        mesh = mesh.transformed(np.asarray(to_world))
    if p.get("flipNormals", False):
        mesh.faces = mesh.faces[:, ::-1].copy()
        if mesh.normals is not None:
            mesh.normals = -mesh.normals
    return mesh


def add_shape(builder, shape_node, base_dir, mat_cache, material_fn,
              track=None):
    t = shape_node["type"]
    if t == "shapegroup":
        # reference src/shapes/group.cpp: a named collection only
        # instantiated via <shape type="instance"> — nothing added here.
        return
    if t in ("instance", "animatedinstance"):
        # reference src/shapes/{instance,animatedinstance}.cpp: kd-tree-in-
        # kd-tree instancing. Re-design: flatten — append a transformed
        # copy of the group geometry (device-resident SoA replication; nested
        # traversal would break the wavefront's uniform gather loop).
        # animatedinstance: its binary track file (animatedinstance.cpp:
        # 28-37) registers the flattened meshes as animated shapes; motion
        # blur renders per-time-bin scenes (render_motion), plain renders
        # bake shutter-open.
        group = None
        for c in shape_node["children"]:
            if c["category"] == "shape" and c["type"] == "shapegroup":
                group = c
        if group is None:
            raise ValueError("<instance> needs a <ref> to a shapegroup")
        track = None
        if t == "animatedinstance" and "filename" in shape_node["props"]:
            import os as _os

            from mitsuba_jax.core.track import load_animated_transform

            track = load_animated_transform(
                _os.path.join(base_dir, shape_node["props"]["filename"]))
        to_world = shape_node["props"].get("toWorld")
        for sub in group["children"]:
            if sub["category"] != "shape":
                continue
            sub_copy = dict(sub)
            if to_world is not None:
                import numpy as _np
                props = dict(sub["props"])
                inner = props.get("toWorld")
                comp = _np.asarray(to_world) if inner is None else (
                    _np.asarray(to_world) @ _np.asarray(inner)
                )
                props["toWorld"] = comp
                sub_copy["props"] = props
            add_shape(builder, sub_copy, base_dir, mat_cache, material_fn,
                      track=track)
        return
    # analytic primitives (reference sphere.cpp/cylinder.cpp intersect
    # exactly): spheres and cylinders skip tessellation unless inverted
    # (flipped normals) or carrying subsurface (the irradiance point cloud
    # samples triangles)
    props0 = shape_node["props"]
    analytic = None
    if (t == "sphere" and not props0.get("inverted", False)
            and _find(shape_node, "subsurface") is None):
        center = np.asarray(props0.get("center", (0.0, 0.0, 0.0)),
                            np.float32)
        radius = float(props0.get("radius", 1.0))
        tw = props0.get("toWorld")
        if tw is not None:
            tw = np.asarray(tw)
            center = np.asarray(tf.apply_point(tw, center))
            radius *= float(np.linalg.norm(tw[:3, 0]))
        analytic = ("sphere", center, radius)
        mesh = None
    elif t == "cylinder" and _find(shape_node, "subsurface") is None:
        p1 = np.asarray(props0.get("p1", (0.0, 0.0, 0.0)), np.float32)
        p2 = np.asarray(props0.get("p2", (0.0, 0.0, 1.0)), np.float32)
        radius = float(props0.get("radius", 1.0))
        tw = props0.get("toWorld")
        if tw is not None:
            tw = np.asarray(tw)
            p1 = np.asarray(tf.apply_point(tw, p1))
            p2 = np.asarray(tf.apply_point(tw, p2))
            radius *= float(np.linalg.norm(tw[:3, 0]))
        analytic = ("cylinder", p1, p2, radius)
        mesh = None
    elif (t == "hair" and not props0.get("tessellate", False)
            and _find(shape_node, "subsurface") is None):
        # reference hair.cpp:132 intersects exact per-segment cylinders;
        # route into the segment BVH (set tessellate="true" to force
        # the old tube mesh)
        from mitsuba_jax.io.hairio import load_hair_segments

        seg = load_hair_segments(
            _resolve(base_dir, props0["filename"]),
            radius=float(props0.get("radius", 0.05)))
        tw = props0.get("toWorld")
        if tw is not None:
            tw = np.asarray(tw)
            seg["a"] = np.asarray(tf.apply_point(tw, seg["a"]), np.float32)
            seg["b"] = np.asarray(tf.apply_point(tw, seg["b"]), np.float32)
            seg["r"] = np.asarray(
                seg["r"] * float(np.linalg.norm(tw[:3, 0])), np.float32)
        analytic = ("hair", seg)
        mesh = None
    else:
        mesh = load_shape_mesh(shape_node, base_dir)
    bsdf = _find(shape_node, "bsdf")
    lum = _find(shape_node, "luminaire")
    # interior medium bound to the shape (reference: <medium> child named
    # "interior"; homogeneous or heterogeneous/grid-driven,
    # heterogeneous.cpp:79-96)
    interior = -1
    for c in shape_node["children"]:
        if c["category"] == "medium" and c.get("name") in ("interior", None):
            mp = c["props"]

            def _sp(name, default):
                v = mp.get(name, default)
                if isinstance(v, (int, float)):
                    return (float(v),) * 3
                return tuple(v)

            if "sigmaT" in mp or "albedo" in mp:
                st = _sp("sigmaT", 1.0)
                al = _sp("albedo", 0.5)
                ss = tuple(t_ * a_ for t_, a_ in zip(st, al))
                sa = tuple(t_ - s_ for t_, s_ in zip(st, ss))
            else:
                ss = _sp("sigmaS", 1.0)
                sa = _sp("sigmaA", 0.1)
            g = 0.0
            for pc in c["children"]:
                if pc["category"] == "phase" and pc["type"] == "hg":
                    g = float(pc["props"].get("g", 0.8))
            if c["type"] == "heterogeneous":
                from mitsuba_jax.io.volio import (
                    grid_world_to_index_transform, load_vol)

                vol = None
                for pc in c["children"]:
                    if (pc["category"] == "volume"
                            and pc.get("name") in ("density", None)):
                        vol = pc
                if vol is None or "filename" not in vol["props"]:
                    raise ValueError(
                        "heterogeneous interior needs a gridvolume density")
                data, bmin_v, bmax_v = load_vol(
                    _resolve(base_dir, vol["props"]["filename"]))
                density = data[..., 0]
                w2g = grid_world_to_index_transform(
                    bmin_v, bmax_v, density.shape)
                interior = builder.add_medium(
                    ss, sa, g=g, density=density, world_to_grid=w2g,
                    density_scale=float(mp.get("densityMultiplier", 1.0)))
            else:
                interior = builder.add_medium(ss, sa, g=g)
    if bsdf is not None:
        mid = material_fn(builder, bsdf, mat_cache)
    elif interior >= 0 and lum is None:
        # reference: a shape with an interior medium and no BSDF is an
        # index-matched, non-occluding boundary (Shape::isOccluder false)
        mid = mat_cache.setdefault("__null__", builder.materials.null())
    else:
        # reference default: lambertian 0.5 when shape has no BSDF but is
        # not a pure emitter
        mid = mat_cache.setdefault(
            "__default__", builder.materials.lambertian((0.5, 0.5, 0.5))
        ) if lum is None else mat_cache.setdefault(
            "__black__", builder.materials.lambertian((0.0, 0.0, 0.0))
        )
    ssn = _find(shape_node, "subsurface")
    if ssn is not None and ssn["type"] == "marschner":
        # reference-fork marschner.cpp is an unfinished stub whose Lo()
        # always returns black (marschner.cpp:62-88) — parity is accepting
        # the plugin and contributing nothing
        from mitsuba_jax.utils.logging import get_logger
        get_logger().warn(
            "subsurface type 'marschner' matches the reference stub: "
            "zero contribution")
        ssn = None
    if ssn is not None:
        # reference <subsurface type="dipole"> (dipole.cpp props): sigmaS/
        # sigmaA or sigmaT+albedo, eta or intIOR/extIOR, g, ssFactor.
        # multipole/adipole (multipole.cpp / adipole.cpp) share the prop
        # set plus thickness/poles or anisoDirection/anisoRatio.
        if ssn["type"] not in ("dipole", "multipole", "adipole", ""):
            raise ValueError(
                f"unsupported subsurface type '{ssn['type']}'")
        sp = ssn["props"]

        def _sp3(name, default):
            v = sp.get(name, default)
            if isinstance(v, (int, float)):
                return (float(v),) * 3
            return tuple(v)

        if "sigmaT" in sp or "albedo" in sp:
            st = _sp3("sigmaT", 1.0)
            al = _sp3("albedo", 0.5)
            ss_c = tuple(t_ * a_ for t_, a_ in zip(st, al))
            sa_c = tuple(t_ - s_ for t_, s_ in zip(st, ss_c))
        else:
            ss_c = _sp3("sigmaS", (2.6, 3.2, 3.9))
            sa_c = _sp3("sigmaA", (0.0021, 0.0041, 0.0071))
        eta = float(sp.get("eta", float(sp.get("intIOR", 1.33))
                    / float(sp.get("extIOR", 1.0))))
        # subsurface binds to the *material* here; a cached/ref'd BSDF
        # shared with non-SSS shapes must not inherit it -> fresh copy
        if bsdf is not None:
            mid = material_fn(builder, bsdf, {})
        builder.add_subsurface(
            mid, ss_c, sa_c, g=float(sp.get("g", 0.0)), eta=eta,
            ss_factor=_sp3("ssFactor", 1.0),
            n_points=int(sp.get("irrSamples", 512)),
            profile=ssn["type"] or "dipole",
            thickness=float(sp.get("thickness", 1.0)),
            n_poles=int(sp.get("extraDipoles", 3)),
            aniso_dir=_sp3("anisoDirection", (1.0, 0.0, 0.0)),
            aniso_ratio=float(sp.get("anisoRatio", 2.0)))
    if analytic is not None and analytic[0] == "sphere":
        _, center, radius = analytic
        if lum is not None:
            radiance = _spec(lum["props"], "intensity", 1.0)
            eid = builder.emitters.sphere_area(center, radius, radiance)
            builder.add_sphere(center, radius, mid, emitter_id=eid,
                               interior_medium=interior)
        else:
            builder.add_sphere(center, radius, mid,
                               interior_medium=interior)
        return
    if analytic is not None and analytic[0] == "cylinder":
        _, p1, p2, radius = analytic
        if lum is not None:
            raise ValueError("cylinder area emitters are not supported; "
                             "tessellate explicitly")
        builder.add_cylinder(p1, p2, radius, mid, interior_medium=interior)
        return
    if analytic is not None and analytic[0] == "hair":
        if lum is not None:
            raise ValueError("hair emitters are not supported")
        builder.add_hair(analytic[1], mid)
        return
    if lum is not None:
        if lum["type"] not in ("area", ""):
            raise ValueError("only area luminaires can be attached to shapes")
        radiance = _spec(lum["props"], "intensity", 1.0)
        eid = builder.emitters.area(mesh, radiance)
        if track is not None:
            builder.add_animated_shape(mesh, mid, track, emitter_id=eid)
        else:
            builder.add_shape(mesh, mid, eid, interior_medium=interior)
    elif track is not None:
        builder.add_animated_shape(mesh, mid, track)
    else:
        builder.add_shape(mesh, mid, interior_medium=interior)


def add_scene_luminaire(builder, lum_node):
    t = lum_node["type"]
    p = lum_node["props"]
    intensity = _spec(p, "intensity", 1.0)
    to_world = p.get("toWorld")
    if t == "point":
        pos = p.get("position", (0.0, 0.0, 0.0))
        if to_world is not None:
            pos = tuple(np.asarray(tf.apply_point(to_world, np.asarray(pos))))
        builder.emitters.point(pos, intensity)
    elif t == "spot":
        # reference spot.cpp: aims along +z of toWorld
        origin = (0.0, 0.0, 0.0)
        direction = (0.0, 0.0, 1.0)
        if to_world is not None:
            origin = tuple(np.asarray(tf.apply_point(to_world, np.zeros(3))))
            direction = tuple(np.asarray(tf.apply_vector(to_world, np.asarray([0.0, 0, 1]))))
        builder.emitters.spot(
            origin, direction, intensity,
            cutoff_deg=float(p.get("cutoffAngle", 20.0)),
            falloff_deg=float(p.get("beamWidth", float(p.get("cutoffAngle", 20.0)) * 0.75)),
        )
    elif t == "directional":
        d = p.get("direction", (0.0, 0.0, 1.0))
        if to_world is not None and "direction" not in p:
            d = tuple(np.asarray(tf.apply_vector(to_world, np.asarray([0.0, 0, 1]))))
        builder.emitters.directional(d, intensity)
    elif t == "constant":
        builder.emitters.constant(intensity)
    elif t == "envmap":
        import os as _os
        from mitsuba_jax.io.bitmap import read_image

        img = read_image(_os.path.join(p.get("__base_dir__", "."), p["filename"])) \
            if not _os.path.isabs(p["filename"]) else read_image(p["filename"])
        builder.emitters.envmap(
            img, to_world=p.get("toWorld"),
            scale=float(p.get("intensityScale", 1.0)),
        )
    elif t == "sky":
        sun = p.get("sunDirection", (0.0, 1.0, 0.0))
        builder.emitters.sky(
            turbidity=float(p.get("turbidity", 3.0)), sun_dir=sun,
            scale=float(p.get("intensityScale", 1.0)),
            extend_below=bool(p.get("extend", True)),
        )
    else:
        raise ValueError(f"unsupported scene-level luminaire '{t}'")
