"""Scene container: geometry + materials + emitters + camera as one pytree.

Replaces the reference `Scene` object graph (include/mitsuba/render/scene.h:46,
initialize at src/librender/scene.cpp:291) with a flat pytree of SoA tables —
the whole scene is jit-traceable, replicable across a device mesh, and
differentiable (grad flows into material/emitter/camera arrays).
"""
from __future__ import annotations

import contextlib

import jax
import numpy as np
import jax.numpy as jnp

from mitsuba_jax.bsdfs import MaterialBuilder, MaterialTable
from mitsuba_jax.core import transform as tf
from mitsuba_jax.core.types import pytree_dataclass, static_field
from mitsuba_jax.emitters import EmitterBuilder, EmitterTable
from mitsuba_jax.render.camera import Camera, make_perspective
from mitsuba_jax.render import mesh as mesh_mod
from mitsuba_jax.render.intersect import GeometryTables, build_geometry
from mitsuba_jax.render.texture import TextureBuilder, TextureTable


@pytree_dataclass
class Scene:
    geom: GeometryTables
    materials: MaterialTable
    emitters: EmitterTable
    camera: Camera
    textures: TextureTable
    width: int = static_field(default=256)
    height: int = static_field(default=256)
    # shape-attached interior media (media/medium.py MediumStack); (S,)
    # per-shape medium index, -1 = none.  None when the scene has no media.
    media: object = None
    shape_interior: object = None
    # subsurface scattering entries (subsurface/dipole.py SceneSubsurface);
    # None when no shape carries a <subsurface> (reference: Subsurface
    # plugins attach per shape, include/mitsuba/render/subsurface.h)
    subsurface: object = None


def _host_build_context():
    """default_device(cpu) when a CPU backend exists alongside the default."""
    try:
        cpu = jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return contextlib.nullcontext()
    return jax.default_device(cpu)


class SceneBuilder:
    """Host-side scene assembly: shapes bind materials and area emitters."""

    def __init__(self, build_mips: bool = False):
        self.materials = MaterialBuilder()
        self.emitters = EmitterBuilder()
        self.textures = TextureBuilder(build_mips=build_mips)
        self._shapes = []     # (mesh, material_id, emitter_id, shape_id)
        self._analytic = dict(spheres=[], cylinders=[])
        self._hair = []             # (segments dict, material_id, sid)
        self._n_shapes = 0          # shared id space: meshes + analytic
        self._shape_interior = []   # per shape: medium index or -1
        self._media = []            # (sigma_s, sigma_a, g)
        self._subsurface = []       # dicts: material_id, sigma_s, ...
        self._animated = []         # (mesh, material_id, emitter_id, track)
        self._inst_groups = []      # true instancing: [(mesh, mid, sid)]
        self._instances = []        # (group_id, to_world 4x4)
        self.camera = None
        self.width = 256
        self.height = 256

    def add_medium(self, sigma_s, sigma_a, g: float = 0.0,
                   density=None, world_to_grid=None,
                   density_scale: float = 1.0) -> int:
        """Register a medium; returns its index for
        add_shape(interior_medium=...) (reference: media attach to shapes
        as interior/exterior pointers). Pass density (D,H,W) +
        world_to_grid for a grid-driven (heterogeneous) medium
        (reference heterogeneous.cpp:79-96)."""
        if density is None:
            self._media.append((tuple(sigma_s), tuple(sigma_a), float(g)))
        else:
            self._media.append(dict(
                sigma_s=tuple(sigma_s), sigma_a=tuple(sigma_a),
                g=float(g), density=density, world_to_grid=world_to_grid,
                density_scale=float(density_scale)))
        return len(self._media) - 1

    def add_subsurface(self, material_id: int, sigma_s, sigma_a,
                       g: float = 0.0, eta: float = 1.33,
                       ss_factor=(1.0, 1.0, 1.0), n_points: int = 512,
                       profile: str = "dipole", thickness: float = 1.0,
                       n_poles: int = 3, aniso_dir=(1.0, 0.0, 0.0),
                       aniso_ratio: float = 2.0):
        """Attach a subsurface entry to every shape using material_id
        (reference <subsurface type="dipole">, dipole.cpp:362-468). The
        irradiance point cloud is sampled at build time; irradiance values
        are computed at render start (integrators/path.py render).
        profile: 'dipole' | 'multipole' (thin slab, thickness + n_poles;
        multipole.cpp) | 'adipole' (anisotropic metric, aniso_dir/ratio;
        adipole.cpp)."""
        self._subsurface.append(dict(
            material_id=int(material_id), sigma_s=tuple(sigma_s),
            sigma_a=tuple(sigma_a), g=float(g), eta=float(eta),
            ss_factor=tuple(ss_factor), n_points=int(n_points),
            profile=str(profile), thickness=float(thickness),
            n_poles=int(n_poles), aniso_dir=tuple(aniso_dir),
            aniso_ratio=float(aniso_ratio)))

    def add_shape(self, mesh, material_id, emitter_id=-1,
                  interior_medium: int = -1):
        sid = self._n_shapes
        self._n_shapes += 1
        self._shapes.append((mesh, material_id, emitter_id, sid))
        self._shape_interior.append(int(interior_medium))
        return sid

    def add_sphere(self, center, radius, material_id, emitter_id=-1,
                   interior_medium: int = -1):
        """Analytic sphere primitive (reference src/shapes/sphere.cpp —
        exact quadratic intersection, NOT tessellated)."""
        sid = self._n_shapes
        self._n_shapes += 1
        self._analytic["spheres"].append(
            (tuple(center), float(radius), int(material_id),
             int(emitter_id), sid))
        self._shape_interior.append(int(interior_medium))
        return sid

    def add_sphere_emitter(self, center, radius, material_id, radiance):
        """Analytic sphere area light, sampled by solid angle
        (reference sphere.cpp:359 sampleSolidAngle)."""
        eid = self.emitters.sphere_area(center, radius, radiance)
        return self.add_sphere(center, radius, material_id, emitter_id=eid)

    def add_cylinder(self, p0, p1, radius, material_id, emitter_id=-1,
                     interior_medium: int = -1):
        """Analytic open cylinder (reference src/shapes/cylinder.cpp —
        no end caps)."""
        sid = self._n_shapes
        self._n_shapes += 1
        self._analytic["cylinders"].append(
            (tuple(p0), tuple(p1), float(radius), int(material_id),
             int(emitter_id), sid))
        self._shape_interior.append(int(interior_medium))
        return sid

    def add_hair(self, segments, material_id):
        """Analytic hair fiber segments (reference src/shapes/hair.cpp
        — exact per-segment cylinder intersection, NOT tessellated).
        segments: dict(a, b, r, u0, u1) from io.hairio.load_hair_segments."""
        sid = self._n_shapes
        self._n_shapes += 1
        self._hair.append((segments, int(material_id), sid))
        self._shape_interior.append(-1)
        return sid

    def add_area_emitter_shape(self, mesh, material_id, radiance):
        eid = self.emitters.area(mesh, radiance)
        return self.add_shape(mesh, material_id, eid)

    def add_instanced_group(self, meshes_with_mats) -> int:
        """Register a shape group for TRUE instancing (reference
        shapegroup.cpp + instance.cpp): meshes_with_mats = [(TriMesh in
        OBJECT space, material_id), ...]. Returns a group id for
        add_instance. N instances share ONE copy of the group's triangle
        data on device (cluster backend; other backends flatten).
        Instanced shapes cannot be emitters or carry interior media."""
        gid = len(self._inst_groups)
        items = []
        for msh, mid in meshes_with_mats:
            sid = self._n_shapes
            self._n_shapes += 1
            self._shape_interior.append(-1)
            items.append((msh, int(mid), sid))
        self._inst_groups.append(items)
        return gid

    def add_instance(self, group_id: int, to_world):
        """Place an instance of a registered group (instance.cpp)."""
        import numpy as _np

        self._instances.append((int(group_id),
                                _np.asarray(to_world, _np.float64)))

    def add_animated_shape(self, mesh, material_id, track,
                           emitter_id: int = -1):
        """Shape with an animated to-world transform (reference
        animatedinstance.cpp + track.h AnimatedTransform). mesh is in
        OBJECT space; build() bakes the track at the camera's
        shutter-open time, build_time_scenes() bakes one scene per
        stratified shutter time bin for motion blur (render_motion)."""
        self._animated.append((mesh, int(material_id), int(emitter_id),
                               track))

    def build_time_scenes(self, n_bins: int, backend: str = "auto"):
        """Scenes baked at n_bins stratified times across the camera
        shutter — the wavefront motion-blur decomposition: one compiled
        render program (scenes are pytree args with identical structure)
        runs per bin; averaging the bins integrates the shutter
        (reference: per-ray time + AnimatedTransform::eval at
        intersection time; a wavefront over device-resident static
        tables re-binned per time step keeps the intersection kernels
        branch-free instead)."""
        so = float(self.camera.shutter_open) if self.camera else 0.0
        st = float(self.camera.shutter_time) if self.camera else 0.0
        times = [so + (k + 0.5) / n_bins * st for k in range(n_bins)]
        return [self.build(backend=backend, time=t) for t in times]

    def set_camera(self, camera: Camera, width: int, height: int):
        self.camera = camera
        self.width, self.height = width, height

    def build(self, backend: str = "auto", time: float | None = None) -> Scene:
        """Assemble the scene. time: bake animated shapes at this track
        time (default: the camera's shutter-open).

        Built on the host CPU backend, where the many tiny table-building
        ops cost no device dispatch; the finished pytree then moves to the
        default device in one device_put."""
        with _host_build_context():
            scene = self._build_impl(backend, time)
        if jax.default_backend() != "cpu":
            scene = jax.device_put(scene, jax.devices()[0])
        return scene

    def _build_impl(self, backend: str, time: float | None = None) -> Scene:
        shapes_saved = None
        if self._animated:
            import numpy as _np

            if time is None:
                time = float(self.camera.shutter_open) if self.camera \
                    else 0.0
            shapes_saved = list(self._shapes)
            interior_saved = list(self._shape_interior)
            n_saved = self._n_shapes
            for mesh, mid, eid, track in self._animated:
                m4 = _np.asarray(track.eval(jnp.asarray(time)))
                self.add_shape(mesh.transformed(m4), mid, emitter_id=eid)
        try:
            return self._build_shapes(backend)
        finally:
            if shapes_saved is not None:
                self._shapes = shapes_saved
                self._shape_interior = interior_saved
                self._n_shapes = n_saved

    def _build_shapes(self, backend: str) -> Scene:
        if not self._shapes and not (self._analytic["spheres"]
                                     or self._analytic["cylinders"]
                                     or self._hair):
            raise ValueError("scene has no shapes")
        if not self._shapes:
            # analytic-only scene: the triangle tables still need >=1 row;
            # a degenerate far-away triangle never hits
            from mitsuba_jax.render import mesh as _mesh_mod

            far = _mesh_mod.make_quad((1e8, 1e8, 1e8), (1e8, 1e8, 1e8),
                                      (1e8, 1e8, 1e8), (1e8, 1e8, 1e8))
            self._shapes.append((far, 0, -1, self._n_shapes))
            self._n_shapes += 1
            self._shape_interior.append(-1)
        instanced = None
        if self._instances:
            if backend not in ("cluster", "auto"):
                raise ValueError(
                    "true instancing requires the cluster backend")
            backend = "cluster"
            instanced = (self._inst_groups, self._instances)
        hair = None
        if self._hair:
            import numpy as _np2

            parts = []
            for seg, hmid, hsid in self._hair:
                h = seg["a"].shape[0]
                parts.append(dict(
                    a=seg["a"], b=seg["b"], r=seg["r"],
                    u0=seg["u0"], u1=seg["u1"],
                    mid=_np2.full(h, hmid, _np2.int32),
                    eid=_np2.full(h, -1, _np2.int32),
                    sid=_np2.full(h, hsid, _np2.int32)))
            hair = {k: _np2.concatenate([p[k] for p in parts])
                    for k in parts[0]}
        geom = build_geometry(self._shapes, backend=backend,
                              analytic=self._analytic,
                              instanced=instanced, hair=hair)
        # triangle->emitter binding arrives in BVH order inside geom
        tri_emitter = np.asarray(geom.emitter_id)
        # areas in the same (BVH) order
        e1 = np.asarray(geom.e1)
        e2 = np.asarray(geom.e2)
        areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        em = self.emitters.build(tri_emitter, areas)
        mats = self.materials.build()
        cam = self.camera
        if cam is None:
            cam = make_perspective(tf.identity(), 45.0, self.width / self.height)
        media = None
        shape_interior = None
        if self._media:
            from mitsuba_jax.media.medium import make_medium_stack

            media = make_medium_stack(self._media)
            shape_interior = jnp.asarray(
                np.asarray(self._shape_interior, np.int32))
        subsurface = None
        if self._subsurface:
            from mitsuba_jax.subsurface.dipole import build_scene_subsurface

            n_pts = max(e["n_points"] for e in self._subsurface)
            subsurface = build_scene_subsurface(
                self._subsurface, mats.n_materials, geom, n_points=n_pts)
        return Scene(
            geom=geom, materials=mats, emitters=em, camera=cam,
            textures=self.textures.build(),
            width=self.width, height=self.height,
            media=media, shape_interior=shape_interior,
            subsurface=subsurface,
        )


def cornell_box(width=256, height=256, backend="brute") -> Scene:
    """The classic Cornell box — the headline benchmark scene
    (BASELINE.json config 1). Dimensions after the original Cornell data
    (mirrored by mitsuba's cbox scene): 556×548.8×559.2 units."""
    b = SceneBuilder()
    white = b.materials.lambertian((0.725, 0.71, 0.68))
    red = b.materials.lambertian((0.63, 0.065, 0.05))
    green = b.materials.lambertian((0.14, 0.45, 0.091))
    light_mat = b.materials.lambertian((0.0, 0.0, 0.0))

    mq = mesh_mod.make_quad
    # floor / ceiling / back wall (normals inward)
    b.add_shape(mq([552.8, 0, 0], [0, 0, 0], [0, 0, 559.2], [549.6, 0, 559.2], "floor"), white)
    b.add_shape(mq([556, 548.8, 0], [556, 548.8, 559.2], [0, 548.8, 559.2], [0, 548.8, 0], "ceiling"), white)
    b.add_shape(mq([549.6, 0, 559.2], [0, 0, 559.2], [0, 548.8, 559.2], [556, 548.8, 559.2], "back"), white)
    b.add_shape(mq([0, 0, 559.2], [0, 0, 0], [0, 548.8, 0], [0, 548.8, 559.2], "right-green"), green)
    b.add_shape(mq([552.8, 0, 0], [549.6, 0, 559.2], [556, 548.8, 559.2], [556, 548.8, 0], "left-red"), red)

    # short block
    sb = [
        mq([130, 165, 65], [82, 165, 225], [240, 165, 272], [290, 165, 114]),
        mq([290, 0, 114], [290, 165, 114], [240, 165, 272], [240, 0, 272]),
        mq([130, 0, 65], [130, 165, 65], [290, 165, 114], [290, 0, 114]),
        mq([82, 0, 225], [82, 165, 225], [130, 165, 65], [130, 0, 65]),
        mq([240, 0, 272], [240, 165, 272], [82, 165, 225], [82, 0, 225]),
    ]
    for q in sb:
        b.add_shape(q, white)
    # tall block
    tb = [
        mq([423, 330, 247], [265, 330, 296], [314, 330, 456], [472, 330, 406]),
        mq([423, 0, 247], [423, 330, 247], [472, 330, 406], [472, 0, 406]),
        mq([472, 0, 406], [472, 330, 406], [314, 330, 456], [314, 0, 456]),
        mq([314, 0, 456], [314, 330, 456], [265, 330, 296], [265, 0, 296]),
        mq([265, 0, 296], [265, 330, 296], [423, 330, 247], [423, 0, 247]),
    ]
    for q in tb:
        b.add_shape(q, white)

    # light (slightly below ceiling, facing down)
    light = mq([343, 548.7, 227], [343, 548.7, 332], [213, 548.7, 332], [213, 548.7, 227], "light")
    b.add_area_emitter_shape(light, light_mat, (18.4, 15.6, 8.0))

    cam = make_perspective(
        tf.look_at([278, 273, -800], [278, 273, 0], [0, 1, 0]),
        fov_deg=39.3077,
        aspect=width / height,
    )
    b.set_camera(cam, width, height)
    return b.build(backend=backend)


def cornell_box_specular(width=256, height=256, backend="brute") -> Scene:
    """BASELINE.json config 2: Cornell box with a mirror tall block, a glass
    sphere and a rough-conductor short block — delta + microfacet MIS."""
    from mitsuba_jax.core import microfacet as mf

    b = SceneBuilder()
    white = b.materials.lambertian((0.725, 0.71, 0.68))
    red = b.materials.lambertian((0.63, 0.065, 0.05))
    green = b.materials.lambertian((0.14, 0.45, 0.091))
    mirror = b.materials.mirror((0.95, 0.95, 0.95))
    glass = b.materials.dielectric(int_ior=1.5)
    metal = b.materials.rough_conductor(alpha=0.15, dist=mf.GGX)
    light_mat = b.materials.lambertian((0.0, 0.0, 0.0))

    mq = mesh_mod.make_quad
    b.add_shape(mq([552.8, 0, 0], [0, 0, 0], [0, 0, 559.2], [549.6, 0, 559.2]), white)
    b.add_shape(mq([556, 548.8, 0], [556, 548.8, 559.2], [0, 548.8, 559.2], [0, 548.8, 0]), white)
    b.add_shape(mq([549.6, 0, 559.2], [0, 0, 559.2], [0, 548.8, 559.2], [556, 548.8, 559.2]), white)
    b.add_shape(mq([0, 0, 559.2], [0, 0, 0], [0, 548.8, 0], [0, 548.8, 559.2]), green)
    b.add_shape(mq([552.8, 0, 0], [549.6, 0, 559.2], [556, 548.8, 559.2], [556, 548.8, 0]), red)

    # rough-metal short block
    for q in [
        mq([130, 165, 65], [82, 165, 225], [240, 165, 272], [290, 165, 114]),
        mq([290, 0, 114], [290, 165, 114], [240, 165, 272], [240, 0, 272]),
        mq([130, 0, 65], [130, 165, 65], [290, 165, 114], [290, 0, 114]),
        mq([82, 0, 225], [82, 165, 225], [130, 165, 65], [130, 0, 65]),
        mq([240, 0, 272], [240, 165, 272], [82, 165, 225], [82, 0, 225]),
    ]:
        b.add_shape(q, metal)
    # mirror tall block
    for q in [
        mq([423, 330, 247], [265, 330, 296], [314, 330, 456], [472, 330, 406]),
        mq([423, 0, 247], [423, 330, 247], [472, 330, 406], [472, 0, 406]),
        mq([472, 0, 406], [472, 330, 406], [314, 330, 456], [314, 0, 456]),
        mq([314, 0, 456], [314, 330, 456], [265, 330, 296], [265, 0, 296]),
        mq([265, 0, 296], [265, 330, 296], [423, 330, 247], [423, 0, 247]),
    ]:
        b.add_shape(q, mirror)
    # glass sphere floating between the blocks — ANALYTIC (reference
    # src/shapes/sphere.cpp:359): exact intersection, no tessellation, and
    # the whole scene stays on the brute kernel (32 tris)
    b.add_sphere([160, 280, 170], 70.0, glass)

    light = mesh_mod.make_quad([343, 548.7, 227], [343, 548.7, 332], [213, 548.7, 332], [213, 548.7, 227])
    b.add_area_emitter_shape(light, light_mat, (18.4, 15.6, 8.0))

    cam = make_perspective(
        tf.look_at([278, 273, -800], [278, 273, 0], [0, 1, 0]),
        fov_deg=39.3077, aspect=width / height,
    )
    b.set_camera(cam, width, height)
    return b.build(backend=backend)


def textured_mesh_scene(width=256, height=256, backend="bvh") -> Scene:
    """BASELINE.json config 3: a generated 160x320 UV sphere (102,400
    triangles) with a checkerboard-textured floor under a Preetham sky
    envmap."""
    b = SceneBuilder()
    tex = b.textures.checkerboard(bright=(0.7, 0.7, 0.7), dark=(0.2, 0.2, 0.25),
                                  uv_scale=(8.0, 8.0))
    floor_mat = b.materials.lambertian((1.0, 1.0, 1.0), tex_id=tex)
    body_mat = b.materials.phong(diffuse=(0.4, 0.3, 0.2), specular=(0.3,) * 3,
                                 exponent=40.0)
    body = mesh_mod.make_sphere_mesh([0, 0.8, 0], 0.8, 160, 320)
    b.add_shape(body, body_mat)
    b.add_shape(
        mesh_mod.make_quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6]),
        floor_mat,
    )
    b.emitters.sky(turbidity=3.0, sun_dir=(0.35, 0.6, -0.5), scale=1.0)
    cam = make_perspective(
        tf.look_at([0, 1.4, -3.2], [0, 0.7, 0], [0, 1, 0]),
        fov_deg=40.0, aspect=width / height,
    )
    b.set_camera(cam, width, height)
    return b.build(backend=backend)
