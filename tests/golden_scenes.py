"""Golden-image scenes (VERDICT round-1 weak #5): low-res renders of
reference-style test scenes (data/tests/bunny.ply + test_bsdf.xml
materials), gated by the per-pixel Welch t-test exactly like the
reference's image comparison (src/librender/testcase.cpp:168-250).

Goldens live in tests/goldens/*.npz (mean + per-pixel sample variance at
high spp); regenerate with `python tests/golden_scenes.py` after an
INTENTIONAL change and say so in the commit message.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BUNNY = "/root/reference/data/tests/bunny.ply"
RES = 48          # round-4: raised from 24 (VERDICT #6)
GOLDEN_SPP = 256
TEST_SPP = 128
DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _camera(b, origin, target, fov=35.0):
    from mitsuba_jax.core import transform as tf
    from mitsuba_jax.render.camera import make_perspective

    cam = make_perspective(tf.look_at(origin, target, (0, 1, 0)), fov, 1.0)
    b.set_camera(cam, RES, RES)


def scene_bunny_lambert():
    """bunny.ply, lambertian, constant environment — geometry + BVH +
    env sampling path."""
    from mitsuba_jax.io.meshio import load_ply
    from mitsuba_jax.render.scene import SceneBuilder

    b = SceneBuilder()
    lm = b.materials.lambertian((0.65, 0.6, 0.5))
    mesh = load_ply(BUNNY)
    v = mesh.vertices
    c = 0.5 * (v.max(0) + v.min(0))
    s = 1.0 / max(v.max(0) - v.min(0))
    mesh.vertices = (v - c) * s
    b.add_shape(mesh, lm)
    b.emitters.constant((0.8, 0.9, 1.0))
    _camera(b, (0.0, 0.12, 1.4), (0.0, 0.0, 0.0), fov=30)
    return b.build(backend="auto"), 4


def scene_ward_spheres():
    """Analytic spheres with test_bsdf.xml materials (ward + phong +
    roughglass) under an area light."""
    from mitsuba_jax.render import mesh as mesh_mod
    from mitsuba_jax.render.scene import SceneBuilder

    b = SceneBuilder()
    floor_m = b.materials.lambertian((0.5, 0.5, 0.5))
    ward = b.materials.ward(diffuse=(0.25, 0.25, 0.25),
                            specular=(0.5, 0.5, 0.5),
                            alpha_u=0.1, alpha_v=0.3)
    phong = b.materials.phong(diffuse=(0.25, 0.1, 0.1),
                              specular=(0.4, 0.4, 0.4), exponent=20.0)
    glass = b.materials.rough_glass(alpha=0.4, int_ior=1.5)
    black = b.materials.lambertian((0.0, 0.0, 0.0))
    floor = mesh_mod.make_quad([-4, -1, -4], [4, -1, -4],
                               [4, -1, 4], [-4, -1, 4])
    b.add_shape(floor, floor_m)
    b.add_sphere((-1.2, -0.4, 0), 0.6, ward)
    b.add_sphere((0.0, -0.4, 0), 0.6, phong)
    b.add_sphere((1.2, -0.4, 0), 0.6, glass)
    # wound so the normal faces -y (down toward the spheres)
    light = mesh_mod.make_quad([-1, 2.5, -1], [1, 2.5, -1],
                               [1, 2.5, 1], [-1, 2.5, 1])
    b.add_area_emitter_shape(light, black, (10.0, 10.0, 10.0))
    _camera(b, (0.0, 0.8, 4.2), (0.0, -0.4, 0.0), fov=35)
    return b.build(backend="brute"), 5


def scene_cornell():
    from mitsuba_jax.render.scene import cornell_box

    return cornell_box(RES, RES), 4


def scene_instanced_cluster():
    """TRUE instancing on the work-list cluster backend: three instances
    of one sphere-mesh group over a checker floor (gates the shared
    object-space tables + per-instance transforms end to end)."""
    from mitsuba_jax.render import mesh as mesh_mod
    from mitsuba_jax.render.scene import SceneBuilder

    b = SceneBuilder()
    tex = b.textures.checkerboard(bright=(0.6, 0.6, 0.6),
                                  dark=(0.2, 0.2, 0.25),
                                  uv_scale=(6.0, 6.0))
    floor_m = b.materials.lambertian((1.0, 1.0, 1.0), tex_id=tex)
    red = b.materials.lambertian((0.6, 0.15, 0.1))
    b.add_shape(mesh_mod.make_quad([-6, -1, -6], [6, -1, -6],
                                   [6, -1, 6], [-6, -1, 6]), floor_m)
    ball = mesh_mod.make_sphere_mesh([0, 0, 0], 1.0, 12, 24)
    gid = b.add_instanced_group([(ball, red)])
    import numpy as np

    for x, z, s in ((-1.6, 0.0, 0.6), (0.0, 0.8, 0.9), (1.7, -0.4, 0.5)):
        t = np.eye(4)
        t[:3, 3] = (x, s - 1.0, z)
        t[0, 0] = t[1, 1] = t[2, 2] = s
        b.add_instance(gid, t)
    black = b.materials.lambertian((0.0, 0.0, 0.0))
    light = mesh_mod.make_quad([-1.5, 4, -1.5], [1.5, 4, -1.5],
                               [1.5, 4, 1.5], [-1.5, 4, 1.5])
    b.add_area_emitter_shape(light, black, (12.0, 12.0, 12.0))
    _camera(b, (0.0, 1.2, 5.0), (0.0, 0.0, 0.0), fov=35)
    return b.build(backend="cluster"), 4


def scene_volumetric_tank():
    """Shape-attached scattering medium (Beer-Lambert + HG in-scatter +
    boundary-aware NEE) — gates the volpath_media estimator."""
    from mitsuba_jax.core import transform as tf
    from mitsuba_jax.render import mesh as mesh_mod
    from mitsuba_jax.render.camera import make_perspective
    from mitsuba_jax.render.scene import SceneBuilder

    b = SceneBuilder()
    glass = b.materials.dielectric(int_ior=1.0, ext_ior=1.0)
    lm = b.materials.lambertian((0.0, 0.0, 0.0))
    grey = b.materials.lambertian((0.5, 0.5, 0.5))
    med = b.add_medium((0.4, 0.5, 0.6), (0.15, 0.1, 0.05), g=0.3)
    b.add_shape(mesh_mod.make_box([-1, -1, -1], [1, 1, 1]), glass,
                interior_medium=med)
    b.add_shape(mesh_mod.make_quad([-4, -1.05, -4], [4, -1.05, -4],
                                   [4, -1.05, 4], [-4, -1.05, 4]), grey)
    light = mesh_mod.make_quad([-1, 3.0, -1], [1, 3.0, -1],
                               [1, 3.0, 1], [-1, 3.0, 1])
    b.add_area_emitter_shape(light, lm, (14.0, 13.0, 12.0))
    cam = make_perspective(tf.look_at([0, 0.8, 4.2], [0, 0, 0],
                                      [0, 1, 0]), 35, 1.0)
    b.set_camera(cam, RES, RES)
    return b.build(backend="brute"), 6, "media"


def scene_sss_slab():
    """Dipole subsurface slab under an area light — gates the SSS cache
    (incl. round-4 indirect irradiance) through the path tracer."""
    from mitsuba_jax.core import transform as tf
    from mitsuba_jax.render import mesh as mesh_mod
    from mitsuba_jax.render.camera import make_perspective
    from mitsuba_jax.render.scene import SceneBuilder

    b = SceneBuilder()
    skin = b.materials.lambertian((0.3, 0.25, 0.2))
    grey = b.materials.lambertian((0.5, 0.5, 0.5))
    black = b.materials.lambertian((0.0, 0.0, 0.0))
    b.add_shape(mesh_mod.make_box([-1, -0.25, -1], [1, 0.25, 1]), skin)
    b.add_subsurface(skin, sigma_s=(2.6, 3.2, 3.9),
                     sigma_a=(0.002, 0.003, 0.01), eta=1.3,
                     profile="dipole")
    b.add_shape(mesh_mod.make_quad([-4, -0.3, -4], [4, -0.3, -4],
                                   [4, -0.3, 4], [-4, -0.3, 4]), grey)
    light = mesh_mod.make_quad([-0.8, 2.5, -0.8], [0.8, 2.5, -0.8],
                               [0.8, 2.5, 0.8], [-0.8, 2.5, 0.8])
    b.add_area_emitter_shape(light, black, (16.0, 15.0, 14.0))
    cam = make_perspective(tf.look_at([0, 1.5, 3.4], [0, 0, 0],
                                      [0, 1, 0]), 35, 1.0)
    b.set_camera(cam, RES, RES)
    return b.build(backend="brute"), 4, "sss"


def scene_guided_cornell():
    """Cornell box rendered with guided sampling (one-sample-MIS mixture
    from a learned directional histogram) — gates the guiding estimator's
    unbiasedness against its own golden."""
    from mitsuba_jax.render.scene import cornell_box

    return cornell_box(RES, RES), 4, "guided"


SCENES = {
    "bunny_lambert": scene_bunny_lambert,
    "ward_spheres": scene_ward_spheres,
    "cornell": scene_cornell,
    "instanced_cluster": scene_instanced_cluster,
    "volumetric_tank": scene_volumetric_tank,
    "sss_slab": scene_sss_slab,
    "guided_cornell": scene_guided_cornell,
}


def render_stats(scene, depth, spp, seed, kind="path"):
    """Per-pixel mean + variance over spp samples; kind selects the
    estimator (path | media = per-shape interior volumes | sss =
    subsurface-cached path | guided = learned-mixture sampling)."""
    import jax.numpy as jnp

    from mitsuba_jax.integrators import PathConfig, render
    from mitsuba_jax.integrators.path import path_trace
    from mitsuba_jax.render.sampler import Sampler, sample_position

    cfg = PathConfig(max_depth=depth, spp=spp, remat=False)
    guide = None
    if kind == "sss" and scene.subsurface is not None \
            and scene.subsurface.irradiance is None:
        from mitsuba_jax.core.types import replace as _replace
        from mitsuba_jax.subsurface.dipole import prepare_scene_irradiance

        scene = _replace(
            scene, subsurface=prepare_scene_irradiance(scene, seed=99))
    if kind == "guided":
        from mitsuba_jax.integrators.guiding import make_guide

        v0 = np.asarray(scene.geom.v0)
        ext = v0.max(0) - v0.min(0)
        guide = make_guide(v0.min(0) - 0.01 * ext, v0.max(0) + 0.01 * ext,
                           res=12)

    w, h = scene.width, scene.height
    n = w * h * spp
    lane = jnp.arange(n)
    pixel_id = lane // spp
    sample_id = (lane % spp).astype(jnp.int32)
    px = (pixel_id % w).astype(jnp.float32)
    py = (pixel_id // w).astype(jnp.float32)
    sampler = Sampler(seed, pixel_id, sample_id)
    jitter = sampler.next_2d()
    offset = sample_position("independent", sample_id, spp, jitter)
    uv = jnp.stack([(px + offset[:, 0]) / w, (py + offset[:, 1]) / h], -1)
    ray = scene.camera.sample_ray(uv)
    if kind == "media":
        from mitsuba_jax.integrators.volpath import volpath_media_trace

        L, _ = volpath_media_trace(scene, ray, sampler, cfg)
    elif kind == "guided":
        # learn on a prefix pass, then gate the guided-sampling estimator
        _, aux = path_trace(scene, ray, Sampler(seed + 5, pixel_id,
                                                sample_id), cfg,
                            guide=guide, learn_guide=True)
        L, _ = path_trace(scene, ray, sampler, cfg, guide=aux["guide"],
                          guide_alpha=0.5, guide_sampling=True)
    else:
        L, _ = path_trace(scene, ray, sampler, cfg)
    Ls = L.reshape(h, w, spp, 3)
    return np.asarray(Ls.mean(axis=2)), np.asarray(Ls.var(axis=2, ddof=1))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(DIR, exist_ok=True)
    import sys
    only = set(sys.argv[1:])
    for name, make in SCENES.items():
        if only and name not in only:
            continue
        out = make()
        scene, depth = out[0], out[1]
        kind = out[2] if len(out) > 2 else "path"
        mean, var = render_stats(scene, depth, GOLDEN_SPP, seed=1234,
                                 kind=kind)
        np.savez_compressed(
            os.path.join(DIR, f"{name}.npz"),
            mean=mean.astype(np.float32), var=var.astype(np.float32),
            spp=GOLDEN_SPP, depth=depth)
        print(name, "mean", mean.mean(), "->", f"{name}.npz", flush=True)


if __name__ == "__main__":
    main()
