"""`mtsutil` — utility tool launcher, parity with the reference's
`mtsutil` front-end (src/mitsuba/mtsutil.cpp:365: loads `Utility`
plugins by name and dispatches argv to them).

    python -m mitsuba_jax.mtsutil <tool> [args...]

Tools (each mirrors a reference utility or testcase mode):
    tonemap    HDR -> LDR with exposure/gamma (src/utils tonemapper)
    addimages  weighted sum of two images (src/utils/addimages.cpp)
    joinrgb    merge three single-channel images into RGB
    info       scene statistics from XML (shapes/tris/materials/emitters)
    raybench   ray-intersection throughput benchmark
    ttest      Welch t-test between two renders (testcase analyze mode,
               reference testcase.cpp TestSupervisor::analyze)
"""
from __future__ import annotations

import argparse
import sys


def _cmd_tonemap(argv):
    ap = argparse.ArgumentParser(prog="mtsutil tonemap")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-e", "--exposure", type=float, default=0.0,
                    help="exposure in EV stops")
    ap.add_argument("-g", "--gamma", type=float, default=-1.0,
                    help="gamma (-1 = sRGB curve)")
    a = ap.parse_args(argv)
    from mitsuba_jax.io.bitmap import read_image, write_image
    from mitsuba_jax.utils.tonemap import tonemap

    img = read_image(a.input)
    write_image(a.output, tonemap(img, exposure_ev=a.exposure, gamma=a.gamma))
    print(f"wrote {a.output}")
    return 0


def _cmd_addimages(argv):
    ap = argparse.ArgumentParser(prog="mtsutil addimages")
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("output")
    ap.add_argument("--wa", type=float, default=1.0)
    ap.add_argument("--wb", type=float, default=1.0)
    a = ap.parse_args(argv)
    from mitsuba_jax.io.bitmap import read_image, write_image
    from mitsuba_jax.utils.tonemap import add_images

    out = add_images(read_image(a.a), read_image(a.b), a.wa, a.wb)
    write_image(a.output, out)
    print(f"wrote {a.output}")
    return 0


def _cmd_joinrgb(argv):
    ap = argparse.ArgumentParser(prog="mtsutil joinrgb")
    ap.add_argument("r")
    ap.add_argument("g")
    ap.add_argument("b")
    ap.add_argument("output")
    a = ap.parse_args(argv)
    from mitsuba_jax.io.bitmap import read_image, write_image
    from mitsuba_jax.utils.tonemap import join_rgb

    out = join_rgb(read_image(a.r), read_image(a.g), read_image(a.b))
    write_image(a.output, out)
    print(f"wrote {a.output}")
    return 0


def _cmd_info(argv):
    ap = argparse.ArgumentParser(prog="mtsutil info")
    ap.add_argument("scene")
    ap.add_argument("-D", "--define", action="append", default=[])
    a = ap.parse_args(argv)
    # info is a host-side diagnostic — keep the scene off the accelerator
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from mitsuba_jax.io.xml import load_scene

    params = dict(d.split("=", 1) for d in a.define)
    scene, cfg = load_scene(a.scene, params=params)
    g = scene.geom
    v0 = np.asarray(g.v0)
    print(f"scene        : {a.scene}")
    print(f"resolution   : {scene.width}x{scene.height}")
    print(f"integrator   : {cfg.get('integrator')}  "
          f"maxDepth={cfg.get('maxDepth')}  spp={cfg.get('sampleCount')}")
    print(f"triangles    : {v0.shape[0]}")
    print(f"shapes       : {int(np.asarray(g.shape_id).max()) + 1}")
    print(f"materials    : {scene.materials.n_materials}")
    print(f"emitters     : {scene.emitters.n_emitters}")
    lo = v0.min(0)
    hi = (v0 + np.asarray(g.e1) + np.asarray(g.e2)).max(0)
    print(f"bounds       : [{lo[0]:.3g} {lo[1]:.3g} {lo[2]:.3g}] .. "
          f"[{hi[0]:.3g} {hi[1]:.3g} {hi[2]:.3g}]")
    return 0


def _cmd_raybench(argv):
    ap = argparse.ArgumentParser(prog="mtsutil raybench")
    ap.add_argument("scene", nargs="?", default=None,
                    help="scene XML (default: built-in cornell box)")
    ap.add_argument("-n", type=int, default=1_000_000)
    ap.add_argument("--shadow", action="store_true")
    ap.add_argument("-f", "--fit-costs", action="store_true",
                    help="fit SAH traversal/intersection cost constants "
                         "instead of benchmarking (kdbench -f analog)")
    a = ap.parse_args(argv)
    from mitsuba_jax.utils.raybench import bench_rays, find_costs

    if a.scene:
        from mitsuba_jax.io.xml import load_scene

        scene, _ = load_scene(a.scene)
    else:
        from mitsuba_jax.render.scene import cornell_box

        scene = cornell_box(width=64, height=64)
    if a.fit_costs:
        tc, ic, fit = find_costs(scene.geom, n=min(a.n, 200_000))
        print({"traversal_cost": tc, "intersection_cost": ic, **fit})
        return 0
    stats = bench_rays(scene.geom, n=a.n, shadow=a.shadow)
    print(stats)
    return 0


def _cmd_ttest(argv):
    ap = argparse.ArgumentParser(prog="mtsutil ttest")
    ap.add_argument("a", help="image or .m film A")
    ap.add_argument("b", help="image or .m film B")
    ap.add_argument("--sig", type=float, default=0.01)
    a = ap.parse_args(argv)

    if a.a.endswith(".m") and a.b.endswith(".m"):
        # matlab-style films carry per-pixel variance -> real Welch test
        from mitsuba_jax.io.bitmap import read_mfilm
        from mitsuba_jax.utils.ttest import welch_ttest_images

        fa, fb = read_mfilm(a.a), read_mfilm(a.b)
        n1 = float(fa["nSamples"].ravel()[0])
        n2 = float(fb["nSamples"].ravel()[0])
        res = welch_ttest_images(fa["pixels"], fa["variance"], n1,
                                 fb["pixels"], fb["variance"], n2,
                                 significance=a.sig)
        print(f"failed {res.failed_pixels}/{res.total_pixels} px, "
              f"min p={res.min_p_value:.4g} -> "
              f"{'MATCH' if res.passed else 'DIFFER'}")
        return 0 if res.passed else 1
    # plain images: relative-error gate (reference ERelativeError mode)
    from mitsuba_jax.io.bitmap import read_image
    from mitsuba_jax.utils.ttest import relative_error_test

    ok = relative_error_test(read_image(a.a), read_image(a.b))
    print("MATCH" if ok else "DIFFER")
    return 0 if ok else 1


_TOOLS = {
    "tonemap": _cmd_tonemap,
    "addimages": _cmd_addimages,
    "joinrgb": _cmd_joinrgb,
    "info": _cmd_info,
    "raybench": _cmd_raybench,
    "ttest": _cmd_ttest,
}


def _cmd_uflakefit(argv):
    """Fit σ_t of the gaussian microflake distribution as a sin-power
    series (reference src/utils/uflakefit.cpp, which produced the
    fiberSigmaTCoeffs table in microflake_fiber.h). Here the fit runs
    per-stddev at scene build, so this tool mainly reports/exports."""
    ap = argparse.ArgumentParser(prog="mtsutil uflakefit")
    ap.add_argument("stddev", type=float, nargs="?", default=None,
                    help="single stddev to fit (prints coefficients)")
    ap.add_argument("--table", type=int, default=0, metavar="N",
                    help="emit an N-row table over stddev in (0, 4] with "
                         "the reference's quartic row mapping")
    ap.add_argument("--coeffs", type=int, default=10)
    a = ap.parse_args(argv)
    from mitsuba_jax.media.phase import fit_fiber_sigma_t

    if a.table:
        print(f"# {a.table} rows x {a.coeffs} coeffs; row i -> stddev = "
              f"4*((i+1)/{a.table})^4")
        worst = 0.0
        for i in range(a.table):
            sd = 4.0 * ((i + 1) / a.table) ** 4
            c, err = fit_fiber_sigma_t(sd, n_coeffs=a.coeffs)
            worst = max(worst, err)
            print(" ".join(f"{v:.10e}" for v in c))
        print(f"# max fit error {worst:.3e}")
        return 0
    if a.stddev is None:
        ap.error("need a stddev or --table N")
    c, err = fit_fiber_sigma_t(a.stddev, n_coeffs=a.coeffs)
    print("coeffs:", " ".join(f"{v:.8e}" for v in c))
    print(f"max fit error: {err:.3e}")
    return 0


_TOOLS["uflakefit"] = _cmd_uflakefit


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    tool = argv[0]
    if tool not in _TOOLS:
        print(f"unknown tool '{tool}'; available: {', '.join(sorted(_TOOLS))}",
              file=sys.stderr)
        return 2
    return _TOOLS[tool](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
