"""Interactive preview app (gui.py — the mtsgui analog): serve a tiny
scene, poll state, decode a frame, orbit the camera, confirm restart."""
import io
import json
import time
import urllib.request

import numpy as np


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read()


def test_gui_preview_end_to_end():
    from mitsuba_jax.gui import serve
    from mitsuba_jax.integrators import PathConfig
    from mitsuba_jax.io.bitmap import read_png
    from mitsuba_jax.render.scene import cornell_box

    scene = cornell_box(24, 24, backend="brute")
    cfg = PathConfig(max_depth=2, spp=2, remat=False)
    httpd, session, t = serve(scene, cfg, port=0, open_msg=False)
    port = httpd.server_address[1]
    srv = None
    import threading

    srv = threading.Thread(target=httpd.serve_forever, daemon=True)
    srv.start()
    try:
        page = _get(port, "/").decode()
        assert "canvas" in page
        # wait for the first accumulated pass
        for _ in range(300):
            st = json.loads(_get(port, "/state"))
            if st["pass"] >= 1:
                break
            time.sleep(0.2)
        assert st["pass"] >= 1 and st["width"] == 24
        png = _get(port, "/frame.png")
        import tempfile, os

        fd, p = tempfile.mkstemp(suffix=".png")
        os.close(fd)
        with open(p, "wb") as f:
            f.write(png)
        img = read_png(p)
        os.unlink(p)
        assert img.shape[:2] == (24, 24)
        assert img.mean() > 1            # lit scene, tonemapped uint8
        # orbit: generation bumps and the pass counter restarts
        g0 = st["gen"]
        _get(port, "/camera?yaw=0.3")
        st2 = json.loads(_get(port, "/state"))
        assert st2["gen"] == g0 + 1
        old = np.asarray(session.origin)
        _get(port, "/camera?dolly=0.5")
        assert not np.allclose(session.origin, old)
    finally:
        session.stop = True
        httpd.shutdown()
        srv.join(timeout=10)
        t.join(timeout=60)
