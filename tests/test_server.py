"""Network render service (mtssrv analog): handshake, ping, render
round-trip over localhost TCP, pipe mode, and error reporting."""
import io
import struct

import numpy as np
import pytest

from mitsuba_jax.parallel.server import (
    MAGIC, PROTOCOL_VERSION, RenderClient, RenderServer, serve_pipe,
)

TINY_SCENE = """<scene>
  <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
  <camera type="perspective">
    <float name="fov" value="60"/>
    <transform name="toWorld">
      <lookAt ox="0" oy="0" oz="3" tx="0" ty="1.5" tz="1" ux="0" uy="1" uz="0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="4"/></sampler>
    <film type="exrfilm">
      <integer name="width" value="8"/><integer name="height" value="8"/>
    </film>
  </camera>
  <shape type="obj">
    <string name="filename" value="meshes/cbox_walls.obj"/>
    <bsdf type="lambertian"><rgb name="reflectance" value="0.5 0.5 0.5"/></bsdf>
  </shape>
  <shape type="sphere">
    <point name="center" x="0" y="1.5" z="1"/>
    <float name="radius" value="0.3"/>
    <luminaire type="area"><rgb name="intensity" value="10 10 10"/></luminaire>
  </shape>
</scene>"""


@pytest.fixture(scope="module")
def server():
    srv = RenderServer(host="127.0.0.1", port=0)
    srv.start()
    yield srv
    srv.stop()


def test_ping(server):
    with RenderClient("127.0.0.1", server.port) as c:
        info = c.ping()
    assert info["status"] == "ok"
    assert info["devices"] >= 1


def test_render_roundtrip_matches_local(server):
    import os

    from mitsuba_jax.integrators.path import PathConfig, render
    from mitsuba_jax.io.xml import load_scene_string

    base = os.path.join(os.path.dirname(__file__), "..", "scenes")
    with RenderClient("127.0.0.1", server.port) as c:
        remote = c.render(TINY_SCENE, seed=3, base_dir=base)
    assert remote.shape == (8, 8, 3)
    assert np.isfinite(remote).all()
    assert remote.sum() > 0  # emitter visible, not an all-black frame
    scene, cfg = load_scene_string(TINY_SCENE, base_dir=base)
    local, _ = render(scene, PathConfig(max_depth=3, spp=4, remat=False), seed=3)
    np.testing.assert_allclose(remote, np.asarray(local), rtol=1e-6, atol=1e-7)


def test_spp_override(server):
    import os

    base = os.path.join(os.path.dirname(__file__), "..", "scenes")
    with RenderClient("127.0.0.1", server.port) as c:
        a = c.render(TINY_SCENE, spp=1, seed=0, base_dir=base)
        b = c.render(TINY_SCENE, spp=16, seed=0, base_dir=base)
    # different spp -> different estimates (same seed)
    assert not np.allclose(a, b)


def test_bad_scene_reports_error_and_keeps_serving(server):
    with RenderClient("127.0.0.1", server.port) as c:
        with pytest.raises(RuntimeError, match="remote render failed"):
            c.render("<scene version='0.2.1'><bogus/></scene>")
        # connection must survive the failed request
        assert c.ping()["status"] == "ok"


def test_protocol_version_mismatch_rejected(server):
    import socket

    s = socket.create_connection(("127.0.0.1", server.port), timeout=10)
    try:
        s.sendall(MAGIC + struct.pack("<I", PROTOCOL_VERSION + 99))
        s.settimeout(10)
        reply = s.recv(8)
        # server replies with ITS version then drops the connection
        assert reply[:4] == MAGIC
        assert struct.unpack("<I", reply[4:])[0] == PROTOCOL_VERSION
        rest = s.recv(1)
        assert rest == b""  # closed
    finally:
        s.close()


def test_pipe_mode_matches_tcp():
    """serve_pipe speaks the same framing over file objects (the
    reference's `mtssrv -ls` stdin mode for SSH tunnels)."""
    import os
    import threading

    from mitsuba_jax.parallel.server import (
        _handshake_client, _read_msg, _write_msg,
    )

    c2s_r, c2s_w = os.pipe()
    s2c_r, s2c_w = os.pipe()
    srv_r = os.fdopen(c2s_r, "rb")
    srv_w = os.fdopen(s2c_w, "wb")
    cli_r = os.fdopen(s2c_r, "rb")
    cli_w = os.fdopen(c2s_w, "wb")
    t = threading.Thread(target=serve_pipe, args=(srv_r, srv_w), daemon=True)
    t.start()
    _handshake_client(cli_r, cli_w)
    _write_msg(cli_w, {"cmd": "ping"})
    header, _ = _read_msg(cli_r)
    assert header["status"] == "ok"
    _write_msg(cli_w, {"cmd": "quit"})
    _read_msg(cli_r)
    t.join(timeout=10)
    assert not t.is_alive()
    for f in (cli_r, cli_w, srv_r, srv_w):
        try:
            f.close()
        except OSError:
            pass


def test_ssh_transport_subprocess_pipe(tmp_path):
    """RenderClient.over_ssh with ssh_cmd=() = the SSHStream wire path
    (sshstream.cpp) minus the ssh hop: a real subprocess speaking
    --listen-stdio over its stdio."""
    import subprocess
    import sys

    from mitsuba_jax.parallel.server import RenderClient

    xml = """<scene>
      <integrator type="path"><integer name="maxDepth" value="2"/></integrator>
      <camera type="perspective">
        <transform name="toWorld">
          <lookAt ox="0" oy="0" oz="-3" tx="0" ty="0" tz="0"
                  ux="0" uy="1" uz="0"/>
        </transform>
        <sampler type="independent">
          <integer name="sampleCount" value="2"/>
        </sampler>
        <film type="exrfilm">
          <integer name="width" value="16"/>
          <integer name="height" value="16"/>
        </film>
      </camera>
      <luminaire type="constant"><rgb name="intensity" value="0.5 0.5 0.5"/></luminaire>
      <shape type="sphere">
        <point name="center" x="0" y="0" z="0"/>
        <float name="radius" value="0.4"/>
        <bsdf type="lambertian"><rgb name="reflectance" value="0.5 0.5 0.5"/></bsdf>
      </shape>
    </scene>"""
    # the spawned server must not grab the test host's accelerator (and
    # env JAX_PLATFORMS is force-set in some images): pin CPU in-process
    boot = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            "from mitsuba_jax.cli import main; "
            "raise SystemExit(main(['--listen-stdio']))")
    cli = RenderClient.over_ssh(
        "unused", ssh_cmd=(),
        remote_cmd=(sys.executable, "-c", boot))
    try:
        assert cli.ping()["status"] == "ok"
        img = cli.render(xml, seed=1)
        assert img.shape == (16, 16, 3)
        # background pixels see the constant luminaire directly
        assert abs(float(img[0, 0].mean()) - 0.5) < 1e-3
        assert float(img.mean()) > 0.2
    finally:
        cli.close()
    assert cli._proc.returncode == 0
