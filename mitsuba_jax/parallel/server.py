"""Network render service — analog of the reference's `mtssrv`
(src/mitsuba/mtssrv.cpp:90, TCP accept loop mtssrv.cpp:282-318) and the
remote-scheduling layer (sched_remote.cpp:605 lines of RemoteWorker /
StreamBackend wire protocol).

Re-design: the reference ships *work units* (rectangular film blocks) to
remote CPU worker pools over a custom object-serialization stream.  Within
one job, scaling is SPMD over the device mesh (parallel/mesh.py) —
there is nothing to gain from shipping blocks between hosts of one slice.
What remains genuinely useful from mtssrv is the *service* form factor:
a long-lived node that holds warm compiled executables and renders scenes
on request.  So the wire protocol here is scene-level, not block-level:

    client ──(scene XML + settings)──▶ server (jit-cached render) ──(image)──▶

Framing: 8-byte magic+version handshake (the reference refuses mismatched
protocol versions, mtssrv.cpp/sched_remote.cpp), then length-prefixed
JSON header + raw payload per message.  Repeated renders of the same
(resolution, spp, depth) hit the server's XLA compile cache, which is the
equivalent of the reference keeping worker pools warm.

The reference's `-ls` stdin mode (SSH tunneling) maps to `serve_pipe`,
which speaks the same framing over arbitrary file objects.
"""
from __future__ import annotations

import io
import json
import socket
import socketserver
import struct
import threading

import numpy as np

from mitsuba_jax.utils.compile_cache import enable_compile_cache

# default port matches the reference (include/mitsuba/mitsuba.h:44)
DEFAULT_PORT = 7554
MAGIC = b"MTPU"
PROTOCOL_VERSION = 1


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def _write_msg(wfile, header: dict, payload: bytes = b"") -> None:
    hb = json.dumps(header).encode()
    wfile.write(struct.pack("<I", len(hb)) + hb)
    wfile.write(struct.pack("<Q", len(payload)) + payload)
    wfile.flush()


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return buf


def _read_msg(rfile):
    (hlen,) = struct.unpack("<I", _read_exact(rfile, 4))
    header = json.loads(_read_exact(rfile, hlen))
    (plen,) = struct.unpack("<Q", _read_exact(rfile, 8))
    payload = _read_exact(rfile, plen) if plen else b""
    return header, payload


def _handshake_server(rfile, wfile) -> None:
    got = _read_exact(rfile, 8)
    magic, ver = got[:4], struct.unpack("<I", got[4:])[0]
    if magic != MAGIC:
        raise ConnectionError(f"bad magic {magic!r}")
    # refuse mismatched protocol versions, like the reference's handshake
    wfile.write(MAGIC + struct.pack("<I", PROTOCOL_VERSION))
    wfile.flush()
    if ver != PROTOCOL_VERSION:
        raise ConnectionError(f"protocol version mismatch: {ver}")


def _handshake_client(rfile, wfile) -> None:
    wfile.write(MAGIC + struct.pack("<I", PROTOCOL_VERSION))
    wfile.flush()
    got = _read_exact(rfile, 8)
    if got[:4] != MAGIC:
        raise ConnectionError(f"bad magic from server: {got[:4]!r}")
    ver = struct.unpack("<I", got[4:])[0]
    if ver != PROTOCOL_VERSION:
        raise ConnectionError(f"server protocol version {ver}, "
                              f"client {PROTOCOL_VERSION}")


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

def _render_request(header: dict, payload: bytes) -> np.ndarray:
    """Parse a scene from XML bytes and render it with the requested
    overrides.  Runs on the serving host's local devices."""
    from mitsuba_jax.integrators.path import PathConfig, render
    from mitsuba_jax.io.xml import load_scene_string

    defines = header.get("defines", {})
    scene, cfg = load_scene_string(payload.decode(), params=defines,
                                   base_dir=header.get("base_dir", "."))
    depth = int(header.get("depth") or
                (cfg["maxDepth"] if cfg["maxDepth"] > 0 else 12))
    spp = int(header.get("spp") or cfg["sampleCount"])
    seed = int(header.get("seed", 0))
    pcfg = PathConfig(max_depth=depth, spp=spp, remat=False)
    if cfg["integrator"] in ("volpath", "volpath_simple") or "medium" in cfg:
        from mitsuba_jax.integrators.volpath import render_volpath
        from mitsuba_jax.media import no_medium

        img, _ = render_volpath(
            scene, cfg.get("medium", no_medium()), pcfg, seed=seed,
            mis=cfg["integrator"] != "volpath_simple",
        )
    else:
        img, _ = render(scene, pcfg, seed=seed)
    return np.asarray(img, np.float32)


def _serve_connection(rfile, wfile) -> None:
    """One session: handshake, then a command loop until quit/EOF."""
    _handshake_server(rfile, wfile)
    while True:
        try:
            header, payload = _read_msg(rfile)
        except ConnectionError:
            return
        cmd = header.get("cmd")
        if cmd == "ping":
            import jax
            _write_msg(wfile, {
                "status": "ok",
                "devices": jax.local_device_count(),
                "backend": jax.default_backend(),
            })
        elif cmd == "render":
            try:
                img = _render_request(header, payload)
                buf = io.BytesIO()
                np.save(buf, img)
                _write_msg(wfile, {"status": "ok", "shape": list(img.shape)},
                           buf.getvalue())
            except Exception as e:  # report, keep serving
                _write_msg(wfile, {"status": "error", "message": str(e)})
        elif cmd == "quit":
            _write_msg(wfile, {"status": "ok"})
            return
        else:
            _write_msg(wfile, {"status": "error",
                               "message": f"unknown command {cmd!r}"})


class RenderServer:
    """Threaded TCP render service (mtssrv analog).

    >>> srv = RenderServer(port=0); srv.start()
    >>> ... RenderClient("localhost", srv.port) ...
    >>> srv.stop()
    """

    def __init__(self, host: str = "0.0.0.0", port: int = DEFAULT_PORT):
        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    _serve_connection(self.rfile, self.wfile)
                except (ConnectionError, OSError):
                    pass

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        enable_compile_cache()
        self._srv = _Server((host, port), _Handler)
        self.port = self._srv.server_address[1]
        self._thread = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def serve_forever(self) -> None:
        self._srv.serve_forever()


def serve_pipe(rfile, wfile) -> None:
    """Serve one session over arbitrary streams — the analog of the
    reference's `mtssrv -ls` stdin mode used for SSH tunneling
    (mtssrv.cpp:264-266)."""
    enable_compile_cache()
    _serve_connection(rfile, wfile)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class RenderClient:
    """Client for RenderServer — submit scene XML, receive the HDR image."""

    def __init__(self, host: str = "localhost", port: int = DEFAULT_PORT,
                 timeout: float = 600.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._proc = None
        self._r = self._sock.makefile("rb")
        self._w = self._sock.makefile("wb")
        _handshake_client(self._r, self._w)

    @classmethod
    def over_pipe(cls, rfile, wfile, proc=None) -> "RenderClient":
        """Attach to a server speaking the wire protocol over arbitrary
        streams (the analog of the reference's Stream-polymorphic
        RemoteWorker: FileStream/SocketStream/SSHStream all carry the
        same protocol, sshstream.cpp / mtssrv -ls)."""
        self = cls.__new__(cls)
        self._sock = None
        self._proc = proc
        self._r = rfile
        self._w = wfile
        _handshake_client(self._r, self._w)
        return self

    @classmethod
    def over_ssh(cls, host: str,
                 remote_cmd=("python", "-m", "mitsuba_jax",
                             "--listen-stdio"),
                 ssh_cmd=None) -> "RenderClient":
        """Spawn `ssh host <remote_cmd>` and run the render protocol over
        its stdio — the reference's SSHStream (sshstream.cpp: batch-mode
        ssh with the command appended). `host` may be user@host; pass
        ssh_cmd to override the transport entirely (e.g. for tests:
        ssh_cmd=() runs remote_cmd locally)."""
        import subprocess

        if ssh_cmd is None:
            ssh_cmd = ("ssh", "-oBatchMode=yes", "-x", host)
        proc = subprocess.Popen(
            tuple(ssh_cmd) + tuple(remote_cmd),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        return cls.over_pipe(proc.stdout, proc.stdin, proc=proc)

    def ping(self) -> dict:
        _write_msg(self._w, {"cmd": "ping"})
        header, _ = _read_msg(self._r)
        return header

    def render(self, scene_xml: str, spp: int | None = None,
               depth: int | None = None, seed: int = 0,
               defines: dict | None = None,
               base_dir: str = ".") -> np.ndarray:
        """base_dir: directory on the SERVER for relative mesh/texture
        paths (the reference ships dependent files over the stream;
        here a shared filesystem or pre-staged assets are assumed)."""
        _write_msg(self._w, {
            "cmd": "render", "spp": spp, "depth": depth, "seed": seed,
            "defines": defines or {}, "base_dir": base_dir,
        }, scene_xml.encode())
        header, payload = _read_msg(self._r)
        if header.get("status") != "ok":
            raise RuntimeError(f"remote render failed: "
                               f"{header.get('message')}")
        return np.load(io.BytesIO(payload))

    def close(self) -> None:
        try:
            _write_msg(self._w, {"cmd": "quit"})
            _read_msg(self._r)
        except (ConnectionError, OSError):
            pass
        if self._sock is not None:
            self._sock.close()
        else:
            self._w.close()
            self._r.close()
        if self._proc is not None:
            self._proc.wait(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
