"""Stream layer + InstanceManager object graphs (reference stream.h /
serialization.h test surface)."""
import socket
import threading

import numpy as np
import pytest

from mitsuba_jax.core.streams import (
    FileStream, InstanceManager, MemoryStream, Serializable, SocketStream,
    Stream, ZlibStream, register_serializable,
)


def test_typed_scalar_roundtrip_both_endian():
    for be in (False, True):
        s = MemoryStream(big_endian=be)
        s.write_bool(True)
        s.write_i8(-5)
        s.write_u16(65535)
        s.write_i32(-123456)
        s.write_u64(2**63)
        s.write_f32(1.5)
        s.write_f64(-2.25)
        s.write_string("héllo")
        s.seek(0)
        assert s.read_bool() is True
        assert s.read_i8() == -5
        assert s.read_u16() == 65535
        assert s.read_i32() == -123456
        assert s.read_u64() == 2**63
        assert s.read_f32() == 1.5
        assert s.read_f64() == -2.25
        assert s.read_string() == "héllo"


def test_endianness_bytes_differ():
    a, b = MemoryStream(), MemoryStream(big_endian=True)
    a.write_u32(1)
    b.write_u32(1)
    assert a.getvalue() == b"\x01\x00\x00\x00"
    assert b.getvalue() == b"\x00\x00\x00\x01"


def test_array_roundtrip():
    s = MemoryStream()
    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    s.write_array(arr)
    s.seek(0)
    out = s.read_array()
    assert out.dtype == arr.dtype and out.shape == arr.shape
    np.testing.assert_array_equal(out, arr)


def test_file_stream_roundtrip(tmp_path):
    p = str(tmp_path / "t.bin")
    with FileStream(p, "wb") as s:
        s.write_string("file")
        s.write_f64(3.14)
    with FileStream(p, "rb") as s:
        assert s.read_string() == "file"
        assert s.read_f64() == 3.14


def test_zlib_stream_roundtrip():
    inner = MemoryStream()
    z = ZlibStream(inner)
    payload = b"abc" * 10000
    z.write_u64(len(payload))
    z.write(payload)
    z.finish()
    assert len(inner.getvalue()) < len(payload) // 10   # compressed
    inner.seek(0)
    z2 = ZlibStream(inner)
    n = z2.read_u64()
    assert z2._read_exact(n) == payload


def test_socket_stream():
    a, b = socket.socketpair()
    sa, sb = SocketStream(a), SocketStream(b)

    def server():
        assert sb.read_string() == "ping"
        sb.write_string("pong")

    t = threading.Thread(target=server)
    t.start()
    sa.write_string("ping")
    assert sa.read_string() == "pong"
    t.join(timeout=10)
    sa.close()
    sb.close()


@register_serializable
class _Node(Serializable):
    def __init__(self, name, payload=None, children=()):
        self.name = name
        self.payload = payload
        self.children = list(children)

    def serialize(self, stream, manager):
        stream.write_string(self.name)
        manager.put(stream, self.payload)
        manager.put(stream, self.children)

    def unserialize_fill(self, stream, manager):
        self.name = stream.read_string()
        self.payload = manager.get(stream)
        self.children = manager.get(stream)


def _roundtrip(value):
    s = MemoryStream()
    InstanceManager().put(s, value)
    s.seek(0)
    return InstanceManager().get(s)


def test_object_graph_primitives():
    v = {"a": [1, 2.5, None, True, "x", b"raw"], "b": (7, 8)}
    out = _roundtrip(v)
    assert out == v
    assert isinstance(out["b"], tuple)


def test_object_graph_shared_references_preserved():
    shared = np.ones(4, np.float32)
    node = _Node("root", payload=shared,
                 children=[_Node("a", payload=shared)])
    out = _roundtrip(node)
    # written once, restored as the SAME object (reference m_idToObj)
    assert out.payload is out.children[0].payload
    np.testing.assert_array_equal(out.payload, shared)


def test_object_graph_cycles():
    a = _Node("a")
    b = _Node("b", children=[a])
    a.children.append(b)            # cycle through containers
    out = _roundtrip([a])
    oa = out[0]
    ob = oa.children[0]
    assert ob.children[0] is oa


def test_unregistered_class_raises():
    class Foo(Serializable):
        def serialize(self, stream, manager):
            pass

    with pytest.raises(TypeError):
        _roundtrip(Foo())
