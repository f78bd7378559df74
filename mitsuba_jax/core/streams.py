"""Typed stream abstraction + object-graph serialization.

Re-design of the reference's libcore stream layer
(include/mitsuba/core/stream.h, fstream.h, mstream.h, sstream.h,
zstream.h) and its InstanceManager object-graph serializer
(include/mitsuba/core/serialization.h, libcore/serialization.cpp):

  * Stream: endianness-aware typed scalar/string/array accessors over an
    abstract byte transport.
  * FileStream / MemoryStream / SocketStream / ZlibStream: the four
    transports the reference ships (SSHStream lives in parallel.server
    as RenderClient.over_ssh — it is a transport for the render
    protocol, not a byte stream duplicated here).
  * InstanceManager: reference-preserving object-graph save/load for
    registered Serializable classes — shared subobjects are written
    once and restored as shared (the reference's m_idToObj/m_objToId
    maps); cycles are supported through two-phase instantiation.

Device state does NOT go through this layer: jax pytrees checkpoint via
utils/checkpoint.py (orbax-style host transfer). This layer serializes
host-side object graphs (scene descriptions, caches, session state) the
way the reference streams its ConfigurableObjects.
"""
from __future__ import annotations

import io
import struct
import zlib

import numpy as np

__all__ = [
    "Stream", "FileStream", "MemoryStream", "SocketStream", "ZlibStream",
    "Serializable", "register_serializable", "InstanceManager",
]


class Stream:
    """Abstract typed stream (reference stream.h Stream).

    Subclasses implement `read(n) -> bytes`, `write(data)`, and
    optionally seek/tell/size. Typed accessors are little-endian by
    default; pass big_endian=True for network byte order (the reference
    exposes setByteOrder)."""

    def __init__(self, big_endian: bool = False):
        self._bo = ">" if big_endian else "<"

    # transport interface ---------------------------------------------------
    def read(self, n: int) -> bytes:
        raise NotImplementedError

    def write(self, data: bytes) -> None:
        raise NotImplementedError

    def seek(self, pos: int) -> None:
        raise NotImplementedError(f"{type(self).__name__} is not seekable")

    def tell(self) -> int:
        raise NotImplementedError(f"{type(self).__name__} is not seekable")

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # typed accessors -------------------------------------------------------
    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.read(n - len(buf))
            if not chunk:
                raise EOFError(f"stream ended ({len(buf)}/{n} bytes)")
            buf += chunk
        return buf

    def _w(self, fmt: str, value) -> None:
        self.write(struct.pack(self._bo + fmt, value))

    def _r(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(self._bo + fmt, self._read_exact(size))[0]

    def write_bool(self, v): self._w("?", bool(v))
    def read_bool(self): return self._r("?")
    def write_i8(self, v): self._w("b", int(v))
    def read_i8(self): return self._r("b")
    def write_u8(self, v): self._w("B", int(v))
    def read_u8(self): return self._r("B")
    def write_i16(self, v): self._w("h", int(v))
    def read_i16(self): return self._r("h")
    def write_u16(self, v): self._w("H", int(v))
    def read_u16(self): return self._r("H")
    def write_i32(self, v): self._w("i", int(v))
    def read_i32(self): return self._r("i")
    def write_u32(self, v): self._w("I", int(v))
    def read_u32(self): return self._r("I")
    def write_i64(self, v): self._w("q", int(v))
    def read_i64(self): return self._r("q")
    def write_u64(self, v): self._w("Q", int(v))
    def read_u64(self): return self._r("Q")
    def write_f32(self, v): self._w("f", float(v))
    def read_f32(self): return self._r("f")
    def write_f64(self, v): self._w("d", float(v))
    def read_f64(self): return self._r("d")

    def write_string(self, s: str) -> None:
        data = s.encode("utf-8")
        self.write_u32(len(data))
        self.write(data)

    def read_string(self) -> str:
        n = self.read_u32()
        return self._read_exact(n).decode("utf-8")

    def write_array(self, arr) -> None:
        """numpy array with dtype + shape header (the reference writes
        raw typed spans; shape-carrying arrays are the numpy-native
        equivalent)."""
        arr = np.asarray(arr)
        self.write_string(arr.dtype.str)
        self.write_u8(arr.ndim)
        for d in arr.shape:
            self.write_u64(d)
        data = np.ascontiguousarray(arr).tobytes()
        self.write_u64(len(data))
        self.write(data)

    def read_array(self) -> np.ndarray:
        dtype = np.dtype(self.read_string())
        ndim = self.read_u8()
        shape = tuple(self.read_u64() for _ in range(ndim))
        n = self.read_u64()
        return np.frombuffer(self._read_exact(n), dtype).reshape(shape).copy()


class FileStream(Stream):
    """Stream over a file (reference fstream.h)."""

    def __init__(self, path: str, mode: str = "rb",
                 big_endian: bool = False):
        super().__init__(big_endian)
        self._f = open(path, mode)

    def read(self, n): return self._f.read(n)
    def write(self, data): self._f.write(data)
    def seek(self, pos): self._f.seek(pos)
    def tell(self): return self._f.tell()
    def close(self): self._f.close()


class MemoryStream(Stream):
    """Stream over an in-memory buffer (reference mstream.h)."""

    def __init__(self, data: bytes = b"", big_endian: bool = False):
        super().__init__(big_endian)
        self._buf = io.BytesIO(data)

    def read(self, n): return self._buf.read(n)
    def write(self, data): self._buf.write(data)
    def seek(self, pos): self._buf.seek(pos)
    def tell(self): return self._buf.tell()
    def getvalue(self) -> bytes: return self._buf.getvalue()


class SocketStream(Stream):
    """Stream over a connected socket (reference sstream.h)."""

    def __init__(self, sock, big_endian: bool = False):
        super().__init__(big_endian)
        self._sock = sock

    def read(self, n): return self._sock.recv(n)

    def write(self, data):
        self._sock.sendall(data)

    def close(self):
        self._sock.close()


class ZlibStream(Stream):
    """Compressing/decompressing wrapper around a child stream
    (reference zstream.h). Write side buffers until finish()/close()."""

    def __init__(self, child: Stream, level: int = 6,
                 big_endian: bool = False):
        super().__init__(big_endian)
        self._child = child
        self._comp = zlib.compressobj(level)
        self._decomp = zlib.decompressobj()
        self._rbuf = b""
        self._finished = False

    def write(self, data):
        out = self._comp.compress(data)
        if out:
            self._child.write(out)

    def finish(self) -> None:
        if not self._finished:
            self._child.write(self._comp.flush())
            self._finished = True

    def read(self, n):
        while len(self._rbuf) < n:
            chunk = self._child.read(65536)
            if not chunk:
                self._rbuf += self._decomp.flush()
                break
            self._rbuf += self._decomp.decompress(chunk)
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    def close(self):
        self.finish()


# ---------------------------------------------------------------------------
# object-graph serialization (reference serialization.h InstanceManager)
# ---------------------------------------------------------------------------

_SERIALIZABLE_REGISTRY: dict = {}


class Serializable:
    """Protocol: classes provide serialize(stream, manager) plus ONE of

      * unserialize_fill(self, stream, manager): two-phase — the manager
        allocates via __new__, registers the instance, THEN fills it, so
        cycles through the object's own subtree resolve (the reference's
        registerInstance-before-unserialize, serialization.cpp:86);
      * classmethod unserialize(cls, stream, manager) -> instance:
        one-phase, for classes that can't be __new__-allocated — direct
        cycles back into the instance are not supported on this path.

    Register with @register_serializable so the manager can
    re-instantiate by class name (reference serialization.cpp:101)."""

    def serialize(self, stream: Stream, manager: "InstanceManager") -> None:
        raise NotImplementedError

    def unserialize_fill(self, stream: Stream,
                         manager: "InstanceManager") -> None:
        raise NotImplementedError

    @classmethod
    def unserialize(cls, stream: Stream,
                    manager: "InstanceManager") -> "Serializable":
        raise NotImplementedError


def register_serializable(cls):
    _SERIALIZABLE_REGISTRY[cls.__name__] = cls
    return cls


# value-tag bytes for the generic object graph
_T_NONE, _T_BOOL, _T_INT, _T_FLOAT, _T_STR, _T_BYTES = range(6)
_T_LIST, _T_TUPLE, _T_DICT, _T_ARRAY, _T_OBJ, _T_REF = range(6, 12)


class InstanceManager:
    """Reference-preserving object-graph writer/reader.

    Shared subobjects (lists/dicts/arrays/Serializables reachable more
    than once) are serialized ONCE and read back as shared — the
    reference's m_objToId / m_idToObj maps. Containers support cycles;
    Serializable cycles are supported when references occur through a
    container."""

    def __init__(self):
        self._obj_to_id: dict = {}
        self._id_to_obj: dict = {}
        self._next_id = 0

    # --- write -------------------------------------------------------------
    def put(self, stream: Stream, value) -> None:
        if value is None:
            stream.write_u8(_T_NONE)
        elif isinstance(value, bool):
            stream.write_u8(_T_BOOL)
            stream.write_bool(value)
        elif isinstance(value, int):
            stream.write_u8(_T_INT)
            stream.write_i64(value)
        elif isinstance(value, float):
            stream.write_u8(_T_FLOAT)
            stream.write_f64(value)
        elif isinstance(value, str):
            stream.write_u8(_T_STR)
            stream.write_string(value)
        elif isinstance(value, bytes):
            stream.write_u8(_T_BYTES)
            stream.write_u64(len(value))
            stream.write(value)
        else:
            oid = self._obj_to_id.get(id(value))
            if oid is not None:
                stream.write_u8(_T_REF)
                stream.write_u32(oid)
                return
            oid = self._next_id
            self._next_id += 1
            # keep the object alive (id() stability) for the manager's life
            self._obj_to_id[id(value)] = oid
            self._id_to_obj[oid] = value
            if isinstance(value, (list, tuple)):
                stream.write_u8(_T_LIST if isinstance(value, list)
                                else _T_TUPLE)
                stream.write_u32(len(value))
                for item in value:
                    self.put(stream, item)
            elif isinstance(value, dict):
                stream.write_u8(_T_DICT)
                stream.write_u32(len(value))
                for k, v in value.items():
                    self.put(stream, k)
                    self.put(stream, v)
            elif isinstance(value, np.ndarray):
                stream.write_u8(_T_ARRAY)
                stream.write_array(value)
            elif isinstance(value, Serializable):
                name = type(value).__name__
                if name not in _SERIALIZABLE_REGISTRY:
                    raise TypeError(
                        f"{name} is not @register_serializable-d")
                stream.write_u8(_T_OBJ)
                stream.write_string(name)
                value.serialize(stream, self)
            else:
                raise TypeError(
                    f"cannot serialize {type(value).__name__}")

    # --- read --------------------------------------------------------------
    def get(self, stream: Stream):
        tag = stream.read_u8()
        if tag == _T_NONE:
            return None
        if tag == _T_BOOL:
            return stream.read_bool()
        if tag == _T_INT:
            return stream.read_i64()
        if tag == _T_FLOAT:
            return stream.read_f64()
        if tag == _T_STR:
            return stream.read_string()
        if tag == _T_BYTES:
            return stream._read_exact(stream.read_u64())
        if tag == _T_REF:
            return self._id_to_obj[stream.read_u32()]
        oid = self._next_id
        self._next_id += 1
        if tag in (_T_LIST, _T_TUPLE):
            n = stream.read_u32()
            out = []
            self._id_to_obj[oid] = out    # pre-register: cycles resolve
            for _ in range(n):
                out.append(self.get(stream))
            if tag == _T_TUPLE:
                out = tuple(out)
                self._id_to_obj[oid] = out
            return out
        if tag == _T_DICT:
            n = stream.read_u32()
            out = {}
            self._id_to_obj[oid] = out
            for _ in range(n):
                k = self.get(stream)
                out[k] = self.get(stream)
            return out
        if tag == _T_ARRAY:
            arr = stream.read_array()
            self._id_to_obj[oid] = arr
            return arr
        if tag == _T_OBJ:
            name = stream.read_string()
            cls = _SERIALIZABLE_REGISTRY.get(name)
            if cls is None:
                raise TypeError(f"unknown serializable class {name!r}")
            if cls.unserialize_fill is not Serializable.unserialize_fill:
                # two-phase: register BEFORE filling so cycles resolve
                obj = cls.__new__(cls)
                self._id_to_obj[oid] = obj
                obj.unserialize_fill(stream, self)
            else:
                obj = cls.unserialize(stream, self)
                self._id_to_obj[oid] = obj
            return obj
        raise ValueError(f"corrupt stream: unknown tag {tag}")
