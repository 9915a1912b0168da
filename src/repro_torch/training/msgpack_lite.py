"""A msgpack encoder and decoder for the subset checkpoint files use.

The JAX package writes its checkpoints with ``msgpack.packb(payload,
use_bin_type=True)``.  The port carries its own codec so that it needs no
package beyond torch and numpy.  :func:`packb` gives the bytes
msgpack-python gives for the same payload: maps, arrays (lists and tuples),
str, bin (bytes), bool, nil, ints in the smallest encoding that holds
them, and Python floats as float64.  :func:`unpackb` reads those, and
float32 besides, as ``msgpack.unpackb(data, raw=False)`` does: arrays as
lists, str as str, bin as bytes.
"""
from __future__ import annotations

import struct


def _int(v: int) -> bytes:
    if v >= 0:
        if v < 0x80:
            return bytes((v,))
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= top:
                return bytes((code,)) + struct.pack(fmt, v)
    else:
        if v >= -32:
            return struct.pack(">b", v)
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if v >= low:
                return bytes((code,)) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _head(n: int, fix: int, fix_max: int, codes) -> bytes:
    """The header of a str, bin, array or map of length ``n``: a fix form
    below ``fix_max`` (when the type has one), else the first of ``codes``
    ((code, struct format, largest length)) that holds ``n``."""
    if fix_max and n < fix_max:
        return bytes((fix | n,))
    for code, fmt, top in codes:
        if n <= top:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"length {n} exceeds msgpack's 32-bit lengths")


_STR = ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff), (0xdb, ">I", 0xffffffff))
_BIN = ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff), (0xc6, ">I", 0xffffffff))
_ARRAY = ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff))
_MAP = ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff))


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_head(len(data), 0xa0, 32, _STR))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out.append(_head(len(data), 0, 0, _BIN))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 16, _ARRAY))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 16, _MAP))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``obj`` in msgpack, as ``msgpack.packb(obj, use_bin_type=True)``."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# fixed-width formats: code -> (struct format, size)
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8),
          0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
# sized formats: code -> (kind, struct format of the length, its size)
_SIZED = {0xd9: ("str", ">B", 1), 0xda: ("str", ">H", 2),
          0xdb: ("str", ">I", 4), 0xc4: ("bin", ">B", 1),
          0xc5: ("bin", ">H", 2), 0xc6: ("bin", ">I", 4),
          0xdc: ("array", ">H", 2), 0xdd: ("array", ">I", 4),
          0xde: ("map", ">H", 2), 0xdf: ("map", ">I", 4)}


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self):
        code = self.take(1)[0]
        if code <= 0x7f:
            return code
        if code >= 0xe0:
            return code - 0x100
        if 0xa0 <= code <= 0xbf:
            return self.sized("str", code & 0x1f)
        if 0x90 <= code <= 0x9f:
            return self.sized("array", code & 0x0f)
        if 0x80 <= code <= 0x8f:
            return self.sized("map", code & 0x0f)
        if code == 0xc0:
            return None
        if code in (0xc2, 0xc3):
            return code == 0xc3
        if code in _FIXED:
            return self.unpack(*_FIXED[code])
        if code in _SIZED:
            kind, fmt, size = _SIZED[code]
            return self.sized(kind, self.unpack(fmt, size))
        raise ValueError(f"msgpack type 0x{code:02x} is not supported")

    def sized(self, kind: str, n: int):
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "array":
            return [self.value() for _ in range(n)]
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data):
    """The object that ``data`` encodes, as ``msgpack.unpackb(data,
    raw=False)`` returns it."""
    reader = _Reader(data)
    obj = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes of extra "
                         "data after the msgpack object")
    return obj
