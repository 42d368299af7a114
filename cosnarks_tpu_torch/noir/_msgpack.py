"""A minimal MessagePack reader and writer for ACIR programs.

The Noir compiler serialises a `Program` as msgpack (nil, bool, ints,
str, bin, arrays and maps; no extension types). This module covers
exactly those, so loading an artifact needs no `msgpack` package.

`unpackb(data)` returns what `msgpack.unpackb(data, strict_map_key=False)`
returns: str as str, bin as bytes, arrays as lists, maps as dicts with any
key type. `packb(obj)` returns what `msgpack.packb(obj)` returns (bin type
for bytes, the shortest encoding of each int, tuples as arrays).
"""

from __future__ import annotations

import struct


class MsgpackError(ValueError):
    pass


# -- reader ----------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError("truncated msgpack data")
        out = self.data[self.pos:end].tobytes()
        self.pos = end
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def obj(self):
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        handler = _SIMPLE.get(b)
        if handler is None:
            raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x}")
        return handler(self)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if isinstance(k, list):
                k = _freeze(k)
            out[k] = self.obj()
        return out

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def str(self, n: int) -> str:
        return self.take(n).decode("utf-8")


def _freeze(v):
    return tuple(_freeze(x) for x in v) if isinstance(v, list) else v


_SIMPLE = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: r.take(r.uint(1)),
    0xC5: lambda r: r.take(r.uint(2)),
    0xC6: lambda r: r.take(r.uint(4)),
    0xCA: lambda r: struct.unpack(">f", r.take(4))[0],
    0xCB: lambda r: struct.unpack(">d", r.take(8))[0],
    0xCC: lambda r: r.uint(1),
    0xCD: lambda r: r.uint(2),
    0xCE: lambda r: r.uint(4),
    0xCF: lambda r: r.uint(8),
    0xD0: lambda r: r.sint(1),
    0xD1: lambda r: r.sint(2),
    0xD2: lambda r: r.sint(4),
    0xD3: lambda r: r.sint(8),
    0xD9: lambda r: r.str(r.uint(1)),
    0xDA: lambda r: r.str(r.uint(2)),
    0xDB: lambda r: r.str(r.uint(4)),
    0xDC: lambda r: r.array(r.uint(2)),
    0xDD: lambda r: r.array(r.uint(4)),
    0xDE: lambda r: r.map(r.uint(2)),
    0xDF: lambda r: r.map(r.uint(4)),
}


def unpackb(data: bytes):
    """Decode one msgpack object; trailing bytes are an error."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise MsgpackError("extra bytes after msgpack object")
    return out


# -- writer ----------------------------------------------------------------

def _pack_int(v: int, out: bytearray):
    if v >= 0:
        if v <= 0x7F:
            out.append(v)
        elif v <= 0xFF:
            out += b"\xcc" + v.to_bytes(1, "big")
        elif v <= 0xFFFF:
            out += b"\xcd" + v.to_bytes(2, "big")
        elif v <= 0xFFFFFFFF:
            out += b"\xce" + v.to_bytes(4, "big")
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + v.to_bytes(8, "big")
        else:
            raise MsgpackError("int too large for msgpack")
        return
    if v >= -32:
        out.append(v & 0xFF)
    elif v >= -0x80:
        out += b"\xd0" + v.to_bytes(1, "big", signed=True)
    elif v >= -0x8000:
        out += b"\xd1" + v.to_bytes(2, "big", signed=True)
    elif v >= -0x80000000:
        out += b"\xd2" + v.to_bytes(4, "big", signed=True)
    elif v >= -0x8000000000000000:
        out += b"\xd3" + v.to_bytes(8, "big", signed=True)
    else:
        raise MsgpackError("int too small for msgpack")


def _pack_len(n: int, out: bytearray, fix_base: int, fix_max: int,
              codes: tuple):
    """Length header: fix form when n <= fix_max, else 8/16/32-bit forms
    (codes lists the type bytes of the available forms, shortest first)."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for code, width in codes:
        if n < (1 << (8 * width)):
            out.append(code)
            out += n.to_bytes(width, "big")
            return
    raise MsgpackError("msgpack container too long")


def _pack(obj, out: bytearray):
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), out, 0xA0, 31,
                  ((0xD9, 1), (0xDA, 2), (0xDB, 4)))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), out, None, -1,
                  ((0xC4, 1), (0xC5, 2), (0xC6, 4)))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 15, ((0xDC, 2), (0xDD, 4)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 15, ((0xDE, 2), (0xDF, 4)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise MsgpackError(f"cannot msgpack {type(obj).__name__}")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)
