"""A small MessagePack codec for checkpoint metadata.

``tree.msgpack`` is MessagePack.  The reference writes it with
``msgpack.packb(x, use_bin_type=True)`` and reads it with
``msgpack.unpackb(raw=False)``; the card machine has no ``msgpack``
package, so the port carries this codec for the types checkpoint metadata
holds: nil, bool, int (signed and unsigned, up to 64 bits), float (a
Python float encodes as float64), str, bin, array (list or tuple) and map.
:func:`packb` gives the bytes ``msgpack.packb(x, use_bin_type=True)``
gives: each value in its smallest format, maps in insertion order.
:func:`unpackb` decodes what ``msgpack.unpackb(raw=False)`` decodes: str
as ``str``, bin as ``bytes``, arrays as lists, map keys str or bytes.  Any
other type is refused with a ``TypeError``; an extension type, a truncated
blob or trailing bytes with a ``ValueError``.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def _head(out: bytearray, n: int, fix: int, fix_limit: int,
          codes: Tuple[Tuple[int, int, str], ...]) -> None:
    """A length header: the fix form below ``fix_limit`` (``fix`` = None
    for bin, which has none), else the first of ``codes`` whose limit
    holds ``n``."""
    if fix is not None and n < fix_limit:
        out.append(fix | n)
        return
    for code, limit, fmt in codes:
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"object of length {n} is too large for msgpack")


_U8, _U16, _U32 = 0xFF, 0xFFFF, 0xFFFFFFFF


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v <= _U8:
            out += b"\xcc" + struct.pack(">B", v)
        elif v <= _U16:
            out += b"\xcd" + struct.pack(">H", v)
        elif v <= _U32:
            out += b"\xce" + struct.pack(">I", v)
        elif v < 1 << 64:
            out += b"\xcf" + struct.pack(">Q", v)
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(v & 0xFF)
    elif v >= -(1 << 7):
        out += b"\xd0" + struct.pack(">b", v)
    elif v >= -(1 << 15):
        out += b"\xd1" + struct.pack(">h", v)
    elif v >= -(1 << 31):
        out += b"\xd2" + struct.pack(">i", v)
    elif v >= -(1 << 63):
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError("Integer value out of range")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _head(out, len(raw), None, 0,
              ((0xC4, _U8, ">B"), (0xC5, _U16, ">H"), (0xC6, _U32, ">I")))
        out += raw
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 32,
              ((0xD9, _U8, ">B"), (0xDA, _U16, ">H"), (0xDB, _U32, ">I")))
        out += raw
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16,
              ((0xDE, _U16, ">H"), (0xDF, _U32, ">I")))
        for key, val in obj.items():
            _pack(key, out)
            _pack(val, out)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16,
              ((0xDC, _U16, ">H"), (0xDD, _U32, ">I")))
        for val in obj:
            _pack(val, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack bytes (``msgpack.packb(obj,
    use_bin_type=True)``)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


#: fixed-width scalars: type byte → struct format
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
#: length-prefixed values: type byte → (kind, length format)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(bytes(data))
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        raw = bytes(self.data[self.pos:end])
        self.pos = end
        return raw

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.sized("map", b & 0x0F)
        if b <= 0x9F:
            return self.sized("array", b & 0x0F)
        if b <= 0xBF:
            return self.sized("str", b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            return self.sized(kind, self.unpack(fmt))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def sized(self, kind: str, n: int) -> Any:
        if kind == "bin":
            return self.take(n)
        if kind == "str":
            return self.take(n).decode("utf-8")
        if kind == "array":
            return [self.value() for _ in range(n)]
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"{type(key).__name__} is not allowed for "
                                 "map key")
            out[key] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    """Decode one MessagePack value (``msgpack.unpackb(data,
    raw=False)``); trailing bytes are refused."""
    reader = _Reader(data)
    val = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("extra data after the msgpack value")
    return val
