"""The msgpack subset a checkpoint manifest uses, without the ``msgpack``
package.

``packb`` writes what ``msgpack.packb`` writes with its default options
(``use_bin_type=True``, doubles for floats, the shortest integer, string,
array and map headers), byte for byte; ``unpackb`` reads that subset back:
nil, bool, int, float (single and double), str, bin, array and map.
Maps keep their insertion order.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def _header(n: int, fix: int, fix_max: int, wide: Tuple[int, ...]) -> bytes:
    """A length header: the fix form below ``fix_max``, else the first of
    the 8-, 16- and 32-bit forms (``wide``, 0 where the type has none)
    that holds ``n``."""
    if n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(wide, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit msgpack")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF),
             (0xCE, ">I", 0, 0xFFFFFFFF), (0xCF, ">Q", 0, 0xFFFFFFFFFFFFFFFF))
    if v < 0:
        forms = ((0xD0, ">b", -0x80, 0), (0xD1, ">h", -0x8000, 0),
                 (0xD2, ">i", -0x80000000, 0),
                 (0xD3, ">q", -0x8000000000000000, 0))
    for code, fmt, lo, hi in forms:
        if lo <= v <= hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += [_header(len(raw), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB)), raw]
    elif isinstance(obj, (bytes, bytearray)):
        out += [_header(len(obj), 0, -1, (0xC4, 0xC5, 0xC6)), bytes(obj)]
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 0x0F, (0, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 0x0F, (0, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} into a manifest")


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack bytes."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        c = self.take(1)[0]
        if c <= 0x7F or c >= 0xE0:
            return c if c <= 0x7F else c - 0x100
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in scalars:
            return self.num(scalars[c])
        sizes = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H",
                 0xC6: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if c not in sizes:
            raise ValueError(f"msgpack type 0x{c:02x} is not a manifest type")
        n = self.num(sizes[c])
        if c in (0xD9, 0xDA, 0xDB):
            return self.take(n).decode("utf-8")
        if c in (0xC4, 0xC5, 0xC6):
            return self.take(n)
        if c in (0xDC, 0xDD):
            return [self.obj() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes) -> Any:
    """The object of one msgpack message."""
    reader = _Reader(bytes(data))
    obj = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack message")
    return obj
