"""The subset of MessagePack that xl.meta holds, in pure Python.

minio_tpu writes xl.meta with the `msgpack` package
(`msgpack.packb(doc, use_bin_type=True)` and
`msgpack.unpackb(buf, raw=False, strict_map_key=False)`); the port must
write the same bytes without it. `packb` makes the encoding that package
picks for nil, bool, int, float, str, bin, array and map: the smallest
int form (positive and negative fixint, then uint8..64 or int8..64),
fixstr/str8/16/32 for str, bin8/16/32 for bytes, fixarray/array16/32,
fixmap/map16/32 in insertion order, and float64 for every float.
`unpackb` reads those forms back (float32 too) into None, bool, int,
float, str, bytes, list and dict, and refuses anything else.
"""

from __future__ import annotations

import struct


class PackError(ValueError):
    """An object or a buffer outside the supported subset."""


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -0x20 <= x < 0:
        out.append(x & 0xFF)
    elif 0 <= x <= 0xFF:
        out += b"\xcc" + x.to_bytes(1, "big")
    elif 0 <= x <= 0xFFFF:
        out += b"\xcd" + x.to_bytes(2, "big")
    elif 0 <= x <= 0xFFFFFFFF:
        out += b"\xce" + x.to_bytes(4, "big")
    elif 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + x.to_bytes(8, "big")
    elif -0x80 <= x < 0:
        out += b"\xd0" + x.to_bytes(1, "big", signed=True)
    elif -0x8000 <= x < 0:
        out += b"\xd1" + x.to_bytes(2, "big", signed=True)
    elif -0x80000000 <= x < 0:
        out += b"\xd2" + x.to_bytes(4, "big", signed=True)
    elif -0x8000000000000000 <= x < 0:
        out += b"\xd3" + x.to_bytes(8, "big", signed=True)
    else:
        raise PackError(f"int {x} does not fit 64 bits")


def _pack_len(n: int, fix_tag: int, fix_max: int, tags: tuple,
              out: bytearray) -> None:
    """Header of a str/bin/array/map of n items: a fix form where the
    type has one and n fits it, else the smallest of 8/16/32-bit
    lengths that `tags` offers (None where the type has no such form)."""
    if fix_tag is not None and n <= fix_max:
        out.append(fix_tag | n)
        return
    for tag, width in zip(tags, (1, 2, 4)):
        if tag is not None and n < (1 << (8 * width)):
            out.append(tag)
            out += n.to_bytes(width, "big")
            return
    raise PackError(f"length {n} does not fit 32 bits")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is False:
        out.append(0xC2)
    elif obj is True:
        out.append(0xC3)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = memoryview(obj).cast("B")
        _pack_len(len(raw), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise PackError(f"cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    """Bytes of `obj`, as msgpack.packb(obj, use_bin_type=True) gives."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# Fixed-width scalars: tag -> (struct format, byte count).
_SCALARS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# Variable-length containers: tag -> (kind, length-field bytes).
_SIZED = {
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise PackError("buffer ends inside an object")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def value(self):
        tag = self.take(1)[0]
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.container("map", tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return self.container("array", tag & 0x0F)
        if 0xA0 <= tag <= 0xBF:
            return self.container("str", tag & 0x1F)
        if tag == 0xC0:
            return None
        if tag == 0xC2:
            return False
        if tag == 0xC3:
            return True
        if tag in _SCALARS:
            fmt, n = _SCALARS[tag]
            return struct.unpack(fmt, self.take(n))[0]
        if tag in _SIZED:
            kind, width = _SIZED[tag]
            return self.container(kind, int.from_bytes(self.take(width),
                                                        "big"))
        raise PackError(f"unsupported msgpack tag 0x{tag:02x}")

    def container(self, kind: str, n: int):
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "array":
            return [self.value() for _ in range(n)]
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(buf):
    """The object in `buf`, as msgpack.unpackb(buf, raw=False,
    strict_map_key=False) gives; raises PackError on a malformed or
    unsupported buffer or on bytes after the object."""
    reader = _Reader(buf)
    obj = reader.value()
    if reader.pos != len(reader.buf):
        raise PackError(f"{len(reader.buf) - reader.pos} extra bytes")
    return obj
