"""Canonical record serialization: msgpack + magic + version + checksum
(port of ``shodh_tpu/storage/serialization.py``).

    [4-byte magic b'STPU'][1-byte version][8-byte crc32 (zero-padded)]
    [msgpack payload]

Decode refuses payloads over the 10 MB limit and verifies the checksum, so a
corrupted or truncated record raises instead of deserializing garbage.

The payload codec is this module's own, so the port needs no ``msgpack``
package. ``encode`` writes exactly the bytes of
``msgpack.packb(obj, use_bin_type=True)`` for the types records hold:
``None``, ``bool``, ``int`` in its smallest form, ``float`` as float64,
``str``, ``bytes``/``bytearray``/``memoryview`` as bin, lists and tuples as
arrays, and dicts as maps in insertion order. Any other type raises
``TypeError``, an int outside [-2^63, 2^64) ``OverflowError``, and nesting
deeper than 511 ``ValueError``, as ``packb`` does. ``decode`` reads what
``msgpack.unpackb(raw=False, strict_map_key=False)`` reads, arrays as
lists and any map key; it also takes float32, and refuses extension types
with ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

MAGIC = b"STPU"
VERSION = 1
MAX_DECODE_BYTES = 10 * 1024 * 1024  # 10 MB (constants.rs MAX_DECOMPRESSED_SIZE)
_HEADER = struct.Struct("<4sBQ")
_NEST_LIMIT = 511  # msgpack's default recursion limit


class CorruptRecordError(ValueError):
    pass


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
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
            raise OverflowError("Integer value out of range")
    elif v >= -32:
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
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int, codes: bytes) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-bit (when
    ``codes`` has three), 16-bit or 32-bit form."""
    if n < fix_max:
        out.append(fix | n)
        return
    if len(codes) == 3:
        if n <= 0xFF:
            out += codes[0:1] + n.to_bytes(1, "big")
            return
        codes = codes[1:]
    if n <= 0xFFFF:
        out += codes[0:1] + n.to_bytes(2, "big")
    elif n <= 0xFFFFFFFF:
        out += codes[1:2] + n.to_bytes(4, "big")
    else:
        raise ValueError(f"object of length {n} is too large to serialize")


_F64 = struct.Struct(">d")


def _pack_str(obj: str, out: bytearray) -> None:
    b = obj.encode("utf-8")
    _pack_len(len(b), out, 0xA0, 32, b"\xd9\xda\xdb")
    out += b


def _pack(obj, out: bytearray, depth: int) -> None:
    if depth > _NEST_LIMIT:
        raise ValueError("recursion limit exceeded.")
    # the record types by exact type first (the common cases: a dict of
    # str keys and float or str values); subclasses take the chain below
    t = type(obj)
    if t is str:
        _pack_str(obj, out)
    elif t is float:
        out += b"\xcb" + _F64.pack(obj)
    elif t is dict:
        _pack_len(len(obj), out, 0x80, 16, b"\xde\xdf")
        inline = depth < _NEST_LIMIT  # a child at depth + 1 is within the limit
        for k, v in obj.items():
            if inline and type(k) is str:
                _pack_str(k, out)
            else:
                _pack(k, out, depth + 1)
            if inline and type(v) is float:
                out += b"\xcb" + _F64.pack(v)
            else:
                _pack(v, out, depth + 1)
    elif obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), out, 0, 0, b"\xc4\xc5\xc6")
        out += obj
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 32, b"\xd9\xda\xdb")
        out += b
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, b"\xde\xdf")
        for k, v in obj.items():
            _pack(k, out, depth + 1)
            _pack(v, out, depth + 1)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, b"\xdc\xdd")
        for v in obj:
            _pack(v, out, depth + 1)
    elif isinstance(obj, memoryview):
        b = obj.tobytes()
        _pack_len(len(b), out, 0, 0, b"\xc4\xc5\xc6")
        out += b
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the record types."""
    out = bytearray()
    _pack(obj, out, 0)
    return bytes(out)


_FIXED = {  # code -> (struct format, size) of fixed-width scalars
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {  # code -> (kind, width of the length field)
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}


def _need(data: bytes, end: int) -> None:
    if end > len(data):
        raise ValueError("Unpack failed: incomplete input")


def _unpack(data: bytes, pos: int, depth: int):
    """(object, next position) of the value at ``pos``."""
    if depth > _NEST_LIMIT:
        raise ValueError("recursion limit exceeded.")
    _need(data, pos + 1)
    c = data[pos]
    pos += 1
    if c < 0x80:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if c == 0xC0:
        return None, pos
    if c == 0xC2:
        return False, pos
    if c == 0xC3:
        return True, pos
    if c in _FIXED:
        fmt, size = _FIXED[c]
        _need(data, pos + size)
        return struct.unpack_from(fmt, data, pos)[0], pos + size
    if 0xA0 <= c <= 0xBF:
        kind, n = "str", c & 0x1F
    elif 0x90 <= c <= 0x9F:
        kind, n = "array", c & 0x0F
    elif 0x80 <= c <= 0x8F:
        kind, n = "map", c & 0x0F
    elif c in _LEN:
        kind, width = _LEN[c]
        _need(data, pos + width)
        n = int.from_bytes(data[pos:pos + width], "big")
        pos += width
    else:
        raise ValueError(f"Unpack failed: unsupported msgpack type 0x{c:02x}")
    if kind in ("str", "bin"):
        _need(data, pos + n)
        raw = data[pos:pos + n]
        return (raw.decode("utf-8") if kind == "str" else bytes(raw)), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _unpack(data, pos, depth + 1)
            items.append(v)
        return items, pos
    # maps read fixstr keys and float64 values in place (the common record
    # shapes); any other key or value, and every error, takes _unpack
    out = {}
    size = len(data)
    inline = depth < _NEST_LIMIT  # a child at depth + 1 is within the limit
    for _ in range(n):
        c = data[pos] if inline and pos < size else -1
        if 0xA0 <= c <= 0xBF:
            end = pos + 1 + (c & 0x1F)
            _need(data, end)
            k = data[pos + 1:end].decode("utf-8")
            pos = end
        else:
            k, pos = _unpack(data, pos, depth + 1)
        if inline and pos + 9 <= size and data[pos] == 0xCB:
            v = _F64.unpack_from(data, pos + 1)[0]
            pos += 9
        else:
            v, pos = _unpack(data, pos, depth + 1)
        out[k] = v
    return out, pos


def unpackb(data: bytes):
    """``msgpack.unpackb(data, raw=False, strict_map_key=False)``."""
    obj, pos = _unpack(data, 0, 0)
    if pos != len(data):
        raise ValueError("unpack(b) received extra data.")
    return obj


def encode(obj) -> bytes:
    payload = packb(obj)
    crc = zlib.crc32(payload)
    return _HEADER.pack(MAGIC, VERSION, crc) + payload


def decode(data: bytes):
    if len(data) < _HEADER.size:
        raise CorruptRecordError(f"record too short: {len(data)} bytes")
    if len(data) > MAX_DECODE_BYTES + _HEADER.size:
        raise CorruptRecordError(f"record exceeds decode limit: {len(data)} bytes")
    magic, version, crc = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise CorruptRecordError(f"bad magic {magic!r}")
    if version != VERSION:
        raise CorruptRecordError(f"unsupported format version {version}")
    payload = data[_HEADER.size :]
    if zlib.crc32(payload) != crc:
        raise CorruptRecordError("checksum mismatch")
    return unpackb(payload)
