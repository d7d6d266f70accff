"""A minimal MessagePack encoder and decoder for checkpoint manifests.

The card's machine has no ``msgpack`` package, so the port carries the part
of the format a manifest uses: map, str, int, list (array), bool and nil.
The encoder picks the shortest form of each value, as ``msgpack.packb``
does, so the bytes are the same; anything else raises ``TypeError`` (on
encode) or ``ValueError`` (on decode).
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def _length(n: int, fix: int, fix_max: int, tags: Tuple[int, ...]) -> bytes:
    """The header of a str, array or map of ``n`` items: the fix form, then
    the 8- (str only), 16- and 32-bit forms of ``tags``."""
    if n <= fix_max:
        return bytes([fix | n])
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I")[-len(tags):],
                               (0xFF, 0xFFFF, 0xFFFFFFFF)[-len(tags):]):
        if n <= limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"{n} items do not fit in a msgpack header")


def _int(x: int) -> bytes:
    if 0 <= x <= 0x7F:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack(">b", x)
    if x > 0:
        for tag, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                (0xCE, ">I", 0xFFFFFFFF),
                                (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if x <= limit:
                return bytes([tag]) + struct.pack(fmt, x)
    else:
        for tag, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15),
                               (0xD2, ">i", 31), (0xD3, ">q", 63)):
            if x >= -(1 << bits):
                return bytes([tag]) + struct.pack(fmt, x)
    raise ValueError(f"{x} does not fit in 64 bits")


def packb(obj: Any) -> bytes:
    """``obj`` (dicts, lists or tuples, str, int, bool, None) as msgpack."""
    if obj is None:
        return b"\xc0"
    if obj is True:
        return b"\xc3"
    if obj is False:
        return b"\xc2"
    if isinstance(obj, int):
        return _int(obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _length(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(obj, (list, tuple)):
        return _length(len(obj), 0x90, 15, (0xDC, 0xDD)) + b"".join(
            packb(x) for x in obj)
    if isinstance(obj, dict):
        return _length(len(obj), 0x80, 15, (0xDE, 0xDF)) + b"".join(
            packb(k) + packb(v) for k, v in obj.items())
    raise TypeError(f"cannot encode {type(obj).__name__} in a manifest")


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}


def _read(buf: bytes, at: int, fmt: str) -> Tuple[int, int]:
    size = struct.calcsize(fmt)
    return struct.unpack_from(fmt, buf, at)[0], at + size


def _decode(buf: bytes, at: int) -> Tuple[Any, int]:
    tag = buf[at]
    at += 1
    if tag <= 0x7F:
        return tag, at
    if tag >= 0xE0:
        return tag - 0x100, at
    if tag == 0xC0:
        return None, at
    if tag in (0xC2, 0xC3):
        return tag == 0xC3, at
    if tag in _FIXED:
        return _read(buf, at, _FIXED[tag])
    if 0xA0 <= tag <= 0xBF or tag in _STR:
        n, at = (tag & 0x1F, at) if tag <= 0xBF else _read(buf, at,
                                                             _STR[tag])
        return buf[at:at + n].decode("utf-8"), at + n
    if 0x90 <= tag <= 0x9F or tag in _ARRAY:
        n, at = (tag & 0x0F, at) if tag <= 0x9F else _read(buf, at,
                                                             _ARRAY[tag])
        out = []
        for _ in range(n):
            x, at = _decode(buf, at)
            out.append(x)
        return out, at
    if 0x80 <= tag <= 0x8F or tag in _MAP:
        n, at = (tag & 0x0F, at) if tag <= 0x8F else _read(buf, at,
                                                             _MAP[tag])
        out = {}
        for _ in range(n):
            k, at = _decode(buf, at)
            out[k], at = _decode(buf, at)
        return out, at
    raise ValueError(f"msgpack type 0x{tag:02x} is not one a manifest uses")


def unpackb(buf: bytes) -> Any:
    """The value of one msgpack object that fills ``buf``."""
    obj, at = _decode(buf, 0)
    if at != len(buf):
        raise ValueError(f"{len(buf) - at} bytes after the msgpack object")
    return obj
