"""The subset of MessagePack a checkpoint uses: nil, booleans, integers,
64-bit floats, strings, binary, arrays and maps.

``pack`` writes what ``msgpack.packb(obj, use_bin_type=True)`` writes,
byte for byte (the smallest encoding of every integer, maps in insertion
order); ``unpack`` reads every encoding of these types, so it also reads
files another MessagePack writer made.  The port keeps its own codec so
that a checkpoint needs nothing beyond the standard library and numpy.
"""

from __future__ import annotations

import struct


def _head(write, small, base, codes, n):
    """A length or count: ``base + n`` below ``small``, else the first of
    ``codes`` (8-, 16-, 32-bit; None where the format has none) that
    holds it."""
    if n < small:
        write(bytes((base + n,)))
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            write(bytes((code,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} exceeds MessagePack's 32-bit limit")


def _int(write, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        write(struct.pack(">b" if v < 0 else ">B", v))
        return
    fmts = (((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
             (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)) if v >= 0 else
            ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
             (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)))
    for code, fmt, limit in fmts:
        if (v < limit) if v >= 0 else (v >= -limit):
            write(bytes((code,)) + struct.pack(fmt, v))
            return
    raise OverflowError(f"integer {v} does not fit 64 bits")


def pack(obj, write) -> None:
    """Encode ``obj`` through ``write(bytes)`` (a file's ``write``)."""
    if obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _int(write, obj)
    elif isinstance(obj, float):
        write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(write, 32, 0xa0, (0xd9, 0xda, 0xdb), len(data))
        write(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        _head(write, 0, 0, (0xc4, 0xc5, 0xc6), data.nbytes)
        write(data)
    elif isinstance(obj, (list, tuple)):
        _head(write, 16, 0x90, (None, 0xdc, 0xdd), len(obj))
        for v in obj:
            pack(v, write)
    elif isinstance(obj, dict):
        _head(write, 16, 0x80, (None, 0xde, 0xdf), len(obj))
        for k, v in obj.items():
            pack(k, write)
            pack(v, write)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H",
        0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I"}


class _Reader:
    def __init__(self, buf):
        self.buf, self.pos = memoryview(buf).cast("B"), 0

    def take(self, n: int) -> memoryview:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated MessagePack data")
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        c = self.take(1)[0]
        if c < 0x80 or c >= 0xe0:                       # fixint
            return c - 0x100 if c >= 0xe0 else c
        if c == 0xc0:
            return None
        if c in (0xc2, 0xc3):
            return c == 0xc3
        if c in _FIXED:
            return self.num(_FIXED[c])
        if 0xa0 <= c < 0xc0 or c in (0xd9, 0xda, 0xdb):  # str
            n = c - 0xa0 if c < 0xc0 else self.num(_LEN[c])
            return str(self.take(n), "utf-8")
        if c in (0xc4, 0xc5, 0xc6):                       # bin
            return self.take(self.num(_LEN[c])).tobytes()
        if 0x90 <= c < 0xa0 or c in (0xdc, 0xdd):         # array
            n = c - 0x90 if c < 0xa0 else self.num(_LEN[c])
            return [self.value() for _ in range(n)]
        if 0x80 <= c < 0x90 or c in (0xde, 0xdf):         # map
            n = c - 0x80 if c < 0x90 else self.num(_LEN[c])
            out = {}
            for _ in range(n):
                k = self.value()
                out[k] = self.value()
            return out
        raise ValueError(f"unsupported MessagePack type byte 0x{c:02x}")


def unpackb(buf):
    """Decode one object from ``buf`` (bytes-like); binary as ``bytes``."""
    reader = _Reader(buf)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the MessagePack object")
    return out
