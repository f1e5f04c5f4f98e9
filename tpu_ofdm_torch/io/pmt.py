"""Typed polymorphic values with compact binary serialization (a
numpy-only copy of tpu_ofdm/io/pmt.py: the two write the same bytes, so a
JAX endpoint and a port endpoint interoperate).

Host-side counterpart of the reference's PMT library (polymorphic typed
values -- ints, symbols, dicts, uniform vectors -- with serialization,
gnuradio-runtime/lib/pmt/pmt.cc).  PMTs are what the reference's tags,
messages, and socket frames are made of; here they serve the same roles on
the host side (Pdu metadata, control messages, spectrum-frame payloads),
while device-side metadata stays static-shape tensors.

No object model is needed in Python -- native values already carry their
type -- so this module is just the wire format: `dumps(value) -> bytes` /
`loads(bytes) -> value` for None, bool, int, float, complex, str, bytes,
lists/tuples, string-keyed dicts, and uniform numpy vectors (any real or
complex dtype, any shape).  Format: 1 type byte + big-endian payload;
self-delimiting, so values nest and stream.

NOT wire-compatible with the reference: this is a bespoke encoding (its own
type bytes), not the pmt::serialize PST tag layout, so UdpPduLink endpoints
cannot interoperate with reference socket_pdu endpoints -- both ends of a
link must run this framework (either of its two packages).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_T_NONE = 0x00
_T_TRUE = 0x01
_T_FALSE = 0x02
_T_INT = 0x03      # signed 64-bit
_T_BIGINT = 0x04   # arbitrary precision (len + sign-magnitude bytes)
_T_FLOAT = 0x05    # IEEE f64
_T_COMPLEX = 0x06  # two f64
_T_STR = 0x07      # u32 len + utf-8 (the reference's "symbol")
_T_BYTES = 0x08    # u32 len + raw (the reference's u8vector)
_T_LIST = 0x09     # u32 count + items
_T_DICT = 0x0A     # u32 count + (str, value) pairs
_T_NDARRAY = 0x0B  # dtype str + u8 ndim + u32 dims + raw little-endian


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">I", len(b)) + b


def dumps(v: Any) -> bytes:
    """Serialize a value (cf. pmt::serialize)."""
    if v is None:
        return bytes([_T_NONE])
    if isinstance(v, bool) or isinstance(v, np.bool_):
        return bytes([_T_TRUE if v else _T_FALSE])
    if isinstance(v, (int, np.integer)):
        v = int(v)
        if -(1 << 63) <= v < (1 << 63):
            return bytes([_T_INT]) + struct.pack(">q", v)
        mag = abs(v)
        raw = mag.to_bytes((mag.bit_length() + 7) // 8, "big")
        return (bytes([_T_BIGINT]) + struct.pack(">Ib", len(raw), v < 0) + raw)
    if isinstance(v, (float, np.floating)):
        return bytes([_T_FLOAT]) + struct.pack(">d", float(v))
    if isinstance(v, (complex, np.complexfloating)):
        v = complex(v)
        return bytes([_T_COMPLEX]) + struct.pack(">dd", v.real, v.imag)
    if isinstance(v, str):
        return bytes([_T_STR]) + _pack_str(v)
    if isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        return bytes([_T_BYTES]) + struct.pack(">I", len(b)) + b
    if isinstance(v, np.ndarray):
        a = np.ascontiguousarray(v)
        dt = a.dtype.newbyteorder("<")
        a = a.astype(dt, copy=False)
        head = (bytes([_T_NDARRAY]) + _pack_str(dt.str)
                + struct.pack(">B", a.ndim)
                + b"".join(struct.pack(">I", d) for d in a.shape))
        return head + a.tobytes()
    if isinstance(v, (list, tuple)):
        return (bytes([_T_LIST]) + struct.pack(">I", len(v))
                + b"".join(dumps(x) for x in v))
    if isinstance(v, dict):
        out = [bytes([_T_DICT]), struct.pack(">I", len(v))]
        for k, val in v.items():
            if not isinstance(k, str):
                raise TypeError(f"dict keys must be str, got {type(k).__name__}")
            out.append(_pack_str(k))
            out.append(dumps(val))
        return b"".join(out)
    raise TypeError(f"cannot serialize {type(v).__name__}")


def _read_str(buf: bytes, off: int) -> tuple[str, int]:
    (n,) = struct.unpack_from(">I", buf, off)
    off += 4
    return buf[off : off + n].decode("utf-8"), off + n


def _loads(buf: bytes, off: int) -> tuple[Any, int]:
    t = buf[off]
    off += 1
    if t == _T_NONE:
        return None, off
    if t == _T_TRUE:
        return True, off
    if t == _T_FALSE:
        return False, off
    if t == _T_INT:
        (v,) = struct.unpack_from(">q", buf, off)
        return v, off + 8
    if t == _T_BIGINT:
        n, neg = struct.unpack_from(">Ib", buf, off)
        off += 5
        mag = int.from_bytes(buf[off : off + n], "big")
        return (-mag if neg else mag), off + n
    if t == _T_FLOAT:
        (v,) = struct.unpack_from(">d", buf, off)
        return v, off + 8
    if t == _T_COMPLEX:
        re, im = struct.unpack_from(">dd", buf, off)
        return complex(re, im), off + 16
    if t == _T_STR:
        return _read_str(buf, off)
    if t == _T_BYTES:
        (n,) = struct.unpack_from(">I", buf, off)
        off += 4
        return buf[off : off + n], off + n
    if t == _T_LIST:
        (n,) = struct.unpack_from(">I", buf, off)
        off += 4
        out = []
        for _ in range(n):
            v, off = _loads(buf, off)
            out.append(v)
        return out, off
    if t == _T_DICT:
        (n,) = struct.unpack_from(">I", buf, off)
        off += 4
        d = {}
        for _ in range(n):
            k, off = _read_str(buf, off)
            d[k], off = _loads(buf, off)
        return d, off
    if t == _T_NDARRAY:
        dt, off = _read_str(buf, off)
        (ndim,) = struct.unpack_from(">B", buf, off)
        off += 1
        shape = []
        for _ in range(ndim):
            (d,) = struct.unpack_from(">I", buf, off)
            shape.append(d)
            off += 4
        dtype = np.dtype(dt)
        nb = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        a = np.frombuffer(buf[off : off + nb], dtype=dtype).reshape(shape)
        return a.copy(), off + nb
    raise ValueError(f"bad pmt type byte 0x{t:02x} at offset {off - 1}")


def loads(buf: bytes) -> Any:
    """Deserialize one value (cf. pmt::deserialize); trailing bytes error."""
    v, off = _loads(bytes(buf), 0)
    if off != len(buf):
        raise ValueError(f"{len(buf) - off} trailing bytes after value")
    return v


def dumps_pdu(meta: dict, payload: bytes) -> bytes:
    """Serialize a (metadata, u8vector) PDU pair, the reference's message
    convention (cf. pmt::cons(meta_dict, u8vector))."""
    return dumps([meta, bytes(payload)])


def loads_pdu(buf: bytes) -> tuple[dict, bytes]:
    meta, payload = loads(buf)
    return meta, payload
