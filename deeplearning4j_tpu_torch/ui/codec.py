"""Compact binary codec for stats reports: the port of
``deeplearning4j_tpu/ui/codec.py`` (the SBE role of
``ui/stats/sbe/UpdateEncoder.java``).

A small TLV (type-length-value) format over nested dicts, behind a
``DLTS`` magic and a version. The bytes equal the reference's for every
supported type, and the native validator (``nativelib.tlv_validate``)
accepts them, so a report written by either package decodes in the
other.

Supported value types: None, bool, int, float, str, bytes, float32 ndarray
(any rank), list of supported values, dict[str, supported]. Values are
host values: a report's tensors are copied to the host before they are
encoded (``ui/stats.py``).
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"DLTS"
VERSION = 1

_T_NONE = 0
_T_BOOL = 1
_T_INT = 2
_T_FLOAT = 3
_T_STR = 4
_T_BYTES = 5
_T_NDARRAY = 6
_T_LIST = 7
_T_DICT = 8


def _enc_value(out, v):
    if v is None:
        out.append(struct.pack("<B", _T_NONE))
    elif isinstance(v, bool):
        out.append(struct.pack("<BB", _T_BOOL, 1 if v else 0))
    elif isinstance(v, (int, np.integer)):
        out.append(struct.pack("<Bq", _T_INT, int(v)))
    elif isinstance(v, (float, np.floating)):
        out.append(struct.pack("<Bd", _T_FLOAT, float(v)))
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out.append(struct.pack("<BI", _T_STR, len(b)))
        out.append(b)
    elif isinstance(v, (bytes, bytearray)):
        out.append(struct.pack("<BI", _T_BYTES, len(v)))
        out.append(bytes(v))
    elif isinstance(v, np.ndarray):
        arr = np.ascontiguousarray(v, np.float32)
        out.append(struct.pack("<BB", _T_NDARRAY, arr.ndim))
        out.append(struct.pack(f"<{arr.ndim}I", *arr.shape))
        out.append(arr.tobytes())
    elif isinstance(v, (list, tuple)):
        out.append(struct.pack("<BI", _T_LIST, len(v)))
        for item in v:
            _enc_value(out, item)
    elif isinstance(v, dict):
        out.append(struct.pack("<BI", _T_DICT, len(v)))
        for k, item in v.items():
            kb = str(k).encode("utf-8")
            out.append(struct.pack("<H", len(kb)))
            out.append(kb)
            _enc_value(out, item)
    else:
        raise TypeError(f"cannot encode {type(v).__name__}")


def encode(obj: dict) -> bytes:
    out = [MAGIC, struct.pack("<H", VERSION)]
    _enc_value(out, obj)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.data = data
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated stats payload")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))


def _dec_value(r: _Reader):
    (t,) = r.unpack("<B")
    if t == _T_NONE:
        return None
    if t == _T_BOOL:
        return r.unpack("<B")[0] != 0
    if t == _T_INT:
        return r.unpack("<q")[0]
    if t == _T_FLOAT:
        return r.unpack("<d")[0]
    if t == _T_STR:
        (n,) = r.unpack("<I")
        return r.take(n).decode("utf-8")
    if t == _T_BYTES:
        (n,) = r.unpack("<I")
        return bytes(r.take(n))
    if t == _T_NDARRAY:
        (ndim,) = r.unpack("<B")
        shape = r.unpack(f"<{ndim}I") if ndim else ()
        count = int(np.prod(shape)) if ndim else 1
        arr = np.frombuffer(r.take(4 * count), np.float32).reshape(shape)
        return arr.copy()
    if t == _T_LIST:
        (n,) = r.unpack("<I")
        return [_dec_value(r) for _ in range(n)]
    if t == _T_DICT:
        (n,) = r.unpack("<I")
        out = {}
        for _ in range(n):
            (kl,) = r.unpack("<H")
            key = r.take(kl).decode("utf-8")
            out[key] = _dec_value(r)
        return out
    raise ValueError(f"unknown stats TLV type {t}")


def decode(data: bytes) -> dict:
    r = _Reader(data)
    if r.take(4) != MAGIC:
        raise ValueError("bad stats payload magic")
    (version,) = r.unpack("<H")
    if version > VERSION:
        raise ValueError(f"stats payload version {version} > supported {VERSION}")
    return _dec_value(r)
