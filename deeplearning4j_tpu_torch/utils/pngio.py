"""PNG encode and decode with the standard library and numpy: the port of
``deeplearning4j_tpu/utils/pngio.py``.

The LFW-style image-directory iterator (``datasets/fetchers.py``,
LFWDataSetIterator.java) reads PNG files through it. Supports 8-bit
grayscale, gray+alpha and RGB(A), non-interlaced, all five scanline
filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["decode_png", "encode_png_gray"]


def encode_png_gray(img: np.ndarray) -> bytes:
    """2-D uint8 array → 8-bit grayscale PNG (filter 0 on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _paeth_vec(a, b, c):
    """Vectorized Paeth predictor over int32 arrays (one pixel-column of
    channels at a time)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 array (H, W) for grayscale or (H, W, C) for
    RGB/RGBA. 8-bit, non-interlaced only (the formats this package writes
    plus common exports)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos = 8
    w = h = None
    bitdepth = color = interlace = None
    idat = []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if w is None:
        raise ValueError("PNG missing IHDR")
    if bitdepth != 8 or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bitdepth={bitdepth}, interlace={interlace}); "
            "only 8-bit non-interlaced is supported")
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color)
    if channels is None:
        raise ValueError(f"unsupported PNG color type {color}")
    raw = zlib.decompress(b"".join(idat))
    stride = w * channels
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG data length mismatch")
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    zero_px = np.zeros(channels, np.int32)
    for r in range(h):
        row = np.frombuffer(
            raw[r * (stride + 1) + 1:(r + 1) * (stride + 1)],
            np.uint8).astype(np.int32)
        ftype = raw[r * (stride + 1)]
        if ftype == 0:
            pass
        elif ftype == 2:    # up — fully vectorized
            row = (row + prev) & 0xFF
        elif ftype in (1, 3, 4):
            # left-neighbor dependency forces a serial walk, but only over
            # PIXEL COLUMNS (the per-column channel math is vectorized)
            row2 = row.reshape(-1, channels)
            pr = prev.reshape(-1, channels)
            left = zero_px
            for x in range(row2.shape[0]):
                if ftype == 1:      # sub
                    row2[x] = (row2[x] + left) & 0xFF
                elif ftype == 3:    # average
                    row2[x] = (row2[x] + (left + pr[x]) // 2) & 0xFF
                else:               # paeth
                    ul = pr[x - 1] if x > 0 else zero_px
                    row2[x] = (row2[x] + _paeth_vec(left, pr[x], ul)) & 0xFF
                left = row2[x]
            row = row2.reshape(-1)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[r] = row.astype(np.uint8)
        prev = row
    img = out.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img
