"""Minimal PNG codec on the standard library's zlib.

Reads 8-bit grayscale, gray+alpha, RGB and RGBA images, non-interlaced,
with all five row filter types; writes 8-bit grayscale and RGB (and RGBA)
with filter 0. That covers every image this repository writes or reads.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # color type -> samples per pixel
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode(image: np.ndarray) -> bytes:
    """(h, w) or (h, w, c) uint8 array, c in 1..4 -> PNG bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"unsupported image shape {image.shape}")
    h, w, c = img.shape
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        ftype = raw[y, 0]
        line = raw[y, 1:].astype(np.int64)
        if ftype == 0:  # None
            cur = line
        elif ftype == 1:  # Sub: running sum per byte lane, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prior) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential in x
            cur = line.copy()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + prior[i]) >> 1
                else:
                    upleft = prior[i - bpp] if i >= bpp else 0
                    pred = _paeth(int(left), int(prior[i]), int(upleft))
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (h, w) or (h, w, c) uint8 array."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type {color}, interlace {interlace}")
    c = _CHANNELS[color]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)
    img = _unfilter(raw, h, stride, c).reshape(h, w, c)
    return img[..., 0] if c == 1 else img
