"""Minimal PNG codec (zlib + numpy) for frames and masks.

Writes 8-bit grey or RGB, one IDAT, filter type 0 on every row.  Reads any
non-interlaced 8-bit PNG: grey, grey+alpha, RGB, RGBA or palette, with all
five row filters (other encoders pick filters per row).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples/pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 -> PNG bytes."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        ctype = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"PNG writer takes (H, W) or (H, W, 3), got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def _unfilter_slow(ftype: int, row: bytearray, prev: bytes, bpp: int):
    """Average (3) and Paeth (4) filters, which run left to right."""
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ftype == 3:
            row[i] = (row[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            row[i] = (row[i] + pred) & 0xFF


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 with C the file's samples per pixel
    (palette images come back as RGB)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    ftypes, rows = raw[:, 0], raw[:, 1:]
    if not ftypes.any():
        out = rows.copy()
    else:
        out = np.empty((h, stride), np.uint8)
        prev = np.zeros(stride, np.uint8)
        for y in range(h):
            f, row = ftypes[y], rows[y]
            if f == 0:
                cur = row
            elif f == 1:      # Sub: running sum along each sample lane
                cur = (np.cumsum(row.reshape(w, bpp), axis=0, dtype=np.uint64)
                       % 256).astype(np.uint8).reshape(-1)
            elif f == 2:      # Up
                cur = row + prev
            elif f in (3, 4):
                buf = bytearray(row.tobytes())
                _unfilter_slow(int(f), buf, prev.tobytes(), bpp)
                cur = np.frombuffer(bytes(buf), np.uint8)
            else:
                raise ValueError(f"bad PNG row filter {f}")
            out[y] = cur
            prev = out[y]
    img = out.reshape(h, w, bpp)
    if ctype == 3:
        img = palette[img[..., 0]]
    return img


def read_png(path: str | Path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())


def write_png(path: str | Path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(img))
