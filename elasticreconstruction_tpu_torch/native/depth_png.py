"""Depth PNG codec in numpy and the standard library's ``zlib``.

Counterpart of ``elasticreconstruction_tpu/native/loader.py`` and its C codec
(``depth_png.cc``), for machines with neither a C++ toolchain with zlib
headers nor PIL. It reads exactly what the C codec reads: 8- or 16-bit
grayscale, non-interlaced PNG with any of the five row filters (8-bit samples
are widened); it writes 16-bit grayscale PNG in millimetres, every row with
filter 0 (None), zlib level 6, as the C codec does. Decoding vectorises the
None, Sub and Up rows; Average and Paeth rows are decoded byte by byte.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DEPTH_SCALE = 1000.0  # mm per meter
_SIG = b"\x89PNG\r\n\x1a\n"


def _chunks(buf: bytes):
    pos = 8
    while pos + 8 <= len(buf):
        (length,) = struct.unpack(">I", buf[pos : pos + 4])
        ctype = buf[pos + 4 : pos + 8]
        if pos + 12 + length > len(buf):
            raise ValueError("truncated PNG chunk")
        yield ctype, buf[pos + 8 : pos + 8 + length]
        if ctype == b"IEND":
            return
        pos += 12 + length


def _paeth_row(raw: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    cur = bytearray(len(raw))
    up = prev.tolist()
    for x, r in enumerate(raw.tolist()):
        a = cur[x - bpp] if x >= bpp else 0
        b = up[x]
        c = up[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[x] = (r + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _average_row(raw: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    cur = bytearray(len(raw))
    up = prev.tolist()
    for x, r in enumerate(raw.tolist()):
        a = cur[x - bpp] if x >= bpp else 0
        cur[x] = (r + ((a + up[x]) >> 1)) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png_u16(buf: bytes) -> np.ndarray:
    """PNG bytes -> ``(H, W)`` uint16 samples (8-bit samples widened)."""
    if len(buf) < 8 + 25 or buf[:8] != _SIG:
        raise ValueError("not a PNG file")
    width = height = 0
    bit_depth = 0
    idat = []
    for ctype, data in _chunks(buf):
        if ctype == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", data[:13])
            if interlace != 0:
                raise ValueError("interlaced PNG is not supported")
            if color_type != 0:
                raise ValueError("only grayscale PNG is supported")
            if bit_depth not in (8, 16):
                raise ValueError(f"unsupported PNG bit depth {bit_depth}")
        elif ctype == b"IDAT":
            idat.append(data)
    if width == 0 or height == 0:
        raise ValueError("PNG without a valid IHDR")
    bpp = bit_depth // 8
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != (stride + 1) * height:
        raise ValueError("PNG image data has the wrong size")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        filt, line = rows[y, 0], rows[y, 1:]
        if filt == 0:
            cur = line
        elif filt == 1:  # Sub: a running sum along each byte lane, mod 256
            cur = np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif filt == 2:  # Up
            cur = line + prev
        elif filt == 3:
            cur = _average_row(line, prev, bpp)
        elif filt == 4:
            cur = _paeth_row(line, prev, bpp)
        else:
            raise ValueError(f"bad PNG row filter {filt}")
        out[y] = cur
        prev = out[y]
    if bit_depth == 16:
        return out.view(">u2").astype(np.uint16)
    return out.astype(np.uint16)


def encode_png_u16(mm: np.ndarray) -> bytes:
    """``(H, W)`` uint16 -> 16-bit grayscale PNG bytes, filter 0 rows, zlib level 6."""
    h, w = mm.shape
    rows = np.zeros((h, 1 + 2 * w), np.uint8)
    rows[:, 1:] = np.ascontiguousarray(mm, ">u2").view(np.uint8).reshape(h, 2 * w)

    def chunk(ctype: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + ctype + data + struct.pack(">I", zlib.crc32(ctype + data))

    ihdr = struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)
    return _SIG + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b"")


def read_depth_u16(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png_u16(f.read())


def read_depth(path) -> np.ndarray:
    """Depth map in meters, float32 ``(H, W)``; 0 = invalid."""
    return read_depth_u16(path).astype(np.float32) / DEPTH_SCALE


def read_depth_batch(paths, width: int, height: int, *, threads: int | None = None) -> np.ndarray:
    """``(N, H, W)`` float32 meters, decoded on ``threads`` threads (zlib
    releases the interpreter lock). Raises if a file is not ``width x height``."""
    paths = [str(p) for p in paths]

    def one(p):
        d = read_depth(p)
        if d.shape != (height, width):
            raise ValueError(f"{p}: {d.shape[1]}x{d.shape[0]} depth map, expected {width}x{height}")
        return d

    if not paths:
        return np.zeros((0, height, width), np.float32)
    workers = threads if threads is not None else min(len(paths), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        return np.stack(list(ex.map(one, paths)))


def write_depth(path, depth_m: np.ndarray) -> None:
    """Float meters -> 16-bit millimetre PNG (rounded, clipped to 0..65535)."""
    mm = np.clip(np.round(np.asarray(depth_m) * DEPTH_SCALE), 0, 65535).astype(np.uint16)
    with open(path, "wb") as f:
        f.write(encode_png_u16(mm))
