"""Single-file RGB-D stream container: the ``.oni`` ingestion equivalent.

A copy of ``elasticreconstruction_tpu/core/stream.py`` (numpy + zlib), so that
the port imports nothing of the JAX package. The file format is the same.

The reference's fragment stage consumes either a directory of depth PNGs or
an OpenNI ``.oni`` recording (SURVEY.md §3.1).  OpenNI is dead and its
container is a sensor-API dump; the capability that matters is *streaming
ingestion*: one file, sequential append while recording, random access by
frame index while processing, no filesystem-per-frame overhead.  This module
provides that TPU-native: depth frames as zlib-compressed uint16 millimeter
images in one container with an offset index, so multi-host pipelines can
``seek`` straight to their sharded frame ranges (SURVEY.md §7 hard-parts #4)
and decode in parallel threads (zlib releases the GIL).

Layout (little-endian):
    magic  b"ERTS"  | u32 version | u32 header_len | header JSON
    per frame: u32 payload_len | zlib(uint16 depth, row-major)
    index: u64 offset per frame | u32 frame_count | u64 index_offset

The header JSON carries intrinsics + depth scale, making the file fully
self-describing (a PNG dataset needs the side-car intrinsics.json).
``pack_stream`` converts a PNG dataset directory; ``Dataset`` auto-detects
``stream.erts`` and reads frames from it instead of PNGs.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

MAGIC = b"ERTS"
VERSION = 1
DEPTH_SCALE = 1000.0  # mm per meter, PrimeSense/ICL-NUIM convention


class StreamWriter:
    """Append depth frames (float32 meters) to a stream file."""

    def __init__(self, path: str | os.PathLike, intr_dict: dict, *, level: int = 1):
        self.path = Path(path)
        self.f = open(self.path, "wb")
        self.level = level
        self.offsets: list[int] = []
        header = json.dumps(
            {"intrinsics": intr_dict, "depth_scale": DEPTH_SCALE}
        ).encode()
        self.f.write(MAGIC)
        self.f.write(struct.pack("<II", VERSION, len(header)))
        self.f.write(header)

    def append(self, depth_m: np.ndarray) -> None:
        mm = np.clip(np.asarray(depth_m, np.float32) * DEPTH_SCALE, 0, 65535)
        payload = zlib.compress(
            np.round(mm).astype("<u2").tobytes(), self.level
        )
        self.offsets.append(self.f.tell())
        self.f.write(struct.pack("<I", len(payload)))
        self.f.write(payload)

    def close(self) -> None:
        index_offset = self.f.tell()
        for o in self.offsets:
            self.f.write(struct.pack("<Q", o))
        self.f.write(struct.pack("<IQ", len(self.offsets), index_offset))
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StreamReader:
    """Random-access frame reads from a stream file (thread-safe)."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            if f.read(4) != MAGIC:
                raise ValueError(f"{self.path}: not an ERTS stream")
            version, hlen = struct.unpack("<II", f.read(8))
            if version != VERSION:
                raise ValueError(f"{self.path}: unsupported stream version {version}")
            self.header = json.loads(f.read(hlen))
            f.seek(-12, os.SEEK_END)
            count, index_offset = struct.unpack("<IQ", f.read(12))
            f.seek(index_offset)
            raw = f.read(8 * count)
            if len(raw) != 8 * count:
                raise ValueError(f"{self.path}: truncated index")
            self.offsets = np.frombuffer(raw, "<u8")
        intr = self.header["intrinsics"]
        self.width = int(intr["width"])
        self.height = int(intr["height"])
        self.depth_scale = float(self.header.get("depth_scale", DEPTH_SCALE))

    def __len__(self) -> int:
        return len(self.offsets)

    def depth(self, k: int) -> np.ndarray:
        with open(self.path, "rb") as f:
            f.seek(int(self.offsets[k]))
            (n,) = struct.unpack("<I", f.read(4))
            payload = f.read(n)
        mm = np.frombuffer(zlib.decompress(payload), "<u2").reshape(
            self.height, self.width
        )
        return mm.astype(np.float32) / self.depth_scale

    def depth_chunk(self, start: int, count: int) -> np.ndarray:
        idx = range(start, min(start + count, len(self)))
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 2)) as ex:
            frames = list(ex.map(self.depth, idx))
        return np.stack(frames) if frames else np.zeros(
            (0, self.height, self.width), np.float32
        )


def pack_stream(dataset_dir: str | os.PathLike, out_path: str | os.PathLike | None = None) -> Path:
    """Convert a PNG dataset directory to a single stream file.

    Crash-safe: writes to a ``.tmp`` sibling and renames into place only after
    the index footer lands, so an interrupted pack never leaves a truncated
    ``stream.erts`` that Dataset would auto-prefer over the intact PNGs.  An
    existing file is validated (footer readable) before being trusted.
    """
    from ..pipeline.dataset import Dataset

    out = Path(out_path) if out_path else Path(dataset_dir) / "stream.erts"
    if out.exists():
        try:
            StreamReader(out)  # validates magic/version/index footer
            return out  # already packed (and Dataset would now read from it)
        except (ValueError, struct.error, json.JSONDecodeError, OSError):
            out.unlink()  # corrupt leftover from a pre-crash-safe pack
    ds = Dataset(dataset_dir)
    tmp = out.with_suffix(out.suffix + ".tmp")
    with StreamWriter(tmp, ds.intrinsics._asdict()) as w:
        chunk = 64
        for s in range(0, len(ds), chunk):
            for d in ds.depth_chunk(s, chunk):
                w.append(d)
    os.replace(tmp, out)
    return out
