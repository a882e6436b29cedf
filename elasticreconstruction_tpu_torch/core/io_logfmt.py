"""Reference-compatible file formats: .log, .info, .pcd, corres, ctr, xyzn and .ply.

These formats are the reference's inter-stage API: every executable
communicates through them. The writers produce byte-identical files to the
JAX package's ``core/io_logfmt.py`` for the same matrices, so stage-level
parity between the two packages can be checked on the files alone.

.log  (trajectory / edge list)::

    <i> <j> <k>          # metadata ints; for trajectories i=j=frame idx, k=i+1
    m00 m01 m02 m03      # 4x4 transform, row-major, 4 lines

.info (information matrices)::

    <i> <j> <k>
    6 lines x 6 floats   # 6x6 information matrix

Host-side numpy IO by design: tensors are moved to the host by the caller.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np


@dataclass
class TrajectoryEntry:
    i: int
    j: int
    k: int
    transform: np.ndarray  # (4, 4) float64


@dataclass
class InfoEntry:
    i: int
    j: int
    k: int
    info: np.ndarray  # (6, 6) float64


@dataclass
class Trajectory:
    entries: list[TrajectoryEntry] = field(default_factory=list)

    def matrices(self) -> np.ndarray:
        return np.stack([e.transform for e in self.entries]) if self.entries else np.zeros((0, 4, 4))

    @staticmethod
    def from_matrices(mats, index_offset: int = 0) -> "Trajectory":
        """A trajectory of poses: entry ``n`` carries the metadata ``n n n+1``."""
        return Trajectory(
            [
                TrajectoryEntry(n + index_offset, n + index_offset, n + index_offset + 1,
                                np.asarray(m, dtype=np.float64))
                for n, m in enumerate(np.asarray(mats))
            ]
        )


@dataclass
class InfoFile:
    entries: list[InfoEntry] = field(default_factory=list)


def _read_records(path, width: int, what: str):
    with open(path, "r") as f:
        tokens = f.read().split()
    rec = 3 + width
    pos = 0
    out = []
    while pos + rec <= len(tokens):
        i, j, k = int(tokens[pos]), int(tokens[pos + 1]), int(tokens[pos + 2])
        mat = np.array([float(t) for t in tokens[pos + 3 : pos + rec]], dtype=np.float64)
        out.append((i, j, k, mat))
        pos += rec
    if pos != len(tokens):
        raise ValueError(
            f"{path}: trailing/truncated record ({len(tokens) - pos} leftover tokens; "
            f"{what} record is 3 ints + {width} floats)"
        )
    return out


def _write_records(path, records) -> None:
    with open(path, "w") as f:
        for i, j, k, mat in records:
            f.write(f"{i}\t{j}\t{k}\n")
            for row in np.asarray(mat, dtype=np.float64):
                f.write("\t".join(f"{v:.8f}" for v in row) + "\n")


def read_log(path: str | os.PathLike) -> Trajectory:
    return Trajectory(
        [TrajectoryEntry(i, j, k, m.reshape(4, 4)) for i, j, k, m in _read_records(path, 16, "a .log")]
    )


def write_log(path: str | os.PathLike, traj: Trajectory) -> None:
    _write_records(path, ((e.i, e.j, e.k, e.transform) for e in traj.entries))


def read_info(path: str | os.PathLike) -> InfoFile:
    return InfoFile(
        [InfoEntry(i, j, k, m.reshape(6, 6)) for i, j, k, m in _read_records(path, 36, "an .info")]
    )


def write_info(path: str | os.PathLike, info: InfoFile) -> None:
    _write_records(path, ((e.i, e.j, e.k, e.info) for e in info.entries))


def read_corres(path: str | os.PathLike) -> np.ndarray:
    """Correspondence index pairs ``(N, 2)`` int32 (BuildCorrespondence output)."""
    data = np.loadtxt(path, dtype=np.int64, ndmin=2)
    if data.size == 0:
        return np.zeros((0, 2), dtype=np.int32)
    return data[:, :2].astype(np.int32)


def write_corres(path: str | os.PathLike, pairs: np.ndarray) -> None:
    np.savetxt(path, np.asarray(pairs, dtype=np.int64), fmt="%d")


def corres_filename(i: int, j: int) -> str:
    return f"corres_{i}_{j}.txt"


def parse_corres_filename(name: str) -> tuple[int, int] | None:
    m = re.fullmatch(r"corres_(\d+)_(\d+)\.txt", name)
    return (int(m.group(1)), int(m.group(2))) if m else None


def read_ctr(path: str | os.PathLike) -> tuple[np.ndarray, int, float]:
    """Control lattice file -> (positions ``(num, 3)``, resolution, length)."""
    with open(path, "r") as f:
        header = f.readline().split()
        num, res, length = int(header[0]), int(header[1]), float(header[2])
        data = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if data.shape[0] != num:
        raise ValueError(f"{path}: ctr file claims {num} vertices, has {data.shape[0]}")
    return data[:, :3], res, length


def write_ctr(path: str | os.PathLike, positions: np.ndarray, resolution: int, length: float) -> None:
    positions = np.asarray(positions, dtype=np.float64)
    with open(path, "w") as f:
        f.write(f"{positions.shape[0]} {resolution} {length:.6f}\n")
        for p in positions:
            f.write(f"{p[0]:.8f} {p[1]:.8f} {p[2]:.8f}\n")


def write_xyzn(path: str | os.PathLike, points: np.ndarray, normals: np.ndarray) -> None:
    """Plain ``x y z nx ny nz`` per line (the reference FragmentOptimizer's
    optional deformed-cloud output format)."""
    data = np.concatenate([np.asarray(points, np.float64), np.asarray(normals, np.float64)], axis=1)
    np.savetxt(path, data, fmt="%.6f")


def read_xyzn(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray]:
    arr = np.loadtxt(path, dtype=np.float64, ndmin=2)
    return arr[:, :3].astype(np.float32), arr[:, 3:6].astype(np.float32)


def write_pcd(
    path: str | os.PathLike,
    points: np.ndarray,
    normals: np.ndarray | None = None,
    *,
    binary: bool = True,
) -> None:
    """PCD v0.7 writer (fragment clouds — reference ``cloud_bin_<i>.pcd``).

    Binary by default (an ASCII parse of a 131k-point fragment costs seconds
    on the host); ``binary=False`` writes the human-readable ASCII form.
    """
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32)
        fields = "x y z normal_x normal_y normal_z"
        sizes, types, counts = "4 4 4 4 4 4", "F F F F F F", "1 1 1 1 1 1"
        data = np.ascontiguousarray(np.concatenate([points, normals], axis=1))
    else:
        fields = "x y z"
        sizes, types, counts = "4 4 4", "F F F", "1 1 1"
        data = np.ascontiguousarray(points)
    mode = "binary" if binary else "ascii"
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\nSIZE {sizes}\nTYPE {types}\nCOUNT {counts}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA {mode}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(data.astype("<f4").tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def read_pcd(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray | None]:
    """ASCII/binary PCD reader -> (points ``(N, 3)``, normals ``(N, 3)`` or None)."""
    with open(path, "rb") as f:
        header: dict[str, list[str]] = {}
        while True:
            raw_line = f.readline()
            if not raw_line:
                raise ValueError(f"{path}: PCD header has no DATA line")
            line = raw_line.decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, *vals = line.split()
            header[key.upper()] = vals
            if key.upper() == "DATA":
                data_mode = vals[0]
                break
        fields = [s.lower() for s in header["FIELDS"]]
        n = int(header["POINTS"][0])
        if data_mode == "ascii":
            arr = np.loadtxt(f, dtype=np.float64, max_rows=n, ndmin=2)
        elif data_mode == "binary":
            sizes = [int(s) for s in header["SIZE"]]
            types = header["TYPE"]
            np_types = {("F", 4): "f4", ("F", 8): "f8", ("U", 4): "u4", ("U", 1): "u1", ("I", 4): "i4"}
            dt = np.dtype([(fld, np_types[(t, s)]) for fld, t, s in zip(fields, types, sizes)])
            raw = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
            arr = np.stack([raw[fld].astype(np.float64) for fld in fields], axis=1)
        else:
            raise ValueError(f"unsupported PCD DATA mode {data_mode!r}")
    ix = [fields.index(c) for c in ("x", "y", "z")]
    points = arr[:, ix].astype(np.float32)
    normals = None
    if all(c in fields for c in ("normal_x", "normal_y", "normal_z")):
        jx = [fields.index(c) for c in ("normal_x", "normal_y", "normal_z")]
        normals = arr[:, jx].astype(np.float32)
    return points, normals


def write_ply_mesh(path: str | os.PathLike, vertices: np.ndarray, triangles: np.ndarray) -> None:
    """ASCII PLY mesh writer (the integrate stage's ``mesh.ply``)."""
    vertices = np.asarray(vertices, dtype=np.float32)
    triangles = np.asarray(triangles, dtype=np.int64)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {vertices.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {triangles.shape[0]}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in vertices:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in triangles:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def read_ply_mesh(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray]:
    """The files of :func:`write_ply_mesh` -> (vertices ``(V, 3)`` f32, faces ``(F, 3)`` int64)."""
    with open(path) as f:
        if f.readline().strip() != "ply" or f.readline().strip() != "format ascii 1.0":
            raise ValueError(f"{path}: not an ASCII PLY file")
        counts = {}
        for line in f:
            words = line.split()
            if words[:1] == ["element"]:
                counts[words[1]] = int(words[2])
            elif words[:1] == ["end_header"]:
                break
        else:
            raise ValueError(f"{path}: PLY header has no end_header line")
        nv, nf = counts.get("vertex", 0), counts.get("face", 0)
        verts = np.loadtxt(f, dtype=np.float32, max_rows=nv, ndmin=2) if nv else np.zeros((0, 3), np.float32)
        faces = np.loadtxt(f, dtype=np.int64, max_rows=nf, ndmin=2) if nf else np.zeros((0, 4), np.int64)
    if verts.shape != (nv, 3) or faces.shape != (nf, 4):
        raise ValueError(f"{path}: expected {nv} vertices and {nf} faces")
    if nf and not (faces[:, 0] == 3).all():
        raise ValueError(f"{path}: faces other than triangles")
    return verts, faces[:, 1:]
