"""Readers and writers of the fragment stage's files, for the judge and the control.

``local_<f>.log`` (a trajectory: ``n n n+1`` and four rows a pose),
``cloud_bin_<f>.pcd`` (PCD v0.7, binary float32 ``x y z normal_x normal_y
normal_z``) and ``health_<f>.json``, as ``pipeline/stages.py::run_fragments``
writes them.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def read_log(path) -> np.ndarray:
    tokens = Path(path).read_text().split()
    if len(tokens) % 19:
        raise ValueError(f"{path}: not whole records of 3 ints and 16 floats")
    recs = np.array(tokens, dtype=object).reshape(-1, 19)
    return recs[:, 3:].astype(np.float64).reshape(-1, 4, 4)


def write_log(path, mats) -> None:
    with open(path, "w") as f:
        for n, m in enumerate(np.asarray(mats, dtype=np.float64)):
            f.write(f"{n}\t{n}\t{n + 1}\n")
            for row in m:
                f.write("\t".join(f"{v:.8f}" for v in row) + "\n")


def read_pcd(path) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no DATA line")
            key, *vals = line.decode("ascii").split()
            header[key.upper()] = vals
            if key.upper() == "DATA":
                break
        if header["DATA"][0] != "binary" or header["FIELDS"][:3] != ["x", "y", "z"]:
            raise ValueError(f"{path}: expected binary x y z [normals]")
        n, k = int(header["POINTS"][0]), len(header["FIELDS"])
        arr = np.frombuffer(f.read(n * k * 4), dtype="<f4").reshape(n, k)
    return arr[:, :3].copy(), (arr[:, 3:6].copy() if k >= 6 else np.zeros((n, 3), np.float32))


def write_pcd(path, points: np.ndarray, normals: np.ndarray) -> None:
    n = points.shape[0]
    header = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
              "FIELDS x y z normal_x normal_y normal_z\nSIZE 4 4 4 4 4 4\nTYPE F F F F F F\n"
              f"COUNT 1 1 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n")
    data = np.concatenate([points, normals], 1).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())


def health(fitness: np.ndarray, rmse: np.ndarray, obs: np.ndarray, healthy_obs: float, healthy_fit: float) -> dict:
    """The health record of a fragment from its tracked frames' (1..K) numbers."""
    bad = (obs < healthy_obs) | (fitness < healthy_fit)
    return {"min_fitness": float(fitness.min()), "max_rmse": float(rmse.max()), "min_obs_ratio": float(obs.min()),
            "frames_unhealthy": int(bad.sum()), "suspect": bool(bad.any())}


def read_health(path) -> dict:
    return json.loads(Path(path).read_text())


def write_health(path, record: dict) -> None:
    Path(path).write_text(json.dumps(record, indent=2))
