"""The registration benchmark's synthetic scene: overlapping swaths of one surface.

A numpy copy of ``bench.py::make_fragments`` (same random stream, same
surface, same per-fragment poses up to f32 rounding), kept here so the port's
smoke run and tests need nothing from the JAX package. Fragment ``f`` covers
``x in [-1.5 + 0.8 f, 1.5 + 0.8 f]``, so only adjacent fragments overlap
well, and each lives in its own local frame.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .core import io_logfmt, se3
from .core.types import PointCloud


def make_fragments(num: int, n: int = 20000, seed: int = 0) -> tuple[PointCloud, np.ndarray]:
    """``num`` fragments of ``n`` points each, and their local-to-world poses.

    Returns (a ``PointCloud`` of numpy arrays ``(num, n, ...)``, poses
    ``(num, 4, 4)`` float32). Fragment j maps into fragment i's frame by
    ``inv(poses[i]) @ poses[j]``.
    """
    rng = np.random.default_rng(seed)

    def surf(lo, hi):
        x = rng.uniform(lo, hi, n).astype(np.float32)
        y = rng.uniform(-1.5, 1.5, n).astype(np.float32)
        z = (
            0.35 * np.sin(2.3 * x) * np.cos(1.7 * y)
            + 0.2 * np.sin(4.1 * y)
            + 0.12 * np.cos(5.3 * x)
        ).astype(np.float32)
        return np.stack([x, y, z], 1)

    clouds, poses = [], []
    for f in range(num):
        world = surf(-1.5 + 0.8 * f, 1.5 + 0.8 * f)
        T = se3.exp(torch.from_numpy(rng.uniform(-0.3, 0.3, 6).astype(np.float32)))
        clouds.append(se3.apply(se3.inverse(T), torch.from_numpy(world)).numpy())
        poses.append(T.numpy())
    points = np.stack(clouds)
    return (
        PointCloud(points, np.zeros_like(points), np.ones(points.shape[:-1], bool)),
        np.stack(poses),
    )


def surface_normals(world: np.ndarray) -> np.ndarray:
    """Unit normals of the scene's height field z = f(x, y) at world points ``(..., 3)``."""
    x, y = world[..., 0].astype(np.float64), world[..., 1].astype(np.float64)
    fx = 0.35 * 2.3 * np.cos(2.3 * x) * np.cos(1.7 * y) - 0.12 * 5.3 * np.sin(5.3 * x)
    fy = -0.35 * 1.7 * np.sin(2.3 * x) * np.sin(1.7 * y) + 0.2 * 4.1 * np.cos(4.1 * y)
    nrm = np.stack([-fx, -fy, np.ones_like(x)], -1)
    return (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)


def write_fragments_dir(
    out, num: int, n: int = 20000, seed: int = 0, drift: float = 0.01
) -> tuple[np.ndarray, np.ndarray]:
    """Write the scene as the fragment stage's artifacts under ``out/fragments``.

    What ``run_registration`` reads: ``cloud_bin_<f>.pcd`` (the
    :func:`make_fragments` clouds with their surface normals, local frame),
    ``health_<f>.json`` (all healthy) and ``fragments.log``, the chained base
    poses: fragment 0 at the identity and every edge the ground-truth relative
    pose times a drift ``exp(xi)``, ``xi ~ N(0, drift)`` per component (m and
    rad), drawn from ``seed``. Returns the ground-truth poses relative to
    fragment 0, ``(num, 4, 4)`` float64, and each fragment's centroid in its
    own frame, ``(num, 3)``.
    """
    frag_dir = Path(out) / "fragments"
    frag_dir.mkdir(parents=True, exist_ok=True)
    clouds, poses = make_fragments(num, n=n, seed=seed)
    poses = poses.astype(np.float64)
    rng = np.random.default_rng([seed, 1])
    base = np.eye(4)
    bases = []
    for f in range(num):
        world = clouds.points[f].astype(np.float64) @ poses[f, :3, :3].T + poses[f, :3, 3]
        normals = surface_normals(world) @ poses[f, :3, :3].astype(np.float32)  # R^T n, row form
        io_logfmt.write_pcd(frag_dir / f"cloud_bin_{f}.pcd", clouds.points[f], normals)
        health = {"fragment": f, "min_fitness": 1.0, "max_rmse": 0.0, "min_obs_ratio": 1.0,
                  "frames_unhealthy": 0, "suspect": False}
        with open(frag_dir / f"health_{f}.json", "w") as hf:
            json.dump(health, hf, indent=2)
        bases.append(base)
        if f + 1 < num:
            xi = torch.from_numpy(rng.normal(0.0, drift, 6))
            base = base @ np.linalg.inv(poses[f]) @ poses[f + 1] @ se3.exp(xi).numpy()
    io_logfmt.write_log(frag_dir / "fragments.log", io_logfmt.Trajectory.from_matrices(np.stack(bases)))
    return np.linalg.inv(poses[0]) @ poses, clouds.points.astype(np.float64).mean(1)


def pose_error(T_est: np.ndarray, T_gt: np.ndarray) -> tuple[float, float]:
    """(translation m, rotation rad) norms of ``log(T_est @ inv(T_gt))``."""
    d = se3.log(torch.from_numpy(np.asarray(T_est, np.float64) @ np.linalg.inv(np.asarray(T_gt, np.float64))))
    d = d.numpy()
    return float(np.linalg.norm(d[:3])), float(np.linalg.norm(d[3:]))


def placement_error(T_est: np.ndarray, T_gt: np.ndarray, at: np.ndarray) -> tuple[float, float]:
    """(m, rad) by which ``T_est`` misplaces the point ``at`` and misrotates, against ``T_gt``.

    :func:`make_fragments` keeps every local frame within 0.3 m of the world
    origin, so fragment ``f``'s points lie about ``0.8 f`` m from their own
    frame's origin and a milliradian of rotation error reads there as
    centimetres of translation. Measured at the fragment's centroid, the
    error is that of the data, whatever the frame.
    """
    T_est, T_gt = np.asarray(T_est, np.float64), np.asarray(T_gt, np.float64)
    moved = (T_est[:3, :3] - T_gt[:3, :3]) @ at + (T_est[:3, 3] - T_gt[:3, 3])
    return float(np.linalg.norm(moved)), pose_error(T_est, T_gt)[1]
