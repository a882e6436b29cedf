"""The registration benchmark's synthetic scene: overlapping swaths of one surface.

A numpy copy of ``bench.py::make_fragments`` (same random stream, same
surface, same per-fragment poses up to f32 rounding), kept here so the port's
smoke run and tests need nothing from the JAX package. Fragment ``f`` covers
``x in [-1.5 + 0.8 f, 1.5 + 0.8 f]``, so only adjacent fragments overlap
well, and each lives in its own local frame.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import se3
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


def pose_error(T_est: np.ndarray, T_gt: np.ndarray) -> tuple[float, float]:
    """(translation m, rotation rad) norms of ``log(T_est @ inv(T_gt))``."""
    d = se3.log(torch.from_numpy(np.asarray(T_est, np.float64) @ np.linalg.inv(np.asarray(T_gt, np.float64))))
    d = d.numpy()
    return float(np.linalg.norm(d[:3])), float(np.linalg.norm(d[3:]))
