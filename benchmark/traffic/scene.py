"""A scene's fragment files, as the fragments stage leaves them for the registration stage.

The clouds are ``fragments.py``'s: consecutive fragments of the livingroom
orbit, each fused from every ``stride``-th of its frames at ground-truth
poses. Written as ``pipeline/stages.py::run_fragments`` writes them
(``reference/files.py`` holds the formats): ``cloud_bin_<f>.pcd``, the
cloud's valid rows in the fragment's own frame; ``health_<f>.json``, healthy
unless ``f`` is listed under the traffic's ``suspect``; ``fragments.log``,
the chained base poses. Fragment 0's base is the identity, and every edge is
its ground-truth relative pose composed with a drift step of
``drift_m`` metres and ``drift_deg`` degrees along directions drawn from the
seed, as kinfu's odometry would chain them with a small error an edge.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from ..reference import files
from ..reference.geometry import Intrinsics, exp
from . import livingroom
from .fragments import fragment_clouds

HEALTHY = {"min_fitness": 1.0, "max_rmse": 0.0, "min_obs_ratio": 1.0, "frames_unhealthy": 0, "suspect": False}


def orbit_poses(params: dict, frames: int, seed: int) -> np.ndarray:
    """The ``(frames, 4, 4)`` float64 poses ``livingroom.orbit_frames`` renders, without rendering."""
    start = float(np.random.default_rng([seed, 0]).uniform(0.0, 2.0 * np.pi))
    return livingroom.orbit(frames, radius=params["radius"], height=params["height"],
                            sweep=2.0 * np.pi * frames / params["frames_per_orbit"], start_angle=start
                            ).astype(np.float64)


def drifted_bases(params: dict, K: int, seed: int) -> np.ndarray:
    """``(F, 4, 4)`` float64: fragment ``f``'s base pose as the odometry chain gives it, drift included."""
    num = params["fragments"]
    gt = orbit_poses(params, num * K + 1, seed)[:: K][:num]
    rng = np.random.default_rng([seed, 2])
    bases = [np.eye(4)]
    for f in range(num - 1):
        t, r = rng.normal(size=3), rng.normal(size=3)
        step = np.concatenate([params["drift_m"] * t / np.linalg.norm(t),
                               math.radians(params["drift_deg"]) * r / np.linalg.norm(r)])
        edge = np.linalg.inv(gt[f]) @ gt[f + 1] @ exp(torch.from_numpy(step)).numpy()
        bases.append(bases[-1] @ edge)
    return np.stack(bases)


def write_fragments(out: Path, params: dict, config: dict, seed: int, device) -> np.ndarray:
    """Write the scene under ``out`` (the stage's ``fragments`` directory); returns each fragment's
    centroid in its own frame, ``(F, 3)`` float64."""
    out.mkdir(parents=True, exist_ok=True)
    pts, nrm, mask = fragment_clouds(params, config, Intrinsics(**config["camera"]), seed, device)
    suspect = set(params.get("suspect", []))
    for f in range(pts.shape[0]):
        files.write_pcd(out / f"cloud_bin_{f}.pcd", pts[f][mask[f]], nrm[f][mask[f]])
        files.write_health(out / f"health_{f}.json", {"fragment": f, **HEALTHY, "suspect": f in suspect})
    files.write_log(out / "fragments.log", drifted_bases(params, config["frames_per_fragment"], seed))
    w = mask[..., None]
    return (pts.astype(np.float64) * w).sum(1) / np.maximum(w.sum(1), 1)
