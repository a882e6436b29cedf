"""Surface reconstruction error against the analytic scene SDF.

Counterpart of ``elasticreconstruction_tpu/eval/surface_error.py``. The
reference scores surface quality by the mean distance from the reconstructed
mesh to the source CAD model; on the synthetic benchmark the model is an
analytic SDF (``synthetic/scenes.py``), so ``|sdf(x)|`` at reconstructed
points is the distance to the true surface directly (a tight lower bound near
CSG seams, the same for every method compared).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import resolve_device
from ..synthetic.sdf import SDF


def surface_error(scene: SDF, points, *, max_points: int = 200_000, seed: int = 0, device="cuda") -> dict:
    """Distance-to-true-surface statistics of world points ``(N, 3)`` (mesh
    vertices or posed fragment clouds), subsampled to ``max_points`` with the
    reference's draw; the SDF is evaluated on ``device``."""
    dev = resolve_device(device)
    pts = np.asarray(points, np.float32)
    if len(pts) == 0:
        return {"points": 0}
    if len(pts) > max_points:
        rng = np.random.default_rng(seed)
        pts = pts[rng.choice(len(pts), max_points, replace=False)]
    d = np.abs(scene(torch.from_numpy(pts).to(dev)).cpu().numpy())
    return {
        "points": int(len(pts)),
        "mean": float(d.mean()),
        "rmse": float(np.sqrt(np.mean(d * d))),
        "median": float(np.median(d)),
        "p95": float(np.percentile(d, 95.0)),
        "max": float(d.max()),
    }
