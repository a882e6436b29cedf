"""Score a recovered SLAC lattice against the injected distortion field.

Counterpart of ``elasticreconstruction_tpu/eval/lattice_recovery.py``. On the
synthetic benchmark the injected field is analytic
(``synthetic/distortion.py``), so the exact correction vector at every
observed point is known and the learned lattice can be scored directly, not
only through the trajectory error.

Protocol: sample observed (distorted) points of the fragment clouds inside
the lattice cube, evaluate the learned trilinear correction and the
ground-truth correction at each, and compare:

- ``residual_rms``: raw ``|learned - gt|``, which charges the gauge too;
- ``residual_rms_aligned``: after the best-fit similarity transform (Umeyama)
  between the learned-corrected and gt-corrected point sets, the null space
  of the shared-lattice objective; ``recovery_fraction`` = 1 - aligned
  residual / injected RMS (1 is perfect, <= 0 learned nothing).

The sampling and the alignment run in numpy with the reference's draws; the
two fields are evaluated in torch on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import camera as cam
from ..core.types import PointCloud, resolve_device
from ..elastic.lattice import Lattice, deform
from ..synthetic.distortion import DepthDistortion, gt_correction


def _aligned_residual(src: np.ndarray, dst: np.ndarray, *, scale: bool) -> float:
    """RMS of ``c R src + t - dst`` under the best-fit rigid (``scale=False``,
    Kabsch) or similarity (``scale=True``, Umeyama) transform."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    s = src - mu_s
    d = dst - mu_d
    U, sv, Vt = np.linalg.svd(s.T @ d)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = (U @ S @ Vt).T
    c = float(np.trace(np.diag(sv) @ S) / np.sum(s * s)) if scale else 1.0
    res = c * (s @ R.T) - d
    return float(np.sqrt(np.mean(np.sum(res * res, axis=-1))))


def lattice_recovery(
    lat: Lattice,
    displacement,
    clouds: list[PointCloud],
    dist: DepthDistortion,
    intr: cam.Intrinsics,
    *,
    max_points_per_fragment: int = 4096,
    seed: int = 0,
    device="cuda",
) -> dict:
    """Compare the learned lattice correction to the injected field.

    ``displacement``: (M, 3) shared-lattice vertex displacements (SLAC mode);
    ``clouds``: fragment clouds (numpy or tensors). Points outside the lattice
    cube are left out (the lattice only clamps there). The two fields are
    evaluated on ``device``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    lo = np.asarray(lat.origin, np.float32)
    hi = lo + lat.length
    pts = []
    for c in clouds:
        p = np.asarray(torch.as_tensor(c.points).cpu())[np.asarray(torch.as_tensor(c.mask).cpu())]
        inside = np.all((p >= lo) & (p <= hi), axis=1) & (p[:, 2] > 0.25)
        p = p[inside]
        if len(p) > max_points_per_fragment:
            p = p[rng.choice(len(p), max_points_per_fragment, replace=False)]
        pts.append(p)
    p_obs = np.concatenate(pts, axis=0).astype(np.float32)
    if len(p_obs) == 0:
        return {"error": "no points inside lattice support"}

    p_t = torch.from_numpy(p_obs).to(dev)
    disp = torch.as_tensor(displacement).to(dev, torch.float32)
    learned = deform(lat, disp, p_t).cpu().numpy() - p_obs
    gt = gt_correction(dist, p_t, intr).cpu().numpy()

    injected_rms = float(np.sqrt(np.mean(np.sum(gt * gt, axis=-1))))
    raw = learned - gt
    residual_sim = _aligned_residual(p_obs + learned, p_obs + gt, scale=True)
    return {
        "points": int(len(p_obs)),
        "injected_rms": injected_rms,
        "learned_rms": float(np.sqrt(np.mean(np.sum(learned * learned, axis=-1)))),
        "residual_rms": float(np.sqrt(np.mean(np.sum(raw * raw, axis=-1)))),
        "residual_rms_rigid_aligned": _aligned_residual(p_obs + learned, p_obs + gt, scale=False),
        "residual_rms_aligned": residual_sim,
        "recovery_fraction": float(1.0 - residual_sim / max(injected_rms, 1e-12)),
    }
