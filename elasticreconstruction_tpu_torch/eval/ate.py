"""Trajectory evaluation: absolute trajectory error (ATE).

Counterpart of ``elasticreconstruction_tpu/eval/ate.py``: translational errors
after the best rigid alignment of the estimated positions onto ground truth
(the TUM / ICL-NUIM protocol of the reference's Matlab toolbox).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3


class ATEResult(NamedTuple):
    rmse: torch.Tensor
    mean: torch.Tensor
    median: torch.Tensor
    max: torch.Tensor
    per_frame: torch.Tensor  # (N,) translational errors after alignment
    alignment: torch.Tensor  # (4, 4) estimated->gt rigid alignment


def align_trajectories(est_t: torch.Tensor, gt_t: torch.Tensor) -> torch.Tensor:
    """Best rigid transform mapping estimated positions onto ground truth."""
    return se3.kabsch(est_t[None], gt_t[None])[0]


def median(x: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D tensor, the mean of the two middle values for an even
    count (as ``jnp.median``; ``torch.median`` returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def absolute_trajectory_error(
    est_poses: torch.Tensor, gt_poses: torch.Tensor, align: bool = True
) -> ATEResult:
    """ATE between pose trajectories ``(N, 4, 4)`` (camera-to-world)."""
    est_t = est_poses[:, :3, 3]
    gt_t = gt_poses[:, :3, 3]
    if align:
        T = align_trajectories(est_t, gt_t)
    else:
        T = torch.eye(4, dtype=est_t.dtype, device=est_t.device)
    est_aligned = est_t @ T[:3, :3].T + T[:3, 3]
    err = torch.linalg.norm(est_aligned - gt_t, dim=-1)
    return ATEResult(
        rmse=torch.sqrt(torch.mean(err**2)),
        mean=torch.mean(err),
        median=median(err),
        max=torch.max(err),
        per_frame=err,
        alignment=T,
    )


def relative_pose_error(est_poses: torch.Tensor, gt_poses: torch.Tensor, delta: int = 1):
    """RPE: translational and rotational drift over a fixed frame delta."""
    est_rel = se3.inverse(est_poses[:-delta]) @ est_poses[delta:]
    gt_rel = se3.inverse(gt_poses[:-delta]) @ gt_poses[delta:]
    err_T = se3.inverse(gt_rel) @ est_rel
    trans_err = torch.linalg.norm(err_T[:, :3, 3], dim=-1)
    rot_err = torch.linalg.norm(se3.so3_log(err_T[:, :3, :3]), dim=-1)
    return trans_err, rot_err
