"""Pairwise-registration precision/recall against ground-truth edges.

Reference equivalent: the Matlab_Toolbox registration evaluation that compares
a result.log/.info against gt.log/gt.info on the augmented ICL-NUIM fragment
pair benchmark: a proposed edge (i, j, T) is correct if its pose error
against the ground-truth relative pose is within threshold under the
ground-truth information matrix. A copy of
``elasticreconstruction_tpu/eval/registration_pr.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


def edge_error_sq(
    T_est: np.ndarray, T_gt: np.ndarray, info_gt: np.ndarray, num_points: float | None = None
) -> float:
    """Mahalanobis-style mean-squared correspondence error of a proposed edge.

    The CVPR'15 protocol scores xi^T Lambda xi / n where xi = log-ish 6-vector
    of the relative error and Lambda is the ground-truth information matrix
    accumulated over n fragment points (so the quotient is a mean squared
    point-displacement, comparable against a metric threshold^2).  When
    ``num_points`` is None it is read from ``info_gt[0, 0]``: with
    G = [I | -[p]x] the (0, 0) entry of sum G^T G is exactly the point count
    (the reference's Matlab evaluation normalizes the same way).
    """
    if num_points is None:
        num_points = float(info_gt[0, 0])
    err = np.linalg.inv(T_gt) @ T_est
    # Small-displacement parameterization (tx, ty, tz, rx, ry, rz) matching the
    # G^T G accumulation used to build .info matrices (see registration.infomat).
    t = err[:3, 3]
    r = 0.5 * np.array([err[2, 1] - err[1, 2], err[0, 2] - err[2, 0], err[1, 0] - err[0, 1]])
    xi = np.concatenate([t, r])
    return float(xi @ info_gt @ xi) / max(num_points, 1.0)


def precision_recall(
    est_edges: list[tuple[int, int, np.ndarray]],
    gt_edges: list[tuple[int, int, np.ndarray]],
    gt_infos: dict[tuple[int, int], np.ndarray],
    err_threshold: float = 0.2,
    num_points: float | None = None,
    nonconsecutive_only: bool = True,
) -> dict:
    """Precision/recall of proposed registration edges vs ground truth.

    ``est_edges``/``gt_edges``: (i, j, T_rel 4x4).  Odometry (|i-j|==1) edges
    are excluded by default, matching the benchmark's loop-closure focus.
    """
    gt_map = {}
    for i, j, T in gt_edges:
        if nonconsecutive_only and abs(i - j) <= 1:
            continue
        gt_map[(i, j)] = T
    n_correct = 0
    n_proposed = 0
    for i, j, T in est_edges:
        if nonconsecutive_only and abs(i - j) <= 1:
            continue
        n_proposed += 1
        key = (i, j)
        if key not in gt_map:
            continue
        info = gt_infos.get(key, np.eye(6))
        if edge_error_sq(T, gt_map[key], info, num_points) < err_threshold**2:
            n_correct += 1
    n_gt = len(gt_map)
    return {
        # Undefined ratios (no proposals / no gt edges) report None, not 0.0:
        # "precision 0" claims every proposal was wrong; an odometry-only run
        # proposes nothing.
        "precision": n_correct / n_proposed if n_proposed else None,
        "recall": n_correct / n_gt if n_gt else None,
        "n_correct": n_correct,
        "n_proposed": n_proposed,
        "n_gt": n_gt,
    }
