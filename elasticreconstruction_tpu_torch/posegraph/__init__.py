"""Robust pose-graph optimisation with line processes.

The reference's GraphOptimizer executable: Levenberg-damped Gauss-Newton over
SE(3) vertices and edges alternated with closed-form line-process updates that
down-weight and finally prune false loop closures. Exact per-edge Jacobians by
forward-mode autodiff of ``se3.log``, dense normal equations, and the
``l = (mu / (mu + r^2))^2`` alternation.
"""

from . import robust_pgo
from .robust_pgo import EdgeList, PGOConfig, PGOResult, optimize_pose_graph

__all__ = ["robust_pgo", "EdgeList", "PGOConfig", "PGOResult", "optimize_pose_graph"]
