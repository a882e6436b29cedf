"""Batched point-to-plane ICP: Gauss-Newton steps with a batch-wide early exit.

Counterpart of ``elasticreconstruction_tpu/registration/icp.py``. Each step
finds every transformed source point's nearest dst point, accumulates the 6x6
point-to-plane normal equations, solves them with trace-relative Levenberg
damping and composes the update. The reference's ``lax.while_loop`` is a
Python loop here with one host sync (``.item()``) per step for the exit test.

The correspondence search is the hand-written CUDA kernel on the card:
``kernels/cuda/nn.py`` in the default step, or the whole step fused into
``kernels/cuda/icp_step.py`` with ``fused_step=True``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3, trace
from ..core.types import PointCloud
from ..kernels import knn as _knn
from ..kernels.cuda import icp_step as _icp_step

# |delta|^2 convergence threshold: |delta| = 1e-5 rad/m per step, far below any
# voxel size and above the f32 GN noise floor.
_TOL2 = 1e-10
# Lanes matching under this fraction of their source points after the probe
# steps are hopeless (way below any acceptance threshold) and stop gating.
_HOPELESS_FITNESS = 0.05
_PROBE_ITERS = 5


class ICPResult(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4): maps src-frame points into dst frame
    fitness: torch.Tensor  # fraction of valid src points with a close match
    inlier_rmse: torch.Tensor  # RMSE over matched inliers (m)
    num_inliers: torch.Tensor  # int32


def _step_batch(src_pts, src_mask, dst, T, max_dist, damping, fused_step):
    """One GN iteration over a (B, N, 3) batch; returns (T', delta, (n_in, rmse)).

    J = d r / d xi with left-multiplied update exp(xi) @ T: [n | p x n].
    """
    p = se3.apply(T, src_pts)  # (B, N, 3)
    src_w = src_mask.to(p.dtype)
    if fused_step:
        H, g, n_in, wrr = _icp_step.normal_eqs_batch(
            p, src_w, dst.points, dst.normals, dst.mask, max_dist=max_dist
        )
    else:
        d2, idx = _knn.nearest_auto_batch(p, dst.points, dst.mask)
        H, g, n_in, wrr = _icp_step.normal_eqs_from_matches(
            p, src_w, dst.points, dst.normals, d2, idx, max_dist
        )
    # Trace-relative Levenberg damping: near-zero support yields delta ~ 0, not NaN.
    tr_h = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
    mu = damping * (1.0 + tr_h / 6.0)
    H = H + mu[:, None, None] * torch.eye(6, dtype=H.dtype, device=H.device)
    delta = -torch.linalg.solve(H, g[..., None])[..., 0]
    delta = delta.clamp(-1.0, 1.0) * (n_in >= 6.0).to(delta.dtype)[:, None]
    T_new = se3.compose(se3.exp(delta), T)
    rmse = torch.sqrt(wrr / n_in.clamp_min(1.0))
    return T_new, delta, (n_in, rmse)


def icp_point_to_plane_batch(
    src: PointCloud,
    dst: PointCloud,
    init_transform: torch.Tensor,
    *,
    max_correspondence_distance: float = 0.075,
    iterations: int = 30,
    damping: float = 1e-6,
    coarse_iterations: int = 0,
    coarse_stride: int = 4,
    dead: torch.Tensor | None = None,
    fused_step: bool = False,
) -> ICPResult:
    """Batched refine: ``src``/``dst`` carry ``(B, N, 3)`` tensors, init ``(B, 4, 4)``.

    ``dst`` must carry normals. Runs up to ``iterations`` GN steps and stops
    as soon as every lane has converged or is hopeless (matches under 5% of
    its source points after the first 5 steps).

    ``dead`` (B,) bool: lanes the caller already knows are rejects (e.g. RANSAC
    found too few inliers); they never hold the batch's early exit.

    ``coarse_iterations > 0`` prepends a coarse phase on every
    ``coarse_stride``-th src point; the returned fitness/rmse always come from
    the full-density phase.

    ``fused_step`` runs each step as the one fused kernel
    (``kernels/cuda/icp_step.py``) instead of the nearest-neighbour kernel
    plus torch gathers and einsums.
    """
    b = init_transform.shape[0]
    dev = init_transform.device

    def run_phase(src_pts, src_mask, max_iters, T):
        probe_iters = min(_PROBE_ITERS, max_iters)
        n_src = src_mask.to(torch.float32).sum(-1).clamp_min(1.0)
        n_in = torch.zeros(b, dtype=torch.float32, device=dev)
        rmse = torch.full((b,), float("inf"), dtype=torch.float32, device=dev)
        for it in range(max_iters):
            T, delta, (n_in, rmse) = _step_batch(
                src_pts, src_mask, dst, T, max_correspondence_distance, damping, fused_step
            )
            trace.count("icp_steps")
            converged = (delta * delta).sum(-1) <= _TOL2
            hopeless = (n_in / n_src < _HOPELESS_FITNESS) & (it + 1 >= probe_iters)
            if dead is not None:
                hopeless = hopeless | dead
            if not bool((~(converged | hopeless)).any()):
                break
        return T, n_in, rmse, n_src

    T0 = init_transform
    if coarse_iterations > 0 and coarse_stride > 1:
        T0, _, _, _ = run_phase(
            src.points[:, ::coarse_stride].contiguous(),
            src.mask[:, ::coarse_stride].contiguous(),
            coarse_iterations,
            T0,
        )
    T_final, n_in, rmse, n_src = run_phase(src.points, src.mask, iterations, T0)
    return ICPResult(
        transform=T_final,
        fitness=n_in / n_src,
        inlier_rmse=rmse,
        num_inliers=n_in.to(torch.int32),
    )


def icp_point_to_plane(
    src: PointCloud,
    dst: PointCloud,
    init_transform: torch.Tensor,
    *,
    max_correspondence_distance: float = 0.075,
    iterations: int = 30,
    damping: float = 1e-6,
    fused_step: bool = False,
) -> ICPResult:
    """Unbatched refine (batch-1 wrapper over :func:`icp_point_to_plane_batch`)."""
    res = icp_point_to_plane_batch(
        PointCloud(*(x[None] for x in src)),
        PointCloud(*(x[None] for x in dst)),
        init_transform[None],
        max_correspondence_distance=max_correspondence_distance,
        iterations=iterations,
        damping=damping,
        fused_step=fused_step,
    )
    return ICPResult(*(x[0] for x in res))
