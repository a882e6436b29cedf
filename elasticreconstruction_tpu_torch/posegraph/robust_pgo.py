"""Line-process robust pose-graph optimisation: Gauss-Newton + closed-form reweighting.

Counterpart of ``elasticreconstruction_tpu/posegraph/robust_pgo.py``.
Objective (the reference's GraphOptimizer):

    min_{T, l}  sum_odom  r_e^T L_e r_e
              + sum_loop  l_e r_e^T L_e r_e  +  mu (sqrt(l_e) - 1)^2

with ``r_e = log(That_ij^-1 T_i^-1 T_j)`` and the closed-form minimiser
``l_e = (mu / (mu + r^T L r))^2`` given poses. Gauss-Newton solves on the
dense 6N x 6N normal equations (N is the fragment count, ~10^2) alternate
with that update; edges with a small ``l`` are pruned.

Design notes:
- Per-edge Jacobians are exact: forward-mode differentiation
  (``torch.func.jvp``) of the residual in the two 6-dim tangent perturbations
  at xi = 0, the twelve tangents batched with all edges into one pass, no
  hand Jacobians and no small-angle approximation around large loop
  corrections. Forward mode, not reverse:
  ``se3.so3_exp`` takes ``sqrt(theta^2)`` at 0 and selects its Taylor branch
  with ``torch.where``, which forward mode passes cleanly and reverse mode
  turns into 0 * inf.
- Gauge freedom is fixed by a strong prior on pose 0 (1e8, in float32) instead
  of variable elimination.
- The scatter into H is one segment sum over flattened block ids, in a fixed
  order (``core/segment.py``), so the card solves the same system every run.
- The alternation scans are Python loops; everything runs on the device of
  ``poses``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp

from ..core import se3, segment
from ..core.types import resolve_device


class EdgeList(NamedTuple):
    """Fixed-capacity edge set (invalid rows masked out)."""

    i: torch.Tensor  # (E,) int64 source pose index
    j: torch.Tensor  # (E,) int64 target pose index
    transform: torch.Tensor  # (E, 4, 4) measured That_ij: p_i = That_ij @ p_j
    information: torch.Tensor  # (E, 6, 6)
    is_odometry: torch.Tensor  # (E,) bool — odometry edges bypass the line process
    mask: torch.Tensor  # (E,) bool — valid edge

    @staticmethod
    def build(i, j, transform, information, is_odometry, mask=None, *, device="cuda") -> "EdgeList":
        dev = resolve_device(device)
        i = torch.as_tensor(i, device=dev).to(torch.int64)
        if mask is None:
            mask = torch.ones(i.shape, dtype=torch.bool, device=dev)
        return EdgeList(
            i,
            torch.as_tensor(j, device=dev).to(torch.int64),
            torch.as_tensor(transform, dtype=torch.float32, device=dev),
            torch.as_tensor(information, dtype=torch.float32, device=dev),
            torch.as_tensor(is_odometry, dtype=torch.bool, device=dev),
            torch.as_tensor(mask, dtype=torch.bool, device=dev),
        )

    def to(self, device) -> "EdgeList":
        return EdgeList(*(x.to(device) for x in self))


class PGOConfig(NamedTuple):
    """Solver constants: the same fields and defaults as the JAX package's."""

    mu: float = 16.0  # squared Mahalanobis residual at which trust halves
    outer_iterations: int = 5  # line-process alternations
    inner_iterations: int = 8  # GN steps per alternation
    damping: float = 1e-4  # LM lambda (relative to diag scale)
    prune_threshold: float = 0.25  # keep loop edges with l >= this
    anchor_weight: float = 1e8  # gauge prior on pose 0
    # Information multiplier for suspect odometry edges (tracking health
    # tripped / chain refinement rejected — pipeline/stages.py): keeps them
    # as weak connectivity priors instead of full-weight measurements.
    suspect_info_scale: float = 0.01
    # Gauge-consensus pre-filter for loop edges whose chain path crosses
    # suspect stretches (pipeline/stages.py _gauge_consensus): candidate
    # component-alignment gauges are rejected when their rotation disagrees
    # with the odometry chain beyond base + per-suspect-edge budget.
    gauge_rot_budget_base: float = 15.0  # degrees
    gauge_rot_budget_per_suspect: float = 6.0  # degrees per suspect edge
    # Translation budget: base + drift_suspect x (suspect edges in path).
    gauge_trans_budget_base: float = 0.5  # m
    gauge_cluster_trans: float = 0.35  # m — cluster membership threshold
    gauge_cluster_rot: float = 12.0  # degrees


class PGOResult(NamedTuple):
    poses: torch.Tensor  # (N, 4, 4) optimized camera/fragment-to-world
    line_process: torch.Tensor  # (E,) final l_e (1 for odometry edges)
    kept: torch.Tensor  # (E,) bool — mask & (odometry | l >= threshold)
    residual_sq: torch.Tensor  # (E,) final r^T L r per edge


def _edge_residual(T_i, T_j, That_inv, xi_i, xi_j):
    """r = log(That^-1 (T_i exp(xi_i))^-1 (T_j exp(xi_j))) — (6,)."""
    Ti = T_i @ se3.exp(xi_i)
    Tj = T_j @ se3.exp(xi_j)
    return se3.log(That_inv @ se3.inverse(Ti) @ Tj)


def edge_residuals_and_jacobians(poses: torch.Tensor, edges: EdgeList):
    """All edges at once: r (E, 6) at xi = 0 and exact Jacobians Ji, Jj (E, 6, 6).

    One forward-mode pass over a (12, E) batch: row k < 6 carries the tangent
    e_k on xi_i, row k >= 6 the tangent e_(k-6) on xi_j. Every operation of the
    residual is batched over the leading dimensions, so row k of the output
    tangent is column k of the edges' Jacobians.
    """
    T_i, T_j = poses[edges.i][None], poses[edges.j][None]
    That_inv = se3.inverse(edges.transform)[None]
    e = edges.i.shape[0]
    zero = torch.zeros((12, e, 6), dtype=poses.dtype, device=poses.device)
    basis = torch.eye(12, dtype=poses.dtype, device=poses.device)[:, None, :].expand(12, e, 12)
    r, d = jvp(
        lambda xi, xj: _edge_residual(T_i, T_j, That_inv, xi, xj),
        (zero, zero),
        (basis[..., :6].contiguous(), basis[..., 6:].contiguous()),
    )
    return r[0], d[:6].permute(1, 2, 0), d[6:].permute(1, 2, 0)


def _gn_step(poses, edges: EdgeList, weights, cfg: PGOConfig):
    """One damped GN step over all poses; returns updated poses."""
    n = poses.shape[0]
    r, Ji, Jj = edge_residuals_and_jacobians(poses, edges)

    w = weights * edges.mask.to(torch.float32)  # (E,)
    L = edges.information * w[:, None, None]  # weighted information
    # Per-edge blocks of H = J^T L J and b = J^T L r.
    LJi = L @ Ji
    LJj = L @ Jj
    Hii = torch.einsum("eab,eac->ebc", Ji, LJi)
    Hij = torch.einsum("eab,eac->ebc", Ji, LJj)
    Hjj = torch.einsum("eab,eac->ebc", Jj, LJj)
    Lr = torch.einsum("eab,eb->ea", L, r)
    bi = torch.einsum("eab,ea->eb", Ji, Lr)
    bj = torch.einsum("eab,ea->eb", Jj, Lr)

    # Assemble dense H (6N, 6N) and b (6N,) with segment sums over block ids.
    blk = torch.cat(
        [edges.i * n + edges.i, edges.i * n + edges.j, edges.j * n + edges.i, edges.j * n + edges.j]
    )
    vals = torch.cat([Hii, Hij, Hij.transpose(-1, -2), Hjj], dim=0)
    Hblocks = segment.segment_sum_by_keys(vals, blk, n * n)
    H = Hblocks.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
    b = segment.segment_sum_by_keys(torch.cat([bi, bj], dim=0), torch.cat([edges.i, edges.j]), n).reshape(6 * n)

    # Gauge anchor on pose 0 + LM damping.
    anchor = torch.zeros(6 * n, dtype=H.dtype, device=H.device)
    anchor[:6] = cfg.anchor_weight
    lm = cfg.damping * torch.diagonal(H).clamp_min(1.0) + anchor + 1e-6
    delta = -torch.linalg.solve(H + torch.diag(lm), b)  # (6N,)
    return poses @ se3.exp(delta.reshape(n, 6))


def _edge_residual_sq(poses, edges: EdgeList):
    That_inv = se3.inverse(edges.transform)
    r = se3.log(That_inv @ se3.inverse(poses[edges.i]) @ poses[edges.j])
    return torch.einsum("ea,eab,eb->e", r, edges.information, r)


def optimize_pose_graph(
    poses: torch.Tensor,
    edges: EdgeList,
    cfg: PGOConfig = PGOConfig(),
) -> PGOResult:
    """Alternate GN pose solves with closed-form line-process updates.

    Runs on the device of ``poses``; ``edges`` is moved there.
    """
    edges = edges.to(poses.device)
    one = torch.ones((), dtype=torch.float32, device=poses.device)
    l = torch.ones(edges.i.shape[0], dtype=torch.float32, device=poses.device)
    for _ in range(cfg.outer_iterations):
        weights = torch.where(edges.is_odometry, one, l)
        for _ in range(cfg.inner_iterations):
            poses = _gn_step(poses, edges, weights, cfg)
        r2 = _edge_residual_sq(poses, edges)
        l = (cfg.mu / (cfg.mu + r2)) ** 2

    # Final polish on the pruned graph.
    kept_soft = edges.is_odometry | (l >= cfg.prune_threshold)
    weights = torch.where(edges.is_odometry, one, torch.where(kept_soft, l, torch.zeros_like(l)))
    for _ in range(cfg.inner_iterations):
        poses = _gn_step(poses, edges, weights, cfg)
    r2 = _edge_residual_sq(poses, edges)
    l_final = torch.where(edges.is_odometry, one, (cfg.mu / (cfg.mu + r2)) ** 2)
    kept = edges.mask & (edges.is_odometry | (l_final >= cfg.prune_threshold))
    return PGOResult(
        poses=se3.orthonormalize(poses),
        line_process=l_final,
        kept=kept,
        residual_sq=r2,
    )
