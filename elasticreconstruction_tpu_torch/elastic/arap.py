"""As-rigid-as-possible lattice regulariser (FragmentOptimizer's prior).

Counterpart of ``elasticreconstruction_tpu/elastic/arap.py``: per lattice
vertex, a rotation estimated from the SVD of the local displacement
covariance; residuals penalise deviation of deformed edges from rigidly
rotated rest edges. Rotations are re-estimated in closed form (one batched
3x3 SVD over all vertices, and over every lattice at once), then held fixed
inside the linear Gauss-Newton step, where the ARAP term is linear in the
displacements.
"""

from __future__ import annotations

import functools

import torch

from ..core import segment
from .lattice import Lattice, edge_list


@functools.lru_cache(maxsize=16)
def directed_edges(lat: Lattice, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Both directions of every lattice edge: ``(a, b)``, each ``(2E,)``; made
    once per lattice and device (the copy to the card synchronises)."""
    e = edge_list(lat, device)
    return torch.cat([e[:, 0], e[:, 1]]), torch.cat([e[:, 1], e[:, 0]])


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of ``(..., 3, 3)`` matrices: row0 . (row1 x row2)."""
    return (m[..., 0, :] * torch.linalg.cross(m[..., 1, :], m[..., 2, :])).sum(-1)


def estimate_rotations(lat: Lattice, displacement: torch.Tensor,
                       plan: segment.SegmentPlan | None = None) -> torch.Tensor:
    """Best-fit rotation per vertex from its incident edges: ``(..., M, 3, 3)``
    for ``displacement (..., M, 3)``.

    Solves ``min_R sum_k || (x_k - x_v) - R (r_k - r_v) ||^2`` per vertex via
    the SVD of the cross-covariance (Kabsch without translation), with the
    reflection fix. ``plan``: the segment plan of :func:`directed_edges`'s
    ``a``, reused across calls by the optimiser.
    """
    dev = displacement.device
    rest = lat.rest_positions(dev)
    cur = rest + displacement
    a, b = directed_edges(lat, dev)
    if plan is None:
        plan = segment.plan(a, lat.num_vertices)
    rest_e = rest[b] - rest[a]  # (2E, 3)
    cur_e = (cur[..., b, :] - cur[..., a, :]).movedim(-2, 0)  # (2E, ..., 3)
    contrib = cur_e[..., :, None] * rest_e.reshape((-1,) + (1,) * (cur_e.ndim - 2) + (1, 3))
    cov = segment.segment_sum(contrib, plan).movedim(0, -3)  # (..., M, 3, 3)
    u, _, vt = torch.linalg.svd(cov)
    det = _det3(u @ vt)
    fix = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (u * fix[..., None, :]) @ vt


def residuals(lat: Lattice, displacement: torch.Tensor, rotations: torch.Tensor):
    """ARAP residuals per directed edge, ``(2E, 3)``, with rotations fixed;
    also the edges' ``(a, b)``."""
    dev = displacement.device
    rest = lat.rest_positions(dev)
    cur = rest + displacement
    a, b = directed_edges(lat, dev)
    rest_e = rest[b] - rest[a]
    cur_e = cur[b] - cur[a]
    rot_rest = torch.einsum("eij,ej->ei", rotations[a], rest_e)
    return cur_e - rot_rest, a, b
