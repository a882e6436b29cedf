"""Batched-hypothesis RANSAC rigid alignment over feature correspondences.

Counterpart of ``elasticreconstruction_tpu/registration/ransac.py``: draw ALL
hypotheses up front, solve every 3-point alignment in one batch, score every
hypothesis against every correspondence as one masked reduction, take the
first argmax, then re-fit on the inlier set twice. The pair batch is an
explicit leading dimension.

The reference draws with ``jax.random.randint(key, (H, 3), 0, 1 << 30)``,
which torch cannot reproduce. So :func:`ransac_alignment` takes either a
``torch.Generator`` or the ``draws`` themselves; parity tests feed it the
reference's draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..core.types import f32_square

DRAW_HIGH = 1 << 30


class RansacResult(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4) best rigid map: A-frame -> B-frame points
    inlier_mask: torch.Tensor  # (B, C) bool over input correspondences
    num_inliers: torch.Tensor  # (B,) int32
    fitness: torch.Tensor  # (B,) inliers / valid correspondences


def _triangle_align(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """Rigid maps from 3-point samples via orthonormal triangle frames.

    ``sa``/``sb`` are ``(..., 3, 3)`` (sample points in rows). Builds the
    frame (e1 = p1->p2, e2 = Gram-Schmidt of p1->p3, e3 = e1 x e2) on both
    triangles and returns ``(..., 4, 4)`` poses with ``T @ a ~= b``. No SVD.
    """

    def frame(p):
        u = p[..., 1, :] - p[..., 0, :]
        e1 = u / torch.linalg.norm(u, dim=-1, keepdim=True).clamp_min(1e-12)
        v = p[..., 2, :] - p[..., 0, :]
        v = v - (v * e1).sum(-1, keepdim=True) * e1
        e2 = v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-12)
        e3 = torch.linalg.cross(e1, e2, dim=-1)
        return torch.stack([e1, e2, e3], dim=-1)  # (..., 3, 3) columns

    fa, fb = frame(sa), frame(sb)
    rot = fb @ fa.transpose(-1, -2)
    t = sb.mean(-2) - (rot @ sa.mean(-2)[..., None])[..., 0]
    return se3.make(rot, t)


def draw_hypotheses(
    batch: int, num_hypotheses: int, generator: torch.Generator | None, device, sample_size: int = 3
) -> torch.Tensor:
    """``(batch, H, sample_size)`` int64 uniform in ``[0, 2^30)`` from ``generator``
    (drawn on the CPU, so a seeded generator gives the same draws on any device)."""
    draws = torch.randint(0, DRAW_HIGH, (batch, num_hypotheses, sample_size), generator=generator)
    return draws.to(device)


def ransac_alignment(
    pts_a: torch.Tensor,
    pts_b: torch.Tensor,
    corr: torch.Tensor,
    corr_mask: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    draws: torch.Tensor | None = None,
    inlier_threshold: float = 0.075,
    edge_similarity: float = 0.9,
    num_hypotheses: int = 4096,
    sample_size: int = 3,
) -> RansacResult:
    """Estimate per pair the rigid transform T with ``T @ a ~= b``.

    Args:
      pts_a/pts_b: ``(B, Na, 3)`` / ``(B, Nb, 3)`` cloud positions.
      corr: ``(B, C, 2)`` int ``[ia, ib]`` candidate matches; corr_mask ``(B, C)``.
      generator: source of the hypothesis draws when ``draws`` is None.
      draws: ``(B, H, sample_size)`` ints in ``[0, 2^30)``; H replaces
        ``num_hypotheses``.
      inlier_threshold: post-transform distance for counting inliers (m).
      edge_similarity: every pairwise edge of the sampled polygon must satisfy
        ``min(la, lb) / max(la, lb) > s`` (PCL's polygon rejector).
    """
    bsz, c = corr_mask.shape
    dev = pts_a.device
    thr2 = f32_square(inlier_threshold)
    a = torch.gather(pts_a, 1, corr[..., 0].long()[..., None].expand(-1, -1, 3))  # (B, C, 3)
    b = torch.gather(pts_b, 1, corr[..., 1].long()[..., None].expand(-1, -1, 3))
    if draws is None:
        draws = draw_hypotheses(bsz, num_hypotheses, generator, dev, sample_size)
    draws = draws.to(device=dev, dtype=torch.int64)
    num_h = draws.shape[1]

    # Samples index the VALID correspondences: stable-sort them to the front,
    # draw uniform ints mod the valid count (with replacement; a duplicate
    # collapses the polygon and the edge check prunes it).
    order = torch.sort((~corr_mask).to(torch.int32), dim=-1, stable=True)[1]
    n_valid_c = corr_mask.to(torch.int64).sum(-1).clamp_min(1)
    samp = torch.gather(order, 1, (draws % n_valid_c[:, None, None]).reshape(bsz, -1))
    samp = samp.reshape(bsz, num_h, sample_size)

    def take(x, ix):  # x (B, C, 3), ix (B, H, S) -> (B, H, S, 3)
        return torch.gather(x, 1, ix.reshape(bsz, -1, 1).expand(-1, -1, 3)).reshape(ix.shape + (3,))

    sa, sb = take(a, samp), take(b, samp)

    # Polygon edge-length compatibility pruning.
    ii, jj = torch.triu_indices(sample_size, sample_size, offset=1, device=dev)
    ea = torch.linalg.norm(sa[..., ii, :] - sa[..., jj, :], dim=-1)
    eb = torch.linalg.norm(sb[..., ii, :] - sb[..., jj, :], dim=-1)
    ratio = torch.minimum(ea, eb) / torch.maximum(ea, eb).clamp_min(1e-9)
    compatible = (ratio > edge_similarity).all(-1)  # (B, H)
    # Void if any sampled correspondence is invalid (< S valid ones exist).
    compatible &= torch.gather(corr_mask, 1, samp.reshape(bsz, -1)).reshape(samp.shape).all(-1)

    T = _triangle_align(sa, sb) if sample_size == 3 else se3.kabsch(sa, sb)  # (B, H, 4, 4)

    # Score all hypotheses against all correspondences with one K=15 product:
    #   |R a + t - b|^2 = |a|^2 + |b|^2 + |t|^2 - 2 b.t + 2 (R^T t).a - 2 <b a^T, R>
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    s_c = (a * a).sum(-1) + (b * b).sum(-1)  # (B, C)
    t2 = (t * t).sum(-1)  # (B, H)
    rt = (R.transpose(-1, -2) @ t[..., None])[..., 0]  # R^T t
    ab = (b[..., :, None] * a[..., None, :]).reshape(bsz, c, 9)
    lhs = torch.cat([t, rt, R.reshape(bsz, num_h, 9)], dim=-1)  # (B, H, 15)
    rhs = torch.cat([-b, a, -ab], dim=-1)  # (B, C, 15)
    err2 = s_c[:, None, :] + t2[:, :, None] + 2.0 * (lhs @ rhs.transpose(-1, -2))  # (B, H, C)
    inl = (err2 < thr2) & corr_mask[:, None, :]
    score = inl.sum(-1) * compatible  # (B, H)
    del err2, inl

    best = torch.argmax(score, dim=-1)  # first maximum
    ar = torch.arange(bsz, device=dev)
    best_T = T[ar, best]
    best_score = score[ar, best]

    def inliers(T_, gate):
        e2 = ((se3.apply(T_, a) - b) ** 2).sum(-1)
        return (e2 < thr2) & corr_mask & gate[:, None]

    # Recount the winner exactly (the expanded form has ~1e-5 cancellation noise).
    best_inl = inliers(best_T, best_score > 0)
    # Polish: re-fit on the full inlier set and recount, twice.
    for _ in range(2):
        any_inl = best_inl.any(-1)
        T_fit = se3.kabsch(a, b, best_inl.to(a.dtype))
        best_T = torch.where(any_inl[:, None, None], T_fit, best_T)
        best_inl = inliers(best_T, any_inl)
    n_in = best_inl.to(torch.int32).sum(-1)
    n_valid = corr_mask.to(torch.int32).sum(-1).clamp_min(1)
    return RansacResult(
        transform=best_T,
        inlier_mask=best_inl,
        num_inliers=n_in,
        fitness=n_in.to(torch.float32) / n_valid.to(torch.float32),
    )
