"""Closed-form eigenanalysis of batched symmetric 3x3 matrices.

Counterpart of ``elasticreconstruction_tpu/kernels/eigen33.py`` (the PCL
``eigen33`` approach): scale by the max |entry|, take the eigenvalues from the
characteristic cubic with the trigonometric identity, and recover the
smallest eigenvalue's eigenvector from the columns of ``(A - l1 I)(A - l2 I)``.
Near-isotropic or zero inputs fall back to ``+z`` with ``ok = False``.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _cubic(cov: torch.Tensor):
    """Scaled entries, eigenvalues (largest l1, middle l2, smallest l3), p and scale."""
    scale = cov.abs().amax(dim=(-2, -1)).clamp_min(_EPS)
    a = cov / scale[..., None, None]
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt((p2 / 6.0).clamp_min(0.0))
    p_safe = p.clamp_min(_EPS)
    # det((A - qI)/p) / 2, clamped into the acos domain.
    c00, c11, c22 = b00 / p_safe, b11 / p_safe, b22 / p_safe
    c01, c02, c12 = a01 / p_safe, a02 / p_safe, a12 / p_safe
    half_det = 0.5 * (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    angle = torch.acos(half_det.clamp(-1.0, 1.0)) / 3.0
    l1 = q + 2.0 * p * torch.cos(angle)  # largest
    l3 = q + 2.0 * p * torch.cos(angle + 2.0 * math.pi / 3.0)  # smallest
    l2 = 3.0 * q - l1 - l3
    return (a00, a01, a02, a11, a12, a22), (l1, l2, l3), p, scale


def smallest_eigenvector(cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit eigenvector of the smallest eigenvalue of symmetric ``(..., 3, 3)``.

    Returns ``(vec (..., 3), ok (...,) bool)``; ``ok`` is False where the
    matrix is numerically isotropic/zero (the vector is ``+z`` there).
    """
    (a00, a01, a02, a11, a12, a22), (l1, l2, _), p, _ = _cubic(cov)

    def shifted(lam):
        return (
            torch.stack([a00 - lam, a01, a02], -1),
            torch.stack([a01, a11 - lam, a12], -1),
            torch.stack([a02, a12, a22 - lam], -1),
        )

    r10, r11, r12 = shifted(l1)
    m2 = torch.stack(shifted(l2), -1)  # (..., 3 comps, 3 rows of A - l2)
    # Columns of (A - l1)(A - l2) are parallel to the smallest eigenvector.
    cols = torch.stack(
        [
            torch.stack(
                [(r10 * m2[..., k]).sum(-1), (r11 * m2[..., k]).sum(-1), (r12 * m2[..., k]).sum(-1)],
                -1,
            )
            for k in range(3)
        ],
        -2,
    )
    norms = (cols * cols).sum(-1)
    best = torch.argmax(norms, -1)
    vec = torch.gather(cols, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    n = torch.sqrt((vec * vec).sum(-1, keepdim=True).clamp_min(0.0))
    ok = (n[..., 0] > 1e-20) & (p > 1e-7)
    ez = torch.zeros_like(vec)
    ez[..., 2] = 1.0
    return torch.where(ok[..., None], vec / n.clamp_min(1e-30), ez), ok


def eigenvalues(cov: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues ``(..., 3)`` of symmetric 3x3 matrices."""
    _, (l1, l2, l3), _, scale = _cubic(cov)
    return torch.stack([l3, l2, l1], -1) * scale[..., None]
