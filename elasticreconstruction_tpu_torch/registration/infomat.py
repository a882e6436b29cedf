"""6x6 edge information matrices for pose-graph weighting.

Counterpart of ``elasticreconstruction_tpu/registration/infomat.py``: per
accepted pair, ``Lambda = sum_p G_p^T G_p`` over the matched target points,
with ``G_p = [I | -[p]x]`` (3x6) for the ``[rho, phi]`` twist ordering.
"""

from __future__ import annotations

import torch

from ..core import se3


def information_matrix(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``(..., 6, 6)`` information matrix from target-frame points ``(..., N, 3)``."""
    w = mask.to(points.dtype)
    k = se3.hat(points)  # (..., N, 3, 3)
    eye = torch.eye(3, dtype=points.dtype, device=points.device).expand(k.shape)
    G = torch.cat([eye, -k], dim=-1)  # (..., N, 3, 6)
    return torch.einsum("...nij,...nik,...n->...jk", G, G, w)
