"""FPFH descriptor matching: mutual nearest neighbours from one distance matmul.

Counterpart of ``elasticreconstruction_tpu/registration/features.py``.
"""

from __future__ import annotations

import torch


def match_features(
    feat_a: torch.Tensor,
    mask_a: torch.Tensor,
    feat_b: torch.Tensor,
    mask_b: torch.Tensor,
    *,
    mutual: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate correspondences from descriptor space, batched over a leading dim.

    ``feat_a (..., Na, D)``, ``mask_a (..., Na)``, ``feat_b (..., Nb, D)``,
    ``mask_b (..., Nb)``. Returns (corr ``(..., Na, 2)`` int32 rows
    ``[ia, ib]``, corr_mask ``(..., Na)`` bool): row ``i`` is A's point i with
    its best B match. ``mutual`` keeps only mutual-nearest pairs. Ties take
    the first index (``torch.argmin``, like ``jnp.argmin``).
    """
    a2 = (feat_a * feat_a).sum(-1, keepdim=True)
    b2 = (feat_b * feat_b).sum(-1, keepdim=True)
    d = a2 + b2.transpose(-1, -2) - 2.0 * (feat_a @ feat_b.transpose(-1, -2))  # (..., Na, Nb)
    inf = float("inf")
    d = torch.where(mask_b[..., None, :], d, inf)
    best_b = torch.argmin(d, dim=-1)  # (..., Na)
    valid = mask_a & torch.isfinite(torch.gather(d, -1, best_b[..., None])[..., 0])
    ia = torch.arange(feat_a.shape[-2], device=feat_a.device).expand(best_b.shape)
    if mutual:
        best_a = torch.argmin(torch.where(mask_a[..., :, None], d, inf), dim=-2)  # (..., Nb)
        valid &= torch.gather(best_a, -1, best_b) == ia
    corr = torch.stack([ia, best_b], dim=-1).to(torch.int32)
    return corr, valid
