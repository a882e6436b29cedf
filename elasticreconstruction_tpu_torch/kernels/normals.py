"""Surface-normal estimation by neighbourhood PCA.

Counterpart of ``elasticreconstruction_tpu/kernels/normals.py``: the radius
variant :func:`estimate_normals_radius`, which registration runs, and the k-NN
variant :func:`estimate_normals` (the reference calls PCL
``NormalEstimationOMP``, a radius search plus per-point PCA). Instead of
neighbour lists the radius variant accumulates each point's neighbourhood
moments with one blocked ``(B, N) @ (N, 10)`` matmul:

    w_ij = [|p_i - p_j| <= r] * valid_j
    (S0, S1, S2)_i = sum_j w_ij * (1, p_j, p_j p_j^T)

then forms the 3x3 covariance and takes its smallest eigenvector with the
closed form of :mod:`.eigen33`. Only block rows of the weight matrix exist.
"""

from __future__ import annotations

import torch

from ..core.types import PointCloud
from . import eigen33 as _eigen33
from . import knn as _knn


def estimate_normals_radius(
    cloud: PointCloud,
    radius: float,
    viewpoint: torch.Tensor | None = None,
    *,
    block_size: int = 1024,
    min_neighbors: int = 3,
) -> PointCloud:
    """PCA normal per point from ALL valid neighbours within ``radius``.

    Normals point toward ``viewpoint`` (default: the origin). Points with
    fewer than ``min_neighbors`` neighbours, invalid points and isotropic
    neighbourhoods get a zero normal.
    """
    pts, mask = cloud.points, cloud.mask
    n = pts.shape[0]
    maskf = mask.to(pts.dtype)
    cnt_all = maskf.sum().clamp_min(1.0)
    center = (pts * maskf[:, None]).sum(0) / cnt_all
    # Centered coords for well-conditioned f32 second moments; invalid rows
    # are parked at the origin and excluded by the weight mask.
    p = (pts - center) * maskf[:, None]
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    src = torch.stack([x, y, z, x * x, y * y, z * z, x * y, x * z, y * z, torch.ones_like(x)], 1)
    p2 = (p * p).sum(1)
    r2 = torch.tensor(radius * radius, dtype=pts.dtype, device=pts.device)
    inf_row = torch.where(mask, 0.0, float("inf")).to(pts.dtype)

    moms = []
    for s in range(0, n, block_size):
        qb = p[s : s + block_size]
        q2 = (qb * qb).sum(1, keepdim=True)
        d2 = q2 + p2[None, :] - 2.0 * (qb @ p.T)
        w = ((d2 + inf_row[None, :]) <= r2).to(pts.dtype)
        moms.append(w @ src)
    mom = torch.cat(moms)

    s0 = mom[:, 9].clamp_min(1.0)
    mu = mom[:, 0:3] / s0[:, None]
    exx = mom[:, 3:9] / s0[:, None]  # E[xx, yy, zz, xy, xz, yz]
    cxx = exx[:, 0] - mu[:, 0] * mu[:, 0]
    cyy = exx[:, 1] - mu[:, 1] * mu[:, 1]
    czz = exx[:, 2] - mu[:, 2] * mu[:, 2]
    cxy = exx[:, 3] - mu[:, 0] * mu[:, 1]
    cxz = exx[:, 4] - mu[:, 0] * mu[:, 2]
    cyz = exx[:, 5] - mu[:, 1] * mu[:, 2]
    cov = torch.stack(
        [
            torch.stack([cxx, cxy, cxz], -1),
            torch.stack([cxy, cyy, cyz], -1),
            torch.stack([cxz, cyz, czz], -1),
        ],
        -2,
    )
    nrm, ok = _eigen33.smallest_eigenvector(cov)

    vp = torch.zeros(3, dtype=pts.dtype, device=pts.device) if viewpoint is None else viewpoint
    flip = (nrm * (vp[None, :] - pts)).sum(-1, keepdim=True) < 0
    nrm = torch.where(flip, -nrm, nrm)
    degenerate = (mom[:, 9] < min_neighbors) | ~mask | ~ok
    nrm = torch.where(degenerate[:, None], 0.0, nrm)
    return PointCloud(points=pts, normals=nrm, mask=mask)


def estimate_normals(
    cloud: PointCloud,
    k: int = 16,
    radius: float | None = None,
    viewpoint: torch.Tensor | None = None,
) -> PointCloud:
    """PCA normal per point from its ``k`` nearest valid neighbours (self included).

    ``radius`` masks out neighbours farther than it (PCL's radius search with
    a ``k`` cap). Normals point toward ``viewpoint`` (default: the origin);
    points with fewer than 3 neighbours, and invalid points, get a zero normal
    but stay in the mask.
    """
    pts, mask = cloud.points, cloud.mask
    d2, idx = _knn.knn(pts, pts, mask, k=k)
    nbr_valid = torch.isfinite(d2)
    if radius is not None:
        nbr_valid &= d2 <= radius * radius
    nbr = pts[idx.long()]  # (N, k, 3)
    w = nbr_valid.to(pts.dtype)
    cnt = w.sum(-1, keepdim=True)
    mu = (nbr * w[..., None]).sum(-2) / cnt.clamp_min(1.0)
    centered = (nbr - mu[:, None, :]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", centered, centered) / cnt[..., None].clamp_min(1.0)
    # Batched 3x3 symmetric eigendecomposition; the smallest eigenvector is the normal.
    _, vecs = torch.linalg.eigh(cov)
    nrm = vecs[..., 0]
    vp = torch.zeros(3, dtype=pts.dtype, device=pts.device) if viewpoint is None else viewpoint
    flip = (nrm * (vp[None, :] - pts)).sum(-1, keepdim=True) < 0
    nrm = torch.where(flip, -nrm, nrm)
    degenerate = (cnt[..., 0] < 3) | ~mask
    nrm = torch.where(degenerate[:, None], 0.0, nrm)
    return PointCloud(points=pts, normals=nrm, mask=mask)
