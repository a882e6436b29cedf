"""Core data containers: fixed-capacity point clouds and registration edges.

The reference's variable-size PCL clouds are fixed-capacity tensors plus a
validity mask, exactly as in the JAX package, so shapes and field names agree
field by field with ``elasticreconstruction_tpu.core.types``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The requested device; raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain PyTorch versions"
        )
    return dev


def f32_square(x: float) -> float:
    """``x * x`` rounded as one float32 product of float32 ``x``.

    The reference squares thresholds that are traced f32 scalars inside its
    jitted functions, giving ``f32(f32(x) * f32(x))`` rather than ``f32(x * x)``;
    the two can differ in the last bit, which decides exact-boundary cases.
    """
    return float(np.float32(x) * np.float32(x))


class PointCloud(NamedTuple):
    """Fixed-capacity point cloud.

    points:  (..., N, 3) float32 — positions; rows past the live count are padding
    normals: (..., N, 3) float32 — unit normals (zeros where absent/invalid)
    mask:    (..., N)    bool    — True for live points
    """

    points: torch.Tensor
    normals: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self) -> torch.Tensor:
        return self.mask.to(torch.int32).sum(-1)

    @staticmethod
    def from_points(points, normals=None, mask=None, *, device="cuda") -> "PointCloud":
        dev = resolve_device(device)
        points = torch.as_tensor(points, dtype=torch.float32, device=dev)
        normals = (
            torch.zeros_like(points)
            if normals is None
            else torch.as_tensor(normals, dtype=torch.float32, device=dev)
        )
        mask = (
            torch.ones(points.shape[:-1], dtype=torch.bool, device=dev)
            if mask is None
            else torch.as_tensor(mask, dtype=torch.bool, device=dev)
        )
        return PointCloud(points, normals, mask)

    def to(self, device) -> "PointCloud":
        return PointCloud(*(x.to(device) for x in self))

    def take(self, index) -> "PointCloud":
        """Rows of the leading (fragment) dimension, e.g. ``cloud.take(idx_i)``."""
        return PointCloud(*(x[index] for x in self))


class RegistrationResult(NamedTuple):
    """One pairwise-registration edge: the reference's .log/.info record."""

    i: torch.Tensor
    j: torch.Tensor
    transform: torch.Tensor  # (4, 4): maps frame j -> frame i
    information: torch.Tensor  # (6, 6)
    num_inliers: torch.Tensor
    fitness: torch.Tensor  # inlier fraction [0, 1]
    success: torch.Tensor  # bool


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None, keepdim=False) -> torch.Tensor:
    m = mask.to(x.dtype)
    if x.ndim > mask.ndim:
        m = m[..., None]
    if dim is None:
        return (x * m).sum() / m.sum().clamp_min(1.0)
    denom = m.sum(dim=dim, keepdim=keepdim)
    return (x * m).sum(dim=dim, keepdim=keepdim) / denom.clamp_min(1.0)
