"""Pinhole camera model: project / unproject / depth-map geometry.

Counterpart of ``elasticreconstruction_tpu/core/camera.py``. Intrinsics are a
small named tuple of Python numbers (the reference's are static arguments of
its jitted functions), so every division by ``fx`` or ``fy`` is a multiply by
the float32 reciprocal and the projection ``x / z * fx + cx`` one fused
multiply-add, as XLA compiles the reference's (``core/types.py``,
``f32_reciprocal`` and ``fma``): the projection picks pixels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .types import f32_reciprocal, fma


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def scaled(self, factor: float) -> "Intrinsics":
        """Intrinsics of a downsampled image (for ICP pyramids)."""
        return Intrinsics(
            fx=self.fx * factor,
            fy=self.fy * factor,
            cx=(self.cx + 0.5) * factor - 0.5,
            cy=(self.cy + 0.5) * factor - 0.5,
            width=int(round(self.width * factor)),
            height=int(round(self.height * factor)),
        )


# Augmented ICL-NUIM / PrimeSense defaults used throughout the reference.
PRIMESENSE = Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)


def pixel_grid(intr: Intrinsics, dtype=torch.float32, *, device) -> torch.Tensor:
    """Pixel-center coordinates ``(H, W, 2)`` as (u, v)."""
    u = torch.arange(intr.width, dtype=dtype, device=device)
    v = torch.arange(intr.height, dtype=dtype, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")  # (H, W)
    return torch.stack([uu, vv], dim=-1)


def ray_directions(intr: Intrinsics, *, device) -> torch.Tensor:
    """Camera-frame rays ``(H, W, 3)`` through the pixel centers, at z = 1."""
    uv = pixel_grid(intr, device=device)
    return torch.stack(
        [
            (uv[..., 0] - intr.cx) * f32_reciprocal(intr.fx),
            (uv[..., 1] - intr.cy) * f32_reciprocal(intr.fy),
            torch.ones_like(uv[..., 0]),
        ],
        dim=-1,
    )


def unproject(depth: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Depth map ``(H, W)`` (meters, 0 = invalid) -> camera-frame points ``(H, W, 3)``.

    Invalid pixels yield the zero point; callers carry the validity mask
    (``depth > 0``) separately.
    """
    uv = pixel_grid(intr, depth.dtype, device=depth.device)
    x = (uv[..., 0] - intr.cx) * f32_reciprocal(intr.fx) * depth
    y = (uv[..., 1] - intr.cy) * f32_reciprocal(intr.fy) * depth
    return torch.stack([x, y, depth], dim=-1)


def project(points: torch.Tensor, intr: Intrinsics) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points ``(..., 3)`` -> (uv ``(..., 2)``, valid ``(...,)``).

    ``valid`` is True where z > 0 and the pixel lands inside the image.
    """
    u, valid = project_uv(points[..., 0], points[..., 1], points[..., 2], intr)
    return torch.stack(u, dim=-1), valid


def project_uv(x, y, z, intr: Intrinsics):
    """:func:`project` on separate coordinate tensors: ``((u, v), valid)``."""
    safe_z = torch.where(z > 1e-6, z, 1.0)
    u = fma(x / safe_z, intr.fx, intr.cx)
    v = fma(y / safe_z, intr.fy, intr.cy)
    valid = (
        (z > 1e-6)
        & (u >= 0.0)
        & (u <= intr.width - 1.0)
        & (v >= 0.0)
        & (v <= intr.height - 1.0)
    )
    return (u, v), valid


def _clipped_index(x: torch.Tensor, n: int) -> torch.Tensor:
    """``clip(x, 0, n - 1)`` cast to int64, and clipped again: a NaN coordinate
    (a pose that tracking lost) casts to no index at all, which the
    reference's gather clamps into range; so does this, and the caller's
    validity mask (false for NaN) drops the sample."""
    return torch.clip(x, 0, n - 1).to(torch.int64).clamp_(0, n - 1)


def pixel_index(u: torch.Tensor, v: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Flat index ``v * W + u`` of the nearest pixel: round, clip, cast, in the
    reference's order (``kernels/tsdf.py``, ``odometry/kinfu.py``)."""
    ui = _clipped_index(torch.round(u), intr.width)
    vi = _clipped_index(torch.round(v), intr.height)
    return vi * intr.width + ui


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample ``img (H, W[, C])`` at ``uv (..., 2)`` (u=x, v=y).

    Out-of-range coordinates clamp to the border; callers mask validity.
    """
    h, w = img.shape[0], img.shape[1]
    u = torch.clip(uv[..., 0], 0.0, w - 1.0)
    v = torch.clip(uv[..., 1], 0.0, h - 1.0)
    u0 = _clipped_index(torch.floor(u), w)
    v0 = _clipped_index(torch.floor(v), h)
    u1 = torch.clamp_max(u0 + 1, w - 1)
    v1 = torch.clamp_max(v0 + 1, h - 1)
    du = u - u0.to(u.dtype)
    dv = v - v0.to(v.dtype)
    if img.ndim == 3:
        du, dv = du[..., None], dv[..., None]
    p00 = img[v0, u0]
    p01 = img[v0, u1]
    p10 = img[v1, u0]
    p11 = img[v1, u1]
    top = p00 * (1.0 - du) + p01 * du
    bot = p10 * (1.0 - du) + p11 * du
    return top * (1.0 - dv) + bot * dv


def nearest_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor sample (for depth maps, where bilinear mixes surfaces)."""
    h, w = img.shape[0], img.shape[1]
    u = _clipped_index(torch.round(uv[..., 0]), w)
    v = _clipped_index(torch.round(uv[..., 1]), h)
    return img[v, u]


def depth_to_normals(depth: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Per-pixel normals ``(H, W, 3)`` from central differences of the vertex map.

    Zero normal where any touched depth is invalid.
    """
    verts = unproject(depth, intr)
    dx = torch.roll(verts, -1, dims=1) - torch.roll(verts, 1, dims=1)
    dy = torch.roll(verts, -1, dims=0) - torch.roll(verts, 1, dims=0)
    n = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.where(norm > 1e-9, norm, 1.0)
    # Orient toward the camera (points have +z depth; camera looks down +z).
    flip = (n * verts).sum(-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    valid = (
        (depth > 0)
        & (torch.roll(depth, -1, dims=1) > 0)
        & (torch.roll(depth, 1, dims=1) > 0)
        & (torch.roll(depth, -1, dims=0) > 0)
        & (torch.roll(depth, 1, dims=0) > 0)
        & (norm[..., 0] > 1e-9)
    )
    return torch.where(valid[..., None], n, 0.0)
