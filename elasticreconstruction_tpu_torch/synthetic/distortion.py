"""Synthetic depth-camera distortion: the CVPR'14 SLAC failure model.

Counterpart of ``elasticreconstruction_tpu/synthetic/distortion.py``.
Consumer depth cameras report ``d' = d * (1 + f(u, v, d))`` with a smooth,
reproducible bias field ``f``; this module injects a parametric stand-in into
the synthetic renderer, and because the field is analytic and invertible,
ground-truth correction vectors are available everywhere
(``eval/lattice_recovery.py`` scores a learned lattice against them).

Model: ``f(u, v, d) = radial_a * r^2(u, v) + depth_b * (d - depth_ref)
+ bilinear(grid, u, v)`` with ``r`` the image radius normalised to 1 at the
corner and ``grid`` a seeded coarse random field.

Arithmetic: the reference applies the field to rendered depth inside a jitted
function, where XLA multiplies by the float32 reciprocal of each constant
divisor and contracts a product feeding a sum into one fused multiply-add
(``core/types.py``); :func:`apply_depth` does the same, so distorted depth
maps quantise to the same millimetres as the reference's.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from ..core import camera as cam
from ..core.types import f32_reciprocal, fma


def _f32(x: float) -> float:
    return float(np.float32(x))


class DepthDistortion(NamedTuple):
    """Parametric multiplicative depth-bias field:
    ``d_observed = d_true * (1 + field(u, v, d_true))``."""

    radial_a: float  # quadratic radial term (value of f at the image corner)
    depth_b: float  # linear range term per metre around depth_ref
    depth_ref: float  # range the depth term is centred on (m)
    grid: torch.Tensor  # (Gy, Gx) float32 smooth random component, bilinear over the image

    def to_json(self) -> str:
        return json.dumps(
            {
                "radial_a": float(self.radial_a),
                "depth_b": float(self.depth_b),
                "depth_ref": float(self.depth_ref),
                "grid": np.asarray(self.grid.cpu()).tolist(),
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "DepthDistortion":
        d = json.loads(s)
        return cls(
            radial_a=float(d["radial_a"]),
            depth_b=float(d["depth_b"]),
            depth_ref=float(d["depth_ref"]),
            grid=torch.from_numpy(np.array(d["grid"], np.float32)),
        )


def make_distortion(
    seed: int,
    *,
    radial_a: float = 0.02,
    depth_b: float = 0.005,
    depth_ref: float = 2.0,
    grid_shape: tuple[int, int] = (4, 5),
    grid_sigma: float = 0.008,
) -> DepthDistortion:
    """Seeded distortion field (defaults ~2% corner bias, consumer-camera scale);
    the grid is the reference's numpy draw from ``seed``, bit for bit."""
    rng = np.random.default_rng(seed)
    grid = rng.normal(0.0, grid_sigma, size=grid_shape).astype(np.float32)
    grid -= grid.mean()  # keep the DC in the radial/depth terms, not the noise
    return DepthDistortion(float(radial_a), float(depth_b), float(depth_ref), torch.from_numpy(grid))


def _bilinear_grid(grid: torch.Tensor, un: torch.Tensor, vn: torch.Tensor) -> torch.Tensor:
    """Sample ``grid (Gy, Gx)`` at normalised image coords in [0, 1]."""
    gy, gx = grid.shape
    grid = grid.to(un.device)
    x = torch.clip(un, 0.0, 1.0) * float(gx - 1)
    y = torch.clip(vn, 0.0, 1.0) * float(gy - 1)
    x0 = torch.clip(torch.floor(x), 0, gx - 2)
    y0 = torch.clip(torch.floor(y), 0, gy - 2)
    fx = x - x0
    fy = y - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    g00 = grid[y0, x0]
    g01 = grid[y0, x0 + 1]
    g10 = grid[y0 + 1, x0]
    g11 = grid[y0 + 1, x0 + 1]
    s = fma(g00 * (1 - fy), 1 - fx, g01 * (1 - fy) * fx)
    s = fma(g10 * fy, 1 - fx, s)
    return fma(g11 * fy, fx, s)


def field(dist: DepthDistortion, u: torch.Tensor, v: torch.Tensor, d: torch.Tensor,
          intr: cam.Intrinsics) -> torch.Tensor:
    """The multiplicative bias ``f(u, v, d)`` at pixel coords (u, v), depth d."""
    rx = (u - intr.cx) * f32_reciprocal(0.5 * intr.width)
    ry = (v - intr.cy) * f32_reciprocal(0.5 * intr.height)
    # radial_a * r^2 with r^2 = (rx^2 + ry^2) / 2, so that r = 1 at the image
    # corner; the halving is exact and XLA folds it into the constant.
    radial = fma(rx, rx, ry * ry)
    depth_term = (d - _f32(dist.depth_ref)) * _f32(dist.depth_b)
    smooth = _bilinear_grid(dist.grid, u * f32_reciprocal(intr.width - 1), v * f32_reciprocal(intr.height - 1))
    return fma(radial, 0.5 * _f32(dist.radial_a), depth_term) + smooth


def apply_depth(dist: DepthDistortion, depth: torch.Tensor, intr: cam.Intrinsics) -> torch.Tensor:
    """Distort true depth maps ``(..., H, W)``: ``d' = d (1 + f)``; invalid (0) stays 0."""
    uv = cam.pixel_grid(intr, device=depth.device)
    f = field(dist, uv[..., 0], uv[..., 1], depth, intr)
    return torch.where(depth > 0, depth * (1.0 + f), 0.0)


def true_depth(dist: DepthDistortion, depth_obs: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               intr: cam.Intrinsics) -> torch.Tensor:
    """Invert the bias at given pixels: ``d`` with ``d' = d (1 + f(u, v, d))``,
    by five fixed-point sweeps (contraction rate ~|d * depth_b|)."""
    d = depth_obs
    for _ in range(5):
        d = depth_obs / (1.0 + field(dist, u, v, d, intr))
    return d


def _project_uv(p: torch.Tensor, intr: cam.Intrinsics):
    z = p[..., 2]
    ok = z > 1e-6
    safe_z = torch.where(ok, z, 1.0)
    u = p[..., 0] / safe_z * intr.fx + intr.cx
    v = p[..., 1] / safe_z * intr.fy + intr.cy
    return z, ok, safe_z, u, v


def distort_points(dist: DepthDistortion, p_true: torch.Tensor, intr: cam.Intrinsics) -> torch.Tensor:
    """Forward-distort TRUE camera-frame points ``(N, 3)``: the point the sensor
    reports for the pixel and depth that observe ``p_true``. Points with
    z <= 0 pass through unchanged."""
    z, ok, _, u, v = _project_uv(p_true, intr)
    f = field(dist, u, v, z, intr)
    return p_true * (1.0 + torch.where(ok, f, 0.0)[..., None])


def gt_correction(dist: DepthDistortion, p_obs: torch.Tensor, intr: cam.Intrinsics) -> torch.Tensor:
    """Ground-truth correction vectors ``c`` with ``p_obs + c = p_true`` for
    OBSERVED camera-frame points ``(N, 3)`` (unprojected from distorted depth):
    the field a perfect SLAC lattice learns. Points with z <= 0 get zero."""
    z, ok, safe_z, u, v = _project_uv(p_obs, intr)
    d_true = true_depth(dist, z, u, v, intr)
    return p_obs * torch.where(ok, d_true / safe_z - 1.0, 0.0)[..., None]
