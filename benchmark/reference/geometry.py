"""Rounding helpers, SE(3) and the pinhole camera: frozen copies of the port's plain versions.

Copied from the port's ``core/types.py``, ``core/se3.py`` and
``core/camera.py`` at the commit that introduced the benchmark, with every
matrix product routed through :mod:`.prec`. Twists are ``[rho, phi]``;
poses map local points to the target frame.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import prec


def f32_reciprocal(x: float) -> float:
    return float(np.float32(1.0) / np.float32(x))


def f32_square(x: float) -> float:
    return float(np.float32(x) * np.float32(x))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (products exact in float64)."""
    return (a.double() * b + c).float()


class PointCloud(NamedTuple):
    points: torch.Tensor
    normals: torch.Tensor
    mask: torch.Tensor

    def take(self, index) -> "PointCloud":
        return PointCloud(*(x[index] for x in self))


# ----------------------------------------------------------------- SE(3)

_SMALL_ANGLE = 1e-3


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def vee(m):
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], -1)


def so3_exp(phi):
    theta2 = (phi * phi).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2)
    small = theta < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    k = hat(phi)
    return _eye3(phi) + a * k + b * prec.mm(k, k)


def so3_log(rot):
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = ((trace - 1.0) * 0.5).clamp(-1.0, 1.0)
    w = vee(rot - rot.transpose(-1, -2)) * 0.5
    sin_theta_est = torch.sqrt((w * w).sum(-1) + 1e-12)
    theta = torch.atan2(sin_theta_est, cos_theta)
    small = theta < _SMALL_ANGLE
    near_pi = theta > math.pi - 1e-2
    sin_theta = torch.sin(torch.where(small | near_pi, torch.ones_like(theta), theta))
    generic = w * (theta / sin_theta)[..., None]
    small_vec = w * (1.0 + theta * theta / 6.0)[..., None]
    diag = torch.stack([rot[..., 0, 0], rot[..., 1, 1], rot[..., 2, 2]], -1)
    ax = torch.sqrt(((diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + 1e-12)).clamp_min(1e-12))
    s01 = rot[..., 0, 1] + rot[..., 1, 0]
    s02 = rot[..., 0, 2] + rot[..., 2, 0]
    s12 = rot[..., 1, 2] + rot[..., 2, 1]

    def sign_of(x):
        return torch.where(x >= 0, 1.0, -1.0).to(rot.dtype)

    cand0 = torch.stack([ax[..., 0], sign_of(s01) * ax[..., 1], sign_of(s02) * ax[..., 2]], -1)
    cand1 = torch.stack([sign_of(s01) * ax[..., 0], ax[..., 1], sign_of(s12) * ax[..., 2]], -1)
    cand2 = torch.stack([sign_of(s02) * ax[..., 0], sign_of(s12) * ax[..., 1], ax[..., 2]], -1)
    cands = torch.stack([cand0, cand1, cand2], -2)
    idx = torch.argmax(ax, -1)
    axis_pi = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 3)))[..., 0, :]
    out = torch.where(small[..., None], small_vec, generic)
    return torch.where(near_pi[..., None], axis_pi * theta[..., None], out)


def _left_jacobian(phi):
    theta2 = (phi * phi).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2)
    small = theta < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(theta), theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (safe - torch.sin(safe)) / (safe * safe * safe))
    k = hat(phi)
    return _eye3(phi) + b * k + c * prec.mm(k, k)


def _left_jacobian_inv(phi):
    theta2 = (phi * phi).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2)
    small = theta < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(theta), theta)
    half = safe * 0.5
    cot = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                      (1.0 - half * torch.cos(half) / torch.sin(half)) / (safe * safe))
    k = hat(phi)
    return _eye3(phi) - 0.5 * k + cot * prec.mm(k, k)


def make(rot, t):
    batch = torch.broadcast_shapes(rot.shape[:-2], t.shape[:-1])
    rot = rot.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([rot, t[..., None]], -1)
    bottom = rot.new_zeros(batch + (1, 4))
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], -2)


def exp(xi):
    rho, phi = xi[..., :3], xi[..., 3:]
    t = prec.mm(_left_jacobian(phi), rho[..., None])[..., 0]
    return make(so3_exp(phi), t)


def log(pose):
    phi = so3_log(pose[..., :3, :3])
    rho = prec.mm(_left_jacobian_inv(phi), pose[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], -1)


def identity(*, device):
    return torch.eye(4, dtype=torch.float32, device=device)


def inverse(pose):
    rot_t = pose[..., :3, :3].transpose(-1, -2)
    t = -prec.mm(rot_t, pose[..., :3, 3:4])[..., 0]
    return make(rot_t, t)


def compose(a, b):
    return prec.mm(a, b)


def apply(pose, points):
    return prec.mm(points, pose[..., :3, :3].transpose(-1, -2)) + pose[..., None, :3, 3]


def rotate(pose, vectors):
    return prec.mm(vectors, pose[..., :3, :3].transpose(-1, -2))


def kabsch(src, dst, weights):
    w = weights / (weights.sum(-1, keepdim=True) + 1e-12)
    mu_s = (src * w[..., None]).sum(-2, keepdim=True)
    mu_d = (dst * w[..., None]).sum(-2, keepdim=True)
    cov = prec.einsum("...ni,...nj->...ij", (dst - mu_d) * w[..., None], src - mu_s)
    u, _, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(prec.mm(u, vt))
    fix = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    rot = prec.mm(u * fix[..., None, :], vt)
    t = mu_d[..., 0, :] - prec.mm(rot, mu_s[..., 0, :, None])[..., 0]
    return make(rot, t)


# ---------------------------------------------------------------- camera


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def scaled(self, factor: float) -> "Intrinsics":
        return Intrinsics(self.fx * factor, self.fy * factor, (self.cx + 0.5) * factor - 0.5,
                          (self.cy + 0.5) * factor - 0.5, int(round(self.width * factor)),
                          int(round(self.height * factor)))


def pixel_grid(intr: Intrinsics, dtype=torch.float32, *, device):
    u = torch.arange(intr.width, dtype=dtype, device=device)
    v = torch.arange(intr.height, dtype=dtype, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return torch.stack([uu, vv], -1)


def ray_directions(intr: Intrinsics, *, device):
    uv = pixel_grid(intr, device=device)
    return torch.stack([(uv[..., 0] - intr.cx) * f32_reciprocal(intr.fx),
                        (uv[..., 1] - intr.cy) * f32_reciprocal(intr.fy),
                        torch.ones_like(uv[..., 0])], -1)


def unproject(depth, intr: Intrinsics):
    uv = pixel_grid(intr, depth.dtype, device=depth.device)
    x = (uv[..., 0] - intr.cx) * f32_reciprocal(intr.fx) * depth
    y = (uv[..., 1] - intr.cy) * f32_reciprocal(intr.fy) * depth
    return torch.stack([x, y, depth], -1)


def project_uv(x, y, z, intr: Intrinsics):
    safe_z = torch.where(z > 1e-6, z, 1.0)
    u = fma(x / safe_z, intr.fx, intr.cx)
    v = fma(y / safe_z, intr.fy, intr.cy)
    valid = (z > 1e-6) & (u >= 0.0) & (u <= intr.width - 1.0) & (v >= 0.0) & (v <= intr.height - 1.0)
    return (u, v), valid


def _clipped_index(x, n: int):
    return torch.clip(x, 0, n - 1).to(torch.int64).clamp_(0, n - 1)


def pixel_index(u, v, intr: Intrinsics):
    return _clipped_index(torch.round(v), intr.height) * intr.width + _clipped_index(torch.round(u), intr.width)
