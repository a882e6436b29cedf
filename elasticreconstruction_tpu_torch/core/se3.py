"""Batched SE(3) / SO(3) operations on ``(..., 4, 4)`` pose tensors.

Same conventions as the JAX package's ``core/se3.py``:

- Twist vectors are ``(..., 6)`` ordered ``[rho(3), phi(3)]`` (translation
  first, rotation last).
- ``exp`` / ``log`` use the closed-form SE(3) exponential with small-angle
  Taylor guards chosen to be safe in float32.
- Pose matrices map points FROM the local frame TO the target frame:
  ``x_world = T @ [x_local, 1]``.
"""

from __future__ import annotations

import math

import torch

# Below this angle (radians) the Taylor branches are used.
_SMALL_ANGLE = 1e-3


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``(..., 3)`` vectors -> ``(..., 3, 3)``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: ``(..., 3, 3)`` -> ``(..., 3)``."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: ``(..., 3)`` rotation vector -> ``(..., 3, 3)``."""
    theta2 = (phi * phi).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2)
    small = theta < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    k = hat(phi)
    return _eye3(phi) + a * k + b * (k @ k)


def so3_log(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``(..., 3, 3)`` -> rotation vector ``(..., 3)``.

    Near pi it falls back to the diagonal-based axis extraction, where the
    vee-based formula degenerates.
    """
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = ((trace - 1.0) * 0.5).clamp(-1.0, 1.0)
    w = vee(rot - rot.transpose(-1, -2)) * 0.5  # = sin(theta) * axis
    sin_theta_est = torch.sqrt((w * w).sum(-1) + 1e-12)
    theta = torch.atan2(sin_theta_est, cos_theta)  # in [0, pi]

    small = theta < _SMALL_ANGLE
    near_pi = theta > math.pi - 1e-2

    sin_theta = torch.sin(torch.where(small | near_pi, torch.ones_like(theta), theta))
    generic = w * (theta / sin_theta)[..., None]
    small_vec = w * (1.0 + theta * theta / 6.0)[..., None]

    # Near pi: |axis_i| from the diagonal, signs from the off-diagonal sums,
    # anchored on the largest component.
    diag = torch.stack([rot[..., 0, 0], rot[..., 1, 1], rot[..., 2, 2]], dim=-1)
    ax = torch.sqrt(
        ((diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + 1e-12)).clamp_min(1e-12)
    )
    s01 = rot[..., 0, 1] + rot[..., 1, 0]
    s02 = rot[..., 0, 2] + rot[..., 2, 0]
    s12 = rot[..., 1, 2] + rot[..., 2, 1]

    def sign_of(x):
        return torch.where(x >= 0, 1.0, -1.0).to(rot.dtype)

    cand0 = torch.stack([ax[..., 0], sign_of(s01) * ax[..., 1], sign_of(s02) * ax[..., 2]], dim=-1)
    cand1 = torch.stack([sign_of(s01) * ax[..., 0], ax[..., 1], sign_of(s12) * ax[..., 2]], dim=-1)
    cand2 = torch.stack([sign_of(s02) * ax[..., 0], sign_of(s12) * ax[..., 1], ax[..., 2]], dim=-1)
    cands = torch.stack([cand0, cand1, cand2], dim=-2)  # (..., 3 candidates, 3)
    idx = torch.argmax(ax, dim=-1)
    axis_pi = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 3)))[..., 0, :]
    pi_vec = axis_pi * theta[..., None]

    out = torch.where(small[..., None], small_vec, generic)
    return torch.where(near_pi[..., None], pi_vec, out)


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta2 = (phi * phi).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2)
    small = theta < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(theta), theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (safe - torch.sin(safe)) / (safe * safe * safe)
    )
    k = hat(phi)
    return _eye3(phi) + b * k + c * (k @ k)


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = (phi * phi).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2)
    small = theta < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(theta), theta)
    half = safe * 0.5
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / (safe * safe),
    )
    k = hat(phi)
    return _eye3(phi) - 0.5 * k + cot_term * (k @ k)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: twist ``(..., 6)`` [rho, phi] -> pose ``(..., 4, 4)``."""
    rho, phi = xi[..., :3], xi[..., 3:]
    t = (_so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return make(so3_exp(phi), t)


def log(pose: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: pose ``(..., 4, 4)`` -> twist ``(..., 6)`` [rho, phi]."""
    phi = so3_log(pose[..., :3, :3])
    rho = (_so3_left_jacobian_inv(phi) @ pose[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def make(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble ``(..., 4, 4)`` from rotation ``(..., 3, 3)`` + translation ``(..., 3)``."""
    batch = torch.broadcast_shapes(rot.shape[:-2], t.shape[:-1])
    rot = rot.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([rot, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype, device=rot.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def inverse(pose: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid inverse (no general 4x4 inversion)."""
    rot_t = pose[..., :3, :3].transpose(-1, -2)
    t = -(rot_t @ pose[..., :3, 3:4])[..., 0]
    return make(rot_t, t)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with broadcasting over batch dims."""
    return a @ b


def apply(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Transform points ``(..., N, 3)`` by poses ``(..., 4, 4)``."""
    return points @ pose[..., :3, :3].transpose(-1, -2) + pose[..., None, :3, 3]


def kabsch(
    src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Weighted closed-form rigid alignment: pose T with ``T @ src ~= dst``.

    ``src``/``dst`` are ``(..., N, 3)``; ``weights`` ``(..., N)`` or None.
    The rotation is unique wherever the covariance's singular values are
    distinct, so torch's U/V sign convention (which differs from XLA's) does
    not show in the result; the determinant fix makes it a proper rotation.
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights / (weights.sum(-1, keepdim=True) + 1e-12)
    mu_s = (src * w[..., None]).sum(-2, keepdim=True)
    mu_d = (dst * w[..., None]).sum(-2, keepdim=True)
    cov = torch.einsum("...ni,...nj->...ij", (dst - mu_d) * w[..., None], src - mu_s)
    u, _, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    fix = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    rot = (u * fix[..., None, :]) @ vt
    t = mu_d[..., 0, :] - (rot @ mu_s[..., 0, :, None])[..., 0]
    return make(rot, t)
