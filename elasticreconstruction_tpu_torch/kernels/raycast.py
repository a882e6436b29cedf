"""TSDF raycasting: the model view for frame-to-model odometry.

Counterpart of ``elasticreconstruction_tpu/kernels/raycast.py`` (plain jnp
there, plain PyTorch ops here). All rays march in lockstep for a fixed number
of steps, reading one nearest voxel per step from the combined sampling
volume; the bracketed zero crossing is then refined with trilinear samples
(half a step early, three bisections, a secant) and the normal taken from the
TSDF gradient. Every step is a handful of elementwise ops over the image, and
no step reads anything back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import camera as cam
from ..core import se3
from ..core.types import fma
from .tsdf import TSDFVolume, _gradient, _nearest, _trilinear, make_sampling_volume


class RaycastResult(NamedTuple):
    vertices: torch.Tensor  # (H, W, 3) world-frame surface points
    normals: torch.Tensor  # (H, W, 3) world-frame unit normals
    valid: torch.Tensor  # (H, W) bool


def raycast(
    vol: TSDFVolume,
    pose: torch.Tensor,
    intr: cam.Intrinsics,
    *,
    depth_min: float = 0.1,
    depth_max: float = 6.0,
    num_steps: int = 192,
) -> RaycastResult:
    """March camera rays (``pose`` = camera-to-world) through the volume.

    Step size is chosen so ``num_steps`` covers [depth_min, depth_max]; keep
    it <= half the truncation band for reliable crossing detection.
    """
    dev = vol.tsdf.device
    dirs_cam = cam.ray_directions(intr, device=dev)
    h, w = dirs_cam.shape[:2]
    dirs = se3.rotate(pose, dirs_cam.reshape(-1, 3)).reshape(h, w, 3).unbind(-1)
    origin = [pose[k, 3] for k in range(3)]
    # Step depths in float32, as the reference's scan computes them.
    dz = np.float32((depth_max - depth_min) / num_steps)
    sval = make_sampling_volume(vol)

    def at(z):  # points o + d z, one rounding each (the voxel choice depends on it)
        return [fma(d, z, o) for o, d in zip(origin, dirs)]

    prev_val = torch.zeros((h, w), dtype=torch.float32, device=dev)
    prev_valid = torch.zeros((h, w), dtype=torch.bool, device=dev)
    bracket_z = torch.zeros((h, w), dtype=torch.float32, device=dev)
    found = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for step in range(num_steps):
        z = np.float32(depth_min) + (np.float32(step) + np.float32(1.0)) * dz
        val, valid = _nearest(sval, vol.origin, vol.voxel_size, at(float(z)))
        crossing = prev_valid & valid & (prev_val > 0) & (val <= 0) & ~found
        bracket_z = torch.where(crossing, float(z - dz), bracket_z)  # crossing in [z-dz, z]
        found = found | crossing
        prev_val, prev_valid = val, valid

    # Refine inside the bracket, started half a step early (the march brackets
    # on nearest-voxel signs), bisected three times, then a secant. Without it
    # a coarse march biases the model surface toward the camera.
    def sample(z):
        return _trilinear(sval, sval.shape, vol.origin, vol.voxel_size, at(z), True)

    lo = bracket_z - float(0.5 * float(dz))
    hi = bracket_z + float(dz)
    vlo, oklo = sample(lo)
    vhi, okhi = sample(hi)
    for _ in range(3):
        mid = 0.5 * (lo + hi)
        vmid, _ = sample(mid)
        take_low = vmid > 0  # crossing in [mid, hi]
        lo = torch.where(take_low, mid, lo)
        vlo = torch.where(take_low, vmid, vlo)
        hi = torch.where(take_low, hi, mid)
        vhi = torch.where(take_low, vhi, vmid)
    denom = vlo - vhi
    big = denom.abs() > 1e-9
    alpha = torch.where(oklo & okhi & big, vlo / torch.where(big, denom, 1.0), 0.5)
    hit_z = lo + torch.clip(alpha, 0.0, 1.0) * (hi - lo)
    verts = at(hit_z)
    normals = _gradient(vol, verts)
    # Orient normals toward the camera.
    flip = ((normals[0] * (origin[0] - verts[0]) + normals[1] * (origin[1] - verts[1]))
            + normals[2] * (origin[2] - verts[2])) < 0
    normals = [torch.where(flip, -n, n) for n in normals]
    keep = found[..., None]
    return RaycastResult(
        vertices=torch.where(keep, torch.stack(verts, -1), 0.0),
        normals=torch.where(keep, torch.stack(normals, -1), 0.0),
        valid=found,
    )
