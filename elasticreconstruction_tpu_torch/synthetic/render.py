"""Sphere-tracing depth renderer: the synthetic stand-in for the RGB-D sensor.

Counterpart of ``elasticreconstruction_tpu/synthetic/render.py``. Fixed-step
sphere tracing of every pixel; where the reference maps one frame at a time
(``lax.map``), the port marches a batch of poses in one pass, e.g. 16 frames
as one ``(16, H, W)`` march, because every step evaluates the whole scene (a
few hundred small ops) and a batch shares those launches.
"""

from __future__ import annotations

import torch

from ..core import camera as cam
from .sdf import SDF


def render_batch(
    scene: SDF,
    poses: torch.Tensor,
    intr: cam.Intrinsics,
    *,
    max_depth: float = 8.0,
    num_steps: int = 96,
    hit_threshold: float = 1e-3,
) -> torch.Tensor:
    """Depth maps ``(B, H, W)`` from camera-to-world ``poses (B, 4, 4)``.

    Depth is the camera-frame z of the first surface hit; 0 where the ray
    escapes ``max_depth`` without converging (the sensor-invalid convention).
    """
    dev = poses.device
    dirs_cam = cam.ray_directions(intr, device=dev)
    norm = torch.linalg.vector_norm(dirs_cam, dim=-1, keepdim=True)
    dirs_unit = dirs_cam * (torch.scalar_tensor(1.0) / norm)  # unit rays, cam frame
    dz = dirs_unit[..., 2]  # z per unit ray length
    R = poses[:, None, :3, :3]  # (B, 1, 3, 3)
    dirs_world = dirs_unit.reshape(1, -1, 3) @ R[:, 0].transpose(-1, -2)  # (B, H*W, 3)
    b = poses.shape[0]
    h, w = dz.shape
    # Coordinate-major layout: each coordinate of the points is contiguous.
    dirs_world = dirs_world.reshape(b, h, w, 3).permute(3, 0, 1, 2).contiguous()
    origin = poses[:, :3, 3].T.reshape(3, b, 1, 1)
    escape = torch.scalar_tensor(max_depth) / torch.clamp_max(dz, 1.0)

    def points(t):
        return (origin + dirs_world * t).permute(1, 2, 3, 0)  # (B, H, W, 3) view

    t = torch.full((b, h, w), 0.05, dtype=torch.float32, device=dev)
    done = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    for _ in range(num_steps):
        d = scene(points(t))
        done = done | (d < hit_threshold) | (t > escape)
        # Conservative step (0.9x) guards slightly-non-metric CSG fields.
        t = torch.where(done, t, t + torch.clamp_min(d * 0.9, hit_threshold * 0.5))
    converged = (scene(points(t)) < 10 * hit_threshold) & (t * dz <= max_depth)
    return torch.where(converged, t * dz, 0.0)


def render_depth(scene: SDF, pose: torch.Tensor, intr: cam.Intrinsics, **kw) -> torch.Tensor:
    """Render one depth map ``(H, W)`` from camera-to-world ``pose (4, 4)``."""
    return render_batch(scene, pose[None], intr, **kw)[0]


def render_sequence(scene: SDF, poses: torch.Tensor, intr: cam.Intrinsics, *, batch: int = 16,
                    **kw) -> torch.Tensor:
    """Render ``(T, H, W)`` depths for a ``(T, 4, 4)`` trajectory, ``batch`` frames per march."""
    return torch.cat([render_batch(scene, poses[s : s + batch], intr, **kw)
                      for s in range(0, poses.shape[0], batch)])
