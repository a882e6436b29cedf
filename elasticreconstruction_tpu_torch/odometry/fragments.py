"""Fragment emitter: k-frame odometry windows -> fragment clouds + local poses.

Counterpart of ``elasticreconstruction_tpu/odometry/fragments.py``. The
reference builds a fragment in one jitted ``lax.scan`` over its frames (track
-> fuse), then extracts the zero-crossing surface. Here the scan is a Python
loop over frames that keeps every per-frame decision on the device: the lost
and healthy tests and the trusted-velocity update are ``torch.where``, and no
per-frame value is read back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import camera as cam
from ..core import se3, trace
from ..core.types import PointCloud
from ..kernels import tsdf as _tsdf
from .kinfu import OdometryConfig, track_frame


class FragmentConfig(NamedTuple):
    """Fragment constants: the same fields and defaults as the JAX package's."""

    frames_per_fragment: int = 50
    volume_shape: tuple[int, int, int] = (256, 256, 256)
    voxel_size: float = 0.012
    # Volume placement in the fragment-local (first-camera) frame: centered
    # laterally on the optical axis, starting just in front of the camera.
    volume_min_z: float = 0.3
    cloud_capacity: int = 1 << 17  # 131072 surface samples per fragment
    max_weight: float = 64.0
    depth_min: float = 0.1
    depth_max: float = 6.0
    odometry: OdometryConfig = OdometryConfig()


class FragmentResult(NamedTuple):
    cloud: PointCloud  # surface samples, fragment-local frame
    local_poses: torch.Tensor  # (K, 4, 4) camera-to-fragment poses (frame 0 = I)
    fitness: torch.Tensor  # (K,) per-frame tracking fitness
    rmse: torch.Tensor  # (K,) per-frame tracking rmse
    obs_ratio: torch.Tensor  # (K,) translation observability (min/max eig of H_tt)
    final_velocity: torch.Tensor  # (6,) body twist at the last frame (next seed)


def _volume_origin(cfg: FragmentConfig) -> tuple[float, float, float]:
    sx, sy, sz = cfg.volume_shape
    return (
        -0.5 * sx * cfg.voxel_size,
        -0.5 * sy * cfg.voxel_size,
        cfg.volume_min_z,
    )


def build_fragment(
    depths: torch.Tensor,
    intr: cam.Intrinsics,
    cfg: FragmentConfig = FragmentConfig(),
    init_velocity: torch.Tensor | None = None,
) -> FragmentResult:
    """Run frame-to-model odometry over ``depths (K, H, W)`` on their device.

    Frame 0 defines the fragment frame (pose = identity); each later frame is
    tracked against the fused model, then fused in. ``init_velocity`` seeds
    the constant-body-velocity prediction for frame 1 (the previous
    fragment's ``final_velocity``).
    """
    dev = depths.device
    fuse_kw = dict(max_weight=cfg.max_weight, depth_min=cfg.depth_min, depth_max=cfg.depth_max)
    ocfg = cfg.odometry
    eye = se3.identity(device=dev)
    vol = _tsdf.make_volume(cfg.volume_shape, cfg.voxel_size, _volume_origin(cfg), device=dev)
    with trace.span("odometry.fuse"):
        vol = _tsdf.fuse(vol, depths[0], eye, intr, **fuse_kw)
    v_trusted = torch.zeros(6, dtype=torch.float32, device=dev) if init_velocity is None else init_velocity
    T_prev = eye
    poses, fits, rmses, obss = [eye], [], [], []
    for k in range(1, depths.shape[0]):
        depth = depths[k]
        # Seed and prior anchor: constant-body-velocity prediction from the
        # trusted velocity, which is re-estimated only on healthy frames.
        gain = ocfg.velocity_gain
        T_pred = T_prev @ se3.exp(gain * v_trusted) if gain > 0 else T_prev
        with trace.span("odometry.track"):
            tr = track_frame(vol, depth, T_pred, intr, ocfg)
        lost = tr.fitness < 1e-3
        pose = torch.where(lost, T_pred, tr.pose)
        healthy = ~lost & (tr.obs_ratio > ocfg.healthy_obs_ratio) & (tr.fitness > ocfg.healthy_fitness)
        # EMA over healthy frames (~10-frame horizon).
        v_obs = se3.log(se3.inverse(T_prev) @ pose)
        v_trusted = torch.where(healthy, 0.8 * v_trusted + 0.2 * v_obs, v_trusted)
        with trace.span("odometry.fuse"):
            vol = _tsdf.fuse(vol, depth, pose, intr, **fuse_kw)
        T_prev = pose
        poses.append(pose)
        fits.append(tr.fitness)
        rmses.append(tr.rmse)
        obss.append(tr.obs_ratio)
    one = torch.ones((), dtype=torch.float32, device=dev)
    with trace.span("odometry.extract"):
        cloud = _tsdf.extract_surface_points(vol, capacity=cfg.cloud_capacity)
    return FragmentResult(
        cloud=cloud,
        local_poses=torch.stack(poses),
        fitness=torch.stack([one] + fits),
        rmse=torch.stack([one * 0] + rmses),
        obs_ratio=torch.stack([one] + obss),
        final_velocity=v_trusted,
    )
