"""Scene-scale TSDF integration with optimized trajectories.

Counterpart of ``elasticreconstruction_tpu/integrate/scene.py``: for every
frame of the raw sequence, compose the frame's pose (fragment pose o
within-fragment odometry pose) and fuse it into one scene volume. The
reference scans a chunk of frames inside one jitted call; here a Python loop
over the chunk calls ``kernels/tsdf.py``'s ``fuse`` or ``fuse_scatter``, whose
work is a few dozen whole-volume (or whole-band) ops per frame.

The lattice-undistorted variants need the control lattice's warp
(``elastic/lattice.py``), which is not ported yet: they raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import camera as cam
from ..core.types import resolve_device
from ..kernels import tsdf as _tsdf

_NO_LATTICE = (
    "lattice-undistorted integration needs elastic/lattice.py, which is not ported yet "
    "(ROADMAP.md, Queue 1 item 9)"
)


class SceneConfig(NamedTuple):
    volume_shape: tuple[int, int, int] = (512, 512, 256)
    voxel_size: float = 0.012
    origin: tuple[float, float, float] = (-3.2, -0.2, -3.2)
    max_weight: float = 256.0
    depth_min: float = 0.1
    depth_max: float = 6.0


def make_scene_volume(cfg: SceneConfig, device="cuda") -> _tsdf.TSDFVolume:
    return _tsdf.make_volume(cfg.volume_shape, cfg.voxel_size, cfg.origin, device=resolve_device(device))


def _fuse_each(fuse, vol, depths, poses, intr, cfg):
    for depth, pose in zip(depths, poses):
        vol = fuse(vol, depth, pose, intr, max_weight=cfg.max_weight,
                   depth_min=cfg.depth_min, depth_max=cfg.depth_max)
    return vol


def integrate_frames(
    vol: _tsdf.TSDFVolume,
    depths: torch.Tensor,
    poses: torch.Tensor,
    intr: cam.Intrinsics,
    cfg: SceneConfig = SceneConfig(),
) -> _tsdf.TSDFVolume:
    """Fuse a chunk of ``(K, H, W)`` depths with ``(K, 4, 4)`` world poses."""
    return _fuse_each(_tsdf.fuse, vol, depths, poses, intr, cfg)


def integrate_frames_scatter(
    vol: _tsdf.TSDFVolume,
    depths: torch.Tensor,
    poses: torch.Tensor,
    intr: cam.Intrinsics,
    cfg: SceneConfig = SceneConfig(),
) -> _tsdf.TSDFVolume:
    """Scatter-formulation twin of :func:`integrate_frames`: the work per frame
    scales with pixels x band samples instead of the voxel count
    (``kernels/tsdf.py::fuse_scatter``), the right form for scene volumes,
    which are meshed, never raycast."""
    return _fuse_each(_tsdf.fuse_scatter, vol, depths, poses, intr, cfg)


def integrate_frames_slac(vol, depths, frag_poses, local_poses, displacement, lat, intr, cfg=SceneConfig()):
    """Fuse a chunk with the SLAC/elastic lattice correction: not ported yet."""
    raise NotImplementedError(_NO_LATTICE)


def integrate_frames_slac_scatter(vol, depths, frag_poses, local_poses, displacement, lat, intr,
                                  cfg=SceneConfig()):
    """Scatter twin of :func:`integrate_frames_slac`: not ported yet."""
    raise NotImplementedError(_NO_LATTICE)


def compose_frame_poses(fragment_poses: torch.Tensor, local_poses_per_fragment: torch.Tensor) -> torch.Tensor:
    """World pose per frame: ``T_frag[f] @ T_local[f][k]`` flattened in order.

    ``fragment_poses``: (NF, 4, 4); ``local_poses_per_fragment``: (NF, K, 4, 4).
    """
    return torch.einsum("fij,fkjl->fkil", fragment_poses, local_poses_per_fragment).reshape(-1, 4, 4)
