"""Scene-scale TSDF integration with optimized trajectories.

Counterpart of ``elasticreconstruction_tpu/integrate/scene.py``: for every
frame of the raw sequence, compose the frame's pose (fragment pose o
within-fragment odometry pose) and fuse it into one scene volume. The
reference scans a chunk of frames inside one jitted call; here a Python loop
over the chunk calls ``kernels/tsdf.py``'s ``fuse`` or ``fuse_scatter``, whose
work is a few dozen whole-volume (or whole-band) ops per frame.

The lattice-corrected variants take every point through the fragment's
control-lattice warp (``elastic/lattice.py``) on its way between world and
camera. Each point's warp is computed from that point alone (elementwise
rigid maps, corner-by-corner interpolation), which the scatter form needs:
duplicate samples of a voxel must carry the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import camera as cam
from ..core import se3
from ..core.types import resolve_device
from ..elastic.lattice import Lattice, deform
from ..kernels import tsdf as _tsdf


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


def _affine(pose: torch.Tensor):
    """``p -> R p + t`` for ``(..., 3)`` points, elementwise: ``p @ R.T + t``."""
    R, t = pose[:3, :3], pose[:3, 3]
    return lambda p: torch.stack(
        [(p[..., 0] * R[j, 0] + p[..., 1] * R[j, 1]) + p[..., 2] * R[j, 2] + t[j] for j in range(3)], -1)


def _world_to_cam(lat: Lattice, disp: torch.Tensor, Tf: torch.Tensor, Lk: torch.Tensor):
    """World -> fragment-local (``Tf^-1``) -> inverse lattice warp (the small-
    displacement approximation ``D^-1(x) ~= 2x - D(x)``) -> camera (``Lk^-1``)."""
    to_local, to_cam = _affine(se3.inverse(Tf)), _affine(se3.inverse(Lk))

    def warp(p_world):
        local = to_local(p_world)
        return to_cam(2.0 * local - deform(lat, disp, local))

    return warp


def integrate_frames_slac(
    vol: _tsdf.TSDFVolume,
    depths: torch.Tensor,
    frag_poses: torch.Tensor,
    local_poses: torch.Tensor,
    displacement: torch.Tensor,
    lat: Lattice,
    intr: cam.Intrinsics,
    cfg: SceneConfig = SceneConfig(),
) -> _tsdf.TSDFVolume:
    """Fuse a chunk with the SLAC/elastic lattice correction applied.

    Per frame k: voxel world point -> fragment-local via ``frag_poses[k]^-1``
    -> inverse lattice warp -> camera via ``local_poses[k]^-1`` -> project into
    ``depths[k]``. ``displacement``: (K, M, 3), the lattice of the fragment
    owning each frame.
    """
    for depth, Tf, Lk, disp in zip(depths, frag_poses, local_poses, displacement):
        p_cam = _world_to_cam(lat, disp, Tf, Lk)(_tsdf.voxel_centers(vol))
        vol = _tsdf.fuse_at_camera_points(vol, depth, p_cam, intr, max_weight=cfg.max_weight,
                                          depth_min=cfg.depth_min, depth_max=cfg.depth_max)
    return vol


def integrate_frames_slac_scatter(
    vol: _tsdf.TSDFVolume,
    depths: torch.Tensor,
    frag_poses: torch.Tensor,
    local_poses: torch.Tensor,
    displacement: torch.Tensor,
    lat: Lattice,
    intr: cam.Intrinsics,
    cfg: SceneConfig = SceneConfig(),
) -> _tsdf.TSDFVolume:
    """Scatter twin of :func:`integrate_frames_slac`.

    Band samples go camera -> fragment-local (``local_poses[k]``) -> FORWARD
    lattice warp -> world (``frag_poses[k]``), the optimiser's geometry model
    ``T_i D_i(p)``, to nominate voxels; each hit voxel's observation is then
    re-evaluated at its centre through the inverse warp chain of the gather
    twin (``kernels/tsdf.py::scatter_update``).
    """
    for depth, Tf, Lk, disp in zip(depths, frag_poses, local_poses, displacement):
        p_cam, valid = _tsdf.band_samples(depth, intr, vol.truncation, depth_min=cfg.depth_min,
                                          depth_max=cfg.depth_max)
        p_world = _affine(Tf)(deform(lat, disp, _affine(Lk)(p_cam)))
        vol = _tsdf.scatter_update(vol, p_world, valid, _world_to_cam(lat, disp, Tf, Lk), depth, intr,
                                   max_weight=cfg.max_weight, depth_min=cfg.depth_min,
                                   depth_max=cfg.depth_max)
    return vol


def compose_frame_poses(fragment_poses: torch.Tensor, local_poses_per_fragment: torch.Tensor) -> torch.Tensor:
    """World pose per frame: ``T_frag[f] @ T_local[f][k]`` flattened in order.

    ``fragment_poses``: (NF, 4, 4); ``local_poses_per_fragment``: (NF, K, 4, 4).
    """
    return torch.einsum("fij,fkjl->fkil", fragment_poses, local_poses_per_fragment).reshape(-1, 4, 4)
