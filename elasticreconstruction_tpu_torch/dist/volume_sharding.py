"""Spatially sharded scene TSDF: each rank holds an x-slab of the volume.

Counterpart of ``elasticreconstruction_tpu/dist/volume_sharding.py``, plus
what XLA did there without being asked. Fusion is voxel-local, so each rank
fuses its own slab with no collective (:func:`fuse_sharded`). Meshing marches
each rank's own cubes with a halo of neighbouring planes passed on by
:func:`comm.ring_shift`, and the triangles are gathered
(:func:`extract_mesh_sharded`).

A slab keeps the whole volume's origin and knows its first plane's x index
(:class:`VolumeSlab`): a slab with its own shifted origin would round voxel
centres differently, since centres and mesh vertices are ``o + i * h``
formed as one fused multiply-add (``core/types.py::fma``). With the global
origin a slab's floats equal the whole volume's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..core import camera as cam
from ..integrate.mesh import extract_mesh
from ..integrate.scene import SceneConfig
from ..kernels import tsdf as _tsdf
from . import comm
from .mesh import group_or_world, shard_bounds

# Planes of the neighbours a rank's cubes need: the cube corners reach one
# plane past the slab, the orientation test's gradient samples (a voxel
# either side of a triangle's centroid, which float rounding can put a hair
# outside its cube) reach two below and three above.
HALO_BELOW = 2
HALO_ABOVE = 3


class VolumeSlab(NamedTuple):
    """Planes ``x0 .. x0 + X_slab - 1`` of a volume along x."""

    vol: _tsdf.TSDFVolume  # the slab's arrays, the whole volume's origin and scalars
    x0: int


def shard_volume(vol: _tsdf.TSDFVolume, group: dist.ProcessGroup | None = None) -> VolumeSlab:
    """This rank's x-slab of ``vol``; the x extent must divide by the world size."""
    a, b = shard_bounds(vol.shape[0], group, "volume x extent")
    return VolumeSlab(vol._replace(tsdf=vol.tsdf[a:b].clone(), weight=vol.weight[a:b].clone()), a)


def gather_volume(slab: VolumeSlab, group: dist.ProcessGroup | None = None) -> _tsdf.TSDFVolume:
    """The whole volume on every rank, from every rank's slab."""
    return slab.vol._replace(tsdf=comm.all_gather_rows(slab.vol.tsdf, group),
                             weight=comm.all_gather_rows(slab.vol.weight, group))


def fuse_sharded(slab: VolumeSlab, depths: torch.Tensor, poses: torch.Tensor, intr: cam.Intrinsics,
                 cfg: SceneConfig = SceneConfig(), *, scatter: bool = False) -> VolumeSlab:
    """Fuse ``(K, H, W)`` depths at ``(K, 4, 4)`` camera-to-world poses into
    the rank's slab: ``integrate_frames`` (``scatter=False``) or
    ``integrate_frames_scatter``, each voxel with the bits it gets there."""
    fuse = _tsdf.fuse_scatter if scatter else _tsdf.fuse
    vol = slab.vol
    for depth, pose in zip(depths, poses):
        vol = fuse(vol, depth, pose, intr, max_weight=cfg.max_weight, depth_min=cfg.depth_min,
                   depth_max=cfg.depth_max, x_offset=slab.x0)
    return slab._replace(vol=vol)


def _planes(vol: _tsdf.TSDFVolume, a: int, b: int) -> list[torch.Tensor]:
    return [vol.tsdf[a:b].contiguous(), vol.weight[a:b].contiguous()]


def extract_mesh_sharded(slab: VolumeSlab, group: dist.ProcessGroup | None = None, *,
                         capacity_per_slab: int = 16384) -> torch.Tensor:
    """Every rank's kept triangles ``(T, 3, 3)``, rank by rank, on every rank.

    Each rank marches the cubes of its own x-range (the last rank's end at
    the volume's last plane) with ``integrate.mesh.extract_mesh``, after
    taking :data:`HALO_BELOW` planes from the previous rank and
    :data:`HALO_ABOVE` from the next. Where no z-slab outgrows
    ``capacity_per_slab`` the triangles are the single volume's, in another
    order.
    """
    group = group_or_world(group)
    d, r = dist.get_world_size(group), dist.get_rank(group)
    vol, width = slab.vol, slab.vol.shape[0]
    if d > 1 and width < max(HALO_BELOW, HALO_ABOVE):
        raise ValueError(f"x-slabs of {width} planes are thinner than the halo ({HALO_ABOVE} planes)")
    above = comm.ring_shift(_planes(vol, 0, HALO_ABOVE), group, shift=1)  # the next rank's first planes
    below = comm.ring_shift(_planes(vol, width - HALO_BELOW, width), group, shift=-1)  # the previous rank's last
    first, last = r == 0, r == d - 1
    parts = ([] if first else [below]) + [_planes(vol, 0, width)] + ([] if last else [above])
    ext = vol._replace(tsdf=torch.cat([p[0] for p in parts]), weight=torch.cat([p[1] for p in parts]))
    lo = 0 if first else HALO_BELOW
    tris, mask = extract_mesh(ext, capacity_per_slab=capacity_per_slab, x_offset=slab.x0 - lo,
                              x_cells=(lo, lo + width - (1 if last else 0)))
    kept = tris[mask]
    counts = comm.all_gather_rows(torch.tensor([kept.shape[0]], device=kept.device), group).tolist()
    padded = torch.cat([kept, kept.new_zeros((max(counts) - kept.shape[0], 3, 3))])
    every = comm.all_gather_rows(padded, group).reshape(d, max(counts), 3, 3)
    return torch.cat([every[k, :n] for k, n in enumerate(counts)])
