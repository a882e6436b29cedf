"""Voxel-grid downsampling under static shapes (sort + segment reduction).

Counterpart of ``elasticreconstruction_tpu/kernels/voxel_grid.py``: pack
voxel coords into a key, scramble it with a bijective hash, stable-sort points
by key, detect run starts, segment-mean each run into a fixed-capacity output
with a validity mask.

The output ROW ORDER is part of the contract: ICP keeps every second row of
it (``icp_src_stride``), its coarse phase every fourth, and an over-capacity
cloud keeps a prefix. So the key math reproduces the reference's uint32
arithmetic exactly, in int64 with an explicit 30-bit mask (torch's uint32
arithmetic is incomplete), and the sort is stable as ``jnp.argsort`` is.
The voxel sums reduce each run of the sorted rows in a fixed order
(``core/segment.py``), so a cloud gives the same means on every run; they
may differ from the reference's in the last bits while masks and order stay
equal.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import segment
from ..core.types import PointCloud

_AXIS_BITS = 10
_AXIS_CAP = (1 << _AXIS_BITS) - 1  # 1023 voxels per axis
_KEY_MASK = (1 << (3 * _AXIS_BITS)) - 1
# Odd multiplier: k -> (k * A) mod 2^30 is a bijection on the 30-bit key
# space, so segments stay intact while the sort order is spatially scrambled
# (an over-capacity overflow then drops a pseudo-random subset of voxels, not
# one side of the fragment).
_HASH_MULT = 0x9E3779B1
_INVALID_KEY = 0xFFFFFFFF


def voxel_keys(
    points: torch.Tensor, mask: torch.Tensor, voxel_size: float, origin: torch.Tensor
) -> torch.Tensor:
    """Packed voxel key per point (int64 holding the reference's uint32 value);
    invalid or out-of-range points get the ``0xFFFFFFFF`` sentinel."""
    # Multiply by the f32 reciprocal: XLA rewrites the reference's division by
    # the constant voxel size that way, and a true division can put a point in
    # the neighbouring voxel.
    inv = float(np.float32(1.0) / np.float32(voxel_size))
    coords = torch.floor((points - origin) * inv).to(torch.int64)
    in_range = ((coords >= 0) & (coords <= _AXIS_CAP)).all(-1)
    key = (coords[..., 0] << (2 * _AXIS_BITS)) | (coords[..., 1] << _AXIS_BITS) | coords[..., 2]
    return torch.where(mask & in_range, key, _INVALID_KEY)


def voxel_downsample(cloud: PointCloud, voxel_size: float, capacity: int) -> PointCloud:
    """Average points (and normals) per occupied voxel into ``capacity`` rows.

    Over capacity, a deterministic pseudo-random (spatially unbiased) subset
    of voxels survives. Points outside the 1023^3 key range around the
    cloud's min corner are dropped.
    """
    points, normals, mask = cloud.points, cloud.normals, cloud.mask
    origin = torch.where(mask[:, None], points, 1e30).amin(0)
    keys = voxel_keys(points, mask, voxel_size, origin)
    keys = torch.where(keys == _INVALID_KEY, keys, (keys * _HASH_MULT) & _KEY_MASK)

    skeys, order = torch.sort(keys, stable=True)
    spts = points[order]
    snrm = normals[order]
    valid = skeys != _INVALID_KEY

    first = torch.ones_like(valid)
    first[1:] = skeys[1:] != skeys[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    # Invalid rows and voxels past capacity go to the dropped row `capacity`.
    seg = torch.where(valid, seg.clamp_max(capacity), capacity)

    runs = segment.plan_sorted(seg, capacity + 1)  # seg ascends with the sorted keys

    def segment_sum(x):
        return segment.segment_sum(x, runs)[:capacity]

    psum = segment_sum(spts)
    nsum = segment_sum(snrm)
    cnt = segment_sum(valid.to(torch.float32))

    out_mask = cnt > 0
    denom = cnt.clamp_min(1.0)[:, None]
    mean_pts = psum / denom
    mean_nrm = nsum / denom
    nrm_len = torch.linalg.norm(mean_nrm, dim=-1, keepdim=True)
    mean_nrm = mean_nrm / torch.where(nrm_len > 1e-9, nrm_len, 1.0)
    return PointCloud(
        points=torch.where(out_mask[:, None], mean_pts, 0.0),
        normals=torch.where(out_mask[:, None], mean_nrm, 0.0),
        mask=out_mask,
    )
