"""Block-grid scene TSDF: scenes larger than one dense volume.

A copy of ``elasticreconstruction_tpu/integrate/blocks.py`` (numpy only).
The reference's Integrate derives from pcl_kinfu_largeScale, whose volume
shifts through the scene so the working set stays bounded. Here the scene
bounding box is tiled into uniform blocks of at most ``max_shape`` voxels
with a small halo overlap; the frame stream is integrated into one block at a
time (fusion is voxel-local, so a voxel's value does not depend on which
block computes it), the mesh is extracted per block, and only triangles whose
centroid lies in the block's owned (non-halo) region are kept: the owned
regions tile the scene exactly, so block boundaries leave no seams and no
duplicates.

All blocks share one tile shape. Frames are culled per block against
per-fragment world bounds (a frame can only touch a block if its fragment's
surface does), keeping total work about linear in scene size instead of
blocks x frames.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Block(NamedTuple):
    index: tuple[int, int, int]  # tile coordinates
    vox_lo: tuple[int, int, int]  # first voxel of the tile in scene-grid units
    owned_lo_vox: tuple[int, int, int]  # owned region [lo, hi) in scene voxels
    owned_hi_vox: tuple[int, int, int]

    def world_origin(self, scene_lo: np.ndarray, voxel_size: float) -> tuple[float, float, float]:
        return tuple(float(scene_lo[a] + self.vox_lo[a] * voxel_size) for a in range(3))

    def owned_world(
        self, scene_lo: np.ndarray, voxel_size: float, want_shape: tuple[int, int, int]
    ) -> tuple[np.ndarray, np.ndarray]:
        """World AABB of the owned region; open-ended at the scene border so
        boundary triangles (which can poke slightly outside the bbox) are kept."""
        lo = np.array(
            [
                -np.inf if self.owned_lo_vox[a] == 0 else scene_lo[a] + self.owned_lo_vox[a] * voxel_size
                for a in range(3)
            ]
        )
        hi = np.array(
            [
                np.inf
                if self.owned_hi_vox[a] >= want_shape[a]
                else scene_lo[a] + self.owned_hi_vox[a] * voxel_size
                for a in range(3)
            ]
        )
        return lo, hi


class BlockPlan(NamedTuple):
    blocks: list[Block]
    tile_shape: tuple[int, int, int]  # common static shape (one compile)
    want_shape: tuple[int, int, int]
    overlap: int


def _axis_tiles(n: int, m: int, ov: int) -> tuple[list[tuple[int, int, int]], int]:
    """Tiles along one axis: [(vox_lo, owned_lo, owned_hi)], tile length."""
    if n <= m:
        return [(0, 0, n)], n
    own = m - 2 * ov
    if own <= 0:
        raise ValueError(f"max_shape {m} too small for overlap {ov}")
    k = -(-n // own)
    tiles = []
    for t in range(k):
        o0 = t * own
        o1 = min(n, o0 + own)
        # Clamp the tile inside the scene grid: boundary tiles take their halo
        # one-sided, so block voxels always alias scene voxels exactly (the
        # block path then reproduces the monolithic volume bit-for-bit).
        v0 = min(max(o0 - ov, 0), n - m)
        tiles.append((v0, o0, o1))
    return tiles, m


def plan_blocks(
    want_shape: tuple[int, int, int],
    max_shape: tuple[int, int, int],
    *,
    overlap: int = 4,
) -> BlockPlan:
    """Tile a ``want_shape`` scene grid into blocks of at most ``max_shape``.

    ``overlap`` halo voxels per face give mesh extraction (cube neighbors +
    gradient normals) full support inside each owned region.  Owned regions
    partition the scene grid exactly.
    """
    per_axis = [_axis_tiles(want_shape[a], max_shape[a], overlap) for a in range(3)]
    tile_shape = tuple(p[1] for p in per_axis)
    blocks = []
    for i, (vx, ox0, ox1) in enumerate(per_axis[0][0]):
        for j, (vy, oy0, oy1) in enumerate(per_axis[1][0]):
            for k, (vz, oz0, oz1) in enumerate(per_axis[2][0]):
                blocks.append(
                    Block(
                        index=(i, j, k),
                        vox_lo=(vx, vy, vz),
                        owned_lo_vox=(ox0, oy0, oz0),
                        owned_hi_vox=(ox1, oy1, oz1),
                    )
                )
    return BlockPlan(blocks=blocks, tile_shape=tile_shape, want_shape=want_shape, overlap=overlap)


def block_world_aabb(
    block: Block, plan: BlockPlan, scene_lo: np.ndarray, voxel_size: float
) -> tuple[np.ndarray, np.ndarray]:
    """World AABB covered by the block's full tile (halo included)."""
    lo = scene_lo + np.array(block.vox_lo) * voxel_size
    hi = lo + np.array(plan.tile_shape) * voxel_size
    return lo, hi


def cull_frames(
    block: Block,
    plan: BlockPlan,
    scene_lo: np.ndarray,
    voxel_size: float,
    frame_aabb_lo: np.ndarray,
    frame_aabb_hi: np.ndarray,
    margin: float,
) -> np.ndarray:
    """Bool mask of frames whose surface AABB intersects the block tile.

    ``frame_aabb_*``: (N, 3) per-frame world bounds (typically the owning
    fragment's posed-cloud AABB).  ``margin`` absorbs pose error + the
    truncation band.
    """
    lo, hi = block_world_aabb(block, plan, scene_lo, voxel_size)
    return np.all(
        (frame_aabb_lo <= hi[None, :] + margin) & (frame_aabb_hi >= lo[None, :] - margin),
        axis=1,
    )


def filter_owned_triangles(
    tris: np.ndarray,
    mask: np.ndarray,
    block: Block,
    plan: BlockPlan,
    scene_lo: np.ndarray,
    voxel_size: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Keep triangles whose centroid lies in the block's owned world region.

    Exact tiling: every triangle of the ideal full-scene mesh has its
    centroid in exactly one owned region, so concatenating filtered block
    meshes reproduces the full mesh without duplicates.
    """
    tris = np.asarray(tris).reshape(-1, 3, 3)
    mask = np.asarray(mask).reshape(-1)
    lo, hi = block.owned_world(scene_lo, voxel_size, plan.want_shape)
    c = tris.mean(axis=1)
    keep = mask & np.all((c >= lo[None, :]) & (c < hi[None, :]), axis=1)
    return tris[keep], np.ones(int(keep.sum()), bool)
