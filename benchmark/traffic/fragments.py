"""The registration cell's clouds: consecutive fragments of the livingroom orbit.

Fragment ``f`` covers orbit frames ``f K .. f K + K``, as the fragments stage
cuts them. Every ``stride``-th of those frames (rendered, noised and rounded to
millimetres by ``livingroom.orbit_frames``) is fused at its ground-truth pose
relative to the fragment's first frame by the reference's fuse
(``reference/odometry.py``, the frozen copy of the port's), into a volume
placed as the program places a fragment's; the cloud is that volume's zero
crossings, extracted as the program extracts them and padded to the
configuration's capacity, as the registration stage loads a fragment's file.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import odometry as ref
from ..reference.geometry import Intrinsics, compose, inverse
from . import livingroom


def fragment_clouds(params: dict, config: dict, intr: Intrinsics, seed: int, device
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(points (F, C, 3), normals (F, C, 3), mask (F, C))`` float32 / bool, ``C`` the cloud capacity."""
    K, stride, num = config["frames_per_fragment"], params["stride"], params["fragments"]
    if K % stride:
        raise ValueError(f"stride {stride} does not divide the {K} frames a fragment steps")
    frag = config["fragment"]
    cap = frag["cloud_capacity"]
    mm, gt = livingroom.orbit_frames(dict(params, frames=num * K + 1), intr, seed, device)
    step = K // stride
    points = np.zeros((num, cap, 3), np.float32)
    normals = np.zeros((num, cap, 3), np.float32)
    mask = np.zeros((num, cap), bool)
    for f in range(num):
        rows = slice(f * step, f * step + step + 1)
        depths = torch.from_numpy(livingroom.from_millimetres(mm[rows])).to(device)
        poses = torch.from_numpy(gt[rows]).to(device)
        base = inverse(poses[0])
        vol = ref.make_volume(tuple(frag["volume_shape"]), frag["voxel_size"], frag["volume_min_z"], device)
        for k in range(depths.shape[0]):
            vol = ref.fuse(vol, depths[k], compose(base, poses[k]), intr, max_weight=frag["max_weight"],
                           depth_min=frag["depth_min"], depth_max=frag["depth_max"])
        cloud = ref.extract_surface_points(vol, capacity=cap)
        del vol
        n = cloud.points.shape[0]
        points[f, :n] = cloud.points.cpu().numpy()
        normals[f, :n] = cloud.normals.cpu().numpy()
        mask[f, :n] = True
    return points, normals, mask
