"""TSDF raycast on the card: CUDA kernel ``csrc/raycast.cu``.

The plain version is ``kernels/raycast.py::raycast_plain``, which
``kernels/raycast.py::raycast`` runs for CPU tensors; for CUDA tensors it
calls :func:`raycast_cuda`. The kernel replaces no TPU kernel (the reference's
raycast is plain jnp): it marches each ray in registers and stops at its
first crossing, in place of the plain version's lockstep march of every ray
for every step. Both route their arithmetic the same way, so on the card the
two agree bit for bit (``csrc/raycast.cu``). One launch a call, on the
current stream, with no readback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core import camera as cam
from ...core import se3
from ...core.types import f32_reciprocal
from . import build

_KERNEL = build.Kernel("raycast", "raycast",
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float] * 7 + [ctypes.c_int])


def raycast_cuda(vol, pose: torch.Tensor, intr: cam.Intrinsics, *, depth_min: float, depth_max: float,
                 num_steps: int):
    """:func:`..raycast.raycast` for a volume on the card: ``(vertices, normals, valid)``.

    The world-frame ray directions come from the plain version's own code
    (``cam.ray_directions``, ``se3.rotate``); the kernel reads the pose's
    translation on the device.
    """
    dev = vol.tsdf.device
    pose = pose.contiguous()
    shape = vol.shape
    build.check_args("raycast", {"tsdf": vol.tsdf, "weight": vol.weight, "pose": pose},
                     {"tsdf": torch.float32, "weight": torch.float32, "pose": torch.float32},
                     {"tsdf": shape, "weight": shape, "pose": (4, 4)})
    if min(shape) < 2:
        raise ValueError(f"raycast: volume shape {shape} needs at least 2 voxels an axis")
    h, w = intr.height, intr.width
    dirs = se3.rotate(pose, cam.ray_directions(intr, device=dev).reshape(-1, 3)).contiguous()
    vertices = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    normals = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((h, w), dtype=torch.bool, device=dev)
    dz = np.float32((depth_max - depth_min) / num_steps)
    _KERNEL(
        dev, vol.tsdf.data_ptr(), vol.weight.data_ptr(), dirs.data_ptr(), pose.data_ptr(),
        vertices.data_ptr(), normals.data_ptr(), valid.data_ptr(), h, w, *shape,
        *vol.origin, vol.voxel_size, f32_reciprocal(vol.voxel_size), float(np.float32(depth_min)),
        float(dz), num_steps,
    )
    return vertices, normals, valid
