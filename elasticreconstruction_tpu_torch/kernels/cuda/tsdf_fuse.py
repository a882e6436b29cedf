"""TSDF fuse on the card: CUDA kernel ``csrc/tsdf_fuse.cu``.

The plain version is ``kernels/tsdf.py::fuse_plain``, which
``kernels/tsdf.py::fuse`` runs for CPU tensors; for CUDA tensors it calls
:func:`fuse_cuda`. The kernel replaces no TPU kernel (the reference's fuse is
plain jnp): one thread a voxel updates tsdf and weight in place, in one
launch a frame, in place of the plain version's 83 full-volume elementwise
launches. Both route their arithmetic the same way, so on the card the two
agree bit for bit (``csrc/tsdf_fuse.cu``). The pose is read on the device;
nothing is read back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core import camera as cam
from ...core.types import f32_reciprocal
from . import build

_KERNEL = build.Kernel("tsdf_fuse", "tsdf_fuse",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_double] * 8 + [ctypes.c_float] * 5)


def fuse_cuda(vol, depth: torch.Tensor, pose: torch.Tensor, intr: cam.Intrinsics, *, max_weight: float,
              depth_min: float, depth_max: float, x_offset: int):
    """:func:`..tsdf.fuse` for a volume on the card: updates ``vol.tsdf`` and
    ``vol.weight`` in place and returns ``vol``, the same tensors."""
    depth, pose = depth.contiguous(), pose.contiguous()
    shape = vol.shape
    hw = (intr.height, intr.width)
    build.check_args("tsdf_fuse", {"tsdf": vol.tsdf, "weight": vol.weight, "depth": depth, "pose": pose},
                     {"tsdf": torch.float32, "weight": torch.float32, "depth": torch.float32,
                      "pose": torch.float32},
                     {"tsdf": shape, "weight": shape, "depth": hw, "pose": (4, 4)})
    # Origin, voxel size and intrinsics enter the plain version's float64
    # multiply-adds as they are; the rest is compared or multiplied in float32.
    f64 = [float(x) for x in (*vol.origin, vol.voxel_size, intr.fx, intr.fy, intr.cx, intr.cy)]
    f32 = [float(np.float32(x)) for x in (vol.truncation, f32_reciprocal(vol.truncation), depth_min, depth_max,
                                          max_weight)]
    _KERNEL(vol.tsdf.device, vol.tsdf.data_ptr(), vol.weight.data_ptr(), depth.data_ptr(), pose.data_ptr(),
            *shape, x_offset, *hw, *f64, *f32)
    return vol
