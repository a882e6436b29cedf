"""Carry pipeline state between the JAX package and this port as numpy arrays.

The pipeline has no weights; its state is point clouds, prepped fragments and
registration results. These converters take the JAX package's containers (or
any object with the same field names) field by field through ``np.asarray``,
so this module never imports the JAX package, and hand back the port's
containers on a given device. ``RegistrationConfig`` keeps its field names,
so the port's config is ``RegistrationConfig(**jax_cfg._asdict())``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .core.types import PointCloud, resolve_device
from .registration.pair import PreppedFragments


def _tensor(x, dev: torch.device, dtype=None) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=dev)


def pointcloud_from_numpy(cloud, device="cuda") -> PointCloud:
    """A cloud with ``points``/``normals``/``mask`` fields -> the port's ``PointCloud``."""
    dev = resolve_device(device)
    return PointCloud(
        _tensor(cloud.points, dev, torch.float32),
        _tensor(cloud.normals, dev, torch.float32),
        _tensor(cloud.mask, dev, torch.bool),
    )


def prepped_from_numpy(prepped, device="cuda") -> PreppedFragments:
    """Prepped fragments (``coarse``, ``features``, ``fine``) -> the port's ``PreppedFragments``."""
    dev = resolve_device(device)
    return PreppedFragments(
        coarse=pointcloud_from_numpy(prepped.coarse, dev),
        features=_tensor(prepped.features, dev, torch.float32),
        fine=pointcloud_from_numpy(prepped.fine, dev),
    )


def result_to_numpy(result: NamedTuple) -> NamedTuple:
    """One of the port's result NamedTuples (``RegistrationResult``, ``ICPResult``,
    ``RansacResult``) with numpy arrays in place of its tensors."""
    return result._make(x.detach().cpu().numpy() for x in result)
