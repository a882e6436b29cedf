"""Carry pipeline state between the JAX package and this port as numpy arrays.

The pipeline has no weights; its state is point clouds, prepped fragments and
registration results, the TSDF volumes of fragment odometry and the scene, and
harvested correspondences. These converters take the JAX package's containers (or
any object with the same field names) field by field through ``np.asarray``,
so this module never imports the JAX package, and hand back the port's
containers on a given device. ``RegistrationConfig`` and ``PGOConfig`` keep
their field names, so the port's record is ``RegistrationConfig(**jax_cfg._asdict())``;
:func:`pipeline_config_from` does the same for a whole ``PipelineConfig``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .core.camera import Intrinsics
from .core.types import PointCloud, resolve_device
from .elastic.correspondence import CorresSet
from .elastic.slac import SlacConfig, SlacMode
from .integrate.scene import SceneConfig
from .kernels.tsdf import TSDFVolume
from .odometry.fragments import FragmentConfig
from .odometry.kinfu import OdometryConfig
from .pipeline.config import PipelineConfig
from .posegraph.robust_pgo import EdgeList, PGOConfig
from .registration.pair import PreppedFragments, RegistrationConfig


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


def edges_from_numpy(edges, device="cuda") -> EdgeList:
    """A pose-graph edge list (``i``, ``j``, ``transform``, ``information``,
    ``is_odometry``, ``mask``) -> the port's ``EdgeList``."""
    return EdgeList.build(
        *(np.array(x) for x in (edges.i, edges.j, edges.transform, edges.information,
                                edges.is_odometry, edges.mask)),
        device=device,
    )


def pipeline_config_from(cfg) -> PipelineConfig:
    """A ``PipelineConfig`` with the same fields (a dataclass whose stage
    records are NamedTuples) -> the port's ``PipelineConfig``."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    frag = cfg.fragment._asdict()
    frag["odometry"] = OdometryConfig(**cfg.fragment.odometry._asdict())
    slac = cfg.slac._asdict()
    slac["mode"] = SlacMode(cfg.slac.mode.value)
    fields.update(
        fragment=FragmentConfig(**frag),
        registration=RegistrationConfig(**cfg.registration._asdict()),
        posegraph=PGOConfig(**cfg.posegraph._asdict()),
        slac=SlacConfig(**slac),
    )
    return PipelineConfig(**fields)


def intrinsics_from(intr) -> Intrinsics:
    """Camera intrinsics with the reference's field names -> the port's ``Intrinsics``."""
    return Intrinsics(**intr._asdict())


def volume_from_numpy(tsdf, weight, origin, voxel_size, truncation, device="cuda") -> TSDFVolume:
    """A TSDF volume's arrays and scalars -> the port's ``TSDFVolume`` on ``device``.

    The scalars are kept as float32 values, as the reference stores them.
    """
    dev = resolve_device(device)
    return TSDFVolume(
        tsdf=_tensor(tsdf, dev, torch.float32),
        weight=_tensor(weight, dev, torch.float32),
        origin=tuple(float(np.float32(o)) for o in np.asarray(origin).reshape(3)),
        voxel_size=float(np.float32(voxel_size)),
        truncation=float(np.float32(truncation)),
    )


def volume_from(vol, device="cuda") -> TSDFVolume:
    """A volume with the reference's field names (``tsdf``, ``weight``,
    ``origin``, ``voxel_size``, ``truncation``) -> the port's ``TSDFVolume``."""
    return volume_from_numpy(vol.tsdf, vol.weight, vol.origin, vol.voxel_size, vol.truncation, device)


def scene_config_from(cfg) -> SceneConfig:
    """A ``SceneConfig`` with the same fields -> the port's ``SceneConfig``."""
    return SceneConfig(**cfg._asdict())


def corres_to_numpy(corres) -> CorresSet:
    """A correspondence set (the JAX package's ``CorresSet`` or the port's) as
    a ``CorresSet`` of numpy arrays; absent optional fields stay ``None``."""
    return CorresSet(*(None if x is None else (x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x))
                       for x in corres))
