"""Fragment building: the configuration record.

Counterpart of ``elasticreconstruction_tpu/odometry/fragments.py``. Only
:class:`FragmentConfig` is here: the pipeline reads ``cloud_capacity`` when it
loads fragment clouds. ``build_fragment`` is still to port.
"""

from __future__ import annotations

from typing import NamedTuple

from .kinfu import OdometryConfig


class FragmentConfig(NamedTuple):
    """Fragment constants: the same fields and defaults as the JAX package's."""

    frames_per_fragment: int = 50
    volume_shape: tuple[int, int, int] = (256, 256, 256)
    voxel_size: float = 0.012
    # Volume placement in the fragment-local (first-camera) frame: centered
    # laterally on the optical axis, starting just in front of the camera.
    volume_min_z: float = 0.3
    cloud_capacity: int = 1 << 17  # 131072 surface samples per fragment
    max_weight: float = 64.0
    depth_min: float = 0.1
    depth_max: float = 6.0
    odometry: OdometryConfig = OdometryConfig()
