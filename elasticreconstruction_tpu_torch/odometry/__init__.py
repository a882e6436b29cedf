"""Fragment construction: frame-to-model TSDF odometry.

Counterpart of ``elasticreconstruction_tpu/odometry``: raycast model maps,
multi-scale projective ICP and TSDF fusion per frame, all on the device,
with no host round trip inside a fragment in the port's own code.
"""

from . import fragments, kinfu
from .fragments import FragmentConfig, build_fragment
from .kinfu import OdometryConfig, track_frame

__all__ = ["fragments", "kinfu", "FragmentConfig", "build_fragment", "OdometryConfig", "track_frame"]
