"""Fragment construction: frame-to-model TSDF odometry.

Only the configuration records are here so far; the tracking and
fragment-building functions are still to port (they need ``kernels/tsdf.py``
and ``kernels/raycast.py``).
"""

from . import fragments, kinfu
from .fragments import FragmentConfig
from .kinfu import OdometryConfig

__all__ = ["fragments", "kinfu", "FragmentConfig", "OdometryConfig"]
