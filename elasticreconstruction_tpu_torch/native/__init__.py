"""Host-side runtime around the math: the depth PNG codec (``depth_png``).

Counterpart of ``elasticreconstruction_tpu/native``, in numpy and ``zlib``.
"""

from . import depth_png
from .depth_png import read_depth, read_depth_batch, write_depth

__all__ = ["depth_png", "read_depth", "read_depth_batch", "write_depth"]
