"""Synthetic RGB-D data: analytic-SDF scenes rendered by sphere tracing.

Counterpart of ``elasticreconstruction_tpu/synthetic``: composable
signed-distance scenes, a batched sphere-tracing depth renderer and smooth
camera trajectories with exact ground truth. ``distortion.py`` and
``warps.py`` are not ported yet.
"""

from . import render, scenes, sdf
from .render import render_depth
from .scenes import livingroom_scene, orbit_trajectory

__all__ = ["render", "scenes", "sdf", "render_depth", "livingroom_scene", "orbit_trajectory"]
