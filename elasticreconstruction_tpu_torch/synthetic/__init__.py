"""Synthetic RGB-D data: analytic-SDF scenes rendered by sphere tracing.

Counterpart of ``elasticreconstruction_tpu/synthetic``: composable
signed-distance scenes, a batched sphere-tracing depth renderer and smooth
camera trajectories with exact ground truth, and the two failure models the
elastic optimiser is tested against: depth distortion (``distortion.py``)
and smooth per-fragment warps (``warps.py``).
"""

from . import distortion, render, scenes, sdf, warps
from .render import render_depth
from .scenes import livingroom_scene, orbit_trajectory

__all__ = ["distortion", "render", "scenes", "sdf", "warps", "render_depth", "livingroom_scene", "orbit_trajectory"]
