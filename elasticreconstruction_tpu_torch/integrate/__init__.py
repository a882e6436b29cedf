"""Final volumetric integration and mesh extraction (the reference's Integrate).

The raw depth sequence is fused with the optimized poses into one scene-scale
TSDF (``scene``), tiled into blocks where it outgrows one volume (``blocks``),
and meshed by marching tetrahedra (``mesh``), the JAX package's redesign of
the reference's marching cubes.
"""

from . import blocks, mesh, scene
from .mesh import extract_mesh
from .scene import SceneConfig, integrate_frames, make_scene_volume

__all__ = [
    "blocks",
    "mesh",
    "scene",
    "extract_mesh",
    "SceneConfig",
    "integrate_frames",
    "make_scene_volume",
]
