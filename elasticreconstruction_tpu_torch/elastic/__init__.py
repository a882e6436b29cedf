"""Elastic / SLAC fragment refinement.

Counterpart of ``elasticreconstruction_tpu/elastic``: the correspondence
harvest (the reference's BuildCorrespondence) and the FragmentOptimizer, a
joint Gauss-Newton over fragment poses and control lattices in rigid, SLAC
and nonrigid modes, solved matrix-free by Jacobi-preconditioned CG. One
lattice per fragment unifies the modes: SLAC shares lattice 0 across
fragments, nonrigid gives each fragment its own, rigid moves none.
"""

from . import arap, correspondence, lattice, slac
from .correspondence import CorresSet, build_correspondences
from .lattice import Lattice
from .slac import SlacConfig, SlacMode, optimize_fragments

__all__ = [
    "arap",
    "correspondence",
    "lattice",
    "slac",
    "CorresSet",
    "build_correspondences",
    "Lattice",
    "SlacConfig",
    "SlacMode",
    "optimize_fragments",
]
