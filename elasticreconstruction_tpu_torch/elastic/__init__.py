"""Elastic / SLAC fragment refinement.

The correspondence harvest (the reference's BuildCorrespondence) and the
optimiser's configuration records are here; the control lattice and the
optimiser itself are still to port.
"""

from . import correspondence, slac
from .correspondence import CorresSet, build_correspondences
from .slac import SlacConfig, SlacMode

__all__ = ["correspondence", "slac", "CorresSet", "build_correspondences", "SlacConfig", "SlacMode"]
