"""Elastic / SLAC fragment refinement.

Only the configuration records are here so far; the correspondence harvest,
the control lattice and the optimiser are still to port.
"""

from . import slac
from .slac import SlacConfig, SlacMode

__all__ = ["slac", "SlacConfig", "SlacMode"]
