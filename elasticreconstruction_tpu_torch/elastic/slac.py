"""Joint pose + control-lattice optimisation: the configuration records.

Counterpart of ``elasticreconstruction_tpu/elastic/slac.py``. Only
:class:`SlacMode` and :class:`SlacConfig` are here, for the pipeline
configuration; ``optimize_fragments`` is still to port.
"""

from __future__ import annotations

import enum
from typing import NamedTuple


class SlacMode(enum.Enum):
    RIGID = "rigid"
    SLAC = "slac"
    NONRIGID = "nonrigid"


class SlacConfig(NamedTuple):
    """Optimiser constants: the same fields and defaults as the JAX package's."""

    mode: SlacMode = SlacMode.SLAC
    resolution: int = 8  # lattice cells per axis (reference --resolution)
    length: float = 3.0  # lattice cube edge (reference --length)
    origin: tuple[float, float, float] = (-1.5, -1.5, 0.0)
    outer_iterations: int = 5  # GN steps (reference --iteration)
    cg_iterations: int = 48
    # Regularizer balance, dimensionless: the ARAP term's total mass is
    # arap_weight x the data term's mass.
    arap_weight: float = 3.0
    # Zero-displacement prior (same scaling): pins the gauge null space of a
    # constant lattice shift.
    disp_prior_weight: float = 0.3
    anchor_weight: float = 1e6  # gauge prior on fragment 0 pose
    damping: float = 1e-6
    # Point-to-plane data rows (used when the correspondences carry normals).
    point_to_plane: bool = True
    # Point-to-point admixture under point_to_plane: each data row carries the
    # weight matrix lambda^2 I + (1 - lambda^2) n n^T.
    p2p_mix: float = 0.15
