"""One typed configuration for the whole pipeline.

Counterpart of ``elasticreconstruction_tpu/pipeline/config.py``: every field
and default of its ``PipelineConfig``. The reference scatters these constants
across five executables' program options; here every stage constant lives in
one place, with the reference defaults (50 frames per fragment, 5 cm matching
voxel, lattice resolution 8 / length 3.0) as the stage-config defaults.
Fields of stages that are not ported yet are carried so that a configuration
written for one package reads the same in the other.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from ..elastic.slac import SlacConfig, SlacMode
from ..odometry.fragments import FragmentConfig
from ..posegraph.robust_pgo import PGOConfig
from ..registration.pair import RegistrationConfig


@dataclass(frozen=True)
class PipelineConfig:
    data_dir: str = "data"
    out_dir: str = "out"
    frames_per_fragment: int = 50
    fragment: FragmentConfig = field(default_factory=FragmentConfig)
    registration: RegistrationConfig = field(default_factory=RegistrationConfig)
    posegraph: PGOConfig = field(default_factory=PGOConfig)
    slac: SlacConfig = field(default_factory=SlacConfig)
    slac_mode: str = "slac"  # rigid | slac | nonrigid | none
    corres_max_distance: float = 0.03
    corres_capacity_per_edge: int = 4096
    # Correspondence/optimize alternation rounds: re-harvest correspondences
    # at the refined poses and re-optimize. 1 = the plain staged behaviour.
    corres_rounds: int = 1
    # Viewpoint-baseline correspondence weighting: row weight
    # 1 + corres_baseline_weight * (1 - cos(angle between the two fragments'
    # optical axes)). 0 = reference parity (uniform rows).
    corres_baseline_weight: float = 0.0
    # Per-round tightening of corres_max_distance during alternation: round k
    # matches at max_distance * decay^k.
    corres_distance_decay: float = 1.0
    # Regularizer annealing across alternation rounds: round r (0-based, R
    # total) scales arap_weight by arap_anneal^(R-1-r). 1.0 = off.
    arap_anneal: float = 1.0
    # Keep the pairwise-refined ICP transforms as the matching alignment on
    # re-association rounds >= 2 (instead of the refined global poses + warp).
    corres_reassoc_pair_transforms: bool = False
    # Loop-candidate gating: all-pairs proposals whose fragment centroids sit
    # farther apart than this under the odometry-chain init are skipped.
    # inf = the reference's ungated all-pairs enumeration. A finite radius
    # still applies as a manual override of ``loop_gating``.
    loop_candidate_radius: float = float("inf")
    # Loop-candidate proposal policy:
    #   "none"  — ungated all-pairs enumeration (safe only with a trusted
    #             odometry backbone).
    #   "drift" — derived gate + content retrieval (default). A pair whose
    #             chain path contains no suspect edge is admitted iff the
    #             fragments' posed bounding boxes intersect within the path's
    #             accumulated drift budget + gate_margin. Pairs whose path
    #             crosses a suspect edge have meaningless init placement; they
    #             are admitted by content instead: mutual top-k FPFH-signature
    #             retrieval (registration.retrieval).
    loop_gating: str = "drift"
    # Per-edge drift budgets for the derived gate: healthy tracking drifts a
    # few cm per fragment; a suspect edge can be wrong by the whole blind
    # stretch's motion.
    drift_per_fragment: float = 0.05
    drift_suspect: float = 0.75
    # Base slack added to the drift budget when testing posed-AABB overlap.
    gate_margin: float = 0.3
    # Mutual top-k signature retrieval for suspect-path pairs.
    retrieval_topk: int = 5
    # Near-diagonal pairs (j - i <= this) are always admitted under drift
    # gating: temporally local overlap is near-certain.
    gate_near_diagonal: int = 3
    # Integration. Scenes needing more than scene_max_shape voxels are tiled
    # into overlapping blocks of that shape, never clamped.
    scene_voxel_size: float = 0.015
    scene_max_shape: tuple[int, int, int] = (448, 256, 448)
    scene_block_overlap: int = 4
    # Scatter-formulation scene fusion: projective work scales with pixels x
    # band samples instead of voxels.
    scene_use_scatter: bool = True
    mesh_capacity_per_slab: int = 1 << 15
    # Registration batching
    registration_batch: int = 8
    seed: int = 0

    # Derived paths
    def p_fragments(self) -> Path:
        return Path(self.out_dir) / "fragments"

    def p_registration(self) -> Path:
        return Path(self.out_dir) / "registration"

    def p_posegraph(self) -> Path:
        return Path(self.out_dir) / "posegraph"

    def p_slac(self) -> Path:
        return Path(self.out_dir) / "slac"

    def p_integrate(self) -> Path:
        return Path(self.out_dir) / "integrate"

    def slac_config(self) -> SlacConfig:
        mode = {
            "rigid": SlacMode.RIGID,
            "slac": SlacMode.SLAC,
            "nonrigid": SlacMode.NONRIGID,
        }[self.slac_mode]
        return self.slac._replace(mode=mode)
