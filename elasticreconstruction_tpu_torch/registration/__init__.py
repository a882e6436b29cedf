"""Pair registration: FPFH matching -> RANSAC -> point-to-plane ICP -> information matrix."""

from .pair import (
    PreppedFragments,
    RegistrationConfig,
    edge_information_batch,
    prep_fragments_batch,
    refine_edges_batch,
    register_pair,
    register_pairs_batch,
    register_prepped_batch,
)

__all__ = [
    "PreppedFragments",
    "RegistrationConfig",
    "edge_information_batch",
    "prep_fragments_batch",
    "refine_edges_batch",
    "register_pair",
    "register_pairs_batch",
    "register_prepped_batch",
]
