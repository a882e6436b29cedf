"""Data-parallel pair registration over the ranks of a process group.

Counterpart of ``elasticreconstruction_tpu/dist/pair_sharding.py`` (the
reference's independent GlobalRegistration jobs): each rank registers its
contiguous block of the pair batch, with no collective until the results
are gathered, so every rank ends with the whole batch's
:class:`RegistrationResult`. The batch must divide by the world size (pad it
with a repeated pair and ignore the tail).

RANSAC hypotheses are the single-device call's: ``draws`` ``(B, H, 3)`` for
the whole batch, of which each rank takes its rows, or a ``generator`` from
which every rank draws the whole batch's ``(B, H, 3)`` as the single-device
call would, and keeps its rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.types import PointCloud, RegistrationResult, resolve_device
from ..registration import ransac as _ransac
from ..registration.pair import (
    PreppedFragments,
    RegistrationConfig,
    register_pairs_batch,
    register_prepped_batch,
)
from . import comm
from .mesh import shard_bounds


def _my_draws(b: int, rows: slice, generator, draws, config: RegistrationConfig) -> torch.Tensor:
    if draws is None:
        draws = _ransac.draw_hypotheses(b, config.num_hypotheses, generator, "cpu")
    elif draws.shape[0] != b:
        raise ValueError(f"draws hold {draws.shape[0]} pairs, the batch {b}")
    return draws[rows]


def gather_result(res: RegistrationResult, group: dist.ProcessGroup | None = None) -> RegistrationResult:
    """Every rank's rows of a sharded result, concatenated in rank order on every rank."""
    return RegistrationResult(*(comm.all_gather_rows(x, group) for x in res))


def register_pairs_sharded(
    clouds_i: PointCloud,
    clouds_j: PointCloud,
    generator: torch.Generator | None = None,
    config: RegistrationConfig = RegistrationConfig(),
    pair_indices=None,
    *,
    draws: torch.Tensor | None = None,
    fused_step: bool = False,
    group: dist.ProcessGroup | None = None,
    device="cuda",
) -> RegistrationResult:
    """:func:`register_pairs_batch` with the ``(B, N, 3)`` batch split over
    the ranks of ``group``; each rank preps and registers its own rows."""
    dev = resolve_device(device)
    b = clouds_i.points.shape[0]
    a, e = shard_bounds(b, group)
    rows = slice(a, e)
    if pair_indices is None:
        pair_indices = (torch.zeros(b, dtype=torch.int32), torch.ones(b, dtype=torch.int32))
    mine = register_pairs_batch(
        PointCloud(*(x[rows] for x in clouds_i)), PointCloud(*(x[rows] for x in clouds_j)),
        None, config, tuple(torch.as_tensor(x)[rows] for x in pair_indices),
        draws=_my_draws(b, rows, generator, draws, config), fused_step=fused_step, device=dev,
    )
    return gather_result(mine, group)


def register_prepped_sharded(
    prepped: PreppedFragments,
    idx_i,
    idx_j,
    generator: torch.Generator | None = None,
    config: RegistrationConfig = RegistrationConfig(),
    *,
    draws: torch.Tensor | None = None,
    fused_step: bool = False,
    group: dist.ProcessGroup | None = None,
    device="cuda",
) -> RegistrationResult:
    """The production all-pairs path over the ranks: the prepped stack is
    replicated on every rank (a fragment's prep is ~1 MB), the pair indices
    are split, and each rank gathers only its own pairs' rows."""
    dev = resolve_device(device)
    ii = torch.as_tensor(idx_i).reshape(-1)
    jj = torch.as_tensor(idx_j).reshape(-1)
    b = ii.shape[0]
    a, e = shard_bounds(b, group)
    rows = slice(a, e)
    mine = register_prepped_batch(
        prepped, ii[rows], jj[rows], None, config,
        draws=_my_draws(b, rows, generator, draws, config), fused_step=fused_step, device=dev,
    )
    return gather_result(mine, group)
