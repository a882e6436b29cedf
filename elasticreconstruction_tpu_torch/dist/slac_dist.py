"""Distributed FragmentOptimizer: correspondence-sharded PCG.

Counterpart of ``elasticreconstruction_tpu/dist/slac_dist.py``. The normal
equations' products (``elastic/slac.py``) are sums over correspondences: each
rank keeps its contiguous block of the rows, builds the operators of its
block with ``_make_operators``, and every ``J^T`` product and the Jacobi
diagonal are summed over the ranks by one :func:`comm.all_reduce_sum` each,
inside the unchanged ``_pcg``. The CG state stays replicated.

As in the reference:

- the ARAP and prior rows carry per-rank weights scaled by the rank's own
  valid-row count (``elastic/slac.py``, ``cvalid``), so their sum over the
  ranks is the global weight; only the anchor rows, the same on every rank,
  are scaled by ``1 / world_size``;
- the Jacobi preconditioner's replicated entries (anchor, ARAP degree,
  prior, damping) are over-counted by the world size, deliberately: a
  rescaled SPD preconditioner changes CG's path, never its solution, and
  skipping the correction keeps one reduction a product;
- the data RMSE is the rank's sums of ``r^2`` and of the row weights, then
  one reduction.

No value is read back to the host inside an outer step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import se3
from ..elastic.correspondence import CorresSet
from ..elastic.lattice import Lattice
from ..elastic.slac import (
    SlacConfig,
    SlacMode,
    SlacResult,
    SlacState,
    _data_geometry,
    _make_operators,
    _num_lattices,
    _pcg,
    _precompute,
)
from . import comm
from .mesh import group_or_world, pad_to_multiple, shard_rows


def pad_corres(corres: CorresSet, multiple: int) -> CorresSet:
    """``corres`` padded with masked zero rows up to a multiple of ``multiple``."""
    return CorresSet(*(None if x is None else pad_to_multiple(x, multiple, False if x.dtype == torch.bool else 0)
                       for x in corres))


def _global_rmse(state: SlacState, corres: CorresSet, prob, group) -> torch.Tensor:
    """The data RMSE over every rank's rows: local sums, one reduction."""
    r = _data_geometry(state, corres, prob)[0]
    mf = corres.mask.to(torch.float32)
    sums = comm.all_reduce_sum(torch.stack([(mf * (r * r).sum(-1)).sum(), mf.sum()]), group)
    return torch.sqrt(sums[0] / sums[1].clamp_min(1.0))


def optimize_fragments_sharded(
    init_poses: torch.Tensor,
    corres: CorresSet,
    cfg: SlacConfig = SlacConfig(),
    *,
    num_fragments: int | None = None,
    group: dist.ProcessGroup | None = None,
) -> SlacResult:
    """``elastic.optimize_fragments`` with the correspondence rows split over
    the ranks of ``group``: each outer Gauss-Newton step runs the PCG with
    summed products. ``corres`` is the whole set (every rank keeps its own
    block), on the device of ``init_poses``."""
    group = group_or_world(group)
    d = dist.get_world_size(group)
    dev = init_poses.device
    nf = num_fragments if num_fragments is not None else init_poses.shape[0]
    corres = pad_corres(corres, d)
    mine = CorresSet(*(None if x is None else shard_rows(x, group, "correspondence count") for x in corres))
    lat = Lattice(cfg.resolution, cfg.length, cfg.origin)
    L, M = _num_lattices(cfg.mode, nf), lat.num_vertices
    update_lattice = cfg.mode is not SlacMode.RIGID
    inv_d = 1.0 / d
    prob = _precompute(lat, mine, cfg.mode, nf)

    state = SlacState(init_poses.to(torch.float32), torch.zeros((L, M, 3), dtype=torch.float32, device=dev))
    rmse_hist = []
    for _ in range(cfg.outer_iterations):
        rmse_hist.append(_global_rmse(state, mine, prob, group))
        J, Jt_local, diag_local, residuals, _ = _make_operators(
            state, mine, prob, lat, cfg, nf, L, M, update_lattice
        )

        def Jt(u, u_arap, u_prior, u_anchor, Jt_local=Jt_local):
            g_xi, g_d = Jt_local(u, u_arap, u_prior, u_anchor * inv_d)
            return comm.all_reduce_sum(g_xi, group), comm.all_reduce_sum(g_d, group)

        def diag(diag_local=diag_local):
            d_xi, d_d = diag_local()
            return comm.all_reduce_sum(d_xi, group), comm.all_reduce_sum(d_d, group)

        dz_xi, dz_d = _pcg(J, Jt, diag, residuals, cfg)
        state = SlacState(se3.exp(dz_xi) @ state.poses,
                          state.displacement + dz_d if update_lattice else state.displacement)
    return SlacResult(
        poses=se3.orthonormalize(state.poses),
        displacement=state.displacement,
        lattice=lat,
        data_rmse=torch.stack(rmse_hist) if rmse_hist else torch.zeros((0,), device=dev),
        final_rmse=_global_rmse(state, mine, prob, group),
    )
