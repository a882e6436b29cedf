"""Distributed robust PGO: edge-sharded normal equations, summed, solved on every rank.

Counterpart of ``elasticreconstruction_tpu/dist/pgo_dist.py``. The blocks of
H and b are sums over edges; each rank forms its contiguous block of the edges'
share (``posegraph/robust_pgo.py::_partial_blocks``), one
:func:`comm.all_reduce_sum` of H's blocks and one of b a Gauss-Newton step
make the full system on every rank, and every rank runs the same small dense
solve (``_damped_solve``), so the poses stay replicated without a gather. The
line-process updates run over all edges on every rank, as in the reference.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..posegraph.robust_pgo import (
    EdgeList,
    PGOConfig,
    PGOResult,
    _damped_solve,
    _partial_blocks,
    alternate,
)
from . import comm
from .mesh import group_or_world, pad_to_multiple, shard_rows


def pad_edges(edges: EdgeList, multiple: int) -> EdgeList:
    """``edges`` padded with masked rows (identity transform, zero
    information) up to a multiple of ``multiple``."""
    eye = torch.eye(4, dtype=edges.transform.dtype, device=edges.transform.device)
    T = edges.transform
    pad = (-T.shape[0]) % multiple
    T = torch.cat([T, eye.expand(pad, 4, 4)]) if pad else T
    return EdgeList(
        i=pad_to_multiple(edges.i, multiple),
        j=pad_to_multiple(edges.j, multiple),
        transform=T,
        information=pad_to_multiple(edges.information, multiple),
        is_odometry=pad_to_multiple(edges.is_odometry, multiple, False),
        mask=pad_to_multiple(edges.mask, multiple, False),
    )


def optimize_pose_graph_sharded(
    poses: torch.Tensor,
    edges: EdgeList,
    cfg: PGOConfig = PGOConfig(),
    *,
    group: dist.ProcessGroup | None = None,
) -> PGOResult:
    """``posegraph.optimize_pose_graph`` with the edge work split over the
    ranks of ``group`` and two all-reduces a GN step. Runs on the device of
    ``poses`` (the same on every rank); the result covers the unpadded edges."""
    group = group_or_world(group)
    e = edges.i.shape[0]
    edges = pad_edges(edges.to(poses.device), dist.get_world_size(group))
    mine = EdgeList(*(shard_rows(x, group, "edge count") for x in edges))

    def gn_step(p, weights):
        Hb, bv = _partial_blocks(p, mine, shard_rows(weights, group, "edge count"))
        return _damped_solve(p, comm.all_reduce_sum(Hb, group), comm.all_reduce_sum(bv, group), cfg)

    res = alternate(poses, edges, cfg, gn_step)
    return res._replace(line_process=res.line_process[:e], kept=res.kept[:e], residual_sq=res.residual_sq[:e])
