"""Segment sums in a fixed order: the same bits from run to run on the card.

Counterpart of ``jax.ops.segment_sum``. ``Tensor.index_add_`` adds on the card
in the order its atomic adds land, so two runs on the same inputs can differ
in the last bits of a float sum, and a Gauss-Newton solve or a voxel mean
carries that on. Here the rows are put in order of their segment once (a
stable sort, kept in a :class:`SegmentPlan`), and every sum reduces each
segment's contiguous run with ``torch.segment_reduce``: a fixed reduction tree
on the card, a left-to-right loop on the CPU. On the CPU that loop adds the
rows of a segment in their original order, as ``index_add_`` does, so the
result is the same bits as ``index_add_``'s there.

Values are reduced one component at a time: ``(N, k)`` values become ``k``
runs of 1-D segments laid end to end, the 1-D form ``segment_reduce`` reduces
with one block per segment on the card (its N-D form loops over a segment in
one thread). No function here reads a value back to the host, so a plan
built once can serve every iteration of a solve without synchronising.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SegmentPlan(NamedTuple):
    """Rows in order of their segment: ``order[s]`` is the row at sorted
    position ``s`` (None when the keys were sorted already), segment ``g``
    spans sorted positions ``offsets[g] .. offsets[g + 1] - 1``."""

    order: torch.Tensor | None  # (N,) int64
    offsets: torch.Tensor  # (S + 1,) int64
    num_segments: int


def plan_sorted(sorted_keys: torch.Tensor, num_segments: int) -> SegmentPlan:
    """Plan for keys already in ascending order, every key in ``[0, num_segments)``."""
    bounds = torch.arange(num_segments + 1, dtype=sorted_keys.dtype, device=sorted_keys.device)
    return SegmentPlan(None, torch.searchsorted(sorted_keys, bounds), num_segments)


def plan(keys: torch.Tensor, num_segments: int) -> SegmentPlan:
    """Plan for ``keys (N,)`` in any order, every key in ``[0, num_segments)``:
    one stable sort, so the rows of a segment keep their order."""
    sorted_keys, order = torch.sort(keys.reshape(-1).to(torch.int64), stable=True)
    return plan_sorted(sorted_keys, num_segments)._replace(order=order)


def sum_sorted_columns(cols: torch.Tensor, p: SegmentPlan) -> torch.Tensor:
    """Segment sums of ``cols (k, N)``, whose columns are already in the plan's
    sorted order: ``(S, k)``."""
    k, n = cols.shape
    if n == 0:
        return cols.new_zeros((p.num_segments, k))
    starts = p.offsets[:-1][None, :] + n * torch.arange(k, device=cols.device)[:, None]
    offsets = torch.cat([starts.reshape(-1), p.offsets[-1:] + n * (k - 1)])
    out = torch.segment_reduce(cols.reshape(-1), "sum", offsets=offsets, unsafe=True)
    # Row-major, as index_add_'s result is: a reduction over a transposed
    # view can take another order and round differently.
    return out.reshape(k, p.num_segments).T.contiguous()


def segment_sum(values: torch.Tensor, p: SegmentPlan) -> torch.Tensor:
    """Segment sums of ``values (N, ...)`` in row order: ``(S, ...)``."""
    n, inner = values.shape[0], values.shape[1:]
    x = values if p.order is None else values[p.order]
    cols = x.reshape(n, math.prod(inner)).T.contiguous()
    return sum_sorted_columns(cols, p).reshape((p.num_segments, *inner))


def segment_sum_by_keys(values: torch.Tensor, keys: torch.Tensor, num_segments: int) -> torch.Tensor:
    """One-off :func:`segment_sum` with a plan made for these keys."""
    return segment_sum(values, plan(keys, num_segments))
