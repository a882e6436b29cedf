"""The collectives of the distributed paths, in one place.

In the reference XLA inserts the collectives a sharding implies (``psum``,
``ppermute``, the all-gather of a sharded result). Here every distributed
function calls these four, each on an explicit process group:

- :func:`all_reduce_sum`: the sum over ranks (``jax.lax.psum``);
- :func:`all_gather_rows`: every rank's rows, in rank order (a result whose
  leading axis was sharded, replicated again);
- :func:`broadcast`: rank ``src``'s tensor on every rank;
- :func:`ring_shift`: ``ppermute`` with ``perm = [(k, k - shift)]``, done as
  one ``batch_isend_irecv`` of one send and one receive a tensor, so no rank
  waits for a peer that waits for it.

Under NCCL they pass CUDA tensors straight through. The gloo backend takes no
CUDA tensor for a point-to-point send or receive, so under gloo a CUDA
tensor's :func:`ring_shift` goes through host memory (:data:`GLOO_HOST_STAGED`).
That is decided from the group's backend before the call, never from a
failure. :data:`host_staged` counts the tensors that went that way.
"""

from __future__ import annotations

import collections
from typing import Sequence

import torch
import torch.distributed as dist

from .mesh import group_or_world

# Ops whose CUDA tensors go through host memory under gloo.
GLOO_HOST_STAGED = frozenset({"ring_shift"})

host_staged: collections.Counter = collections.Counter()  # op -> tensors staged through host memory


def _staged(op: str, x: torch.Tensor, group: dist.ProcessGroup) -> bool:
    if x.is_cuda and op in GLOO_HOST_STAGED and dist.get_backend(group) == "gloo":
        host_staged[op] += 1
        return True
    return False


def all_reduce_sum(x: torch.Tensor, group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """The elementwise sum of ``x`` over the ranks of ``group``, on every rank
    (a new tensor; ``x`` is left as it was)."""
    group = group_or_world(group)
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather_rows(x: torch.Tensor, group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on all) concatenated along the
    leading axis in rank order, on every rank."""
    group = group_or_world(group)
    d = dist.get_world_size(group)
    if d == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(d)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def broadcast(x: torch.Tensor, src: int = 0, group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (a new tensor of ``x``'s shape)."""
    group = group_or_world(group)
    out = x.clone()
    dist.broadcast(out, src=dist.get_global_rank(group, src), group=group)
    return out


def ring_shift(xs: torch.Tensor | Sequence[torch.Tensor], group: dist.ProcessGroup | None = None,
               shift: int = 1):
    """Rank ``k`` sends ``xs`` to rank ``k - shift`` and receives rank
    ``k + shift``'s (mod the world size): the reference's
    ``ppermute(perm=[(k, k - 1)])`` at ``shift = 1``. ``xs`` is one tensor or
    a sequence of them (one exchange for all); the shapes must agree across
    ranks. At world size 1 it is ``xs`` itself."""
    group = group_or_world(group)
    single = torch.is_tensor(xs)
    xs = [xs] if single else list(xs)
    d, r = dist.get_world_size(group), dist.get_rank(group)
    if d == 1:
        return xs[0] if single else xs
    dst = dist.get_global_rank(group, (r - shift) % d)
    src = dist.get_global_rank(group, (r + shift) % d)
    staged = [_staged("ring_shift", x, group) for x in xs]
    sends = [x.cpu() if s else x for x, s in zip(xs, staged)]
    recvs = [torch.empty_like(x) for x in sends]
    # One tag a tensor, so that each receive matches its own send.
    ops = [dist.P2POp(dist.isend, x.contiguous(), dst, group, tag) for tag, x in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, y, src, group, tag) for tag, y in enumerate(recvs)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = [y.to(x.device) if s else y for x, y, s in zip(xs, recvs, staged)]
    return out[0] if single else out
