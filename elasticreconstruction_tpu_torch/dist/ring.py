"""Ring-streamed all-pairs registration: fragments sharded, blocks passed on.

Counterpart of ``elasticreconstruction_tpu/dist/ring.py``. Each rank owns a
block of ``F / D`` fragments; a travelling copy of every block circulates
around the ring (:func:`comm.ring_shift`), and at ring step ``s`` rank ``d``
registers its resident block against the block that started at rank
``(d + s) mod D``. Peak prep memory a rank is ``2 F / D`` fragments instead
of ``F``.

Pair coverage: the walk runs only steps ``0 .. D // 2``. A block pair at ring
separation ``s`` is reachable from one side at step ``s`` and from the other
at ``D - s``, so each unordered pair is registered once: at ``s = 0`` only
one ordering of an intra-block pair is kept, and for even ``D`` the mutual
step ``s = D / 2`` is kept on the side with the lower base. Where the
travelling block wrapped to lower global ids, a per-lane role swap puts the
smaller id first, so roles, draws and results are those of the replicated
enumeration ``register_prepped_batch(prepped, lo, hi)``.

RANSAC draws are fixed per pair by :func:`pair_key` ``(base, lo, hi)``, or
come from a caller's ``draws_for(lo, hi)``, so the ring and the replicated
enumeration use the same draws for each pair. A travelling block's base is
``((rank + s) mod D) * F / D`` at step ``s``, which every rank knows, so only
the block itself travels; the exchange after the last step is skipped, since
its result would never be read (at world size 1 there is none at all).
A step's ``fl * fl`` lanes are registered in batches of at most
``LANE_BATCH``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..core.types import PointCloud, RegistrationResult, resolve_device
from ..registration import ransac as _ransac
from ..registration.pair import PreppedFragments, RegistrationConfig, _register_core
from . import comm
from .mesh import group_or_world, shard_bounds

# Lanes registered in one batch. At world size 1 a step holds every pair of
# the whole stack, and the RANSAC and ICP temporaries of all its lanes at once
# would not fit on one card; 64 lanes peaked at 13.5 GiB on an H100 80GB HBM3
# (PERF.md, dist paths). A step of 64 lanes or fewer is one batch.
LANE_BATCH = 64


def pair_key(base: int, i: int, j: int, num_hypotheses: int, sample_size: int = 3) -> torch.Tensor:
    """The RANSAC draws ``(H, sample_size)`` (int64, on the CPU) of pair
    ``(i, j)`` under seed ``base``: a generator seeded by ``(base, i, j)``
    alone, so any enumeration of the pairs draws the same for each pair.
    Order-sensitive: use ``(i, j)`` with ``i < j``."""
    # The CPU generator keeps 32 bits of its seed: mix the three into them.
    seed = np.random.SeedSequence([int(base), int(i), int(j)]).generate_state(1)[0]
    gen = torch.Generator().manual_seed(int(seed))
    return _ransac.draw_hypotheses(1, num_hypotheses, gen, "cpu", sample_size)[0]


def lanes_wanted(world: int, f: int) -> np.ndarray:
    """Which lanes of :func:`register_all_pairs_ring`'s output at ``world`` ranks
    over ``f`` fragments are unmasked, in its order (rank, step, resident x
    travelling): non-adjacent pairs; at step 0 the travelling block IS the
    resident one, so each intra-block pair sits in two lanes and only the
    unswapped one is kept; an even world's mutual step is kept on the side
    with the lower base."""
    fl, steps = f // world, world // 2 + 1
    lane = np.arange(world * steps * fl * fl)
    r, s, k = lane // (steps * fl * fl), (lane // (fl * fl)) % steps, lane % (fl * fl)
    ii, base = r * fl + k // fl, ((r + s) % world) * fl
    jj = base + k % fl
    lo, hi = np.minimum(ii, jj), np.maximum(ii, jj)
    want = (hi > lo + 1) & ((s != 0) | (jj > ii))
    if world % 2 == 0:
        want &= (s != world // 2) | (r * fl < base)
    return want


def _blocks(prepped: PreppedFragments) -> list[torch.Tensor]:
    return [*prepped.coarse, prepped.features, *prepped.fine]


def _unblocks(ts: list[torch.Tensor]) -> PreppedFragments:
    return PreppedFragments(PointCloud(*ts[:3]), ts[3], PointCloud(*ts[4:]))


def register_all_pairs_ring(
    prepped: PreppedFragments,
    base_key: int,
    config: RegistrationConfig = RegistrationConfig(),
    *,
    draws_for: Callable[[int, int], torch.Tensor] | None = None,
    fused_step: bool = False,
    group: dist.ProcessGroup | None = None,
    device="cuda",
) -> RegistrationResult:
    """All non-adjacent fragment pairs ``(i, j)``, ``j > i + 1``, via the ring.

    ``prepped`` is the full ``(F, ...)`` prep stack (each rank keeps only its
    block, on ``device``; F must divide by the world size: pad the stack with
    repeats and ignore their pairs). Returns the flat
    ``(D * n_steps * fl * fl)`` lane batch, in rank then step order, on every
    rank; masked lanes report ``success = False``, every wanted pair appears
    in exactly one unmasked lane (:func:`lanes_wanted`).
    """
    dev = resolve_device(device)
    group = group_or_world(group)
    d, rank = dist.get_world_size(group), dist.get_rank(group)
    f = prepped.features.shape[0]
    lo_f, hi_f = shard_bounds(f, group, "fragment count")
    fl = hi_f - lo_f
    if draws_for is None:
        def draws_for(i, j):
            return pair_key(base_key, i, j, config.num_hypotheses)

    own = prepped.take(slice(lo_f, hi_f))
    resident = PreppedFragments(own.coarse.to(dev), own.features.to(dev), own.fine.to(dev))
    travel = _blocks(resident)
    n_steps = d // 2 + 1
    wanted = torch.from_numpy(lanes_wanted(d, f).reshape(d, n_steps, fl * fl)[rank])
    # Lane k = (resident a, travelling b) with a = k // fl, b = k % fl.
    ia = torch.arange(fl).repeat_interleave(fl)
    ib = torch.arange(fl).repeat(fl)
    rep_r = [t[ia.to(dev)] for t in _blocks(resident)]
    results = []
    for s in range(n_steps):
        trav_base = ((rank + s) % d) * fl
        ii, jj = lo_f + ia, trav_base + ib
        swap = jj < ii  # the travelling block wrapped below the resident one
        lo, hi = torch.where(swap, jj, ii), torch.where(swap, ii, jj)
        rep_t = [t[ib.to(dev)] for t in travel]
        sw = swap.to(dev)

        def pick(first: bool) -> PreppedFragments:
            def sel(xr, xt):
                m = sw.reshape((-1,) + (1,) * (xr.ndim - 1))
                return torch.where(m, xt, xr) if first else torch.where(m, xr, xt)
            return _unblocks([sel(xr, xt) for xr, xt in zip(rep_r, rep_t)])

        rep_i, rep_j = pick(True), pick(False)  # rep_i: the fragment with the smaller id
        draws = torch.stack([draws_for(int(a), int(b)) for a, b in zip(lo, hi)])
        parts = []
        for a in range(0, fl * fl, LANE_BATCH):
            k = slice(a, a + LANE_BATCH)
            pi, pj = rep_i.take(k), rep_j.take(k)
            parts.append(_register_core(
                pi.coarse, pi.features, pj.coarse, pj.features, pi.fine, pj.fine,
                config, (lo[k].to(dev, torch.int32), hi[k].to(dev, torch.int32)), None, draws[k], fused_step,
            ))
        res = RegistrationResult(*(torch.cat(xs) for xs in zip(*parts)))
        results.append(res._replace(success=res.success & wanted[s].to(dev)))
        if s + 1 < n_steps:
            travel = comm.ring_shift(travel, group)
    mine = RegistrationResult(*(torch.cat(xs) for xs in zip(*results)))
    return RegistrationResult(*(comm.all_gather_rows(x, group) for x in mine))
