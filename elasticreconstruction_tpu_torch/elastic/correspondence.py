"""Dense per-edge correspondence harvest (the reference's BuildCorrespondence).

Counterpart of ``elasticreconstruction_tpu/elastic/correspondence.py``: for
each kept pose-graph edge, the two fragment clouds are posed, each point of
fragment j is matched to its nearest point of fragment i and back, and the
mutual matches closer than ``max_distance`` are kept, in fragment j's row
order, up to a fixed capacity per edge. The edges concatenate into one flat
:class:`CorresSet`.

Both nearest-neighbour queries go through ``kernels/cuda/nn.py::nearest``:
CUDA tensors launch the hand-written ``nearest_batch`` kernel, CPU tensors run
its plain version. Matching at the current lattice warp (the elastic modes'
re-association) needs ``elastic/lattice.py``, which is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import se3
from ..core.types import PointCloud, f32_square
from ..kernels.cuda import nn as _nn

_NO_LATTICE = (
    "matching at a lattice warp needs elastic/lattice.py, which is not ported yet "
    "(ROADMAP.md, Queue 1 item 9)"
)


class CorresSet(NamedTuple):
    """Flat correspondence soup across all edges.

    Points are stored in their fragments' LOCAL frames. ``n``: unit normal at
    ``p`` in fragment-i local frame; ``w``: per-row weight.
    """

    frag_i: torch.Tensor  # (C,) int32
    frag_j: torch.Tensor  # (C,) int32
    p: torch.Tensor  # (C, 3) point in fragment i local frame
    q: torch.Tensor  # (C, 3) point in fragment j local frame
    mask: torch.Tensor  # (C,) bool
    n: torch.Tensor | None = None  # (C, 3) normal at p, fragment-i local frame
    w: torch.Tensor | None = None  # (C,) row weights

    def count(self) -> torch.Tensor:
        return self.mask.to(torch.int32).sum()


def correspondences_for_edge(
    cloud_i: PointCloud,
    cloud_j: PointCloud,
    T_i: torch.Tensor,
    T_j: torch.Tensor,
    *,
    disp_i=None,
    disp_j=None,
    lattice=None,
    max_distance: float = 0.03,
    capacity: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mutually-nearest close pairs between two posed fragments.

    Returns (p ``(capacity, 3)`` local-i, q ``(capacity, 3)`` local-j,
    n ``(capacity, 3)`` normal at p in i-local, mask ``(capacity,)``), rows in
    fragment j's order, zero past the matches.
    """
    if disp_i is not None or disp_j is not None or lattice is not None:
        raise NotImplementedError(_NO_LATTICE)
    pi_w = se3.apply(T_i, cloud_i.points)
    pj_w = se3.apply(T_j, cloud_j.points)
    d2, idx = _nn.nearest(pj_w, pi_w, cloud_i.mask)
    close = cloud_j.mask & torch.isfinite(d2) & (d2 < f32_square(max_distance))
    # Mutual check: j's match in i must match back to j.
    _, idx_back = _nn.nearest(pi_w, pj_w, cloud_j.mask)
    mutual = idx_back[idx.long()] == torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    ok = close & mutual
    order = torch.argsort(~ok, stable=True)[:capacity]
    mask = ok[order]
    src = idx.long()[order]
    p = torch.where(mask[:, None], cloud_i.points[src], 0.0)
    q = torch.where(mask[:, None], cloud_j.points[order], 0.0)
    n = torch.where(mask[:, None], cloud_i.normals[src], 0.0)
    # Pad to exactly `capacity` rows when the source cloud is smaller (the
    # CorresSet layout has a fixed per-edge stride).
    short = capacity - p.shape[0]
    if short > 0:
        p, q, n = (torch.nn.functional.pad(x, (0, 0, 0, short)) for x in (p, q, n))
        mask = torch.nn.functional.pad(mask, (0, short))
    return p, q, n, mask


def build_correspondences(
    clouds: list[PointCloud],
    poses: torch.Tensor,
    edge_pairs,
    *,
    max_distance: float = 0.03,
    capacity_per_edge: int = 4096,
    pair_transforms: dict | None = None,
    edge_weights: dict | None = None,
    lattice=None,
    displacement=None,
    lattice_of_fragment=None,
) -> CorresSet:
    """Harvest all kept edges into one CorresSet.

    ``clouds``: per-fragment clouds (local frames) on one device; ``poses``:
    (N, 4, 4) there; ``edge_pairs``: (i, j) int pairs. ``pair_transforms``:
    optional ``(i, j) -> T_ij`` mapping j-local into i-local points, the
    pairwise-refined alignment the reference harvests at (edges missing from
    it match under the global poses). ``edge_weights``: optional
    ``(i, j) -> float`` row weight, default 1.0. ``lattice``/``displacement``
    (matching at a lattice warp) raise: ``elastic/lattice.py`` is not ported.
    """
    if lattice is not None or displacement is not None:
        raise NotImplementedError(_NO_LATTICE)
    dev = poses.device
    fi, fj, ps, qs, ns, ms, ws = [], [], [], [], [], [], []
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    for i, j in edge_pairs:
        if pair_transforms is not None and (i, j) in pair_transforms:
            T_i = eye
            T_j = torch.as_tensor(np.asarray(pair_transforms[(i, j)], np.float32), device=dev)
        else:
            T_i, T_j = poses[i], poses[j]
        p, q, n, m = correspondences_for_edge(
            clouds[i], clouds[j], T_i, T_j, max_distance=max_distance, capacity=capacity_per_edge
        )
        fi.append(torch.full((capacity_per_edge,), i, dtype=torch.int32, device=dev))
        fj.append(torch.full((capacity_per_edge,), j, dtype=torch.int32, device=dev))
        ps.append(p)
        qs.append(q)
        ns.append(n)
        ms.append(m)
        w_e = 1.0 if edge_weights is None else float(edge_weights.get((i, j), 1.0))
        ws.append(torch.full((capacity_per_edge,), w_e, dtype=torch.float32, device=dev))
    if not fi:
        z = torch.zeros((0,), dtype=torch.int32, device=dev)
        z3 = torch.zeros((0, 3), dtype=torch.float32, device=dev)
        return CorresSet(z, z, z3, z3, torch.zeros((0,), dtype=torch.bool, device=dev), z3,
                         torch.zeros((0,), dtype=torch.float32, device=dev))
    return CorresSet(*(torch.cat(x) for x in (fi, fj, ps, qs, ms, ns, ws)))
