"""Brute-force k-nearest-neighbour search as blocked matmuls.

Counterpart of ``elasticreconstruction_tpu/kernels/knn.py``. For the point
counts the pipeline touches (fragments downsampled to <= ~2^14 points) a
blocked ``|q|^2 + |r|^2 - 2 q.r`` distance matrix is deterministic and
trivially batched. Invalid reference rows are pushed to ``+inf`` distance so
they never win; the CUDA nearest-neighbour route (:func:`nearest_auto_batch`)
uses the finite ``3e38`` instead (see ``kernels/cuda/nn.py``).
"""

from __future__ import annotations

import torch

from .cuda import nn as _cuda_nn


def pairwise_sqdist(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Squared distances ``(..., Nq, Nr)`` as ``|q|^2 + |r|^2 - 2 q@r^T``, clamped at 0."""
    q2 = (query * query).sum(-1, keepdim=True)
    r2 = (ref * ref).sum(-1, keepdim=True)
    cross = query @ ref.transpose(-1, -2)
    return (q2 + r2.transpose(-1, -2) - 2.0 * cross).clamp_min(0.0)


def _inf_row(ref_mask: torch.Tensor) -> torch.Tensor:
    return torch.where(ref_mask, 0.0, float("inf")).to(torch.float32)


def knn(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor, *, k: int, block_size: int = 2048
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid refs of each query: (sqdists ``(Nq, k)``, indices ``(Nq, k)`` int32).

    Where fewer than ``k`` valid refs exist, surplus slots have ``inf``
    distance — mask on ``isfinite``.
    """
    inf_row = _inf_row(ref_mask)
    ds, ids = [], []
    for s in range(0, query.shape[0], block_size):
        d = pairwise_sqdist(query[s : s + block_size], ref) + inf_row[None, :]
        dk, ik = torch.topk(d, k, dim=-1, largest=False, sorted=True)
        ds.append(dk)
        ids.append(ik.to(torch.int32))
    return torch.cat(ds), torch.cat(ids)


def nearest(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor, *, block_size: int = 2048
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single nearest neighbour (``inf`` for masked refs): argmin row-wise."""
    inf_row = _inf_row(ref_mask)
    ds, ids = [], []
    for s in range(0, query.shape[0], block_size):
        d = pairwise_sqdist(query[s : s + block_size], ref) + inf_row[None, :]
        dmin, imin = d.min(dim=-1)
        ds.append(dmin)
        ids.append(imin.to(torch.int32))
    return torch.cat(ds), torch.cat(ids)


def nearest_auto_batch(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched nearest neighbour over ``(B, N, 3)``.

    Routes on the tensors' device, never on whether a card is present: CUDA
    tensors launch the hand-written kernel, CPU tensors run its plain version.
    """
    return _cuda_nn.nearest_batch(query, ref, ref_mask)
