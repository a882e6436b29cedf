"""Brute-force k-nearest-neighbour search over blocked distance matrices.

Counterpart of ``elasticreconstruction_tpu/kernels/knn.py``. For the point
counts the pipeline touches (fragments downsampled to <= ~2^14 points) a
blocked ``|q|^2 + |r|^2 - 2 q.r`` distance matrix is deterministic and
trivially batched; here it is formed elementwise with the reference's
multiply-adds (:func:`pairwise_sqdist`). Invalid reference rows are pushed to
``+inf`` distance so they never win; the CUDA nearest-neighbour routes
(:func:`nearest_auto`, :func:`nearest_auto_batch`) use the finite ``3e38``
instead (see ``kernels/cuda/nn.py``).
"""

from __future__ import annotations

import torch

from ..core.types import fma
from .cuda import nn as _cuda_nn


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a . b`` over the last axis of 3, as XLA on the CPU contracts it:
    ``fma(a2, b2, fma(a1, b1, a0 b0))``."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def pairwise_sqdist(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Squared distances ``(..., Nq, Nr)`` as ``|q|^2 + |r|^2 - 2 q.r``, clamped at 0.

    Norms and dot products are the reference's multiply-add chains
    (:func:`_dot3`), so the matrix is bit-equal to the reference's and a
    point's distance to itself is exactly 0 (a BLAS product rounds it to a
    few 1e-7, which the k-NN FPFH's self test ``d2 > 1e-12`` reads as a
    neighbour).
    """
    q2 = _dot3(query, query)[..., :, None]
    r2 = _dot3(ref, ref)[..., None, :]
    cross = _dot3(query[..., :, None, :], ref[..., None, :, :])
    return (q2 + r2 - 2.0 * cross).clamp_min(0.0)


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


def nearest_auto(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unbatched nearest neighbour over ``(N, 3)``, routed as :func:`nearest_auto_batch`
    is: CPU tensors run :func:`nearest`, CUDA tensors the hand-written kernel at
    B = 1, and any other device raises.

    The routes form distances differently (``|q|^2 + |r|^2 - 2 q.r`` here, the
    kernel's packed key there), so an index may differ on a near-tie; masked refs read
    ``3e38`` on the card and ``inf`` here, which every caller gates behind its
    own radius.
    """
    if query.device.type == "cpu":
        return nearest(query, ref, ref_mask)
    return _cuda_nn.nearest(query, ref, ref_mask)


def nearest_auto_batch(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched nearest neighbour over ``(B, N, 3)``.

    Routes on the tensors' device, never on whether a card is present: CUDA
    tensors launch the hand-written kernel, CPU tensors run its plain version.
    """
    return _cuda_nn.nearest_batch(query, ref, ref_mask)
