"""Batched nearest-neighbour search: CUDA kernel ``csrc/nn.cu`` and its plain version.

Counterpart of ``elasticreconstruction_tpu/kernels/pallas/nn.py``. Contract
of :func:`nearest_batch` (both routes): for each batch ``b`` and query ``q``,
the minimum over refs of ``max(|q|^2 + (|r|^2 + off) - 2 q.r, 0)`` with
``off = 0`` for valid refs and ``3e38`` for masked ones, and the FIRST index
attaining it. A query whose refs are all masked gets ``(3e38, 0)``; callers
gate on their own radius, so this and ``kernels/knn.py``'s ``inf`` sentinel
behave the same downstream.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

BIG = 3.0e38

launches = 0  # kernel launches since the last reset (set to 0 to reset)


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    """``(x0*x0 + x1*x1) + x2*x2``: the kernel's order, each op rounded alone."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def nearest_batch_plain(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor, *, block_q: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, op for op (see ``csrc/nn.cuh``).

    The dot product is written as three products and two sums rather than a
    matmul so that every rounding matches the kernel (built with
    ``-fmad=false``); on the card the two agree bit for bit. Blocked over
    ``block_q`` queries so the (B, block_q, Nr) tiles stay small.
    """
    b, nq, _ = query.shape
    if ref.shape[1] == 0:
        raise ValueError("nearest_batch needs at least one reference point")
    qq = _sqnorm(query)
    rr = _sqnorm(ref) + (~ref_mask).to(torch.float32) * BIG
    d2 = torch.empty((b, nq), dtype=torch.float32, device=query.device)
    idx = torch.empty((b, nq), dtype=torch.int32, device=query.device)
    for s in range(0, nq, block_q):
        q = query[:, s : s + block_q, None, :]  # (B, bq, 1, 3)
        r = ref[:, None, :, :]  # (B, 1, Nr, 3)
        dot = q[..., 0] * r[..., 0] + q[..., 1] * r[..., 1] + q[..., 2] * r[..., 2]
        d = ((qq[:, s : s + block_q, None] + rr[:, None, :]) - 2.0 * dot).clamp_min(0.0)
        dmin, imin = d.min(dim=-1)  # first index of the minimum
        d2[:, s : s + block_q] = dmin
        idx[:, s : s + block_q] = imin.to(torch.int32)
    return d2, idx


def _kernel():
    (lib,) = build.load("nn")
    fn = lib.er_nearest_batch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nearest_batch(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-batch nearest reference point: ``query (B, Nq, 3)``, ``ref (B, Nr, 3)``,
    ``ref_mask (B, Nr)`` -> (sqdist ``(B, Nq)`` f32, index ``(B, Nq)`` int32).

    CUDA tensors launch ``csrc/nn.cu``; CPU tensors run
    :func:`nearest_batch_plain`. Any other device raises.
    """
    global launches
    if query.device.type == "cpu":
        return nearest_batch_plain(query, ref, ref_mask)
    if query.device.type != "cuda":
        raise ValueError(f"nearest_batch: unsupported device {query.device}")
    b, nq, _ = query.shape
    nr = ref.shape[1]
    build.check_args(
        "nearest_batch",
        {"query": query, "ref": ref, "ref_mask": ref_mask},
        {"query": torch.float32, "ref": torch.float32, "ref_mask": torch.bool},
        {"query": (b, nq, 3), "ref": (b, nr, 3), "ref_mask": (b, nr)},
    )
    if nr == 0:
        raise ValueError("nearest_batch needs at least one reference point")
    d2 = torch.empty((b, nq), dtype=torch.float32, device=query.device)
    idx = torch.empty((b, nq), dtype=torch.int32, device=query.device)
    if b * nq == 0:
        return d2, idx
    err = _kernel()(
        query.data_ptr(), ref.data_ptr(), ref_mask.data_ptr(), d2.data_ptr(), idx.data_ptr(),
        b, nq, nr, torch.cuda.current_stream(query.device).cuda_stream,
    )
    build.check(err, "nearest_batch")
    launches += 1
    return d2, idx


def nearest(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unbatched wrapper over :func:`nearest_batch`."""
    d2, idx = nearest_batch(query[None], ref[None], ref_mask[None])
    return d2[0], idx[0]
