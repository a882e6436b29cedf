"""Fused point-to-plane ICP step: CUDA kernel ``csrc/icp_step.cu`` and its plain version.

Counterpart of ``elasticreconstruction_tpu/kernels/pallas/icp_step.py``. For
each batch: nearest dst point of every transformed source point, gather of
the matched point q and normal n, weight ``w = src_w * [d2 < max_dist^2]``,
residual ``r = n.(p - q)`` and Jacobian ``J = [n, p x n]``; returns
``H = sum w J^T J (B, 6, 6)``, ``g = sum w J r (B, 6)``, ``n_in = sum w (B,)``
and ``wrr = sum w r^2 (B,)``. The search, its arithmetic and its tie rule are
those of ``kernels/cuda/nn.py``, in both routes.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.types import f32_square
from . import build
from . import nn as _nn
from .nn import nearest_batch_plain

_NUM_SUMS = 29  # per (batch, query tile) in scratch: 21 upper-triangle H, 6 g, n_in, wrr
_OUT_WIDTH = 44  # the kernel's output row: 36 H (row-major, symmetric), 6 g, n_in, wrr


def unpack_sums(out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Views ``(H (B, 6, 6), g (B, 6), n_in (B,), wrr (B,))`` of the kernel's output ``(B, 44)``."""
    b = out.shape[0]
    return out[:, :36].view(b, 6, 6), out[:, 36:42], out[:, 42], out[:, 43]


def normal_eqs_from_matches(p, src_w, dst_pts, dst_nrm, d2, idx, max_dist):
    """GN normal equations from precomputed NN matches ``(d2, idx)`` (B, N)."""
    ix = idx.long()[..., None].expand(-1, -1, 3)
    q = torch.gather(dst_pts, 1, ix)
    n = torch.gather(dst_nrm, 1, ix)
    w = src_w * (d2 < f32_square(max_dist)).to(p.dtype)
    r = (n * (p - q)).sum(-1)  # (B, N) point-to-plane residual
    J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], dim=-1)  # (B, N, 6)
    H = torch.einsum("bni,bnj->bij", J * w[..., None], J)
    g = torch.einsum("bni,bn->bi", J, w * r)
    return H, g, w.sum(-1), (w * r * r).sum(-1)


def normal_eqs_batch_plain(p, src_w, dst_pts, dst_nrm, dst_mask, *, max_dist: float):
    """Plain PyTorch version of the fused step (the reference's ``_normal_eqs_xla``).

    Nearest neighbour by :func:`..nn.nearest_batch_plain`, then row gathers
    and two einsums. Exact distance ties take the first index, as in the kernel.
    """
    d2, idx = nearest_batch_plain(p, dst_pts, dst_mask)
    return normal_eqs_from_matches(p, src_w, dst_pts, dst_nrm, d2, idx, max_dist)


_KERNEL = build.Kernel("icp_step", "normal_eqs_batch", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float],
                       on_load=_nn.check_geometry)


def normal_eqs_batch(p, src_w, dst_pts, dst_nrm, dst_mask, *, max_dist: float):
    """Point-to-plane GN normal equations for one ICP iteration.

    ``p (B, N, 3)`` transformed src points, ``src_w (B, N)`` 0/1 f32 src
    validity, ``dst_pts``/``dst_nrm (B, M, 3)``, ``dst_mask (B, M)``. Returns
    ``(H (B, 6, 6), g (B, 6), n_in (B,), wrr (B,))``; matches farther than
    ``max_dist`` get zero weight. CUDA tensors launch ``csrc/icp_step.cu`` (one
    launch, which writes one ``(B, 44)`` buffer that the results are views of);
    CPU tensors run :func:`normal_eqs_batch_plain`. The kernel's scratch is
    cached per device (``build.scratch``): launches of one device must stay on
    one stream.
    """
    if not build.on_card(p, "normal_eqs_batch"):
        return normal_eqs_batch_plain(p, src_w, dst_pts, dst_nrm, dst_mask, max_dist=max_dist)
    b, n, _ = p.shape
    m = dst_pts.shape[1]
    build.check_args(
        "normal_eqs_batch",
        {"p": p, "src_w": src_w, "dst_pts": dst_pts, "dst_nrm": dst_nrm, "dst_mask": dst_mask},
        {"p": torch.float32, "src_w": torch.float32, "dst_pts": torch.float32,
         "dst_nrm": torch.float32, "dst_mask": torch.bool},
        {"p": (b, n, 3), "src_w": (b, n), "dst_pts": (b, m, 3), "dst_nrm": (b, m, 3),
         "dst_mask": (b, m)},
    )
    if m == 0:
        raise ValueError("normal_eqs_batch needs at least one dst point")
    if b * n == 0:
        return unpack_sums(torch.zeros((b, _OUT_WIDTH), dtype=torch.float32, device=p.device))
    geo = _nn.plan(b, n, m, _nn.sm_count(p.device.index))
    scratch, counters = _nn.search_scratch(
        p.device, b, geo, extra_floats=b * geo.tiles * _NUM_SUMS, extra_counters=b
    )
    out = torch.empty((b, _OUT_WIDTH), dtype=torch.float32, device=p.device)
    _KERNEL(
        p.device, p.data_ptr(), src_w.data_ptr(), dst_pts.data_ptr(), dst_nrm.data_ptr(),
        dst_mask.data_ptr(), out.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
        b, n, m, geo.splits, geo.range, f32_square(max_dist), shape=(b, n, m),
    )
    return unpack_sums(out)
