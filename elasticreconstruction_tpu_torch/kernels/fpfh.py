"""FPFH (Fast Point Feature Histogram) descriptors from radius neighbourhoods.

Counterpart of ``elasticreconstruction_tpu/kernels/fpfh.py::fpfh_radius``
(the reference computes 33-D FPFH with PCL ``FPFHEstimationOMP``). Two
blocked all-pairs passes over 256-query blocks: pass 1 accumulates each
point's SPFH histogram over in-radius pairs, pass 2 mixes neighbour SPFHs with
inverse-distance weights as one ``(B, N) @ (N, 33)`` matmul. Only block rows
of the pair tensors exist at any time.

Histogram layout: 3 blocks of 11 bins = 33 dims, order [alpha | phi | theta],
each block normalized to sum to 100 (PCL convention).
"""

from __future__ import annotations

import math

import torch

from ..core.types import PointCloud

N_BINS = 11
FEATURE_DIM = 3 * N_BINS


def _normalize_blocks(h: torch.Tensor) -> torch.Tensor:
    """Normalize each 11-bin block to sum 100."""
    blocks = h.reshape(h.shape[:-1] + (3, N_BINS))
    s = blocks.sum(-1, keepdim=True)
    return (blocks / s.clamp_min(1e-12) * 100.0).reshape(h.shape)


def _hist_from_cums(cums: list[torch.Tensor]) -> torch.Tensor:
    s = torch.stack(cums, dim=1)  # (B, 11), monotone non-increasing
    return s - torch.cat([s[:, 1:], torch.zeros_like(s[:, :1])], dim=1)


def fpfh_radius(cloud: PointCloud, radius: float, *, block_size: int = 256) -> torch.Tensor:
    """33-D FPFH ``(N, 33)`` from ALL valid neighbours within ``radius``.

    Points without a unit normal are not neighbours and get a zero descriptor.
    """
    pts, nrm, mask = cloud.points, cloud.normals, cloud.mask
    n = pts.shape[0]
    dev = pts.device
    valid_ref = mask & ((nrm * nrm).sum(-1) > 0.25)  # unit normals only
    inf_row = torch.where(valid_ref, 0.0, float("inf")).to(torch.float32)
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=dev)
    p2 = (pts * pts).sum(1)
    ids = torch.arange(n, device=dev)

    # Histograms as CUMULATIVE THRESHOLD SUMS: for bin boundaries t_1..t_10,
    # S_i = sum w [val >= t_i] and hist_i = S_i - S_{i+1}. The theta feature
    # atan2(y, x) is never evaluated: [theta >= t] is a half-plane test,
    #   cross_t = y cos(t) - x sin(t)
    #   t >= 0:  [theta >= t] = (cross_t >= 0) & (y >= 0)
    #   t <  0:  [theta >= t] = (cross_t >= 0) | (y >= 0)
    # whose >= keeps a theta exactly on a boundary in the upper bin, the same
    # convention as the alpha/phi tests.
    step_a = 2.0 / N_BINS
    ts_lin = [-1.0 + i * step_a for i in range(1, N_BINS)]
    ts_th = [-math.pi + i * (2.0 * math.pi / N_BINS) for i in range(1, N_BINS)]

    def in_radius(s):
        """(d2, w) of query block s against all points; the self pair is
        excluded BY INDEX (a distance test is not rotation-stable)."""
        qb = pts[s : s + block_size]
        q2 = (qb * qb).sum(1, keepdim=True)
        d2 = (q2 + p2[None, :] - 2.0 * (qb @ pts.T)).clamp_min(0.0)
        w = ((d2 + inf_row[None, :]) <= r2) & (ids[s : s + block_size, None] != ids[None, :])
        return d2, w

    hists = []
    for s in range(0, n, block_size):
        _, w = in_radius(s)
        p = pts[s : s + block_size, None, :]
        u = nrm[s : s + block_size, None, :]
        n_q = nrm[None, :, :]
        dp = pts[None, :, :] - p
        d = torch.sqrt((dp * dp).sum(-1).clamp_min(0.0))
        dpn = dp / torch.where(d > 1e-9, d, 1.0)[..., None]
        v = torch.linalg.cross(dpn, u, dim=-1)
        v_len = torch.linalg.norm(v, dim=-1, keepdim=True)
        v = v / torch.where(v_len > 1e-9, v_len, 1.0)
        wv = torch.linalg.cross(u, v, dim=-1)
        alpha = (v * n_q).sum(-1)  # in [-1, 1]
        phi = (u * dpn).sum(-1)  # in [-1, 1]
        x = (u * n_q).sum(-1)  # theta = atan2(y, x), never evaluated
        y = (wv * n_q).sum(-1)

        count = w.to(torch.float32).sum(1)

        def cum(ind):
            return (w & ind).to(torch.float32).sum(1)

        cums_a = [count] + [cum(alpha >= t) for t in ts_lin]
        cums_p = [count] + [cum(phi >= t) for t in ts_lin]
        y_pos = y >= 0.0
        cums_t = [count]
        for t in ts_th:
            half = (y * math.cos(t) - x * math.sin(t)) >= 0.0
            cums_t.append(cum((half & y_pos) if t >= 0.0 else (half | y_pos)))
        hists.append(
            torch.cat([_hist_from_cums(cums_a), _hist_from_cums(cums_p), _hist_from_cums(cums_t)], 1)
        )
    spfh = _normalize_blocks(torch.cat(hists))

    # FPFH(p) = SPFH(p) + (1/k_p) sum_{j in radius} SPFH(q_j) / dist_j.
    mixed, cnt = [], []
    for s in range(0, n, block_size):
        d2, w = in_radius(s)
        inv_w = torch.where(w, torch.rsqrt(d2.clamp_min(1e-12)), 0.0)
        mixed.append(inv_w @ spfh)
        cnt.append(w.to(torch.float32).sum(1))
    out = _normalize_blocks(spfh + torch.cat(mixed) / torch.cat(cnt).clamp_min(1.0)[:, None])
    return torch.where((mask & valid_ref)[:, None], out, 0.0)
