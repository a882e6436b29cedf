"""Content-based loop-candidate retrieval: FPFH fragment signatures.

Counterpart of ``elasticreconstruction_tpu/registration/retrieval.py``. A
pose-based candidate gate fails downstream of a degenerate tracking stretch:
the init distance between fragments that do overlap is meters there.
Retrieval by content does not depend on poses: two fragments that saw the
same geometry have similar FPFH feature distributions wherever odometry
places them.

Signature: the masked mean of the fragment's coarse-cloud FPFH histograms
(computed once per fragment by ``prep_fragments_batch``), L1-normalised.
Candidates are mutual top-k neighbours under the chi-squared distance, which
bounds how many pairs a feature-poor fragment can propose.
"""

from __future__ import annotations

import numpy as np
import torch


def fragment_signatures(features: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """L1-normalized mean FPFH histogram per fragment.

    ``features``: (F, N, 33) FPFH descriptors; ``mask``: (F, N) validity.
    Returns (F, 33) signatures, each summing to 1 (all-invalid fragments
    return zeros).
    """
    w = mask.to(torch.float32)[..., None]
    # Normalize each point histogram first so high-magnitude descriptors
    # (dense neighborhoods) don't dominate the fragment mean.
    row_sum = features.abs().sum(-1, keepdim=True)
    rows = torch.where(row_sum > 1e-8, features / row_sum.clamp_min(1e-8), 0.0)
    mean = (rows * w).sum(1) / w.sum(1).clamp_min(1.0)
    tot = mean.abs().sum(-1, keepdim=True)
    return torch.where(tot > 1e-8, mean / tot.clamp_min(1e-8), 0.0)


def signature_distances(sig: np.ndarray) -> np.ndarray:
    """(F, F) chi-squared distance between signatures (0 = identical)."""
    a = np.asarray(sig, np.float64)[:, None, :]
    b = np.asarray(sig, np.float64)[None, :, :]
    return 0.5 * np.sum((a - b) ** 2 / np.maximum(a + b, 1e-12), axis=-1)


def mutual_topk_pairs(
    dist: np.ndarray, k: int, *, candidates: set[tuple[int, int]] | None = None
) -> set[tuple[int, int]]:
    """Pairs (i, j), i < j, where each is in the other's k nearest signatures.

    ``candidates``: optional restriction — ranking and admission consider
    only these pairs (e.g. pairs a drift gate could not certify). Mutuality
    keeps a planar-degenerate fragment from spraying candidates: both sides
    must rank each other highly.
    """
    f = dist.shape[0]
    allowed = np.zeros((f, f), bool)
    if candidates is None:
        allowed[:] = True
        np.fill_diagonal(allowed, False)
    else:
        for i, j in candidates:
            allowed[i, j] = allowed[j, i] = True
    d = np.where(allowed, dist, np.inf)
    picks: list[set[int]] = []
    for i in range(f):
        order = np.argsort(d[i])
        n_ok = int(np.isfinite(d[i]).sum())
        picks.append(set(order[: min(k, n_ok)].tolist()))
    out = set()
    for i in range(f):
        for j in picks[i]:
            if i < j and i in picks[j]:
                out.add((i, j))
            elif j < i and i in picks[j]:
                out.add((j, i))
    return out
