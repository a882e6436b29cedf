"""Trilinear control lattice: the deformation model of FragmentOptimizer.

Counterpart of ``elasticreconstruction_tpu/elastic/lattice.py``: a
``resolution^3``-cell vertex grid over a ``length^3`` cube; points embed by
trilinear interpolation of the 8 surrounding control vertices, and the
optimiser moves the vertices (``ctr.txt`` stores their displaced positions).

Indexing: vertex (ix, iy, iz) -> flat id ``ix*(R+1)^2 + iy*(R+1) + iz`` with
R cells per axis, the row order of the ``ctr.txt`` writer. Ids are int64
here (int32 in the reference), weights float32. The reference divides by the
cell size inside jitted functions, where XLA multiplies by its float32
reciprocal; so does :func:`embed_weights`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.types import f32_reciprocal, fma


def _f32(values) -> list[float]:
    """Python floats holding float32 values: scalars that need no copy to the card."""
    return [float(np.float32(v)) for v in values]


class Lattice(NamedTuple):
    """Static lattice geometry (displacements live in the optimiser state)."""

    resolution: int  # cells per axis
    length: float  # cube edge length (m)
    origin: tuple[float, float, float]  # fragment-space min corner

    @property
    def verts_per_axis(self) -> int:
        return self.resolution + 1

    @property
    def num_vertices(self) -> int:
        return self.verts_per_axis**3

    @property
    def cell_size(self) -> float:
        return self.length / self.resolution

    def rest_positions(self, device="cpu") -> torch.Tensor:
        """(M, 3) undeformed vertex positions."""
        r = torch.arange(self.verts_per_axis, dtype=torch.float32, device=device) * float(np.float32(self.cell_size))
        g = torch.meshgrid(r, r, r, indexing="ij")
        return torch.stack([c + o for c, o in zip(g, _f32(self.origin))], dim=-1).reshape(-1, 3)


def embed_weights(lat: Lattice, points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Trilinear embedding of ``points (N, 3)``: vertex ids ``(N, 8)`` int64 and
    weights ``(N, 8)`` float32 summing to 1. Points outside the lattice clamp
    to the border cell (constant extrapolation of the deformation)."""
    n = lat.verts_per_axis
    inv = f32_reciprocal(lat.cell_size)
    g = torch.stack([(points[..., k] - o) * inv for k, o in enumerate(_f32(lat.origin))], dim=-1)
    g = torch.clip(g, 0.0, float(np.float32(lat.resolution - 1e-4)))
    c0 = torch.floor(g)
    f = g - c0
    c0 = c0.to(torch.int64)
    ids, wts = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ids.append((c0[..., 0] + dx) * n * n + (c0[..., 1] + dy) * n + (c0[..., 2] + dz))
                wts.append((f[..., 0] if dx else 1 - f[..., 0]) * (f[..., 1] if dy else 1 - f[..., 1])
                           * (f[..., 2] if dz else 1 - f[..., 2]))
    return torch.stack(ids, dim=-1), torch.stack(wts, dim=-1)


def interpolate(ids: torch.Tensor, w: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``sum_k w[:, k] values[ids[:, k]]`` for ``values (M, 3)``: ``(N, 3)``.

    Corner by corner, one fused multiply-add each, which is how XLA on the CPU
    evaluates the reference's jitted ``einsum`` (the same bits); each row's
    value depends on that row alone.
    """
    out = w[:, 0, None] * values[ids[:, 0]]
    for k in range(1, 8):
        out = fma(w[:, k, None], values[ids[:, k]], out)
    return out


def deform(lat: Lattice, displacement: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """The lattice deformation ``D(p) = p + sum_k w_k d_k`` of ``points (..., 3)``
    for ``displacement (M, 3)`` vertex displacements (zero = identity map)."""
    flat = points.reshape(-1, 3)
    ids, w = embed_weights(lat, flat)
    return (flat + interpolate(ids, w, displacement)).reshape(points.shape)


def edge_list(lat: Lattice, device="cpu") -> torch.Tensor:
    """(E, 2) int64 undirected 6-neighbour lattice edges (for ARAP): all x
    edges, then y, then z, each in vertex order, as the reference lists them."""
    n = lat.verts_per_axis
    idx = np.arange(n**3, dtype=np.int64)
    ix, iy, iz = idx // (n * n), (idx // n) % n, idx % n
    edges = [np.stack([idx[c < n - 1], idx[c < n - 1] + step], axis=-1)
             for c, step in ((ix, n * n), (iy, n), (iz, 1))]
    return torch.from_numpy(np.concatenate(edges, axis=0)).to(device)
