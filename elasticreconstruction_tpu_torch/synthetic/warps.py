"""Smooth per-fragment warps: the ICCV'13 elastic-fragments failure model.

Counterpart of ``elasticreconstruction_tpu/synthetic/warps.py``. Odometry
drift inside a fragment bends its geometry by a smooth, low-frequency warp
that rigid alignment cannot undo and the nonrigid mode's per-fragment
lattices can. This module makes such a corruption on the optimiser's own
control lattice, so ground truth is known vertex for vertex: a seeded
displacement on a coarse 2x2x2 corner grid, trilinearly upsampled to the
lattice (numpy, the reference's draws and arithmetic).
"""

from __future__ import annotations

import numpy as np
import torch

from ..elastic.lattice import Lattice, deform


def make_fragment_warp(seed: int, lat: Lattice, *, amplitude: float = 0.03, coarse: int = 2) -> np.ndarray:
    """(M, 3) lattice-vertex displacements of a smooth low-frequency warp.

    ``amplitude``: per-axis std of the coarse control displacements (m). The
    warp's mean is removed, so its rigid part is small.
    """
    rng = np.random.default_rng(seed)
    c = rng.normal(0.0, amplitude, size=(coarse, coarse, coarse, 3)).astype(np.float32)
    c -= c.mean(axis=(0, 1, 2), keepdims=True)
    n = lat.verts_per_axis
    t = np.linspace(0.0, coarse - 1.0, n)
    i0 = np.clip(np.floor(t).astype(np.int32), 0, coarse - 2)
    f = (t - i0).astype(np.float32)

    def lerp_axis(a, axis):
        shape = [1, 1, 1, 1]
        shape[axis] = n
        w = f.reshape(shape)
        return np.take(a, i0, axis=axis) * (1 - w) + np.take(a, i0 + 1, axis=axis) * w

    return lerp_axis(lerp_axis(lerp_axis(c, 0), 1), 2).reshape(-1, 3)


def warp_points(lat: Lattice, vertex_disp, points) -> torch.Tensor:
    """Apply a lattice warp to points (the trilinear rule the optimiser uses);
    the points' device, the CPU for numpy input."""
    points, disp = (x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x, np.float32))
                    for x in (points, vertex_disp))
    return deform(lat, disp.to(points.device), points)
