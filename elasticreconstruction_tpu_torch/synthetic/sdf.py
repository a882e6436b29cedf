"""Composable analytic signed-distance fields.

Counterpart of ``elasticreconstruction_tpu/synthetic/sdf.py``. Each primitive
returns a function ``points (..., 3) -> sdf (...)`` on tensors; scenes are
built by union/intersection combinators. A primitive's constants are Python
floats, so evaluating a scene on the card copies nothing to it.
"""

from __future__ import annotations

from typing import Callable

import torch

SDF = Callable[[torch.Tensor], torch.Tensor]


def _floats(v) -> tuple[float, ...]:
    return tuple(float(x) for x in v)


def _norm(*comps: torch.Tensor) -> torch.Tensor:
    acc = comps[0] * comps[0]
    for c in comps[1:]:
        acc = acc + c * c
    return torch.sqrt(acc)


def sphere(center, radius: float) -> SDF:
    c = _floats(center)

    def f(p):
        return _norm(*(p[..., k] - c[k] for k in range(3))) - radius

    return f


def _box_dist(p, c, h):
    q = [torch.abs(p[..., k] - c[k]) - h[k] for k in range(3)]
    outside = _norm(*(torch.clamp_min(x, 0.0) for x in q))
    inside = torch.clamp_max(torch.maximum(torch.maximum(q[0], q[1]), q[2]), 0.0)
    return outside + inside


def box(center, half_extents) -> SDF:
    """Axis-aligned box (exact exterior distance)."""
    c, h = _floats(center), _floats(half_extents)

    def f(p):
        return _box_dist(p, c, h)

    return f


def rounded_box(center, half_extents, radius: float) -> SDF:
    base = box(center, half_extents)

    def f(p):
        return base(p) - radius

    return f


def cylinder_y(center, radius: float, half_height: float) -> SDF:
    """Vertical (y-axis) capped cylinder."""
    c = _floats(center)

    def f(p):
        d_xy = _norm(p[..., 0] - c[0], p[..., 2] - c[2]) - radius
        d_y = torch.abs(p[..., 1] - c[1]) - half_height
        outside = _norm(torch.clamp_min(d_xy, 0.0), torch.clamp_min(d_y, 0.0))
        inside = torch.clamp_max(torch.maximum(d_xy, d_y), 0.0)
        return outside + inside

    return f


def shell(inner: SDF, thickness: float) -> SDF:
    """Hollow shell of a solid: |d| - t/2 (used for room walls)."""

    def f(p):
        return torch.abs(inner(p)) - thickness * 0.5

    return f


def invert(s: SDF) -> SDF:
    """Flip inside/outside (a room interior = inverted box)."""

    def f(p):
        return -s(p)

    return f


def union(*sdfs: SDF) -> SDF:
    def f(p):
        d = sdfs[0](p)
        for s in sdfs[1:]:
            d = torch.minimum(d, s(p))
        return d

    return f


def intersect(*sdfs: SDF) -> SDF:
    def f(p):
        d = sdfs[0](p)
        for s in sdfs[1:]:
            d = torch.maximum(d, s(p))
        return d

    return f


def subtract(a: SDF, b: SDF) -> SDF:
    """a minus b."""

    def f(p):
        return torch.maximum(a(p), -b(p))

    return f


def normal(s: SDF, p: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Finite-difference SDF gradient (unit surface normal)."""
    g = []
    for k in range(3):
        off = torch.zeros(3, dtype=p.dtype, device=p.device)
        off[k] = eps
        g.append((s(p + off) - s(p - off)) / (2 * eps))
    g = torch.stack(g, -1)
    n = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    return g / torch.where(n > 1e-12, n, 1.0)
