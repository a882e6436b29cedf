"""Marching tetrahedra over a TSDF volume.

Counterpart of ``elasticreconstruction_tpu/integrate/mesh.py``. Each voxel
cube splits into 6 tetrahedra sharing the main diagonal; each tet contributes
0-2 triangles depending on its 4 corner signs. A slab (the cube layer between
z-slices ``z`` and ``z + 1``) has ``6 * cx * cy * 2`` candidate triangles,
enumerated tet-major, then x, y and the triangle slot; its output is the
first ``capacity`` valid candidates in that order (a stable compaction, as the
reference's ``argsort`` of the invalid flags is), zero rows after them.
Orientation is fixed numerically: a triangle whose normal disagrees with the
TSDF gradient at its centroid is reversed.

The reference maps one jitted slab function over the slabs. Here slabs go in
groups (:data:`GROUP_BYTES` of temporaries at most), in two passes per
group: the valid flags of every candidate and their stable compaction, then
the vertices and orientation of the kept candidates only (up to the fullest
slab's count), each from its own cube's corners by the reference's
arithmetic; the rest of the capacity is zero rows. Whole-volume ops on a
group keep the launch count near a few hundred per group instead of ~100 per
slab.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import f32_reciprocal, fma
from ..kernels.tsdf import TSDFVolume, sample_gradient

# Cube corners: bit 0 -> x, bit 1 -> y, bit 2 -> z.
_CORNERS = np.array([[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], dtype=np.int64)
# 6 tetrahedra sharing the 0-7 main diagonal (fan around it).
_TETS = np.array(
    [[0, 1, 5, 7], [0, 5, 4, 7], [0, 4, 6, 7], [0, 6, 2, 7], [0, 2, 3, 7], [0, 3, 1, 7]], dtype=np.int64
)
# Tet edges as (corner-slot a, corner-slot b) pairs.
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)

# Temporaries of one slab group stay under this many bytes (the first pass
# holds about BYTES_PER_CANDIDATE for each candidate triangle of the group).
GROUP_BYTES = 2 << 30
BYTES_PER_CANDIDATE = 32


def _build_case_table() -> np.ndarray:
    """(16, 2, 3) edge ids per triangle (-1 = unused) for each sign case.

    Case bit k set = corner slot k is inside (tsdf < 0).
    """
    table = -np.ones((16, 2, 3), dtype=np.int64)

    def edge_id(a, b):
        for e, (x, y) in enumerate(_TET_EDGES):
            if {a, b} == {x, y}:
                return e
        raise AssertionError

    for case in range(16):
        inside = [k for k in range(4) if case & (1 << k)]
        outside = [k for k in range(4) if not case & (1 << k)]
        if len(inside) == 1:
            a = inside[0]
            table[case, 0] = [edge_id(a, b) for b in outside]
        elif len(inside) == 3:
            a = outside[0]
            table[case, 0] = [edge_id(a, b) for b in inside]
        elif len(inside) == 2:
            a, b = inside
            c, d = outside
            # Quad vertices on edges (a,c), (a,d), (b,d), (b,c), split in two.
            e0, e1, e2, e3 = edge_id(a, c), edge_id(a, d), edge_id(b, d), edge_id(b, c)
            table[case, 0] = [e0, e1, e2]
            table[case, 1] = [e0, e2, e3]
    return table


_CASE_TABLE = _build_case_table()
# Corner offsets of each tet's edge ends: (6 tets, 6 edges, 3).
_EDGE_A = _CORNERS[_TETS[:, _TET_EDGES[:, 0]]]
_EDGE_B = _CORNERS[_TETS[:, _TET_EDGES[:, 1]]]


class _Tables:
    """The host tables as tensors on one device."""

    def __init__(self, dev: torch.device):
        def t(x):
            return torch.as_tensor(x, device=dev)

        self.case = t(_CASE_TABLE)
        self.has = t(_CASE_TABLE[:, :, 0] >= 0)  # (16, 2): the case emits triangle k
        self.corners = t(_CORNERS)
        self.tets = t(_TETS)
        self.slot_a, self.slot_b = t(_TET_EDGES[:, 0]), t(_TET_EDGES[:, 1])
        self.edge_a, self.edge_b = t(_EDGE_A).float(), t(_EDGE_B).float()


def _case(v0, v1, v2, v3) -> torch.Tensor:
    return (v0 < 0).long() + 2 * (v1 < 0).long() + 4 * (v2 < 0).long() + 8 * (v3 < 0).long()


def _valid_candidates(vol: TSDFVolume, z0: int, g: int, cells: tuple[int, int], tab: _Tables) -> torch.Tensor:
    """Valid flags ``(g, 6 * cx * cy * 2)`` of the candidates of slabs
    ``z0 .. z0+g-1`` in the cubes of x ``cells[0] .. cells[1]-1``."""
    _, ny, _ = vol.shape
    x0, cx, cy = cells[0], cells[1] - cells[0], ny - 1
    tz, wz = vol.tsdf.permute(2, 0, 1), vol.weight.permute(2, 0, 1)

    def corner(a, k):
        dx, dy, dz = _CORNERS[k]
        return a[z0 + dz : z0 + dz + g, x0 + dx : x0 + dx + cx, dy : dy + cy]

    vals = [corner(tz, k) for k in range(8)]
    observed = torch.stack([corner(wz, k) > 0 for k in range(8)]).all(0)  # (g, cx, cy)
    cases = torch.stack([_case(*(vals[s] for s in _TETS[t])) for t in range(6)], 1)  # (g, 6, cx, cy)
    valid = tab.has[cases] & observed[:, None, :, :, None]  # (g, 6, cx, cy, 2)
    return valid.reshape(g, -1)


def _kept_triangles(vol: TSDFVolume, z0: int, order: torch.Tensor, cells: tuple[int, int], x_offset: int,
                    tab: _Tables) -> torch.Tensor:
    """Voxel-unit vertices ``(g, M, 3, 3)`` of the candidates ``order (g, M)``
    of slabs ``z0 ..`` among the cubes of local x ``cells``, their x counted
    from the plane ``x_offset`` planes below ``vol``'s first: the reference's
    corner values, edge interpolation and vertex arithmetic, on these
    candidates alone."""
    _, ny, nz = vol.shape
    cx, cy = cells[1] - cells[0], ny - 1
    k = order % 2
    iy = (order // 2) % cy
    ix = (order // (2 * cy)) % cx + cells[0]
    t = order // (2 * cy * cx)
    z = z0 + torch.arange(order.shape[0], device=order.device)[:, None]
    flat = vol.tsdf.reshape(-1)
    v = []
    for s in range(4):
        d = tab.corners[tab.tets[t, s]]  # (g, M, 3)
        v.append(flat[((ix + d[..., 0]) * ny + (iy + d[..., 1])) * nz + (z + d[..., 2])])
    v = torch.stack(v, -1)  # (g, M, 4)
    edges = tab.case[_case(*v.unbind(-1)), k].clamp_min(0)  # (g, M, 3)
    base = torch.stack([ix + x_offset, iy, z.expand_as(ix)], -1).to(torch.float32)  # (g, M, 3)
    va = torch.gather(v, -1, tab.slot_a[edges])
    vb = torch.gather(v, -1, tab.slot_b[edges])
    denom = va - vb
    big = denom.abs() > 1e-12
    alpha = torch.where(big, va / torch.where(big, denom, 1.0), 0.5).clip(0.0, 1.0)
    pa = tab.edge_a[t[..., None], edges]  # (g, M, 3 verts, 3)
    pb = tab.edge_b[t[..., None], edges]
    return (base[..., None, :] + pa) + alpha[..., None] * (pb - pa)


def extract_mesh(vol: TSDFVolume, *, capacity_per_slab: int = 16384, x_offset: int = 0,
                 x_cells: tuple[int, int] | None = None):
    """Triangle soup ``((nz-1, M, 3, 3) verts, (nz-1, M) mask)``, ``M`` the
    smaller of ``capacity_per_slab`` and a slab's candidate count.

    Triangles are oriented so the normal points toward positive TSDF (free
    space). Use :func:`weld_mesh` to produce an indexed mesh for PLY output.

    An x-slab of a larger volume (``dist/volume_sharding.py``): ``vol`` holds
    its planes from plane ``x_offset`` on, with the larger volume's origin,
    and only the cubes of local x ``x_cells[0] .. x_cells[1]-1`` are
    marched. Vertices and orientation then have the bits the larger volume
    gives them, as long as ``vol`` holds the two planes below those cubes
    and the three above (or the larger volume's end): the orientation test
    samples the gradient a voxel either side of the centroid.
    """
    nx, ny, nz = vol.shape
    dev = vol.tsdf.device
    tab = _Tables(dev)
    cells = (0, nx - 1) if x_cells is None else x_cells
    candidates = 12 * (cells[1] - cells[0]) * (ny - 1)
    group = max(1, GROUP_BYTES // (BYTES_PER_CANDIDATE * candidates))
    tris, masks = [], []
    for z0 in range(0, nz - 1, group):
        g = min(group, nz - 1 - z0)
        valid = _valid_candidates(vol, z0, g, cells, tab)
        # Rows past the fullest slab's count are zero in every slab of the
        # group: only the first `kept` are computed (one host read a group).
        kept = min(capacity_per_slab, int(valid.sum(1).max()))
        order = torch.argsort(~valid, dim=-1, stable=True)[:, :kept]
        mask = torch.gather(valid, 1, order)
        local = _kept_triangles(vol, z0, order, cells, x_offset, tab)
        out = torch.stack([fma(local[..., a], vol.voxel_size, vol.origin[a]) for a in range(3)], -1)
        out = torch.where(mask[..., None, None], out, 0.0)
        # Orient: flip triangles whose normal disagrees with the TSDF gradient.
        centroids = (out[..., 0, :] + out[..., 1, :] + out[..., 2, :]) * f32_reciprocal(3.0)
        grad = sample_gradient(vol, centroids, x_offset)
        n = torch.linalg.cross(out[..., 1, :] - out[..., 0, :], out[..., 2, :] - out[..., 0, :], dim=-1)
        flip = (n * grad).sum(-1) < 0
        pad = min(capacity_per_slab, candidates) - kept
        tris.append(torch.nn.functional.pad(torch.where(flip[..., None, None], out.flip(-2), out),
                                            (0, 0, 0, 0, 0, pad)))
        masks.append(torch.nn.functional.pad(mask, (0, pad)))
    return torch.cat(tris), torch.cat(masks)


def weld_mesh(tris, mask, *, decimals: int = 5):
    """Host-side: triangle soup -> (vertices (V, 3), triangles (F, 3) int)."""
    tris = np.asarray(tris).reshape(-1, 3, 3)
    mask = np.asarray(mask).reshape(-1)
    tris = tris[mask]
    flat = tris.reshape(-1, 3)
    key = np.round(flat, decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3)
    # Drop degenerate faces (repeated vertices after welding).
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return uniq.astype(np.float32), faces[ok].astype(np.int64)
