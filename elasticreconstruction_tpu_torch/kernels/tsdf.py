"""TSDF volume: projective fusion, trilinear sampling, surface extraction.

Counterpart of ``elasticreconstruction_tpu/kernels/tsdf.py``. The volume is a
dense ``(X, Y, Z)`` pair of tsdf/weight tensors; fusion is one elementwise pass
over all voxels (project the voxel center into the depth map, gather,
truncate, weighted-average update). The reference's TPU path is plain jnp (no
Pallas kernel), and so is this: plain PyTorch ops.

Convention: ``tsdf`` stores signed distance normalized by the truncation
band, in [-1, 1]; +1 = free space in front of the surface, -1 = behind.
``weight == 0`` marks never-observed voxels.

The volume's origin, voxel size and truncation are Python floats (float32
values), so no operation copies a scalar to the card. The reference builds
its fragment volume inside its jitted fragment builder, where they are
constants and XLA turns every division by them into a multiply by the float32
reciprocal; the port multiplies the same way (``core/types.py``,
``f32_reciprocal``), and forms voxel centers ``o + i * h`` as one fused
multiply-add, as XLA does on the CPU (``core/types.py``, ``fma``). Voxel centers are never materialised at full size:
:func:`fuse` forms each camera coordinate of every voxel from three per-axis
vectors, one broadcast add each.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core import camera as cam
from ..core.types import PointCloud, f32_reciprocal, fma, resolve_device


class TSDFVolume(NamedTuple):
    tsdf: torch.Tensor  # (X, Y, Z) float32, normalized [-1, 1]
    weight: torch.Tensor  # (X, Y, Z) float32
    origin: tuple[float, float, float]  # world position of voxel (0,0,0) CENTER
    voxel_size: float
    truncation: float  # meters

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(self.tsdf.shape)


def _f32(x) -> float:
    return float(np.float32(x))


def make_volume(
    shape: tuple[int, int, int],
    voxel_size: float,
    origin,
    truncation: float | None = None,
    *,
    device="cuda",
) -> TSDFVolume:
    """Fresh volume; default truncation = 4 voxels (KinFu-style band)."""
    dev = resolve_device(device)
    if truncation is None:
        truncation = 4.0 * voxel_size
    return TSDFVolume(
        tsdf=torch.zeros(shape, dtype=torch.float32, device=dev),
        weight=torch.zeros(shape, dtype=torch.float32, device=dev),
        origin=tuple(_f32(o) for o in origin),
        voxel_size=_f32(voxel_size),
        truncation=_f32(truncation),
    )


def axis_centers(vol: TSDFVolume, x_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World coordinate of the voxel centers along each axis: ``(X,), (Y,), (Z,)``.

    ``x_offset``: the volume is the x-slab of a larger one whose plane
    ``x_offset`` is its plane 0; ``origin`` is the larger volume's, so every
    center has the bits it has there (``dist/volume_sharding.py``).
    """
    dev = vol.tsdf.device
    return tuple(
        fma(torch.arange(off, off + n, dtype=torch.float32, device=dev), vol.voxel_size, o)
        for n, o, off in zip(vol.shape, vol.origin, (x_offset, 0, 0))
    )


def voxel_centers(vol: TSDFVolume) -> torch.Tensor:
    """World positions of all voxel centers, ``(X, Y, Z, 3)``."""
    cx, cy, cz = axis_centers(vol)
    return torch.stack(torch.meshgrid(cx, cy, cz, indexing="ij"), dim=-1)


def _in_range(idx, upper) -> torch.Tensor:
    """``0 <= idx[k] < upper[k]`` for every axis k."""
    ok = None
    for i, n in zip(idx, upper):
        ok_k = (i >= 0) & (i < n)
        ok = ok_k if ok is None else ok & ok_k
    return ok


def _observe(x, y, z, depth, intr, truncation, depth_min, depth_max):
    """The per-voxel observation at camera-frame points: project, look up the
    depth, z-difference SDF. Returns ``(obs normalized [-1, 1], valid)``."""
    (u, v), in_img = cam.project_uv(x, y, z, intr)
    d = depth.reshape(-1)[cam.pixel_index(u, v, intr)]
    sdf = d - z
    valid = in_img & (d >= depth_min) & (d <= depth_max) & (sdf >= -truncation)
    return torch.clip(sdf * f32_reciprocal(truncation), -1.0, 1.0), valid


def _fuse_components(vol, depth, x, y, z, intr, max_weight, depth_min, depth_max):
    tsdf_obs, valid = _observe(x, y, z, depth, intr, vol.truncation, depth_min, depth_max)
    w_old = vol.weight
    w_new = w_old + valid.to(torch.float32)
    tsdf_new = torch.where(valid, (vol.tsdf * w_old + tsdf_obs) / torch.clamp_min(w_new, 1.0), vol.tsdf)
    return vol._replace(tsdf=tsdf_new, weight=torch.clamp_max(w_new, max_weight))


def fuse(
    vol: TSDFVolume,
    depth: torch.Tensor,
    pose: torch.Tensor,
    intr: cam.Intrinsics,
    *,
    max_weight: float = 64.0,
    depth_min: float = 0.1,
    depth_max: float = 6.0,
    x_offset: int = 0,
) -> TSDFVolume:
    """Fuse one depth map (``pose`` = camera-to-world) into the volume
    (an x-slab from plane ``x_offset`` on, see :func:`axis_centers`)."""
    R = pose[:3, :3]
    # Camera coordinate j of voxel (i, k, l): sum_a (c_a - t_a) R[a, j], the
    # reference's (p_world - t) @ R, built from three per-axis vectors.
    a = [c - pose[i, 3] for i, c in enumerate(axis_centers(vol, x_offset))]
    ax, ay, az = a[0][:, None, None], a[1][None, :, None], a[2][None, None, :]
    x, y, z = ((ax * R[0, j] + ay * R[1, j]) + az * R[2, j] for j in range(3))
    return _fuse_components(vol, depth, x, y, z, intr, max_weight, depth_min, depth_max)


def fuse_at_camera_points(
    vol: TSDFVolume,
    depth: torch.Tensor,
    p_cam: torch.Tensor,
    intr: cam.Intrinsics,
    *,
    max_weight: float = 64.0,
    depth_min: float = 0.1,
    depth_max: float = 6.0,
) -> TSDFVolume:
    """Core fusion update given camera-space voxel centers ``p_cam (X, Y, Z, 3)``,
    taken through an arbitrary world -> camera warp."""
    x, y, z = p_cam.unbind(-1)
    return _fuse_components(vol, depth, x, y, z, intr, max_weight, depth_min, depth_max)


def band_samples(
    depth: torch.Tensor,
    intr: cam.Intrinsics,
    truncation: float,
    *,
    num_samples: int = 9,
    depth_min: float = 0.1,
    depth_max: float = 6.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Truncation-band sample points along every pixel ray, camera frame.

    ``num_samples`` points per pixel spanning z in [d - trunc, d + trunc];
    returns ``(p_cam (S, P, 3), valid (S, P))`` with P = H*W. The samples only
    nominate voxels: the fused observation is re-evaluated at each voxel's
    center (:func:`voxel_obs`).
    """
    dirs = cam.ray_directions(intr, device=depth.device).reshape(-1, 3)
    d = depth.reshape(-1)
    valid_px = (d >= depth_min) & (d <= depth_max)
    off = torch.linspace(-1.0, 1.0, num_samples, device=depth.device)[:, None] * truncation  # (S, 1)
    z = d[None, :] + off  # (S, P)
    p_cam = dirs[None] * z[..., None]
    valid = valid_px[None, :] & (z > 1e-3)
    return p_cam, valid


def voxel_obs(
    vol: TSDFVolume,
    center_cam: torch.Tensor,
    depth: torch.Tensor,
    intr: cam.Intrinsics,
    *,
    depth_min: float = 0.1,
    depth_max: float = 6.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gather formulation's observation at camera-frame points
    ``center_cam (..., 3)``: the same rule as :func:`fuse`, elementwise, so a
    voxel's value is a function of its center alone."""
    x, y, z = center_cam.unbind(-1)
    return _observe(x, y, z, depth, intr, vol.truncation, depth_min, depth_max)


def rigid_world_to_cam(pose: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """``p -> R^T (p - t)`` for ``(..., 3)`` points, elementwise in the order of
    :func:`fuse` (row results never depend on the batch they are in)."""
    R = pose[:3, :3]

    def warp(p):
        a = [p[..., i] - pose[i, 3] for i in range(3)]
        return torch.stack([(a[0] * R[0, j] + a[1] * R[1, j]) + a[2] * R[2, j] for j in range(3)], -1)

    return warp


def scatter_update(
    vol: TSDFVolume,
    p_world: torch.Tensor,
    valid: torch.Tensor,
    world_to_cam: Callable[[torch.Tensor], torch.Tensor],
    depth: torch.Tensor,
    intr: cam.Intrinsics,
    *,
    max_weight: float = 64.0,
    depth_min: float = 0.1,
    depth_max: float = 6.0,
    x_offset: int = 0,
) -> TSDFVolume:
    """Scatter band samples into the volume; one weight unit per hit voxel.

    Each sample nominates its nearest voxel; the observation is re-evaluated
    at that voxel's center through ``world_to_cam`` + :func:`voxel_obs`, so
    duplicate samples in a voxel carry bit-identical values and one
    scatter-max equals their mean (``world_to_cam`` must be elementwise, as
    :func:`rigid_world_to_cam` is). Of an x-slab (:func:`axis_centers`)
    only the samples nominating its own voxels count.
    """
    nx, ny, nz = vol.shape
    inv = f32_reciprocal(vol.voxel_size)
    idx = [torch.round((p_world[..., k] - vol.origin[k]) * inv).to(torch.int64) for k in range(3)]
    idx[0] = idx[0] - x_offset
    inb = _in_range(idx, (nx, ny, nz))
    ic = [torch.clip(i, 0, n - 1) for i, n in zip(idx, (nx, ny, nz))]
    center_world = torch.stack([fma((i + off).to(torch.float32), vol.voxel_size, o)
                                for i, o, off in zip(ic, vol.origin, (x_offset, 0, 0))], -1)
    obs, obs_ok = voxel_obs(vol, world_to_cam(center_world), depth, intr,
                            depth_min=depth_min, depth_max=depth_max)
    hit_ok = valid & inb & obs_ok
    flat = (ic[0] * ny + ic[1]) * nz + ic[2]
    flat = torch.where(hit_ok, flat, nx * ny * nz).reshape(-1)  # spill slot
    # One scatter-max: duplicates in a voxel are equal, so max == mean.
    neg = float("-inf")
    obs_masked = torch.where(hit_ok, obs, neg).reshape(-1)
    mx = torch.full((nx * ny * nz + 1,), neg, dtype=torch.float32, device=obs.device)
    mx.scatter_reduce_(0, flat, obs_masked, reduce="amax")
    mx = mx[:-1].reshape(vol.shape)
    hit = mx > neg
    obs_mean = torch.where(hit, mx, 0.0)
    w_old = vol.weight
    w_new = torch.where(hit, w_old + 1.0, w_old)
    tsdf_new = torch.where(hit, (vol.tsdf * w_old + obs_mean) / torch.clamp_min(w_new, 1.0), vol.tsdf)
    return vol._replace(tsdf=tsdf_new, weight=torch.clamp_max(w_new, max_weight))


def fuse_scatter(
    vol: TSDFVolume,
    depth: torch.Tensor,
    pose: torch.Tensor,
    intr: cam.Intrinsics,
    *,
    num_samples: int = 9,
    max_weight: float = 64.0,
    depth_min: float = 0.1,
    depth_max: float = 6.0,
    x_offset: int = 0,
) -> TSDFVolume:
    """Scatter-formulation fusion: iterate pixels x band samples, not voxels.

    Same per-voxel observation as :func:`fuse` on hit voxels, but only inside
    the truncation band: free space outside it is never carved. ``x_offset``
    as in :func:`fuse`.
    """
    p_cam, valid = band_samples(depth, intr, vol.truncation, num_samples=num_samples,
                                depth_min=depth_min, depth_max=depth_max)
    p_world = p_cam @ pose[:3, :3].T + pose[:3, 3]
    return scatter_update(vol, p_world, valid, rigid_world_to_cam(pose), depth, intr,
                          max_weight=max_weight, depth_min=depth_min, depth_max=depth_max, x_offset=x_offset)


# Sentinel marking never-observed voxels in a combined sampling volume. Any
# value > 1 works (tsdf lives in [-1, 1]); samples touching it are invalid.
_UNOBSERVED = 2.0


def make_sampling_volume(vol: TSDFVolume) -> torch.Tensor:
    """TSDF with unobserved voxels replaced by the sentinel (one gather per
    corner instead of two). Build once per volume state."""
    return torch.where(vol.weight > 0, vol.tsdf, _UNOBSERVED)


def _grid(origin, voxel_size, comps):
    inv = f32_reciprocal(voxel_size)
    return [(p - o) * inv for p, o in zip(comps, origin)]


def _trilinear(table, shape, origin, voxel_size, comps, with_valid: bool, x_offset: int = 0):
    """Trilinear sample of ``table (X, Y, Z)`` at points given as coordinate
    tensors ``(x, y, z)``; ``(value, valid or None)``. ``x_offset``: the
    table's plane 0 is plane ``x_offset`` of the volume ``origin`` belongs to."""
    nx, ny, nz = shape
    g = _grid(origin, voxel_size, comps)
    g0 = [torch.floor(c) for c in g]
    f = [c - c0 for c, c0 in zip(g, g0)]
    i0 = [c0.to(torch.int64) for c0 in g0]
    i0[0] = i0[0] - x_offset
    in_bounds = _in_range(i0, [n - 1 for n in shape])
    ic = [torch.clip(i, 0, n - 2) for i, n in zip(i0, shape)]
    base = (ic[0] * ny + ic[1]) * nz + ic[2]
    flat = table.reshape(-1)
    one_minus = [1 - c for c in f]
    val = cmax = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (f[0] if dx else one_minus[0]) * (f[1] if dy else one_minus[1]) * (f[2] if dz else one_minus[2])
                c = flat[base + (dx * ny * nz + dy * nz + dz)]
                val = w * c if val is None else val + w * c
                if with_valid:
                    cmax = c if cmax is None else torch.maximum(cmax, c)
    return val, (in_bounds & (cmax < 1.5)) if with_valid else None


def sample_values(
    sval: torch.Tensor, origin, voxel_size: float, points: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Trilinear sample of a :func:`make_sampling_volume` array at ``points (..., 3)``.

    Returns (value, valid); ``valid`` requires in-bounds and all 8 corners observed.
    """
    return _trilinear(sval, sval.shape, origin, voxel_size, points.unbind(-1), True)


def sample_trilinear(vol: TSDFVolume, points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Trilinear TSDF at world ``points (..., 3)`` -> (value, valid)."""
    return sample_values(make_sampling_volume(vol), vol.origin, vol.voxel_size, points)


def _nearest(sval, origin, voxel_size, comps):
    shape = sval.shape
    idx = [torch.round(g).to(torch.int64) for g in _grid(origin, voxel_size, comps)]
    in_bounds = _in_range(idx, shape)
    ic = [torch.clip(i, 0, n - 1) for i, n in zip(idx, shape)]
    c = sval.reshape(-1)[(ic[0] * shape[1] + ic[1]) * shape[2] + ic[2]]
    return c, in_bounds & (c < 1.5)


def sample_nearest(
    sval: torch.Tensor, origin, voxel_size: float, points: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-voxel sample of a :func:`make_sampling_volume` array: 1 gather."""
    return _nearest(sval, origin, voxel_size, points.unbind(-1))


def _gradient(vol: TSDFVolume, comps, x_offset: int = 0) -> list[torch.Tensor]:
    """Unit central-difference TSDF gradient at points ``(x, y, z)``, as components."""
    h = vol.voxel_size

    def s(axis, sign):
        moved = [c + sign * h if k == axis else c for k, c in enumerate(comps)]
        return _trilinear(vol.tsdf, vol.shape, vol.origin, vol.voxel_size, moved, False, x_offset)[0]

    g = [s(k, 1.0) - s(k, -1.0) for k in range(3)]
    n = torch.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2])
    n = torch.where(n > 1e-12, n, 1.0)
    return [c / n for c in g]


def sample_gradient(vol: TSDFVolume, points: torch.Tensor, x_offset: int = 0) -> torch.Tensor:
    """Central-difference TSDF gradient at world points (surface normal dir):
    differences of value-only trilinear samples (48 gathers per point);
    ``x_offset`` as in :func:`axis_centers`."""
    return torch.stack(_gradient(vol, points.unbind(-1), x_offset), -1)


def extract_surface_points(vol: TSDFVolume, *, capacity: int) -> PointCloud:
    """Zero-crossing surface samples with gradient normals.

    For each axis-adjacent voxel pair with a sign change and both observed,
    the linearly interpolated crossing; rows in the reference's order (axis
    0 pairs, then axis 1, then axis 2, each row-major), the first ``capacity``
    of them, padded with zero rows. ``torch.nonzero`` reads the count of
    crossings on the host: three synchronisations per call.
    """
    dev = vol.tsdf.device
    n = vol.shape
    centers = axis_centers(vol)
    pts = []
    taken = 0
    for axis in range(3):
        t0, t1 = vol.tsdf.narrow(axis, 0, n[axis] - 1), vol.tsdf.narrow(axis, 1, n[axis] - 1)
        w0, w1 = vol.weight.narrow(axis, 0, n[axis] - 1), vol.weight.narrow(axis, 1, n[axis] - 1)
        cross = (t0 * t1 < 0) & (w0 > 0) & (w1 > 0)
        flat = torch.nonzero(cross.reshape(-1))[: capacity - taken, 0]
        taken += flat.shape[0]
        dims = cross.shape
        ijk = (flat // (dims[1] * dims[2]), (flat // dims[2]) % dims[1], flat % dims[2])
        a, b = t0.reshape(-1)[flat], t1.reshape(-1)[flat]
        denom = a - b
        big = denom.abs() > 1e-9
        alpha = torch.where(big, a / torch.where(big, denom, 1.0), 0.5)
        pts.append(torch.stack(
            [centers[k][ijk[k]] + alpha * (vol.voxel_size if k == axis else 0.0) for k in range(3)], -1))
    pts = torch.cat(pts)
    count = pts.shape[0]
    normals = sample_gradient(vol, pts)
    pad = capacity - count
    zeros = torch.zeros((pad, 3), dtype=torch.float32, device=dev)
    mask = torch.arange(capacity, device=dev) < count
    return PointCloud(torch.cat([pts, zeros]), torch.cat([normals, zeros]), mask)
