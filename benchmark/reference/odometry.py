"""Fragment odometry: TSDF fuse, raycast, projective ICP, surface extraction.

Frozen copies of the port's plain ``kernels/tsdf.py``, ``kernels/raycast.py``,
``odometry/kinfu.py`` and ``odometry/fragments.py`` at the commit that
introduced the benchmark, with matrix products through :mod:`.prec`. The
raycast march is written anew: every step's nearest-voxel read is the port's
elementwise arithmetic, but the steps run as a few large tensors a chunk
rather than one set of kernels a step, and the first bracketed zero crossing
is found with one ``argmax`` a chunk.

:func:`follow` is the judge's form: it walks a fragment frame by frame from
the poses another run wrote, fusing each frame at that run's pose and
tracking the next frame from that run's state, so one frame's rounding never
carries into the next. :func:`chain` is the whole fragment from its own
poses, as the program runs it; the control runs it in TF32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import prec
from .geometry import (PointCloud, compose, exp, f32_reciprocal, fma, identity, inverse, log, pixel_index,
                       project_uv, ray_directions, rotate, unproject)

# ------------------------------------------------------------------ TSDF


class Volume(NamedTuple):
    tsdf: torch.Tensor
    weight: torch.Tensor
    origin: tuple[float, float, float]
    voxel_size: float
    truncation: float

    @property
    def shape(self):
        return tuple(self.tsdf.shape)


def _f32(x) -> float:
    return float(np.float32(x))


def make_volume(shape, voxel_size: float, min_z: float, device) -> Volume:
    origin = (-0.5 * shape[0] * voxel_size, -0.5 * shape[1] * voxel_size, min_z)
    return Volume(torch.zeros(shape, dtype=torch.float32, device=device),
                  torch.zeros(shape, dtype=torch.float32, device=device),
                  tuple(_f32(o) for o in origin), _f32(voxel_size), _f32(4.0 * voxel_size))


def axis_centers(vol: Volume):
    dev = vol.tsdf.device
    return tuple(fma(torch.arange(n, dtype=torch.float32, device=dev), vol.voxel_size, o)
                 for n, o in zip(vol.shape, vol.origin))


def _in_range(idx, upper):
    ok = None
    for i, n in zip(idx, upper):
        k = (i >= 0) & (i < n)
        ok = k if ok is None else ok & k
    return ok


def fuse(vol: Volume, depth, pose, intr, *, max_weight, depth_min, depth_max) -> Volume:
    R = pose[:3, :3]
    a = [c - pose[i, 3] for i, c in enumerate(axis_centers(vol))]
    ax, ay, az = a[0][:, None, None], a[1][None, :, None], a[2][None, None, :]
    x, y, z = ((ax * R[0, j] + ay * R[1, j]) + az * R[2, j] for j in range(3))
    (u, v), in_img = project_uv(x, y, z, intr)
    d = depth.reshape(-1)[pixel_index(u, v, intr)]
    sdf = d - z
    valid = in_img & (d >= depth_min) & (d <= depth_max) & (sdf >= -vol.truncation)
    obs = torch.clip(sdf * f32_reciprocal(vol.truncation), -1.0, 1.0)
    w_new = vol.weight + valid.to(torch.float32)
    tsdf = prec.stored(torch.where(valid, (vol.tsdf * vol.weight + obs) / torch.clamp_min(w_new, 1.0), vol.tsdf))
    return vol._replace(tsdf=tsdf, weight=torch.clamp_max(w_new, max_weight))


def _sampling_volume(vol: Volume):
    return torch.where(vol.weight > 0, vol.tsdf, 2.0)


def _grid(origin, voxel_size, comps):
    inv = f32_reciprocal(voxel_size)
    return [(p - o) * inv for p, o in zip(comps, origin)]


def _trilinear(table, shape, origin, voxel_size, comps, with_valid: bool):
    nx, ny, nz = shape
    g = _grid(origin, voxel_size, comps)
    g0 = [torch.floor(c) for c in g]
    f = [c - c0 for c, c0 in zip(g, g0)]
    i0 = [c0.to(torch.int64) for c0 in g0]
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


def _nearest(sval, origin, voxel_size, comps):
    shape = sval.shape
    idx = [torch.round(g).to(torch.int64) for g in _grid(origin, voxel_size, comps)]
    in_bounds = _in_range(idx, shape)
    ic = [torch.clip(i, 0, n - 1) for i, n in zip(idx, shape)]
    c = sval.reshape(-1)[(ic[0] * shape[1] + ic[1]) * shape[2] + ic[2]]
    return c, in_bounds & (c < 1.5)


def _gradient(vol: Volume, comps):
    h = vol.voxel_size

    def s(axis, sign):
        moved = [c + sign * h if k == axis else c for k, c in enumerate(comps)]
        return _trilinear(vol.tsdf, vol.shape, vol.origin, vol.voxel_size, moved, False)[0]

    g = [s(k, 1.0) - s(k, -1.0) for k in range(3)]
    n = torch.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2])
    n = torch.where(n > 1e-12, n, 1.0)
    return [c / n for c in g]


def extract_surface_points(vol: Volume, *, capacity: int) -> PointCloud:
    """Zero crossings between axis neighbours, both observed, in axis then row-major order."""
    n = vol.shape
    centers = axis_centers(vol)
    pts, taken = [], 0
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
        pts.append(torch.stack([centers[k][ijk[k]] + alpha * (vol.voxel_size if k == axis else 0.0)
                                for k in range(3)], -1))
    pts = torch.cat(pts)
    normals = torch.stack(_gradient(vol, pts.unbind(-1)), -1)
    return PointCloud(pts, normals, torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device))


# --------------------------------------------------------------- raycast

# Steps of the march evaluated together: a (STEP_CHUNK, H * W) block.
STEP_CHUNK = 24


class Model(NamedTuple):
    vertices: torch.Tensor
    normals: torch.Tensor
    valid: torch.Tensor


def raycast(vol: Volume, pose, intr, *, depth_min: float, depth_max: float, num_steps: int) -> Model:
    """The port's march: nearest-voxel signs at ``num_steps`` fixed depths,
    the first ``+ -> -`` step between observed voxels brackets the surface,
    then half a step back, three bisections and a secant on trilinear
    samples, and the normal from the TSDF gradient."""
    dev = vol.tsdf.device
    dirs_cam = ray_directions(intr, device=dev)
    h, w = dirs_cam.shape[:2]
    dirs = rotate(pose, dirs_cam.reshape(-1, 3)).reshape(h, w, 3).unbind(-1)
    origin = [pose[k, 3] for k in range(3)]
    dz = np.float32((depth_max - depth_min) / num_steps)
    zs = np.float32(depth_min) + (np.arange(num_steps, dtype=np.float32) + np.float32(1.0)) * dz
    lower = zs - dz  # the bracket's lower end at each step
    sval = _sampling_volume(vol)
    flat_dirs = [d.reshape(1, -1) for d in dirs]

    prev_val = torch.zeros((1, h * w), dtype=torch.float32, device=dev)
    prev_valid = torch.zeros((1, h * w), dtype=torch.bool, device=dev)
    bracket_z = torch.zeros(h * w, dtype=torch.float32, device=dev)
    found = torch.zeros(h * w, dtype=torch.bool, device=dev)
    for s0 in range(0, num_steps, STEP_CHUNK):
        z = torch.from_numpy(zs[s0 : s0 + STEP_CHUNK].astype(np.float64)).to(dev)[:, None]
        pts = [fma(d, z, o) for o, d in zip(origin, flat_dirs)]
        val, valid = _nearest(sval, vol.origin, vol.voxel_size, pts)
        pv = torch.cat([prev_val, val[:-1]])
        pok = torch.cat([prev_valid, valid[:-1]])
        crossing = pok & valid & (pv > 0) & (val <= 0)
        first = torch.argmax(crossing.to(torch.int32), 0)
        hit = crossing.any(0) & ~found
        low = torch.from_numpy(lower[s0 : s0 + STEP_CHUNK]).to(dev)
        bracket_z = torch.where(hit, low[first], bracket_z)
        found = found | hit
        prev_val, prev_valid = val[-1:], valid[-1:]
    bracket_z = bracket_z.reshape(h, w)
    found = found.reshape(h, w)

    def at(zz):
        return [fma(d, zz, o) for o, d in zip(origin, dirs)]

    def sample(zz):
        return _trilinear(sval, sval.shape, vol.origin, vol.voxel_size, at(zz), True)

    lo = bracket_z - float(0.5 * float(dz))
    hi = bracket_z + float(dz)
    vlo, oklo = sample(lo)
    vhi, okhi = sample(hi)
    for _ in range(3):
        mid = 0.5 * (lo + hi)
        vmid, _ = sample(mid)
        take_low = vmid > 0
        lo = torch.where(take_low, mid, lo)
        vlo = torch.where(take_low, vmid, vlo)
        hi = torch.where(take_low, hi, mid)
        vhi = torch.where(take_low, vhi, vmid)
    denom = vlo - vhi
    big = denom.abs() > 1e-9
    alpha = torch.where(oklo & okhi & big, vlo / torch.where(big, denom, 1.0), 0.5)
    hit_z = lo + torch.clip(alpha, 0.0, 1.0) * (hi - lo)
    verts = at(hit_z)
    normals = _gradient(vol, verts)
    flip = ((normals[0] * (origin[0] - verts[0]) + normals[1] * (origin[1] - verts[1]))
            + normals[2] * (origin[2] - verts[2])) < 0
    normals = [torch.where(flip, -n, n) for n in normals]
    keep = found[..., None]
    return Model(torch.where(keep, torch.stack(verts, -1), 0.0), torch.where(keep, torch.stack(normals, -1), 0.0),
                 found)


# ------------------------------------------------------------- tracking


class Settings(NamedTuple):
    """The fragment and tracker constants a configuration file states."""

    volume_shape: tuple[int, int, int]
    voxel_size: float
    volume_min_z: float
    cloud_capacity: int
    max_weight: float
    depth_min: float
    depth_max: float
    levels: int
    iterations: tuple[int, ...]
    dist_threshold: float
    ray_depth_min: float
    ray_depth_max: float
    raycast_steps: int
    raycast_scale: int
    damping: float
    min_support: float
    max_step: float
    velocity_gain: float
    prior_beta: float
    healthy_obs_ratio: float
    healthy_fitness: float


def pyramid_down(depth):
    h, w = depth.shape
    d = depth[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
    valid = (d > 0).to(depth.dtype)
    dv = d * valid
    s = (dv[:, 0, :, 0] + dv[:, 0, :, 1]) + (dv[:, 1, :, 0] + dv[:, 1, :, 1])
    c = (valid[:, 0, :, 0] + valid[:, 0, :, 1]) + (valid[:, 1, :, 0] + valid[:, 1, :, 1])
    return torch.where(c > 0, s / torch.clamp_min(c, 1.0), 0.0)


def _gn_level(depth, intr, model: Model, model_pose, model_intr, T0, iters, st: Settings):
    verts_cam = unproject(depth, intr).reshape(-1, 3)
    valid_d = (depth > 0).reshape(-1)
    mR, mt = model_pose[:3, :3], model_pose[:3, 3]
    m_verts, m_normals = model.vertices.reshape(-1, 3), model.normals.reshape(-1, 3)
    m_valid = model.valid.reshape(-1)
    eye6 = torch.eye(6, dtype=torch.float32, device=depth.device)
    T = T0
    n_ok = rmse = obs = None
    for _ in range(iters):
        p_w = prec.mm(verts_cam, T[:3, :3].T) + T[:3, 3]
        p_m = prec.mm(p_w - mt, mR)
        (u, v), in_img = project_uv(p_m[:, 0], p_m[:, 1], p_m[:, 2], model_intr)
        pix = pixel_index(u, v, model_intr)
        q, n = m_verts[pix], m_normals[pix]
        diff = p_w - q
        ok = valid_d & in_img & m_valid[pix] & ((diff * diff).sum(-1) < st.dist_threshold ** 2)
        wf = ok.to(torch.float32)
        n = torch.where(ok[:, None], n, 0.0)
        q = torch.where(ok[:, None], q, 0.0)
        r = (n * (p_w - q)).sum(-1)
        J = torch.cat([n, torch.linalg.cross(p_w, n, dim=-1)], -1)
        H = prec.mm((J * wf[:, None]).T, J)
        g = (J * (wf * r)[:, None]).sum(0)
        eps = log(compose(T, inverse(model_pose)))  # the prior pulls toward the seed
        blocks = torch.stack([H[:3, :3], H[3:, 3:]])
        ev, V = torch.linalg.eigh(blocks)
        fill = torch.clamp_min(st.prior_beta * ev[:, -1:] - ev, 0.0)
        Pb = prec.mm(V * fill[:, None, :], V.transpose(-1, -2))
        P = torch.block_diag(Pb[0], Pb[1])
        H = H + P
        g = g + prec.mm(P, eps)
        mu = st.damping * (1.0 + torch.trace(H) * f32_reciprocal(6.0))
        delta = -torch.linalg.solve_ex(H + mu * eye6, g, check_errors=False)[0]
        n_support = wf.sum()
        delta = torch.clip(delta, -st.max_step, st.max_step) * (n_support >= st.min_support).to(delta.dtype)
        T = compose(exp(delta), T)
        n_ok = n_support
        rmse = torch.sqrt((wf * r * r).sum() / torch.clamp_min(n_ok, 1.0))
        obs = ev[0][0] / torch.clamp_min(ev[0][-1], 1e-12)
    return T, n_ok, rmse, obs


def track_frame(vol: Volume, depth, init_pose, intr, st: Settings):
    """(pose, fitness, rmse, obs_ratio) of ``depth`` aligned to the volume from ``init_pose``."""
    m_intr = intr.scaled(1.0 / st.raycast_scale) if st.raycast_scale > 1 else intr
    model = raycast(vol, init_pose, m_intr, depth_min=st.ray_depth_min, depth_max=st.ray_depth_max,
                    num_steps=st.raycast_steps)
    depths, intrs = [depth], [intr]
    for _ in range(st.levels - 1):
        depths.append(pyramid_down(depths[-1]))
        intrs.append(intrs[-1].scaled(0.5))
    T = init_pose
    zero = torch.zeros((), dtype=torch.float32, device=depth.device)
    fitness, rmse, obs = zero, zero, zero + 1.0
    for lvl in range(st.levels - 1, -1, -1):
        iters = st.iterations[min(lvl, len(st.iterations) - 1)]
        T, n_ok, rmse, obs = _gn_level(depths[lvl], intrs[lvl], model, init_pose, m_intr, T, iters, st)
        if lvl == 0:
            fitness = n_ok / torch.clamp_min((depths[0] > 0).to(torch.float32).sum(), 1.0)
    return T, fitness, rmse, obs


class Fragment(NamedTuple):
    poses: torch.Tensor  # (K+1, 4, 4) the walk's own tracked poses (frame 0 = I)
    fitness: torch.Tensor  # (K+1,)
    rmse: torch.Tensor
    obs_ratio: torch.Tensor
    cloud: PointCloud  # extracted after fusing every frame at the poses the walk steps on


def _walk(depths, intr, st: Settings, given: torch.Tensor | None) -> Fragment:
    dev = depths.device
    fuse_kw = dict(max_weight=st.max_weight, depth_min=st.depth_min, depth_max=st.depth_max)
    eye = identity(device=dev)
    vol = fuse(make_volume(st.volume_shape, st.voxel_size, st.volume_min_z, dev), depths[0], eye, intr, **fuse_kw)
    v_trusted = torch.zeros(6, dtype=torch.float32, device=dev)
    T_prev = eye
    poses, fits, rmses, obss = [eye], [], [], []
    for k in range(1, depths.shape[0]):
        T_pred = compose(T_prev, exp(st.velocity_gain * v_trusted)) if st.velocity_gain > 0 else T_prev
        T, fit, rmse, obs = track_frame(vol, depths[k], T_pred, intr, st)
        lost = fit < 1e-3
        pose = torch.where(lost, T_pred, T)
        nxt = pose if given is None else given[k]
        healthy = ~lost & (obs > st.healthy_obs_ratio) & (fit > st.healthy_fitness)
        v_obs = log(compose(inverse(T_prev), nxt))
        v_trusted = torch.where(healthy, 0.8 * v_trusted + 0.2 * v_obs, v_trusted)
        vol = fuse(vol, depths[k], nxt, intr, **fuse_kw)
        T_prev = nxt
        poses.append(pose)
        fits.append(fit)
        rmses.append(rmse)
        obss.append(obs)
    one = torch.ones((), dtype=torch.float32, device=dev)
    return Fragment(torch.stack(poses), torch.stack([one] + fits), torch.stack([one * 0] + rmses),
                    torch.stack([one] + obss), extract_surface_points(vol, capacity=st.cloud_capacity))


def chain(depths, intr, st: Settings) -> Fragment:
    """A fragment from its own poses, as the program builds one."""
    return _walk(depths, intr, st, None)


def follow(depths, intr, st: Settings, given_poses: torch.Tensor) -> Fragment:
    """Each frame tracked from the state ``given_poses`` (another run's) leave
    it in: the model fused at ``given_poses[:k]``, the prediction from them;
    the cloud is the volume fused at every given pose, so it holds the fuse
    and the extraction to the given poses, and a frame's tracking is held by
    its pose alone."""
    return _walk(depths, intr, st, given_poses)
