"""Pair registration: prep (voxel grid, normals, FPFH), match, RANSAC, ICP, information matrix.

Frozen copies of the port's plain ``core/segment.py``, ``kernels/voxel_grid.py``,
``kernels/normals.py`` (radius variant), ``kernels/eigen33.py``,
``kernels/fpfh.py`` (radius variant), the plain version of the
nearest-neighbour kernel (``kernels/cuda/nn.py::nearest_batch_plain``: three
fused multiply-adds a pair, mirrored through float64), and
``registration/{features,ransac,icp,infomat,pair}.py``, at the commit that
introduced the benchmark, with matrix products through :mod:`.prec`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import prec
from .geometry import PointCloud, apply, compose, exp, f32_reciprocal, f32_square, hat, kabsch, make


class Config(NamedTuple):
    voxel_size: float
    icp_voxel_size: float
    coarse_capacity: int
    fine_capacity: int
    normal_radius_factor: float
    fpfh_radius_factor: float
    inlier_threshold: float
    edge_similarity: float
    num_hypotheses: int
    icp_iterations: int
    icp_src_stride: int
    icp_coarse_iterations: int
    icp_coarse_stride: int
    min_inliers: int
    min_fitness: float


class Prepped(NamedTuple):
    coarse: PointCloud
    features: torch.Tensor
    fine: PointCloud

    def take(self, index) -> "Prepped":
        return Prepped(self.coarse.take(index), self.features[index], self.fine.take(index))


class Result(NamedTuple):
    transform: torch.Tensor
    information: torch.Tensor
    num_inliers: torch.Tensor
    fitness: torch.Tensor
    success: torch.Tensor


# -------------------------------------------------------- segment sums


def _segment_sum_sorted(values, sorted_seg, num_segments):
    """Sums of ``values (N, k)`` over runs of ascending ``sorted_seg``, one component at a time."""
    bounds = torch.arange(num_segments + 1, dtype=sorted_seg.dtype, device=sorted_seg.device)
    offs = torch.searchsorted(sorted_seg, bounds)
    n = values.shape[0]
    inner = values.shape[1:]
    cols = values.reshape(n, math.prod(inner)).T.contiguous()
    k = cols.shape[0]
    starts = offs[:-1][None, :] + n * torch.arange(k, device=cols.device)[:, None]
    offsets = torch.cat([starts.reshape(-1), offs[-1:] + n * (k - 1)])
    out = torch.segment_reduce(cols.reshape(-1), "sum", offsets=offsets, unsafe=True)
    return out.reshape(k, num_segments).T.contiguous().reshape((num_segments, *inner))


# ---------------------------------------------------------- voxel grid

_AXIS_BITS = 10
_AXIS_CAP = (1 << _AXIS_BITS) - 1
_KEY_MASK = (1 << (3 * _AXIS_BITS)) - 1
_HASH_MULT = 0x9E3779B1
_INVALID_KEY = 0xFFFFFFFF


def voxel_downsample(cloud: PointCloud, voxel_size: float, capacity: int) -> PointCloud:
    points, normals, mask = cloud
    origin = torch.where(mask[:, None], points, 1e30).amin(0)
    inv = float(np.float32(1.0) / np.float32(voxel_size))
    coords = torch.floor((points - origin) * inv).to(torch.int64)
    in_range = ((coords >= 0) & (coords <= _AXIS_CAP)).all(-1)
    key = (coords[..., 0] << (2 * _AXIS_BITS)) | (coords[..., 1] << _AXIS_BITS) | coords[..., 2]
    keys = torch.where(mask & in_range, key, _INVALID_KEY)
    keys = torch.where(keys == _INVALID_KEY, keys, (keys * _HASH_MULT) & _KEY_MASK)
    skeys, order = torch.sort(keys, stable=True)
    spts, snrm = points[order], normals[order]
    valid = skeys != _INVALID_KEY
    first = torch.ones_like(valid)
    first[1:] = skeys[1:] != skeys[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    seg = torch.where(valid, seg.clamp_max(capacity), capacity)

    def ssum(x):
        return _segment_sum_sorted(x, seg, capacity + 1)[:capacity]

    psum, nsum, cnt = ssum(spts), ssum(snrm), ssum(valid.to(torch.float32))
    out_mask = cnt > 0
    denom = cnt.clamp_min(1.0)[:, None]
    mean_nrm = nsum / denom
    nrm_len = torch.linalg.norm(mean_nrm, dim=-1, keepdim=True)
    mean_nrm = mean_nrm / torch.where(nrm_len > 1e-9, nrm_len, 1.0)
    return PointCloud(torch.where(out_mask[:, None], psum / denom, 0.0),
                      torch.where(out_mask[:, None], mean_nrm, 0.0), out_mask)


# -------------------------------------------------------------- normals

_EPS = 1e-12


def smallest_eigenvector(cov):
    scale = cov.abs().amax(dim=(-2, -1)).clamp_min(_EPS)
    a = cov / scale[..., None, None]
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt((p2 / 6.0).clamp_min(0.0))
    ps = p.clamp_min(_EPS)
    c00, c11, c22 = b00 / ps, b11 / ps, b22 / ps
    c01, c02, c12 = a01 / ps, a02 / ps, a12 / ps
    half_det = 0.5 * (c00 * (c11 * c22 - c12 * c12) - c01 * (c01 * c22 - c12 * c02)
                      + c02 * (c01 * c12 - c11 * c02))
    angle = torch.acos(half_det.clamp(-1.0, 1.0)) / 3.0
    l1 = q + 2.0 * p * torch.cos(angle)
    l3 = q + 2.0 * p * torch.cos(angle + 2.0 * math.pi / 3.0)
    l2 = 3.0 * q - l1 - l3

    def shifted(lam):
        return (torch.stack([a00 - lam, a01, a02], -1), torch.stack([a01, a11 - lam, a12], -1),
                torch.stack([a02, a12, a22 - lam], -1))

    r10, r11, r12 = shifted(l1)
    m2 = torch.stack(shifted(l2), -1)
    cols = torch.stack([torch.stack([(r10 * m2[..., k]).sum(-1), (r11 * m2[..., k]).sum(-1),
                                     (r12 * m2[..., k]).sum(-1)], -1) for k in range(3)], -2)
    best = torch.argmax((cols * cols).sum(-1), -1)
    vec = torch.gather(cols, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    n = torch.sqrt((vec * vec).sum(-1, keepdim=True).clamp_min(0.0))
    ok = (n[..., 0] > 1e-20) & (p > 1e-7)
    ez = torch.zeros_like(vec)
    ez[..., 2] = 1.0
    return torch.where(ok[..., None], vec / n.clamp_min(1e-30), ez), ok


def normals_radius(cloud: PointCloud, radius: float, *, block_size: int = 1024, min_neighbors: int = 3):
    pts, _, mask = cloud
    n = pts.shape[0]
    maskf = mask.to(pts.dtype)
    center = (pts * maskf[:, None]).sum(0) / maskf.sum().clamp_min(1.0)
    p = (pts - center) * maskf[:, None]
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    src = torch.stack([x, y, z, x * x, y * y, z * z, x * y, x * z, y * z, torch.ones_like(x)], 1)
    p2 = (p * p).sum(1)
    r2 = torch.tensor(radius * radius, dtype=pts.dtype, device=pts.device)
    inf_row = torch.where(mask, 0.0, float("inf")).to(pts.dtype)
    moms = []
    for s in range(0, n, block_size):
        qb = p[s : s + block_size]
        d2 = (qb * qb).sum(1, keepdim=True) + p2[None, :] - 2.0 * prec.mm(qb, p.T)
        w = ((d2 + inf_row[None, :]) <= r2).to(pts.dtype)
        moms.append(prec.mm(w, src))
    mom = torch.cat(moms)
    s0 = mom[:, 9].clamp_min(1.0)
    mu = mom[:, 0:3] / s0[:, None]
    exx = mom[:, 3:9] / s0[:, None]
    cxx = exx[:, 0] - mu[:, 0] * mu[:, 0]
    cyy = exx[:, 1] - mu[:, 1] * mu[:, 1]
    czz = exx[:, 2] - mu[:, 2] * mu[:, 2]
    cxy = exx[:, 3] - mu[:, 0] * mu[:, 1]
    cxz = exx[:, 4] - mu[:, 0] * mu[:, 2]
    cyz = exx[:, 5] - mu[:, 1] * mu[:, 2]
    cov = torch.stack([torch.stack([cxx, cxy, cxz], -1), torch.stack([cxy, cyy, cyz], -1),
                       torch.stack([cxz, cyz, czz], -1)], -2)
    nrm, ok = smallest_eigenvector(cov)
    vp = torch.zeros(3, dtype=pts.dtype, device=pts.device)
    flip = (nrm * (vp[None, :] - pts)).sum(-1, keepdim=True) < 0
    nrm = torch.where(flip, -nrm, nrm)
    degenerate = (mom[:, 9] < min_neighbors) | ~mask | ~ok
    return PointCloud(pts, torch.where(degenerate[:, None], 0.0, nrm), mask)


# ----------------------------------------------------------------- FPFH

N_BINS = 11


def _normalize_blocks(h):
    blocks = h.reshape(h.shape[:-1] + (3, N_BINS))
    s = blocks.sum(-1, keepdim=True)
    return (blocks / s.clamp_min(1e-12) * 100.0).reshape(h.shape)


def _hist_from_cums(cums):
    s = torch.stack(cums, 1)
    return s - torch.cat([s[:, 1:], torch.zeros_like(s[:, :1])], 1)


def fpfh_radius(cloud: PointCloud, radius: float, *, block_size: int = 256):
    pts, nrm, mask = cloud
    n = pts.shape[0]
    dev = pts.device
    valid_ref = mask & ((nrm * nrm).sum(-1) > 0.25)
    inf_row = torch.where(valid_ref, 0.0, float("inf")).to(torch.float32)
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=dev)
    p2 = (pts * pts).sum(1)
    ids = torch.arange(n, device=dev)
    ts_lin = [-1.0 + i * (2.0 / N_BINS) for i in range(1, N_BINS)]
    ts_th = [-math.pi + i * (2.0 * math.pi / N_BINS) for i in range(1, N_BINS)]

    def in_radius(s):
        qb = pts[s : s + block_size]
        d2 = ((qb * qb).sum(1, keepdim=True) + p2[None, :] - 2.0 * prec.mm(qb, pts.T)).clamp_min(0.0)
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
        alpha = (v * n_q).sum(-1)
        phi = (u * dpn).sum(-1)
        x = (u * n_q).sum(-1)
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
        hists.append(torch.cat([_hist_from_cums(cums_a), _hist_from_cums(cums_p), _hist_from_cums(cums_t)], 1))
    spfh = _normalize_blocks(torch.cat(hists))
    mixed, cnt = [], []
    for s in range(0, n, block_size):
        d2, w = in_radius(s)
        inv_w = torch.where(w, torch.rsqrt(d2.clamp_min(1e-12)), 0.0)
        mixed.append(prec.mm(inv_w, spfh))
        cnt.append(w.to(torch.float32).sum(1))
    out = _normalize_blocks(spfh + torch.cat(mixed) / torch.cat(cnt).clamp_min(1.0)[:, None])
    return torch.where((mask & valid_ref)[:, None], out, 0.0)


# ------------------------------------------------------ nearest neighbour

BIG = 3.0e38


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _sqnorm(x):
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def nearest_batch(query, ref, ref_mask, *, block_q: int = 256):
    """Per batch, the nearest valid ref of each query: (d2, first index of the minimum key)."""
    b, nq, _ = query.shape
    if query.device.type == "cpu":
        block_q = max(1, (1 << 19) // (b * ref.shape[1]))
    qq = _sqnorm(query)
    w = (_sqnorm(ref) + (~ref_mask).to(torch.float32) * BIG)[:, None, :]
    r2 = (-2.0 * ref)[:, None, :, :]
    d2 = torch.empty((b, nq), dtype=torch.float32, device=query.device)
    idx = torch.empty((b, nq), dtype=torch.int64, device=query.device)
    for s in range(0, nq, block_q):
        q = query[:, s : s + block_q, None, :]
        key = _fma(q[..., 2], r2[..., 2], w)
        key = _fma(q[..., 1], r2[..., 1], key)
        key = _fma(q[..., 0], r2[..., 0], key)
        kmin, imin = key.min(dim=-1)
        d2[:, s : s + block_q] = (qq[:, s : s + block_q] + kmin).clamp_min(0.0)
        idx[:, s : s + block_q] = imin
    return d2, idx


# ------------------------------------------------- matching and RANSAC


def match_features(feat_a, mask_a, feat_b, mask_b):
    a2 = (feat_a * feat_a).sum(-1, keepdim=True)
    b2 = (feat_b * feat_b).sum(-1, keepdim=True)
    d = a2 + b2.transpose(-1, -2) - 2.0 * prec.mm(feat_a, feat_b.transpose(-1, -2))
    inf = float("inf")
    d = torch.where(mask_b[..., None, :], d, inf)
    best_b = torch.argmin(d, -1)
    valid = mask_a & torch.isfinite(torch.gather(d, -1, best_b[..., None])[..., 0])
    ia = torch.arange(feat_a.shape[-2], device=feat_a.device).expand(best_b.shape)
    best_a = torch.argmin(torch.where(mask_a[..., :, None], d, inf), -2)
    valid &= torch.gather(best_a, -1, best_b) == ia
    return torch.stack([ia, best_b], -1), valid


def _triangle_align(sa, sb):
    def frame(p):
        u = p[..., 1, :] - p[..., 0, :]
        e1 = u / torch.linalg.norm(u, dim=-1, keepdim=True).clamp_min(1e-12)
        v = p[..., 2, :] - p[..., 0, :]
        v = v - (v * e1).sum(-1, keepdim=True) * e1
        e2 = v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-12)
        return torch.stack([e1, e2, torch.linalg.cross(e1, e2, dim=-1)], -1)

    rot = prec.mm(frame(sb), frame(sa).transpose(-1, -2))
    t = sb.mean(-2) - prec.mm(rot, sa.mean(-2)[..., None])[..., 0]
    return make(rot, t)


def ransac(pts_a, pts_b, corr, corr_mask, generator, cfg: Config):
    """(transform, num_inliers) of each pair's best hypothesis, polished twice on its inliers."""
    bsz, c = corr_mask.shape
    dev = pts_a.device
    thr2 = f32_square(cfg.inlier_threshold)
    a = torch.gather(pts_a, 1, corr[..., 0][..., None].expand(-1, -1, 3))
    b = torch.gather(pts_b, 1, corr[..., 1][..., None].expand(-1, -1, 3))
    draws = torch.randint(0, 1 << 30, (bsz, cfg.num_hypotheses, 3), generator=generator).to(dev)
    num_h = draws.shape[1]
    order = torch.sort((~corr_mask).to(torch.int32), dim=-1, stable=True)[1]
    n_valid_c = corr_mask.to(torch.int64).sum(-1).clamp_min(1)
    samp = torch.gather(order, 1, (draws % n_valid_c[:, None, None]).reshape(bsz, -1)).reshape(bsz, num_h, 3)

    def take(x, ix):
        return torch.gather(x, 1, ix.reshape(bsz, -1, 1).expand(-1, -1, 3)).reshape(ix.shape + (3,))

    sa, sb = take(a, samp), take(b, samp)
    ii, jj = torch.triu_indices(3, 3, offset=1, device=dev)
    ea = torch.linalg.norm(sa[..., ii, :] - sa[..., jj, :], dim=-1)
    eb = torch.linalg.norm(sb[..., ii, :] - sb[..., jj, :], dim=-1)
    compatible = (torch.minimum(ea, eb) / torch.maximum(ea, eb).clamp_min(1e-9) > cfg.edge_similarity).all(-1)
    compatible &= torch.gather(corr_mask, 1, samp.reshape(bsz, -1)).reshape(samp.shape).all(-1)
    T = _triangle_align(sa, sb)
    R, t = T[..., :3, :3], T[..., :3, 3]
    s_c = (a * a).sum(-1) + (b * b).sum(-1)
    t2 = (t * t).sum(-1)
    rt = prec.mm(R.transpose(-1, -2), t[..., None])[..., 0]
    ab = (b[..., :, None] * a[..., None, :]).reshape(bsz, c, 9)
    lhs = torch.cat([t, rt, R.reshape(bsz, num_h, 9)], -1)
    rhs = torch.cat([-b, a, -ab], -1)
    err2 = s_c[:, None, :] + t2[:, :, None] + 2.0 * prec.mm(lhs, rhs.transpose(-1, -2))
    score = ((err2 < thr2) & corr_mask[:, None, :]).sum(-1) * compatible
    del err2
    best = torch.argmax(score, -1)
    ar = torch.arange(bsz, device=dev)
    best_T, best_score = T[ar, best], score[ar, best]

    def inliers(T_, gate):
        return (((apply(T_, a) - b) ** 2).sum(-1) < thr2) & corr_mask & gate[:, None]

    best_inl = inliers(best_T, best_score > 0)
    for _ in range(2):
        any_inl = best_inl.any(-1)
        best_T = torch.where(any_inl[:, None, None], kabsch(a, b, best_inl.to(a.dtype)), best_T)
        best_inl = inliers(best_T, any_inl)
    return best_T, best_inl.to(torch.int32).sum(-1)


# ------------------------------------------------------------------ ICP

_TOL2 = 1e-10
_HOPELESS_FITNESS = 0.05
_PROBE_ITERS = 5


def _icp_step(src_pts, src_mask, dst: PointCloud, T, max_dist, damping=1e-6):
    p = apply(T, src_pts)
    src_w = src_mask.to(p.dtype)
    d2, idx = nearest_batch(p, dst.points, dst.mask)
    ix = idx[..., None].expand(-1, -1, 3)
    q = torch.gather(dst.points, 1, ix)
    n = torch.gather(dst.normals, 1, ix)
    w = src_w * (d2 < f32_square(max_dist)).to(p.dtype)
    r = (n * (p - q)).sum(-1)
    J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], -1)
    H = prec.einsum("bni,bnj->bij", J * w[..., None], J)
    g = prec.einsum("bni,bn->bi", J, w * r)
    n_in = w.sum(-1)
    tr_h = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
    H = H + (damping * (1.0 + tr_h / 6.0))[:, None, None] * torch.eye(6, dtype=H.dtype, device=H.device)
    delta = -torch.linalg.solve(H, g[..., None])[..., 0]
    delta = delta.clamp(-1.0, 1.0) * (n_in >= 6.0).to(delta.dtype)[:, None]
    return compose(exp(delta), T), delta, n_in


def icp(src: PointCloud, dst: PointCloud, init, dead, cfg: Config):
    """(transform, fitness) of batched point-to-plane ICP with the port's early exit."""
    b, dev = init.shape[0], init.device

    def phase(src_pts, src_mask, max_iters, T):
        n_src = src_mask.to(torch.float32).sum(-1).clamp_min(1.0)
        n_in = torch.zeros(b, dtype=torch.float32, device=dev)
        for it in range(max_iters):
            T, delta, n_in = _icp_step(src_pts, src_mask, dst, T, cfg.inlier_threshold)
            converged = (delta * delta).sum(-1) <= _TOL2
            hopeless = ((n_in / n_src < _HOPELESS_FITNESS) & (it + 1 >= min(_PROBE_ITERS, max_iters))) | dead
            if not bool((~(converged | hopeless)).any()):
                break
        return T, n_in / n_src

    T = init
    if cfg.icp_coarse_iterations > 0 and cfg.icp_coarse_stride > 1:
        T, _ = phase(src.points[:, :: cfg.icp_coarse_stride].contiguous(),
                     src.mask[:, :: cfg.icp_coarse_stride].contiguous(), cfg.icp_coarse_iterations, T)
    return phase(src.points, src.mask, cfg.icp_iterations, T)


def information_matrix(points, mask):
    w = mask.to(points.dtype)
    k = hat(points)
    eye = torch.eye(3, dtype=points.dtype, device=points.device).expand(k.shape)
    G = torch.cat([eye, -k], -1)
    return prec.einsum("...nij,...nik,...n->...jk", G, G, w)


# ------------------------------------------------------------- the stage


def prep(points, mask, cfg: Config) -> Prepped:
    """Both scales of every fragment of ``points (F, N, 3)`` whose rows ``mask (F, N)`` holds."""
    coarse, feats, fine = [], [], []
    for f in range(points.shape[0]):
        cloud = PointCloud(points[f], torch.zeros_like(points[f]), mask[f])
        ds = normals_radius(voxel_downsample(cloud, cfg.voxel_size, cfg.coarse_capacity),
                            cfg.voxel_size * cfg.normal_radius_factor)
        feats.append(fpfh_radius(ds, cfg.voxel_size * cfg.fpfh_radius_factor))
        coarse.append(ds)
        fine.append(normals_radius(voxel_downsample(cloud, cfg.icp_voxel_size, cfg.fine_capacity),
                                   cfg.icp_voxel_size * cfg.normal_radius_factor))

    def stack(cs):
        return PointCloud(*(torch.stack(xs) for xs in zip(*cs)))

    return Prepped(stack(coarse), torch.stack(feats), stack(fine))


def register(prepped: Prepped, ii, jj, generator, cfg: Config) -> Result:
    """Pairs ``(ii[k], jj[k])``: the transform maps fragment j into fragment i's frame."""
    dev = prepped.features.device
    ii = torch.as_tensor(ii, device=dev).to(torch.int64)
    jj = torch.as_tensor(jj, device=dev).to(torch.int64)
    pi, pj = prepped.take(ii), prepped.take(jj)
    corr, corr_mask = match_features(pj.features, pj.coarse.mask, pi.features, pi.coarse.mask)
    T0, n_inl = ransac(pj.coarse.points, pi.coarse.points, corr, corr_mask, generator, cfg)
    src = PointCloud(*(x[:, :: cfg.icp_src_stride] for x in pj.fine)) if cfg.icp_src_stride > 1 else pj.fine
    T, fitness = icp(src, pi.fine, T0, n_inl < cfg.min_inliers, cfg)
    p = apply(T, pj.fine.points)
    d2, _ = nearest_batch(p, pi.fine.points, pi.fine.mask)
    thr = cfg.inlier_threshold
    info = information_matrix(p, pj.fine.mask & (d2 < thr * thr))
    success = (n_inl >= cfg.min_inliers) & (fitness >= cfg.min_fitness) & torch.isfinite(T).all(-1).all(-1)
    return Result(T, info, n_inl, fitness, success)
