"""Joint fragment-pose + control-lattice Gauss-Newton (FragmentOptimizer).

Counterpart of ``elasticreconstruction_tpu/elastic/slac.py``. Modes: rigid
(poses only), SLAC (poses + ONE shared lattice: depth-distortion
self-calibration, CVPR'14) and nonrigid (one lattice per fragment, ICCV'13).

The normal equations are never assembled. Each Gauss-Newton step runs a
Jacobi-preconditioned conjugate gradient whose ``J`` and ``J^T`` products are
gathers and segment sums over the flat correspondence arrays plus the
lattice's ARAP edges; the ARAP rotations are re-fitted in closed form (one
batched 3x3 SVD) once per step.

Unknown layout: z = (xi ``(NF, 6)`` pose tangents, d ``(L, M, 3)`` lattice
vertex displacement deltas); L = 1 shared lattice for rigid and SLAC, NF for
nonrigid.

On the card:

- every segment sum has a fixed order (``core/segment.py``), so a solve gives
  the same bits on every run. The vertex ids of the data rows never change
  during a solve, so they are sorted once (:func:`_precompute`) and every
  ``J^T`` product reduces rows already laid out in that order: one gather of
  ``(16 C, 3)`` values per product, no ``(C, 8, 3)`` temporary.
- the conjugate gradient runs exactly ``cfg.cg_iterations`` iterations, with
  the reference's freeze once the residual has collapsed done as tensor
  arithmetic: no value is read back to the host inside an outer step. The
  outer loop stays on the host, one step per iteration, as the reference's.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch

from ..core import se3, segment
from . import arap as _arap
from .correspondence import CorresSet
from .lattice import Lattice, embed_weights


class SlacMode(enum.Enum):
    RIGID = "rigid"
    SLAC = "slac"
    NONRIGID = "nonrigid"


class SlacConfig(NamedTuple):
    """Optimiser constants: the same fields and defaults as the JAX package's."""

    mode: SlacMode = SlacMode.SLAC
    resolution: int = 8  # lattice cells per axis (reference --resolution)
    length: float = 3.0  # lattice cube edge (reference --length)
    origin: tuple[float, float, float] = (-1.5, -1.5, 0.0)
    outer_iterations: int = 5  # GN steps (reference --iteration)
    cg_iterations: int = 48
    # Regularizer balance, dimensionless: the ARAP term's total mass is
    # arap_weight x the data term's mass (per-row weights are scaled by the
    # valid-correspondence count over the ARAP row count).
    arap_weight: float = 3.0
    # Zero-displacement prior (same scaling): pins the gauge null space of a
    # constant lattice shift, which neither the data term nor ARAP sees.
    disp_prior_weight: float = 0.3
    anchor_weight: float = 1e6  # gauge prior on fragment 0 pose
    damping: float = 1e-6
    # Point-to-plane data rows (used when the correspondences carry normals).
    point_to_plane: bool = True
    # Point-to-point admixture under point_to_plane: each data row carries the
    # weight matrix W = lambda^2 I + (1 - lambda^2) n n^T, applied as its
    # square root lambda I + (1 - lambda) n n^T inside J and J^T.
    p2p_mix: float = 0.15


class SlacState(NamedTuple):
    poses: torch.Tensor  # (NF, 4, 4)
    displacement: torch.Tensor  # (L, M, 3)


class SlacResult(NamedTuple):
    poses: torch.Tensor
    displacement: torch.Tensor  # (L, M, 3)
    lattice: Lattice
    data_rmse: torch.Tensor  # (outer,) correspondence RMSE before each step
    final_rmse: torch.Tensor


def _num_lattices(mode: SlacMode, num_fragments: int) -> int:
    return 1 if mode in (SlacMode.RIGID, SlacMode.SLAC) else num_fragments


def _lattice_of_fragment(mode: SlacMode, num_fragments: int, device="cpu") -> torch.Tensor:
    if mode in (SlacMode.RIGID, SlacMode.SLAC):
        return torch.zeros((num_fragments,), dtype=torch.int64, device=device)
    return torch.arange(num_fragments, dtype=torch.int64, device=device)


class _Problem(NamedTuple):
    """What every Gauss-Newton step of one solve shares."""

    w_p: torch.Tensor  # (C, 8) trilinear weights of the p points
    w_q: torch.Tensor
    flat_p: torch.Tensor  # (C, 8) their vertex ids in the (L * M) stacked lattices: lat_i * M + id
    flat_q: torch.Tensor
    arap_a: torch.Tensor  # (2E,) directed ARAP edges
    arap_b: torch.Tensor
    rest_e: torch.Tensor  # (2E, 3) rest edge vectors rest[b] - rest[a]
    degree: torch.Tensor  # (M,) directed edges at each vertex, both ends
    frag_plan: segment.SegmentPlan  # rows of cat(frag_i, frag_j) by fragment
    vert_plan: segment.SegmentPlan  # the 16 C (row, corner) pairs of cat(p, q) by stacked vertex
    vert_rows: torch.Tensor  # (16 C,) row of cat(p side, q side) at each sorted position
    vert_w: torch.Tensor  # (16 C,) its weight, negated on the q side, in sorted order
    arap_plan: segment.SegmentPlan  # cat(arap_b, arap_a) by vertex
    rot_plan: segment.SegmentPlan  # arap_a by vertex (the rotation fit's covariance)


def _precompute(lat: Lattice, corres: CorresSet, mode: SlacMode, nf: int) -> _Problem:
    dev = corres.p.device
    L, M = _num_lattices(mode, nf), lat.num_vertices
    ids_p, w_p = embed_weights(lat, corres.p)
    ids_q, w_q = embed_weights(lat, corres.q)
    lof = _lattice_of_fragment(mode, nf, dev)
    flat_p = lof[corres.frag_i.long()][:, None] * M + ids_p
    flat_q = lof[corres.frag_j.long()][:, None] * M + ids_q
    a, b = _arap.directed_edges(lat, dev)
    rest = lat.rest_positions(dev)
    vert_plan = segment.plan(torch.cat([flat_p.reshape(-1), flat_q.reshape(-1)]), L * M)
    signed_w = torch.cat([w_p.reshape(-1), -w_q.reshape(-1)])
    degree = np.bincount(np.concatenate([a.cpu().numpy(), b.cpu().numpy()]), minlength=M)
    return _Problem(
        w_p=w_p, w_q=w_q, flat_p=flat_p, flat_q=flat_q,
        arap_a=a, arap_b=b, rest_e=rest[b] - rest[a],
        degree=torch.from_numpy(degree.astype(np.float32)).to(dev),
        frag_plan=segment.plan(torch.cat([corres.frag_i, corres.frag_j]), nf),
        vert_plan=vert_plan,
        vert_rows=vert_plan.order // 8,
        vert_w=signed_w[vert_plan.order],
        arap_plan=segment.plan(torch.cat([b, a]), M),
        rot_plan=segment.plan(a, M),
    )


def _gather_d(z_d: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """z_d (L, M, 3), flat (C, 8) stacked-vertex ids -> (C, 8, 3)."""
    return z_d.reshape(-1, 3)[flat]


def _data_geometry(state: SlacState, corres: CorresSet, prob: _Problem):
    """Current residuals r (C, 3), world points a, b (C, 3), rotations Ri, Rj."""
    Pi = corres.p + _weigh(prob.w_p, _gather_d(state.displacement, prob.flat_p))
    Qj = corres.q + _weigh(prob.w_q, _gather_d(state.displacement, prob.flat_q))
    Ti = state.poses[corres.frag_i.long()]
    Tj = state.poses[corres.frag_j.long()]
    a = _rot(Ti[:, :3, :3], Pi) + Ti[:, :3, 3]
    b = _rot(Tj[:, :3, :3], Qj) + Tj[:, :3, 3]
    return a - b, a, b, Ti[:, :3, :3], Tj[:, :3, :3]


def _rmse(r: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mf = mask.to(torch.float32)
    return torch.sqrt((mf * (r * r).sum(-1)).sum() / mf.sum().clamp_min(1.0))


def _cross(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(x, y, dim=-1)


# Small per-row products as broadcasts and sums: ``torch.einsum`` makes them
# batched matrix-vector products, which cuBLAS runs as one slow gemv launch
# per operand.
def _weigh(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``sum_k w[c, k] g[c, k, :]``: (C, 8), (C, 8, 3) -> (C, 3)."""
    return (w[..., None] * g).sum(-2)


def _rot(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R v`` per row: (..., 3, 3), (..., 3) -> (..., 3)."""
    return (R * v[..., None, :]).sum(-1)


def _rot_t(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R^T v`` per row."""
    return (R * v[..., :, None]).sum(-2)


def _make_operators(state, corres, prob, lat, cfg, nf, L, M, update_lattice):
    """Build J, J^T, diag(J^T J) closures around the current linearisation.

    Row weighting: ``row_w = mask * corres.w`` enters the normal equations
    once (A = J^T row_w J); ``wm = sqrt(row_w)`` scales rows inside both J
    and J^T, and the data residual handed to :func:`_pcg` carries one factor
    itself (as the ARAP rows do). Point-to-plane: with normals and
    ``cfg.point_to_plane`` each data row is weighted by ``sqrt(W)`` around the
    normal transported to world, ``n_w = R_i n``, held fixed for the step.
    """
    r, a, b, Ri, Rj = _data_geometry(state, corres, prob)
    row_w = corres.mask.to(torch.float32)
    if corres.w is not None:
        row_w = row_w * corres.w
    wm = torch.sqrt(row_w)[:, None]
    p2pl = cfg.point_to_plane and corres.n is not None
    lam = cfg.p2p_mix
    if p2pl:
        nw = _rot(Ri, corres.n)  # normals to world

        def rowS(u3):
            """sqrt(W) u = lam u + (1 - lam) (n.u) n  per data row."""
            return lam * u3 + (1.0 - lam) * (u3 * nw).sum(-1, keepdim=True) * nw
    else:
        def rowS(u3):
            return u3

    cvalid = row_w.sum().clamp_min(1.0)
    n_arap_rows = prob.arap_a.shape[0]  # 2E directed edges per lattice
    w_arap = cfg.arap_weight * cvalid / (L * n_arap_rows)
    sqrt_arap = torch.sqrt(w_arap)
    w_prior = cfg.disp_prior_weight * cvalid / (L * M)
    sqrt_prior = torch.sqrt(w_prior)
    zeros_arap = torch.zeros((L, n_arap_rows, 3), dtype=torch.float32, device=r.device)
    if update_lattice:
        rots = _arap.estimate_rotations(lat, state.displacement, prob.rot_plan)  # (L, M, 3, 3)
        rest_e = prob.rest_e.to(rots.dtype)
        rot_rest = _rot(rots[:, prob.arap_a], rest_e)
        arap_r = rest_e + state.displacement[:, prob.arap_b] - state.displacement[:, prob.arap_a] - rot_rest
    else:  # the lattice stays at rest: no ARAP residual (and no rotation fit)
        arap_r = zeros_arap
    sqrt_anchor = float(np.sqrt(np.float32(cfg.anchor_weight)))
    fi, fj = corres.frag_i.long(), corres.frag_j.long()

    def J(z):
        z_xi, z_d = z  # (NF, 6), (L, M, 3)
        zi, zj = z_xi[fi], z_xi[fj]
        u = zi[:, :3] - _cross(a, zi[:, 3:]) - zj[:, :3] + _cross(b, zj[:, 3:])
        if update_lattice:
            zdp = _weigh(prob.w_p, _gather_d(z_d, prob.flat_p))
            zdq = _weigh(prob.w_q, _gather_d(z_d, prob.flat_q))
            u = u + _rot(Ri, zdp) - _rot(Rj, zdq)
            u_arap = sqrt_arap * (z_d[:, prob.arap_b] - z_d[:, prob.arap_a])
            u_prior = sqrt_prior * z_d
        else:
            u_arap, u_prior = zeros_arap, torch.zeros_like(z_d)
        return wm * rowS(u), u_arap, u_prior, sqrt_anchor * z_xi[0]

    def Jt(u, u_arap, u_prior, u_anchor):
        u = wm * rowS(u)  # sqrt(W) is symmetric
        g = torch.cat([torch.cat([u, _cross(a, u)], -1), -torch.cat([u, _cross(b, u)], -1)])
        g_xi = segment.segment_sum(g, prob.frag_plan)
        g_xi = torch.cat([g_xi[:1] + sqrt_anchor * u_anchor, g_xi[1:]])
        if not update_lattice:
            return g_xi, torch.zeros((L, M, 3), dtype=torch.float32, device=u.device)
        # R^T u on each side, spread over the 8 corners in the plan's order.
        side = torch.cat([_rot_t(Ri, u), _rot_t(Rj, u)]).T  # (3, 2C)
        g_d = segment.sum_sorted_columns(prob.vert_w * side[:, prob.vert_rows], prob.vert_plan)
        ua = sqrt_arap * u_arap  # (L, 2E, 3)
        g_arap = segment.segment_sum(torch.cat([ua, -ua], 1).movedim(1, 0), prob.arap_plan)  # (M, L, 3)
        return g_xi, g_d.reshape(L, M, 3) + g_arap.movedim(0, 1) + sqrt_prior * u_prior

    def diag():
        # Pose blocks: diag of J^T row_w W J per 6-dof block; under p2pl the
        # per-row W = lam^2 I + (1 - lam^2) n n^T makes it the same mix of the
        # point-to-point and projected terms.
        aTa = (a * a).sum(-1, keepdim=True) - a * a  # diag([a]x^T [a]x)
        bTb = (b * b).sum(-1, keepdim=True) - b * b
        if p2pl:
            mix = 1.0 - lam * lam
            t = lam * lam + mix * nw * nw
            t_i = t_j = t
            w_i = lam * lam * aTa + mix * _cross(a, nw) ** 2
            w_j = lam * lam * bTb + mix * _cross(b, nw) ** 2
        else:
            t_i = t_j = torch.ones_like(a)
            w_i, w_j = aTa, bTb
        d = torch.cat([torch.cat([t_i, w_i], -1), torch.cat([t_j, w_j], -1)]) * torch.cat([row_w, row_w])[:, None]
        d_xi = segment.segment_sum(d, prob.frag_plan)
        d_xi = torch.cat([d_xi[:1] + cfg.anchor_weight, d_xi[1:]])
        if not update_lattice:
            return d_xi + cfg.damping, torch.full((L, M, 3), 1.0 + cfg.damping, device=a.device)
        if p2pl:
            # Row wrt vertex k (p side): w_k R_i, projected diagonal
            # w_k^2 (R_i^T n_w)^2 = w_k^2 n^2; the q side through R_j^T n_w.
            nq = _rot_t(Rj, nw)
            sq = torch.cat([lam * lam + mix * corres.n ** 2, lam * lam + mix * nq ** 2])  # (2C, 3)
        else:
            sq = torch.ones((2 * a.shape[0], 3), dtype=torch.float32, device=a.device)
        w2 = prob.vert_w * prob.vert_w * torch.cat([row_w, row_w])[prob.vert_rows]
        d_d = segment.sum_sorted_columns(w2 * sq.T[:, prob.vert_rows], prob.vert_plan).reshape(L, M, 3)
        d_d = d_d + w_arap * prob.degree[None, :, None] + w_prior
        return d_xi + cfg.damping, d_d + cfg.damping

    data_rmse = _rmse(r, corres.mask)
    # Residual rows as J's row scaling produces them: every row carries
    # sqrt(row weight) in J and J^T, so the residual handed to J^T carries one
    # factor itself (data rows: wm; ARAP rows: sqrt_arap).
    residuals = (wm * rowS(r), sqrt_arap * arap_r, sqrt_prior * state.displacement,
                 torch.zeros(6, dtype=torch.float32, device=r.device))
    return J, Jt, diag, residuals, data_rmse


def _pcg(J, Jt, diag, residuals, cfg):
    """Solve (J^T J) z = -J^T r with Jacobi preconditioning, exactly
    ``cfg.cg_iterations`` iterations; updates freeze once ``r.z`` has collapsed."""
    r_data, r_arap, r_prior, r_anchor = residuals
    rhs_xi, rhs_d = Jt(-r_data, -r_arap, -r_prior, -r_anchor)
    d_xi, d_d = diag()
    inv_xi = 1.0 / d_xi.clamp_min(1e-8)
    inv_d = 1.0 / d_d.clamp_min(1e-8)

    def A(z):
        return Jt(*J(z))

    def P(g):
        return g[0] * inv_xi, g[1] * inv_d

    def dot(x, y):
        return (x[0] * y[0]).sum() + (x[1] * y[1]).sum()

    x = (torch.zeros_like(rhs_xi), torch.zeros_like(rhs_d))
    r = (rhs_xi, rhs_d)
    p = z = P(r)
    rz = dot(r, z)
    for _ in range(cfg.cg_iterations):
        Ap = A(p)
        live = (rz > 1e-20).to(torch.float32)
        alpha = rz / dot(p, Ap).clamp_min(1e-20) * live
        x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
        r = (r[0] - alpha * Ap[0], r[1] - alpha * Ap[1])
        z = P(r)
        rz_new = dot(r, z)
        beta = rz_new / rz.clamp_min(1e-20) * live
        p = (z[0] + beta * p[0], z[1] + beta * p[1])
        rz = rz_new
    return x


def _gn_outer_step(state: SlacState, corres: CorresSet, cfg: SlacConfig, num_fragments: int,
                   prob: _Problem) -> tuple[SlacState, torch.Tensor]:
    """One Gauss-Newton outer iteration: linearise, PCG, update. Returns the
    new state and the data RMSE at the old one."""
    lat = Lattice(cfg.resolution, cfg.length, cfg.origin)
    L, M = _num_lattices(cfg.mode, num_fragments), lat.num_vertices
    update_lattice = cfg.mode is not SlacMode.RIGID
    J, Jt, diag, residuals, rmse = _make_operators(
        state, corres, prob, lat, cfg, num_fragments, L, M, update_lattice
    )
    dz_xi, dz_d = _pcg(J, Jt, diag, residuals, cfg)
    poses = se3.exp(dz_xi) @ state.poses
    disp = state.displacement + dz_d if update_lattice else state.displacement
    return SlacState(poses, disp), rmse


def _data_rmse(state: SlacState, corres: CorresSet, prob: _Problem) -> torch.Tensor:
    return _rmse(_data_geometry(state, corres, prob)[0], corres.mask)


def optimize_fragments(
    init_poses: torch.Tensor,
    corres: CorresSet,
    cfg: SlacConfig = SlacConfig(),
    *,
    num_fragments: int | None = None,
    init_displacement: torch.Tensor | None = None,
) -> SlacResult:
    """Run the FragmentOptimizer: Gauss-Newton over poses (+ lattices per mode),
    on the device of ``init_poses`` (``corres`` must be there too).
    ``init_displacement`` ``(L, M, 3)`` warm-starts the lattice (the
    correspondence/optimise alternation rounds)."""
    dev = init_poses.device
    nf = num_fragments if num_fragments is not None else init_poses.shape[0]
    lat = Lattice(cfg.resolution, cfg.length, cfg.origin)
    L, M = _num_lattices(cfg.mode, nf), lat.num_vertices
    disp = (torch.zeros((L, M, 3), dtype=torch.float32, device=dev) if init_displacement is None
            else torch.as_tensor(init_displacement, dtype=torch.float32, device=dev))
    state = SlacState(init_poses.to(torch.float32), disp)
    prob = _precompute(lat, corres, cfg.mode, nf)
    rmse_hist = []
    for _ in range(cfg.outer_iterations):
        state, rmse = _gn_outer_step(state, corres, cfg, nf, prob)
        rmse_hist.append(rmse)
    return SlacResult(
        poses=se3.orthonormalize(state.poses),
        displacement=state.displacement,
        lattice=lat,
        data_rmse=torch.stack(rmse_hist) if rmse_hist else torch.zeros((0,), device=dev),
        final_rmse=_data_rmse(state, corres, prob),
    )
