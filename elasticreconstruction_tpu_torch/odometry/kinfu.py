"""Projective point-to-plane ICP against a raycast TSDF model.

Counterpart of ``elasticreconstruction_tpu/odometry/kinfu.py``: the per-frame
hot loop of fragment odometry (valid-aware depth pyramid, projective data
association against the raycast model, point-to-plane Gauss-Newton per
pyramid level with a spectral-floor motion prior). Each Gauss-Newton
iteration is a pass of plain PyTorch ops over the image plus two 3x3
eigendecompositions (one batched ``eigh``) and one 6x6 solve; nothing in it
reads a value back to the host in the port's own code. ``torch.linalg.eigh``
checks its error flag on the host on the card (one synchronisation per
iteration, counted in PERF.md); the solve uses ``solve_ex`` without the check.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import camera as cam
from ..core import se3
from ..core.types import f32_reciprocal
from ..kernels import raycast as rc
from ..kernels.tsdf import TSDFVolume


class OdometryConfig(NamedTuple):
    """Tracker constants: the same fields and defaults as the JAX package's."""

    levels: int = 3
    iterations: tuple[int, ...] = (4, 5, 10)  # indexed by level; 0 = finest
    dist_threshold: float = 0.1  # max association distance (m)
    normal_threshold: float = 0.6  # min cos(angle) between normals
    depth_min: float = 0.1
    depth_max: float = 6.0
    raycast_steps: int = 192
    # Model-map downscale: raycast the model at 1/raycast_scale resolution and
    # associate full-res pixels against it.
    raycast_scale: int = 1
    damping: float = 1e-6
    min_support: float = 50.0  # matched pixels below which the GN update is skipped
    max_step: float = 0.5  # per-iteration |delta| clamp (rad / m) — trust region
    # Velocity-extrapolation gain for the tracking seed (the trusted velocity,
    # re-estimated only on frames whose tracking is healthy).
    velocity_gain: float = 1.0
    # Spectral-floor motion prior: eigendirections of the data normal equations
    # below prior_beta * lambda_max are topped up with a prior toward the seed.
    prior_beta: float = 0.05
    # Health gates for the trusted-velocity update and for the pipeline's
    # failure detection: obs_ratio below healthy_obs_ratio means a translation
    # direction is effectively unobservable.
    healthy_obs_ratio: float = 0.005
    healthy_fitness: float = 0.5


class TrackResult(NamedTuple):
    pose: torch.Tensor  # (4, 4) camera-to-world of the tracked frame
    fitness: torch.Tensor  # matched-pixel fraction at the finest level
    rmse: torch.Tensor  # final point-to-plane RMSE (m)
    # Translation-block observability: min/max eigenvalue ratio of the final
    # finest-level H[:3,:3] (-> 0 when a translation direction is unobservable).
    obs_ratio: torch.Tensor


def pyramid_down(depth: torch.Tensor) -> torch.Tensor:
    """Halve a depth map, averaging only valid (>0) samples per 2x2 block."""
    h, w = depth.shape
    d = depth[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
    valid = (d > 0).to(depth.dtype)
    dv = d * valid
    # The reference's reduction order over the block: each row, then the two rows.
    s = (dv[:, 0, :, 0] + dv[:, 0, :, 1]) + (dv[:, 1, :, 0] + dv[:, 1, :, 1])
    c = (valid[:, 0, :, 0] + valid[:, 0, :, 1]) + (valid[:, 1, :, 0] + valid[:, 1, :, 1])
    return torch.where(c > 0, s / torch.clamp_min(c, 1.0), 0.0)


def _gn_level(
    depth: torch.Tensor,
    intr: cam.Intrinsics,
    model: rc.RaycastResult,
    model_pose: torch.Tensor,
    model_intr: cam.Intrinsics,
    T0: torch.Tensor,
    T_prior: torch.Tensor,
    iters: int,
    cfg: OdometryConfig,
):
    """Run ``iters`` GN steps at one pyramid level; returns (pose, n_ok, rmse, obs)."""
    verts_cam = cam.unproject(depth, intr).reshape(-1, 3)
    valid_d = (depth > 0).reshape(-1)
    mR = model_pose[:3, :3]
    mt = model_pose[:3, 3]
    m_verts = model.vertices.reshape(-1, 3)
    m_normals = model.normals.reshape(-1, 3)
    m_valid = model.valid.reshape(-1)
    eye6 = torch.eye(6, dtype=torch.float32, device=depth.device)
    T = T0
    n_ok = rmse = obs = None
    for _ in range(iters):
        p_w = verts_cam @ T[:3, :3].T + T[:3, 3]
        # Project into the model (raycast) camera for association.
        p_m = (p_w - mt) @ mR
        (u, v), in_img = cam.project_uv(p_m[:, 0], p_m[:, 1], p_m[:, 2], model_intr)
        pix = cam.pixel_index(u, v, model_intr)
        q = m_verts[pix]
        n = m_normals[pix]
        diff = p_w - q
        ok = valid_d & in_img & m_valid[pix] & ((diff * diff).sum(-1) < cfg.dist_threshold**2)
        # Zero the rejected pixels BEFORE any arithmetic: raycast normals of
        # invalid pixels can be NaN, and NaN * 0 = NaN would poison H.
        wf = ok.to(torch.float32)
        n = torch.where(ok[:, None], n, 0.0)
        q = torch.where(ok[:, None], q, 0.0)
        r = (n * (p_w - q)).sum(-1)
        J = torch.cat([n, torch.linalg.cross(p_w, n, dim=-1)], dim=-1)  # (N, 6)
        H = (J * wf[:, None]).T @ J
        g = (J * (wf * r)[:, None]).sum(0)
        if cfg.prior_beta > 0:
            # Spectral-floor prior: fill eigendirections below beta * lambda_max
            # up to that floor with a pull toward the seed pose.
            eps = se3.log(T @ se3.inverse(T_prior))
            blocks = torch.stack([H[:3, :3], H[3:, 3:]])
            ev, V = torch.linalg.eigh(blocks)
            fill = torch.clamp_min(cfg.prior_beta * ev[:, -1:] - ev, 0.0)
            Pb = (V * fill[:, None, :]) @ V.transpose(-1, -2)
            P = torch.block_diag(Pb[0], Pb[1])
            H = H + P
            g = g + P @ eps
            ev_t = ev[0]
        else:
            ev_t = torch.linalg.eigvalsh(H[:3, :3])
        # Trace-relative Levenberg damping keeps the system SPD, the clamp
        # bounds each step, and vanishing support freezes the pose.
        mu = cfg.damping * (1.0 + torch.trace(H) * f32_reciprocal(6.0))
        delta = -torch.linalg.solve_ex(H + mu * eye6, g, check_errors=False)[0]
        n_support = wf.sum()
        delta = torch.clip(delta, -cfg.max_step, cfg.max_step) * (n_support >= cfg.min_support).to(delta.dtype)
        T = se3.compose(se3.exp(delta), T)
        n_ok = n_support
        rmse = torch.sqrt((wf * r * r).sum() / torch.clamp_min(n_ok, 1.0))
        # Data-term translation observability (prior/damping excluded).
        obs = ev_t[0] / torch.clamp_min(ev_t[-1], 1e-12)
    return T, n_ok, rmse, obs


def track_frame(
    vol: TSDFVolume,
    depth: torch.Tensor,
    init_pose: torch.Tensor,
    intr: cam.Intrinsics,
    cfg: OdometryConfig = OdometryConfig(),
) -> TrackResult:
    """Align ``depth`` to the volume, starting from ``init_pose``.

    Raycasts the model once from ``init_pose``, then runs coarse-to-fine
    projective GN; coarser levels only shrink the data term.
    """
    m_intr = intr.scaled(1.0 / cfg.raycast_scale) if cfg.raycast_scale > 1 else intr
    model = rc.raycast(vol, init_pose, m_intr, depth_min=cfg.depth_min, depth_max=cfg.depth_max,
                       num_steps=cfg.raycast_steps)
    depths = [depth]
    intrs = [intr]
    for _ in range(cfg.levels - 1):
        depths.append(pyramid_down(depths[-1]))
        intrs.append(intrs[-1].scaled(0.5))

    T = init_pose
    zero = torch.zeros((), dtype=torch.float32, device=depth.device)
    fitness, rmse, obs = zero, zero, zero + 1.0
    for lvl in range(cfg.levels - 1, -1, -1):  # coarse -> fine
        iters = cfg.iterations[min(lvl, len(cfg.iterations) - 1)]
        T, n_ok, rmse, obs = _gn_level(depths[lvl], intrs[lvl], model, init_pose, m_intr, T, init_pose,
                                       iters, cfg)
        if lvl == 0:
            n_valid = torch.clamp_min((depths[0] > 0).to(torch.float32).sum(), 1.0)
            fitness = n_ok / n_valid
    return TrackResult(pose=T, fitness=fitness, rmse=rmse, obs_ratio=obs)
