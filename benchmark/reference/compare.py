"""The numbers ``correct`` is decided on: gaps between an answer and the reference's.

Every number is a gap that reads 0 when the two agree and grows with the
disagreement; the cell's workload file gives each its limit.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def frame_gaps(T: np.ndarray, T_ref: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(translation m, rotation rad) of ``inv(T_ref) T`` for each pose of a stack."""
    T, T_ref = T.astype(np.float64), T_ref.astype(np.float64)
    R = np.einsum("kji,kjl->kil", T_ref[:, :3, :3], T[:, :3, :3])
    t = np.einsum("kji,kj->ki", T_ref[:, :3, :3], T[:, :3, 3] - T_ref[:, :3, 3])
    w = 0.5 * np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]], 1)
    ang = np.arctan2(np.linalg.norm(w, axis=1), (np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0)
    gm, gr = np.linalg.norm(t, axis=1), ang
    return np.where(np.isfinite(gm), gm, np.inf), np.where(np.isfinite(gr), gr, np.inf)


def pose_gaps(T: np.ndarray, T_ref: np.ndarray) -> dict:
    """The largest and the median translation and rotation gaps over the tracked frames (all but frame 0,
    whose gap is its distance from the identity and counts in the largest)."""
    if T.shape != T_ref.shape:
        return {k: math.inf for k in ("pose_gap_m", "pose_gap_rad", "pose_gap_median_m", "pose_gap_median_rad")}
    gm, gr = frame_gaps(T, T_ref)
    return {"pose_gap_m": float(gm.max()), "pose_gap_rad": float(gr.max()),
            "pose_gap_median_m": float(np.median(gm[1:])), "pose_gap_median_rad": float(np.median(gr[1:]))}


def cloud_gaps(a: torch.Tensor, b: torch.Tensor, *, block: int = 2048) -> dict:
    """Each point's distance to the other cloud, over both clouds (m): the mean and the median."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        gap = 0.0 if a.shape[0] == b.shape[0] else math.inf
        return {"cloud_gap_m": gap, "cloud_gap_median_m": gap}

    def one_way(q, r):
        r = r.double()
        return torch.cat([torch.cdist(q[s : s + block].double(), r).amin(1) for s in range(0, q.shape[0], block)])

    d = torch.cat([one_way(a, b), one_way(b, a)])
    return {"cloud_gap_m": float(d.mean()), "cloud_gap_median_m": float(d.median())}


def health_gap(h: dict, h_ref: dict) -> float:
    """Largest relative gap of the three health numbers; inf where the flags differ."""
    if h.get("frames_unhealthy") != h_ref["frames_unhealthy"] or h.get("suspect") != h_ref["suspect"]:
        return math.inf
    gaps = [abs(h[k] - h_ref[k]) / max(abs(h_ref[k]), 1e-12) for k in ("min_fitness", "max_rmse", "min_obs_ratio")]
    return float(max(gaps)) if all(np.isfinite(gaps)) else math.inf


def registration_gaps(T, info, fitness, success, ref, centroids_j) -> dict:
    """Gaps of one pass against the reference's, over the pairs either side accepts.

    ``T (P, 4, 4)``, ``info (P, 6, 6)``, ``fitness``/``success (P,)`` of the
    program; ``ref`` the reference's ``Result``; ``centroids_j (P, 3)`` the
    centroid of each pair's fragment j in its own frame. The transform gap is
    read where the points are: the distance by which the two transforms place
    fragment j's centroid, and the angle between their rotations.
    """
    T, info = T.double(), info.double()
    fit, ok = fitness.double(), success.bool()
    rT, rinfo, rfit, rok = ref.transform.double(), ref.information.double(), ref.fitness.double(), ref.success.bool()
    judged = ok | rok
    if not bool(judged.any()):
        return {"transform_gap_m": 0.0, "transform_gap_rad": 0.0, "fitness_gap": 0.0, "information_gap": 0.0}
    T, rT, info, rinfo, fit, rfit = T[judged], rT[judged], info[judged], rinfo[judged], fit[judged], rfit[judged]
    c = centroids_j[judged].double()
    place = ((T[:, :3, :3] - rT[:, :3, :3]) @ c[:, :, None])[..., 0] + (T[:, :3, 3] - rT[:, :3, 3])
    R = rT[:, :3, :3].transpose(1, 2) @ T[:, :3, :3]
    w = 0.5 * torch.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]], 1)
    ang = torch.atan2(w.norm(dim=-1), (R.diagonal(dim1=1, dim2=2).sum(-1) - 1.0) / 2.0)
    scale = rinfo.abs().amax(dim=(1, 2)).clamp_min(1e-12)
    out = {
        "transform_gap_m": float(place.norm(dim=-1).max()),
        "transform_gap_rad": float(ang.max()),
        "fitness_gap": float((fit - rfit).abs().max()),
        "information_gap": float(((info - rinfo).abs().amax(dim=(1, 2)) / scale).max()),
    }
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}
