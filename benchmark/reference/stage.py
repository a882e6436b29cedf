"""The registration stage: ``pipeline/stages.py::run_registration`` restated on the reference's registrar.

From the fragments stage's files (``cloud_bin_<f>.pcd``, ``fragments.log``,
``health_<f>.json``) to what the stage decides and writes, at the settings the
configuration pins (``loop_gating`` "drift", no candidate radius):

- every fragment prepped once;
- the odometry edges: point-to-plane ICP of each consecutive pair from
  the chained bases' relative pose, at twice the inlier threshold, over the
  whole fine clouds in one batch; the trust region (0.25 m, 0.25 rad,
  fitness above 0.2) keeps the refined transform and its information, else
  the init and the information there;
- the suspect edges: a suspect fragment at either end, an untrusted
  refinement, or a fitness under ``min_fitness``;
- the drift gate, in the stage's own float32 numpy operations, so that the
  admitted set is the same and not merely close: near-diagonal pairs always,
  pairs over healthy paths whose posed boxes meet within the path's drift
  budget and the margin, pairs over suspect paths by content (the retrieval's
  FPFH signatures and mutual top-k, restated), those twice;
- the candidates, then the suspect edges, through the registrar in batches,
  batch ``s`` drawing from the stage's generator of (seed, s);
- accepted pairs deduplicated, the best fitness winning.

What a call of the stage left behind is read back by :func:`read_outcome`;
:func:`gaps` gives the numbers ``correct`` is decided on.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import files
from . import registration as reg
from .geometry import PointCloud, apply, log

TRUST_M = 0.25
TRUST_RAD = 0.25
TRUST_FITNESS = 0.2


class Settings(NamedTuple):
    """The stage's knobs as the configuration file pins them."""

    registration: reg.Config
    batch: int
    cloud_capacity: int
    drift_per_fragment: float
    drift_suspect: float
    gate_margin: float
    gate_near_diagonal: int
    retrieval_topk: int
    seed: int

    @staticmethod
    def of(config: dict) -> "Settings":
        if config["loop_gating"] != "drift" or config["loop_candidate_radius"] is not None:
            raise ValueError("the reference restates the drift gate with no candidate radius")
        return Settings(reg.Config(**config["registration"]), config["registration_batch"],
                        config["fragment"]["cloud_capacity"], config["drift_per_fragment"], config["drift_suspect"],
                        config["gate_margin"], config["gate_near_diagonal"], config["retrieval_topk"], config["seed"])


class Outcome(NamedTuple):
    """What the stage decided and wrote, or what a call of it left behind."""

    candidates: list | None  # pairs sent through the registrar, in order (None: the program did not say)
    counts: dict  # the gate's counts: admitted, content, pairs
    suspect: list  # suspect odometry edges (f, f + 1)
    odometry_T: np.ndarray  # (F - 1, 4, 4) float64
    odometry_info: np.ndarray  # (F - 1, 6, 6) float64
    loops: dict  # accepted (i, j) -> (T (4, 4), info (6, 6)) float64


# ------------------------------------------------------------------ files


def load(frag_dir: Path, capacity: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, list]:
    """``(points (F, C, 3), mask (F, C), bases (F, 4, 4) float32, health)`` as the stage loads them."""
    clouds = []
    while (frag_dir / f"cloud_bin_{len(clouds)}.pcd").exists():
        clouds.append(files.read_pcd(frag_dir / f"cloud_bin_{len(clouds)}.pcd")[0])
    points = np.zeros((len(clouds), capacity, 3), np.float32)
    mask = np.zeros((len(clouds), capacity), bool)
    for f, p in enumerate(clouds):
        n = min(len(p), capacity)
        points[f, :n] = p[:n]
        mask[f, :n] = True
    health = [files.read_health(frag_dir / f"health_{f}.json") if (frag_dir / f"health_{f}.json").exists()
              else {"suspect": False} for f in range(len(clouds))]
    return points, mask, files.read_log(frag_dir / "fragments.log").astype(np.float32), health


def read_records(path: Path, width: int) -> list[tuple[int, int, np.ndarray]]:
    """``(i, j, values)`` of each record of a ``.log`` (16 values) or ``.info`` (36) file."""
    tokens = Path(path).read_text().split()
    if len(tokens) % (3 + width):
        raise ValueError(f"{path}: not whole records of 3 ints and {width} floats")
    recs = np.array(tokens, dtype=object).reshape(-1, 3 + width)
    return [(int(r[0]), int(r[1]), r[3:].astype(np.float64)) for r in recs]


def read_outcome(reg_dir: Path, stats: dict) -> Outcome:
    """What a call of the stage wrote under ``reg_dir``, with the stats it returned."""
    odo = read_records(reg_dir / "odometry.log", 16)
    odo_info = read_records(reg_dir / "odometry.info", 36)
    loops = read_records(reg_dir / "loop.log", 16)
    infos = {(i, j): v.reshape(6, 6) for i, j, v in read_records(reg_dir / "loop.info", 36)}
    suspect = [tuple(int(x) for x in line.split())
               for line in (reg_dir / "odometry_suspect.txt").read_text().splitlines()]
    counts = {k: stats.get(k) for k in ("gate_admitted", "gate_content_admitted", "pairs")}
    return Outcome([tuple(p) for p in stats["candidates"]] if "candidates" in stats else None, counts, suspect,
                   np.stack([v.reshape(4, 4) for *_, v in odo]) if odo else np.zeros((0, 4, 4)),
                   np.stack([v.reshape(6, 6) for *_, v in odo_info]) if odo_info else np.zeros((0, 6, 6)),
                   {(i, j): (v.reshape(4, 4), infos.get((i, j), np.full((6, 6), np.nan))) for i, j, v in loops})


# -------------------------------------------------------------- retrieval


def fragment_signatures(features: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """L1-normalised mean of the L1-normalised FPFH rows of each fragment, ``(F, 33)``."""
    w = mask.to(torch.float32)[..., None]
    row_sum = features.abs().sum(-1, keepdim=True)
    rows = torch.where(row_sum > 1e-8, features / row_sum.clamp_min(1e-8), 0.0)
    mean = (rows * w).sum(1) / w.sum(1).clamp_min(1.0)
    tot = mean.abs().sum(-1, keepdim=True)
    return torch.where(tot > 1e-8, mean / tot.clamp_min(1e-8), 0.0)


def signature_distances(sig: np.ndarray) -> np.ndarray:
    """Chi-squared distances between signatures, float64."""
    a = np.asarray(sig, np.float64)[:, None, :]
    b = np.asarray(sig, np.float64)[None, :, :]
    return 0.5 * np.sum((a - b) ** 2 / np.maximum(a + b, 1e-12), axis=-1)


def mutual_topk_pairs(dist: np.ndarray, k: int, candidates: set) -> set:
    """Candidate pairs (i < j) that each rank among the other's ``k`` nearest, over the candidates alone."""
    f = dist.shape[0]
    allowed = np.zeros((f, f), bool)
    for i, j in candidates:
        allowed[i, j] = allowed[j, i] = True
    d = np.where(allowed, dist, np.inf)
    picks = [set(np.argsort(d[i])[: min(k, int(np.isfinite(d[i]).sum()))].tolist()) for i in range(f)]
    return {(min(i, j), max(i, j)) for i in range(f) for j in picks[i] if i in picks[j]}


# ------------------------------------------------------------------ stage


def batch_generator(seed: int, start: int) -> torch.Generator:
    """The stage's RANSAC draw source of the batch starting at pair ``start``."""
    return torch.Generator().manual_seed((int(start) + int(seed) * 0x9E3779B9) % (1 << 32))


def edge_information(fine: PointCloud, ii, jj, T, threshold: float) -> torch.Tensor:
    """Information of edges ``(ii, jj)`` at ``T``: fragment j's fine points within ``threshold`` of fragment i's."""
    fi, fj = fine.take(ii), fine.take(jj)
    p = apply(T, fj.points)
    d2, _ = reg.nearest_batch(p, fi.points, fi.mask)
    return reg.information_matrix(p, fj.mask & (d2 < threshold * threshold))


def odometry_edges(prepped: reg.Prepped, bases: np.ndarray, cfg: reg.Config):
    """``(T (E, 4, 4), info (E, 6, 6), trusted (E,), fitness (E,))`` of the consecutive pairs."""
    nf = bases.shape[0]
    dev = prepped.features.device
    ii = torch.arange(nf - 1, device=dev)
    jj = ii + 1
    init = torch.as_tensor(np.stack([np.linalg.inv(bases[f]) @ bases[f + 1] for f in range(nf - 1)])
                           .astype(np.float32), device=dev)
    wide = cfg._replace(inlier_threshold=cfg.inlier_threshold * 2)
    dead = torch.zeros(nf - 1, dtype=torch.bool, device=dev)
    T, fitness = reg.icp(prepped.fine.take(jj), prepped.fine.take(ii), init, dead, wide)
    info_refined = edge_information(prepped.fine, ii, jj, T, wide.inlier_threshold)
    delta = log(T @ torch.linalg.inv(init))
    trust = ((torch.linalg.norm(delta[:, :3], dim=-1) < TRUST_M) & (torch.linalg.norm(delta[:, 3:], dim=-1) < TRUST_RAD)
             & (fitness > TRUST_FITNESS))
    T = torch.where(trust[:, None, None], T, init)
    info_init = edge_information(prepped.fine, ii, jj, init, wide.inlier_threshold)
    info = torch.where(trust[:, None, None], info_refined, info_init)
    return T.cpu().numpy(), info.cpu().numpy(), trust.cpu().numpy(), fitness.cpu().numpy()


def drift_gate(points: np.ndarray, mask: np.ndarray, bases: np.ndarray, suspect: list, prepped: reg.Prepped,
               s: Settings) -> tuple[list, set]:
    """``(admitted, content)``: the pairs the gate admits, and those retrieval admits over suspect paths."""
    nf = points.shape[0]
    sus_edge = np.zeros(nf - 1, bool)
    sus_edge[[f for f, _ in suspect]] = True
    cum_budget = np.concatenate([[0.0], np.cumsum(np.where(sus_edge, s.drift_suspect, s.drift_per_fragment))])
    cum_sus = np.concatenate([[0], np.cumsum(sus_edge.astype(int))])
    lo = np.zeros((nf, 3), np.float32)
    hi = np.zeros((nf, 3), np.float32)
    for f in range(nf):
        w = (points[f][mask[f]] @ bases[f, :3, :3].T + bases[f, :3, 3] if mask[f].any()
             else np.zeros((1, 3), np.float32))
        lo[f], hi[f] = w.min(0), w.max(0)
    admitted, suspect_path = [], set()
    for i in range(nf):
        for j in range(i + 2, nf):
            if j - i <= s.gate_near_diagonal:
                admitted.append((i, j))
            elif cum_sus[j] == cum_sus[i]:
                margin = s.gate_margin + (cum_budget[j] - cum_budget[i])
                if np.all(lo[i] - margin <= hi[j]) and np.all(lo[j] - margin <= hi[i]):
                    admitted.append((i, j))
            else:
                suspect_path.add((i, j))
    if not suspect_path:
        return admitted, set()
    sig = fragment_signatures(prepped.features, prepped.coarse.mask).cpu().numpy()
    return admitted, mutual_topk_pairs(signature_distances(sig), s.retrieval_topk, suspect_path)


def stage(frag_dir: Path, s: Settings, device) -> Outcome:
    """The registration stage on the fragment files under ``frag_dir``."""
    points, mask, bases, health = load(Path(frag_dir), s.cloud_capacity)
    nf = points.shape[0]
    cfg = s.registration
    prepped = reg.prep(torch.from_numpy(points).to(device), torch.from_numpy(mask).to(device), cfg)
    odo_T, odo_info, trust, fitness = odometry_edges(prepped, bases, cfg)
    suspect = [(f, f + 1) for f in range(nf - 1)
               if health[f].get("suspect", False) or health[f + 1].get("suspect", False) or not trust[f]
               or fitness[f] < cfg.min_fitness]
    admitted, content = drift_gate(points, mask, bases, suspect, prepped, s) if nf > 2 else ([], set())
    pairs = admitted + sorted(content) * 2 + suspect
    best: dict = {}
    for start in range(0, len(pairs), s.batch):
        chunk = pairs[start : start + s.batch]
        r = reg.register(prepped, [i for i, _ in chunk], [j for _, j in chunk], batch_generator(s.seed, start), cfg)
        T, info, fit, ok = (x.cpu().numpy() for x in (r.transform, r.information, r.fitness, r.success))
        for k, p in enumerate(chunk):
            if ok[k] and (p not in best or float(fit[k]) > best[p][0]):
                best[p] = (float(fit[k]), T[k].astype(np.float64), info[k].astype(np.float64))
    counts = {"gate_admitted": len(admitted), "gate_content_admitted": len(content), "pairs": len(pairs)}
    return Outcome(pairs, counts, suspect, odo_T.astype(np.float64), odo_info.astype(np.float64),
                   {p: best[p][1:] for p in sorted(best)})


# ------------------------------------------------------------ comparison


def _multiset_gap(a, b) -> int:
    """Items (with their multiplicity) of one collection missing from the other."""
    count: dict = {}
    for x in a:
        count[x] = count.get(x, 0) + 1
    for x in b:
        count[x] = count.get(x, 0) - 1
    return sum(abs(n) for n in count.values())


def _pose_info_gaps(T, info, T_ref, info_ref, centroids_j) -> tuple[float, float, float]:
    """The largest (m at fragment j's centroid, rad, information relative to the reference's largest entry)."""
    if len(T) == 0:
        return 0.0, 0.0, 0.0
    place = np.einsum("kab,kb->ka", T[:, :3, :3] - T_ref[:, :3, :3], centroids_j) + (T[:, :3, 3] - T_ref[:, :3, 3])
    R = np.einsum("kba,kbc->kac", T_ref[:, :3, :3], T[:, :3, :3])
    w = 0.5 * np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]], 1)
    ang = np.arctan2(np.linalg.norm(w, axis=1), (np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0)
    scale = np.maximum(np.abs(info_ref).max(axis=(1, 2)), 1e-12)
    rel = np.abs(info - info_ref).max(axis=(1, 2)) / scale
    out = (float(np.linalg.norm(place, axis=1).max()), float(ang.max()), float(rel.max()))
    return tuple(x if math.isfinite(x) else math.inf for x in out)


def gaps(got: Outcome, ref: Outcome, centroids: np.ndarray) -> dict:
    """The numbers of one call against the reference's; each reads 0 when the two agree.

    ``centroids (F, 3)``: each fragment's centroid in its own frame, where a
    transform's gap is read (as the register cell reads it). The mismatch
    counts are pairs in one set and not the other; the admitted pairs are the
    candidate lists as multisets (the content pairs come twice), or, for a
    program whose stats do not list them, the gate's counts.
    """
    if got.candidates is not None:
        admitted = _multiset_gap(got.candidates, ref.candidates)
    else:
        admitted = sum(abs((got.counts[k] or 0) - ref.counts[k]) for k in ref.counts)
    out = {"admitted_pair_mismatches": float(admitted),
           "suspect_edge_mismatches": float(_multiset_gap(got.suspect, ref.suspect)),
           "accepted_pair_mismatches": float(_multiset_gap(got.loops, ref.loops))}
    if got.odometry_T.shape == ref.odometry_T.shape:
        j = np.arange(1, len(ref.odometry_T) + 1)
        m, rad, info = _pose_info_gaps(got.odometry_T, got.odometry_info, ref.odometry_T, ref.odometry_info,
                                       centroids[j])
    else:
        m = rad = info = math.inf
    out.update(odometry_transform_gap_m=m, odometry_transform_gap_rad=rad, odometry_information_gap=info)
    both = sorted(set(got.loops) & set(ref.loops))
    m, rad, info = _pose_info_gaps(*(np.array([side.loops[p][k] for p in both]).reshape((-1,) + shape)
                                     for side in (got, ref) for k, shape in ((0, (4, 4)), (1, (6, 6)))),
                                   centroids[[j for _, j in both]].reshape(-1, 3))
    out.update(transform_gap_m=m, transform_gap_rad=rad, information_gap=info)
    return out
