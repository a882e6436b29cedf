"""Stage functions: the reference executables as resumable functions.

Counterpart of ``elasticreconstruction_tpu/pipeline/stages.py``: every stage,
in every ``slac_mode`` (``rigid``, ``slac``, ``nonrigid`` or ``none``).
Artifact layout mirrors the reference contracts so every stage is re-runnable
from files:

    out/fragments/cloud_bin_<f>.pcd      fragment clouds (local frame)
    out/fragments/local_<f>.log          per-frame camera-to-fragment poses
    out/fragments/fragments.log          chained fragment base poses
    out/fragments/health_<f>.json        per-fragment tracking health
    out/registration/odometry.log/.info  consecutive-fragment edges
    out/registration/odometry_suspect.txt  odometry edges not to hard-trust
    out/registration/loop.log/.info      accepted loop-closure candidates
    out/posegraph/pose.log               optimized fragment poses
    out/posegraph/kept_edges.txt         loop edges surviving the line process
    out/corres/corres_<i>_<j>.txt        harvested point pairs (--spill-corres)
    out/slac/pose_slac.log               refined fragment poses
    out/slac/ctr.txt / ctr_<f>.txt       the learned control lattice(s)
    out/slac/deformed_<f>.xyzn           lattice-warped clouds (--spill-deformed)
    out/integrate/mesh.ply               scene mesh
    out/integrate/trajectory.log         per-frame world poses
    out/integrate/ate.json               trajectory error against gt.log
    out/registration/gt.log/.info        ground-truth pair benchmark
    out/registration/registration_pr.json  loop.log scored against it

Stage functions take ``device=`` (default ``"cuda"``, which raises if no card
is present).
"""

from __future__ import annotations

import heapq
import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..core import io_logfmt, se3
from ..core.types import PointCloud, resolve_device
from ..elastic.correspondence import build_correspondences
from ..elastic.lattice import Lattice, deform
from ..elastic.slac import SlacMode, optimize_fragments
from ..eval import ate as ate_mod
from ..eval import gt_benchmark as gtb
from ..eval import registration_pr as prmod
from ..integrate import blocks as blocks_mod
from ..integrate import mesh as mesh_mod
from ..integrate.scene import (
    SceneConfig,
    integrate_frames,
    integrate_frames_scatter,
    integrate_frames_slac,
    integrate_frames_slac_scatter,
)
from ..kernels import tsdf as tsdf_mod
from ..kernels import voxel_grid
from ..odometry import build_fragment
from ..posegraph import EdgeList, optimize_pose_graph
from ..registration import (
    edge_information_batch,
    prep_fragments_batch,
    refine_edges_batch,
    register_prepped_batch,
)
from ..registration.retrieval import fragment_signatures, mutual_topk_pairs, signature_distances
from .config import PipelineConfig
from .dataset import Dataset


def _log(stage: str, msg: str, **kv) -> None:
    rec = {"stage": stage, "msg": msg, "t": round(time.time(), 3), **kv}
    print(json.dumps(rec), flush=True)


def _sync(dev: torch.device) -> None:
    """Wait for the device, so that a host clock read after it times the work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------- fragments


def run_fragments(ds: Dataset, cfg: PipelineConfig, device="cuda") -> None:
    """Fragment odometry over the dataset: ``cloud_bin_<f>.pcd``, ``local_<f>.log``,
    ``health_<f>.json`` per fragment of ``frames_per_fragment`` + 1 frames (the
    last frame overlaps the next fragment), then ``fragments.log``."""
    dev = resolve_device(device)
    out = cfg.p_fragments()
    out.mkdir(parents=True, exist_ok=True)
    K = cfg.frames_per_fragment
    nf = max(1, (len(ds) - 1) // K)
    intr = ds.intrinsics
    base = np.eye(4, dtype=np.float32)
    bases = []
    t0 = time.time()
    # The trusted body-twist velocity carries across the fragment reset:
    # camera motion is continuous.
    velocity = torch.zeros(6, dtype=torch.float32, device=dev)
    ocfg = cfg.fragment.odometry
    for f in range(nf):
        frames = ds.depth_chunk(f * K, K + 1)
        if frames.shape[0] < K + 1:  # pad final fragment (zero depth = no-op)
            pad = np.zeros((K + 1 - frames.shape[0],) + frames.shape[1:], np.float32)
            frames = np.concatenate([frames, pad])
        res = build_fragment(torch.from_numpy(frames).to(dev), intr, cfg.fragment, init_velocity=velocity)
        velocity = res.final_velocity
        cloud = res.cloud
        m = cloud.mask.cpu().numpy()
        io_logfmt.write_pcd(
            out / f"cloud_bin_{f}.pcd",
            cloud.points.cpu().numpy()[m],
            cloud.normals.cpu().numpy()[m],
        )
        local = res.local_poses.cpu().numpy()
        io_logfmt.write_log(out / f"local_{f}.log", io_logfmt.Trajectory.from_matrices(local))
        bases.append(base.copy())
        base = base @ local[K]  # overlap frame chains the next fragment
        # Tracking health: a fragment is suspect when any frame tracked
        # against effectively unobservable geometry or with poor support.
        fit = res.fitness.cpu().numpy()[1:]
        rmse = res.rmse.cpu().numpy()[1:]
        obs = res.obs_ratio.cpu().numpy()[1:]
        health = {
            "fragment": f,
            "min_fitness": float(fit.min()) if K > 0 else 1.0,
            "max_rmse": float(rmse.max()) if K > 0 else 0.0,
            "min_obs_ratio": float(obs.min()) if K > 0 else 1.0,
            "frames_unhealthy": int(
                np.sum((obs < ocfg.healthy_obs_ratio) | (fit < ocfg.healthy_fitness))
            ),
            "suspect": bool(
                np.any(obs < ocfg.healthy_obs_ratio) or np.any(fit < ocfg.healthy_fitness)
            ),
        }
        with open(out / f"health_{f}.json", "w") as hf:
            json.dump(health, hf, indent=2)
        _log("fragments", "fragment built", points=int(m.sum()), **health)
    io_logfmt.write_log(out / "fragments.log", io_logfmt.Trajectory.from_matrices(np.stack(bases)))
    _log("fragments", "done", num_fragments=nf, seconds=round(time.time() - t0, 2))


def load_fragment_health(cfg: PipelineConfig, nf: int) -> list[dict]:
    """Per-fragment tracking-health records (permissive default if absent)."""
    out = cfg.p_fragments()
    health = []
    for f in range(nf):
        p = out / f"health_{f}.json"
        if p.exists():
            with open(p) as hf:
                health.append(json.load(hf))
        else:
            health.append({"fragment": f, "suspect": False})
    return health


def clouds_to(clouds: list[PointCloud], dev: torch.device) -> list[PointCloud]:
    """numpy ``PointCloud``s (as :func:`load_fragment_clouds` gives them) as tensors on ``dev``."""
    return [PointCloud(*(torch.from_numpy(x).to(dev) for x in c)) for c in clouds]


def load_fragment_clouds(cfg: PipelineConfig) -> list[PointCloud]:
    """The fragment clouds on disk as numpy ``PointCloud``s padded to the fragment capacity."""
    out = cfg.p_fragments()
    clouds = []
    cap = cfg.fragment.cloud_capacity
    f = 0
    while (out / f"cloud_bin_{f}.pcd").exists():
        pts, nrm = io_logfmt.read_pcd(out / f"cloud_bin_{f}.pcd")
        n = min(len(pts), cap)
        points = np.zeros((cap, 3), np.float32)
        normals = np.zeros((cap, 3), np.float32)
        mask = np.zeros(cap, bool)
        points[:n] = pts[:n]
        if nrm is not None:
            normals[:n] = nrm[:n]
        mask[:n] = True
        clouds.append(PointCloud(points, normals, mask))
        f += 1
    return clouds


# ------------------------------------------------------------- registration


def _batch_generator(seed: int, start: int) -> torch.Generator:
    """The RANSAC draw source of the batch starting at pair ``start``: one
    stream per (stage seed, batch), whatever ran before it."""
    return torch.Generator().manual_seed((int(seed) << 32) ^ int(start))


def run_registration(
    cfg: PipelineConfig,
    *,
    all_pairs: bool = True,
    gate_poses: np.ndarray | None = None,
    device="cuda",
) -> dict:
    """Odometry-edge refinement + (optionally) all-pairs loop candidates.

    ``all_pairs=False`` is the odometry-chain-only configuration: loop.log
    and loop.info are written empty so downstream stages run unchanged.

    Every batch is queued on the device and results are pulled to the host
    once at the end of the stage.
    """
    dev = resolve_device(device)
    out = cfg.p_registration()
    out.mkdir(parents=True, exist_ok=True)
    clouds = load_fragment_clouds(cfg)
    nf = len(clouds)
    bases = io_logfmt.read_log(cfg.p_fragments() / "fragments.log").matrices().astype(np.float32)
    health = load_fragment_health(cfg, nf)
    t0 = time.time()

    rcfg = cfg.registration
    all_clouds = PointCloud(*(np.stack(xs) for xs in zip(*clouds)))
    prepped = prep_fragments_batch(all_clouds, rcfg, device=dev)

    # Odometry edges: the chained base poses give the init, but raw odometry
    # carries the within-fragment drift — refine every consecutive pair with
    # one batched point-to-plane ICP over the prepped fine clouds.
    idx_i = torch.arange(nf - 1, device=dev)
    idx_j = idx_i + 1
    init_T = torch.as_tensor(
        np.stack([np.linalg.inv(bases[f]) @ bases[f + 1] for f in range(nf - 1)]).astype(np.float32)
        if nf > 1 else np.zeros((0, 4, 4), np.float32),
        device=dev,
    )
    ir, infos_ref = refine_edges_batch(prepped, idx_i, idx_j, init_T, rcfg)
    # Trust region: odometry is locally reliable; reject refinements that
    # slide far from the init (planar overlaps are point-to-plane degenerate
    # and can drift unboundedly) or that matched poorly.
    delta = se3.log(ir.transform @ torch.linalg.inv(init_T))
    trust = (
        (torch.linalg.norm(delta[:, :3], dim=-1) < 0.25)
        & (torch.linalg.norm(delta[:, 3:], dim=-1) < 0.25)
        & (ir.fitness > 0.2)
    )
    That_all = torch.where(trust[:, None, None], ir.transform, init_T)
    infos_init = edge_information_batch(prepped, idx_i, idx_j, init_T, rcfg)
    trust_ok = trust.cpu().numpy()
    odo_T = That_all.cpu().numpy().astype(np.float64)
    odo_info = torch.where(trust[:, None, None], infos_ref, infos_init).cpu().numpy().astype(np.float64)
    odo_fitness = ir.fitness.cpu().numpy()
    io_logfmt.write_log(
        out / "odometry.log",
        io_logfmt.Trajectory(
            [io_logfmt.TrajectoryEntry(f, f + 1, nf, odo_T[f]) for f in range(nf - 1)]
        ),
    )
    io_logfmt.write_info(
        out / "odometry.info",
        io_logfmt.InfoFile([io_logfmt.InfoEntry(f, f + 1, nf, odo_info[f]) for f in range(nf - 1)]),
    )

    # Suspect odometry edges: an edge touching a fragment whose tracking
    # health tripped, or whose chain refinement was rejected or poorly
    # matched, cannot be hard-trusted. They are (a) recorded for the pose
    # graph to make line-process-eligible, and (b) re-registered from scratch
    # (FPFH+RANSAC, no odometry init) as additional loop candidates so the
    # graph has an independent measurement.
    suspect = [
        f
        for f in range(nf - 1)
        if health[f].get("suspect", False)
        or health[f + 1].get("suspect", False)
        or not trust_ok[f]
        or odo_fitness[f] < rcfg.min_fitness
    ]
    with open(out / "odometry_suspect.txt", "w") as sf:
        for f in suspect:
            sf.write(f"{f} {f + 1}\n")

    # Loop candidates: all non-adjacent pairs (+ suspect consecutive pairs),
    # batched through the registrar. Each fragment is prepped exactly once;
    # the pair loop only gathers prepped rows.
    pairs = [(i, j) for i in range(nf) for j in range(i + 2, nf)] if all_pairs else []
    gate_stats: dict = {}
    if all_pairs and (np.isfinite(cfg.loop_candidate_radius) or cfg.loop_gating == "drift"):
        # Fragment centroids under ``gate_poses`` (default: the odometry-chain
        # bases) — the init placement both gates reason about.
        gp = bases if gate_poses is None else np.asarray(gate_poses, np.float32)
        cent = np.zeros((nf, 3), np.float32)
        for f, c in enumerate(clouds):
            local = c.points[c.mask].mean(0) if c.mask.any() else np.zeros(3)
            cent[f] = gp[f, :3, :3] @ local + gp[f, :3, 3]
    if all_pairs and np.isfinite(cfg.loop_candidate_radius):
        # Manual radius gate, kept as an override of the derived gate below.
        pairs = [
            (i, j) for i, j in pairs if np.linalg.norm(cent[i] - cent[j]) < cfg.loop_candidate_radius
        ]
    elif all_pairs and cfg.loop_gating == "drift" and nf > 2:
        # Derived gate + content retrieval (see PipelineConfig.loop_gating).
        sus_edge = np.zeros(nf - 1, bool)
        for f in suspect:
            sus_edge[f] = True
        budget = np.where(sus_edge, cfg.drift_suspect, cfg.drift_per_fragment)
        cum_budget = np.concatenate([[0.0], np.cumsum(budget)])
        cum_sus = np.concatenate([[0], np.cumsum(sus_edge.astype(int))])
        # Overlap test: posed bounding boxes must intersect within the path's
        # drift budget + a fixed slack. AABB intersection is the overlap
        # criterion itself (centroid distance is too strict for two views of
        # one wall from different ranges) and still cuts cross-room aliased
        # pairs whose boxes hug opposite walls.
        lo_b = np.zeros((nf, 3), np.float32)
        hi_b = np.zeros((nf, 3), np.float32)
        for f, c in enumerate(clouds):
            w = (
                c.points[c.mask] @ gp[f, :3, :3].T + gp[f, :3, 3]
                if c.mask.any()
                else np.zeros((1, 3), np.float32)
            )
            lo_b[f] = w.min(0)
            hi_b[f] = w.max(0)
        admitted, suspect_path = [], set()
        for i, j in pairs:
            if j - i <= cfg.gate_near_diagonal:
                admitted.append((i, j))  # temporally local: always register
            elif cum_sus[j] - cum_sus[i] == 0:
                margin = cfg.gate_margin + (cum_budget[j] - cum_budget[i])
                if np.all(lo_b[i] - margin <= hi_b[j]) and np.all(lo_b[j] - margin <= hi_b[i]):
                    admitted.append((i, j))
            else:
                suspect_path.add((i, j))
        content: set = set()
        if suspect_path:
            sig = fragment_signatures(prepped.features, prepped.coarse.mask).cpu().numpy()
            content = mutual_topk_pairs(
                signature_distances(sig), cfg.retrieval_topk, candidates=suspect_path
            )
        gate_stats = dict(
            gate_margin=cfg.gate_margin,
            gate_admitted=len(admitted),
            gate_suspect_path=len(suspect_path),
            gate_content_admitted=len(content),
        )
        # Content-retrieved candidates get a second registration attempt with
        # independent RANSAC draws (they land in a different batch, so the
        # per-batch generator salts them): they are few, high-value (often the
        # only loop closure across a suspect stretch) and typically of
        # marginal overlap. Accepted duplicates are deduped (best fitness
        # wins) before they are written.
        pairs = admitted + sorted(content) + sorted(content)
    pairs += [(f, f + 1) for f in suspect]
    t_prep = time.time() - t0  # prep + odometry refine
    batch_results = []
    B = cfg.registration_batch
    t_first = None  # set after the first batch call returns
    n_first = 0
    t_disp0 = time.time()
    for s in range(0, len(pairs), B):
        chunk = pairs[s : s + B]
        res = register_prepped_batch(
            prepped,
            [i for i, _ in chunk],
            [j for _, j in chunk],
            _batch_generator(cfg.seed, s),
            rcfg,
            device=dev,
        )
        batch_results.append(res)  # stays on the device
        if t_first is None:
            t_first, n_first = time.time(), len(chunk)
    t_dispatch = time.time() - t_disp0  # host-side loop (ICP's exit test syncs per step)

    t_drain0 = time.time()
    results = []
    for res in batch_results:
        host = res._make(x.cpu().numpy() for x in res)  # single drain at stage end
        for b in range(len(host.i)):
            results.append(host._make(x[b] for x in host))
    t_drain = time.time() - t_drain0  # device backlog + readback

    accepted_all = [r for r in results if bool(r.success)]
    # Dedup duplicate attempts (content retries above): best fitness wins.
    best: dict = {}
    for r in accepted_all:
        k = (int(r.i), int(r.j))
        if k not in best or float(r.fitness) > float(best[k].fitness):
            best[k] = r
    accepted = [best[k] for k in sorted(best)]
    io_logfmt.write_log(
        out / "loop.log",
        io_logfmt.Trajectory(
            [
                io_logfmt.TrajectoryEntry(int(r.i), int(r.j), nf, r.transform.astype(np.float64))
                for r in accepted
            ]
        ),
    )
    io_logfmt.write_info(
        out / "loop.info",
        io_logfmt.InfoFile(
            [
                io_logfmt.InfoEntry(int(r.i), int(r.j), nf, r.information.astype(np.float64))
                for r in accepted
            ]
        ),
    )
    t_total = time.time() - t0
    stats = dict(
        pairs=len(pairs),
        accepted=len(accepted),
        odometry_edges=nf - 1,
        suspect_odometry_edges=len(suspect),
        seconds=round(t_total, 2),
        prep_seconds=round(t_prep, 2),
        # Stage-rate attribution: dispatch = the host loop over batches; drain
        # = what the device still had queued + result readback.
        dispatch_seconds=round(t_dispatch, 2),
        drain_seconds=round(t_drain, 2),
        io_seconds=round(t_total - t_prep - t_dispatch - t_drain, 2),
        pairs_per_second=round((len(pairs) + nf - 1) / max(t_total, 1e-9), 3),
        # Rate of the pair loop alone, timed from after the first batch call
        # returns (its one-time set-up excluded, its pairs too).
        pair_loop_pairs_per_second=(
            round((len(pairs) - n_first) / max(t_total - (t_first - t0), 1e-9), 3)
            if t_first is not None and len(pairs) > n_first
            else None
        ),
        **gate_stats,
    )
    _log("registration", "done", **stats)
    return stats


# ----------------------------------------------------------------- posegraph


def _gauge_consensus(
    nf: int,
    odo_T: dict,
    loops: list,
    suspect_edges: set,
    pgo_cfg,
    trans_per_suspect: float = 0.75,
) -> tuple[set, dict]:
    """Select the consistent subset of suspect-path-crossing loop edges.

    Splits the fragment chain into components at suspect edges, computes the
    component-alignment gauge each crossing loop edge implies (via healthy-only
    chains), clusters the gauges, rejects clusters whose rotation or
    translation disagrees with the full odometry chain beyond the
    per-suspect-edge budget (see ``PGOConfig`` ``gauge_*``), and returns
    (set of loop (i, j) to drop, stats).
    """
    suspect_starts = {a for a, _ in suspect_edges}
    comp = np.zeros(nf, int)
    c = 0
    for f in range(nf - 1):
        comp[f] = c
        if f in suspect_starts:
            c += 1
    comp[nf - 1] = c
    # Healthy-only chain poses (per component, rooted at its first fragment)
    # and the full chain (suspect edges included) for the rotation prior.
    cpose = [np.eye(4) for _ in range(nf)]
    fpose = [np.eye(4) for _ in range(nf)]
    for f in range(nf - 1):
        T = np.asarray(odo_T[(f, f + 1)], np.float64)
        fpose[f + 1] = fpose[f] @ T
        cpose[f + 1] = cpose[f] @ T if (f, f + 1) not in suspect_edges else np.eye(4)
    roots = {}
    for f in range(nf):
        roots.setdefault(int(comp[f]), f)

    def rot_angle(R):
        return float(np.degrees(np.arccos(np.clip((np.trace(R[:3, :3]) - 1) / 2, -1.0, 1.0))))

    by_cc = defaultdict(list)
    for i, j, T in loops:
        a, b = int(comp[i]), int(comp[j])
        if a == b:
            continue
        G = cpose[i] @ np.asarray(T, np.float64) @ np.linalg.inv(cpose[j])
        by_cc[(a, b)].append(((i, j), G))
    drop: set = set()
    stats = dict(crossing=0, dropped=0, component_pairs=0)
    for (a, b), lst in by_cc.items():
        stats["component_pairs"] += 1
        stats["crossing"] += len(lst)
        # Budgets from the number of suspect edges between the roots.
        ra, rb = roots[a], roots[b]
        lo, hi = min(ra, rb), max(ra, rb)
        n_sus = sum(1 for (x, y) in suspect_edges if lo <= x < hi)
        budget = pgo_cfg.gauge_rot_budget_base + pgo_cfg.gauge_rot_budget_per_suspect * n_sus
        t_budget = pgo_cfg.gauge_trans_budget_base + trans_per_suspect * n_sus
        # Chain-implied gauge between the same component frames: component
        # frames are their roots' local frames (cpose[root] = I), so the full
        # chain gives G_chain = inv(fpose[ra]) @ fpose[rb].
        G_chain = np.linalg.inv(fpose[ra]) @ fpose[rb]
        # Greedy clustering by SE3 distance to a representative.
        clusters: list[list] = []
        for e, G in lst:
            placed = False
            for cl in clusters:
                D = np.linalg.inv(cl[0][1]) @ G
                if (
                    np.linalg.norm(D[:3, 3]) < pgo_cfg.gauge_cluster_trans
                    and rot_angle(D) < pgo_cfg.gauge_cluster_rot
                ):
                    cl.append((e, G))
                    placed = True
                    break
            if not placed:
                clusters.append([(e, G)])
        # Reject chain-inconsistent clusters; keep the largest survivor and
        # any cluster consistent with it.
        ok_clusters = [
            cl
            for cl in clusters
            if rot_angle(np.linalg.inv(G_chain) @ cl[0][1]) <= budget
            and np.linalg.norm((np.linalg.inv(G_chain) @ cl[0][1])[:3, 3]) <= t_budget
        ]
        if not ok_clusters:
            # Nothing passes the chain priors: every crossing edge asserts a
            # component placement the chain says is impossible — aliased
            # matches. Drop them all and let the chain (and any consistent
            # edges between other component pairs) place the components.
            for e, _ in lst:
                drop.add(e)
                stats["dropped"] += 1
            continue
        winner = max(ok_clusters, key=len)
        keep = {e for e, _ in winner}
        for cl in ok_clusters:
            if cl is winner:
                continue
            D = np.linalg.inv(winner[0][1]) @ cl[0][1]
            if (
                np.linalg.norm(D[:3, 3]) < 2 * pgo_cfg.gauge_cluster_trans
                and rot_angle(D) < 2 * pgo_cfg.gauge_cluster_rot
            ):
                keep |= {e for e, _ in cl}
        for e, _ in lst:
            if e not in keep:
                drop.add(e)
                stats["dropped"] += 1
    return drop, stats


def _spanning_tree_init(
    nf: int, ii, jj, Ts, suspect_edges: set, fallback: np.ndarray
) -> np.ndarray:
    """Compose initial poses along a min-cost spanning tree from fragment 0.

    Edge costs: 1 for trusted odometry, 4 for loop edges (pairwise
    registrations are noisier than healthy tracking), 1000 for suspect
    odometry (last-resort connectivity only). Falls back to the chained
    bases for any fragment unreachable through the edge set.
    """
    adj: list[list[tuple[float, int, np.ndarray]]] = [[] for _ in range(nf)]
    for k in range(len(ii)):
        a, b, T = int(ii[k]), int(jj[k]), np.asarray(Ts[k], np.float64)
        if b - a == 1:
            cost = 1000.0 if (a, b) in suspect_edges else 1.0
        else:
            cost = 4.0
        # T maps b-local into a-local: pose_b = pose_a @ T; inverse for a<-b.
        adj[a].append((cost, b, T))
        adj[b].append((cost, a, np.linalg.inv(T)))
    dist = np.full(nf, np.inf)
    poses = [None] * nf
    poses[0] = np.asarray(fallback[0], np.float64)
    dist[0] = 0.0
    heap = [(0.0, 0)]
    while heap:
        d, a = heapq.heappop(heap)
        if d > dist[a]:
            continue
        for cost, b, T in adj[a]:
            nd = d + cost
            if nd < dist[b]:
                dist[b] = nd
                poses[b] = poses[a] @ T
                heapq.heappush(heap, (nd, b))
    out = np.stack(
        [p if p is not None else np.asarray(fallback[k], np.float64) for k, p in enumerate(poses)]
    )
    return out.astype(np.float32)


def run_posegraph(cfg: PipelineConfig, device="cuda") -> None:
    dev = resolve_device(device)
    out = cfg.p_posegraph()
    out.mkdir(parents=True, exist_ok=True)
    reg = cfg.p_registration()
    bases = io_logfmt.read_log(cfg.p_fragments() / "fragments.log").matrices().astype(np.float32)
    odo = io_logfmt.read_log(reg / "odometry.log")
    odo_info = io_logfmt.read_info(reg / "odometry.info")
    loop = io_logfmt.read_log(reg / "loop.log")
    loop_info = io_logfmt.read_info(reg / "loop.info")

    # Suspect odometry edges (flagged by tracking health or a rejected chain
    # refinement in run_registration) are not hard-trusted: they enter the
    # line process like loop edges, so a broken odometry measurement can be
    # down-weighted instead of dragging the whole graph.
    suspect_path = reg / "odometry_suspect.txt"
    suspect_edges: set[tuple[int, int]] = set()
    if suspect_path.exists():
        for line in suspect_path.read_text().splitlines():
            if line.strip():
                a, b = map(int, line.split())
                suspect_edges.add((a, b))

    # Gauge-consensus pre-filter: loop edges crossing suspect stretches are
    # clustered by the component-alignment gauge they imply; clusters that
    # disagree with the odometry chain beyond the drift budget are dropped
    # before the line process (see _gauge_consensus).
    loop_entries = list(loop.entries)
    loop_info_entries = list(loop_info.entries)
    gauge_stats: dict = {}
    if suspect_edges and loop_entries:
        nf_ = len(bases)
        odo_T = {(e.i, e.j): e.transform for e in odo.entries}
        if all((f, f + 1) in odo_T for f in range(nf_ - 1)):
            drop, gauge_stats = _gauge_consensus(
                nf_,
                odo_T,
                [(e.i, e.j, e.transform) for e in loop_entries],
                suspect_edges,
                cfg.posegraph,
                trans_per_suspect=cfg.drift_suspect,
            )
            if drop:
                keep_idx = [k for k, e in enumerate(loop_entries) if (e.i, e.j) not in drop]
                loop_entries = [loop_entries[k] for k in keep_idx]
                loop_info_entries = [loop_info_entries[k] for k in keep_idx]

    ii = [e.i for e in odo.entries] + [e.i for e in loop_entries]
    jj = [e.j for e in odo.entries] + [e.j for e in loop_entries]
    Ts = [e.transform for e in odo.entries] + [e.transform for e in loop_entries]
    # Suspect odometry edges carry downscaled information in addition to
    # being line-process-eligible: at full weight a run of mutually
    # consistent garbage chain edges outweighs the handful of genuine loop
    # edges that constrain the healthy sub-maps, and the line process then
    # prunes the truth as the outlier.
    infos = [
        e.info * (cfg.posegraph.suspect_info_scale if (e.i, e.j) in suspect_edges else 1.0)
        for e in odo_info.entries
    ] + [e.info for e in loop_info_entries]
    is_odo = [(e.i, e.j) not in suspect_edges for e in odo.entries] + [False] * len(loop_entries)
    n_odo = len(odo.entries)
    if not ii:
        # Single-fragment scene: nothing to optimize — pass the fragment base
        # pose straight through so downstream stages still run.
        io_logfmt.write_log(
            out / "pose.log", io_logfmt.Trajectory.from_matrices(bases.astype(np.float64))
        )
        (out / "kept_edges.txt").write_text("")
        _log("posegraph", "done", edges=0, loops=0, loops_kept=0, seconds=0.0)
        return
    edges = EdgeList.build(
        np.array(ii),
        np.array(jj),
        np.stack(Ts).astype(np.float32),
        np.stack(infos).astype(np.float32),
        np.array(is_odo),
        device=dev,
    )
    t0 = time.time()
    init = bases
    if suspect_edges:
        # Robust-kernel initialization: the chained-odometry init carries the
        # blind stretch's full drift, so genuine loop edges start meters off
        # and the line process zeroes them before they can pull the graph
        # together. Re-chain the init along a spanning tree that prefers
        # reliable edges, so every measurement starts within its own noise of
        # consistency.
        init = _spanning_tree_init(len(bases), ii, jj, Ts, suspect_edges, bases)
    res = optimize_pose_graph(torch.as_tensor(init, device=dev), edges, cfg.posegraph)
    poses = res.poses.cpu().numpy().astype(np.float64)
    io_logfmt.write_log(out / "pose.log", io_logfmt.Trajectory.from_matrices(poses))
    kept = res.kept.cpu().numpy()
    with open(out / "kept_edges.txt", "w") as f:
        for k in range(n_odo, len(ii)):
            if kept[k]:
                f.write(f"{ii[k]} {jj[k]}\n")
    _log(
        "posegraph",
        "done",
        edges=len(ii),
        loops=len(loop_entries),
        loops_kept=int(kept[n_odo:].sum()),
        suspect_odometry=len(suspect_edges),
        suspect_odometry_kept=int(kept[:n_odo][~np.array(is_odo[:n_odo])].sum()),
        **{f"gauge_{k}": v for k, v in gauge_stats.items()},
        seconds=round(time.time() - t0, 2),
    )


# ------------------------------------------------------- fragment optimizer


def load_harvest_inputs(cfg: PipelineConfig):
    """What the harvest of ``run_optimize`` matches: the fragment clouds (numpy),
    ``pose.log``'s poses, the edges (the odometry chain, then the loop edges the
    pose graph kept), the pairwise registration transforms and the
    viewpoint-baseline row weights (None when ``corres_baseline_weight`` is 0)."""
    clouds = load_fragment_clouds(cfg)
    poses = io_logfmt.read_log(cfg.p_posegraph() / "pose.log").matrices().astype(np.float32)
    edge_pairs = [(f, f + 1) for f in range(len(clouds) - 1)]
    kept_path = cfg.p_posegraph() / "kept_edges.txt"
    if kept_path.exists():
        seen = set(edge_pairs)
        with open(kept_path) as f:
            for line in f:
                i, j = map(int, line.split())
                # Re-registered suspect odometry pairs are consecutive and
                # already present as chain edges: skip duplicates.
                if (i, j) not in seen:
                    edge_pairs.append((i, j))
                    seen.add((i, j))

    # The reference harvests at the pairwise-refined registration transforms,
    # not the global poses (BuildCorrespondence re-runs ICP per edge): matching
    # under them keeps the global misalignment out of the matches.
    pair_T: dict = {}
    reg = cfg.p_registration()
    for name in ("odometry.log", "loop.log"):
        p = reg / name
        if p.exists():
            for e in io_logfmt.read_log(p).entries:
                pair_T[(e.i, e.j)] = e.transform.astype(np.float32)

    # Viewpoint-baseline row weights (PipelineConfig.corres_baseline_weight).
    edge_w = None
    if cfg.corres_baseline_weight > 0.0:
        edge_w = {}
        for i, j in edge_pairs:
            cosang = float(np.dot(poses[i][:3, 2], poses[j][:3, 2]))
            edge_w[(i, j)] = 1.0 + cfg.corres_baseline_weight * (1.0 - cosang)
    return clouds, poses, edge_pairs, pair_T, edge_w


def run_optimize(
    cfg: PipelineConfig, *, spill_corres: bool = False, spill_deformed: bool = False, device="cuda"
) -> dict:
    """Correspondence harvest over the kept edges, then the fragment optimiser.

    ``slac_mode="none"`` passes the pose graph's poses through to
    ``pose_slac.log`` after the harvest. The other modes run
    ``optimize_fragments`` ``cfg.corres_rounds`` times, re-harvesting between
    rounds at the refined poses and lattice with a radius shrinking by
    ``corres_distance_decay``, and write ``pose_slac.log`` and ``ctr.txt``
    (``ctr_<f>.txt`` per fragment in nonrigid mode); ``spill_deformed`` also
    writes each fragment cloud through its lattice warp. ``spill_corres``
    writes the first round's point pairs.
    """
    dev = resolve_device(device)
    out = cfg.p_slac()
    out.mkdir(parents=True, exist_ok=True)
    clouds, poses, edge_pairs, pair_T, edge_w = load_harvest_inputs(cfg)
    t0 = time.time()
    scfg = cfg.slac_config() if cfg.slac_mode != "none" else None
    lat = None if scfg is None else Lattice(scfg.resolution, scfg.length, scfg.origin)
    lof = list(range(len(clouds))) if scfg is not None and scfg.mode is SlacMode.NONRIGID else None
    clouds_dev = clouds_to(clouds, dev)
    harvest_s = []

    def harvest(cur_poses: torch.Tensor, displacement=None, max_distance=None):
        """Round 1 matches under the pairwise ICP alignments; later rounds at the
        refined global poses and the current warp, or under the pairwise
        alignments again with ``corres_reassoc_pair_transforms``."""
        _sync(dev)
        t = time.time()
        corres = build_correspondences(
            clouds_dev,
            cur_poses,
            edge_pairs,
            max_distance=cfg.corres_max_distance if max_distance is None else max_distance,
            capacity_per_edge=cfg.corres_capacity_per_edge,
            pair_transforms=pair_T if displacement is None or cfg.corres_reassoc_pair_transforms else None,
            edge_weights=edge_w,
            lattice=None if displacement is None else lat,
            displacement=displacement,
            lattice_of_fragment=lof,
        )
        _sync(dev)
        harvest_s.append(time.time() - t)
        return corres

    corres = harvest(torch.from_numpy(poses).to(dev))
    count = int(corres.count())
    if spill_corres:
        cdir = Path(cfg.out_dir) / "corres"
        cdir.mkdir(parents=True, exist_ok=True)
        cap = cfg.corres_capacity_per_edge
        m_all, p_all, q_all = (x.cpu().numpy() for x in (corres.mask, corres.p, corres.q))
        for e, (i, j) in enumerate(edge_pairs):
            rows = slice(e * cap, (e + 1) * cap)
            m = m_all[rows]
            # Spill as point pairs (the array-native analog of index pairs).
            pq = np.concatenate([p_all[rows][m], q_all[rows][m]], axis=1)
            np.savetxt(cdir / f"corres_{i}_{j}.txt", pq, fmt="%.6f")
    _log("optimize", "correspondences", count=count, edges=len(edge_pairs), seconds=harvest_s[0])

    if scfg is None:
        io_logfmt.write_log(out / "pose_slac.log", io_logfmt.Trajectory.from_matrices(poses))
        _log("optimize", "skipped (mode=none)")
        return {"mode": "none", "correspondences": count, "edges": len(edge_pairs), "harvest_seconds": harvest_s[0]}

    def round_scfg(r: int):
        """Per-round config: ARAP annealing (PipelineConfig.arap_anneal)."""
        if cfg.arap_anneal == 1.0:
            return scfg
        return scfg._replace(arap_weight=scfg.arap_weight * cfg.arap_anneal ** (cfg.corres_rounds - 1 - r))

    opt_s = []

    def optimize(r: int, init_poses, corres, init_displacement=None):
        _sync(dev)
        t = time.time()
        res = optimize_fragments(init_poses, corres, round_scfg(r), num_fragments=len(clouds),
                                 init_displacement=init_displacement)
        _sync(dev)
        opt_s.append(time.time() - t)
        return res

    res = optimize(0, torch.from_numpy(poses).to(dev), corres)
    for r in range(1, cfg.corres_rounds):
        # Re-associate at the refined state (points warped by the refined
        # lattice before the mutual-NN pass) at a tightening radius, and
        # continue from it: the ICCV'13 alternation.
        md = cfg.corres_max_distance * cfg.corres_distance_decay**r
        corres = harvest(res.poses, displacement=res.displacement, max_distance=md)
        res = optimize(r, res.poses, corres, init_displacement=res.displacement)
        _log("optimize", "alternation round", round=r + 1, corres=int(corres.count()), rmse=float(res.final_rmse))
    io_logfmt.write_log(out / "pose_slac.log",
                        io_logfmt.Trajectory.from_matrices(res.poses.cpu().numpy().astype(np.float64)))
    rest = res.lattice.rest_positions().numpy()
    disp = res.displacement.cpu().numpy()
    if scfg.mode is SlacMode.NONRIGID:
        for f in range(disp.shape[0]):
            io_logfmt.write_ctr(out / f"ctr_{f}.txt", rest + disp[f], scfg.resolution, scfg.length)
    else:
        io_logfmt.write_ctr(out / "ctr.txt", rest + disp[0], scfg.resolution, scfg.length)
    if spill_deformed:
        # Each fragment cloud through its lattice warp, fragment-local; the
        # normals are carried over unwarped (the warp is near-rigid at lattice
        # scale), as the reference's dump does.
        for f, c in enumerate(clouds_dev):
            m = c.mask.cpu().numpy()
            d = res.displacement[f if scfg.mode is SlacMode.NONRIGID else 0]
            warped = deform(res.lattice, d, c.points).cpu().numpy()
            io_logfmt.write_xyzn(out / f"deformed_{f}.xyzn", warped[m], c.normals.cpu().numpy()[m])
    stats = dict(
        mode=cfg.slac_mode,
        rmse_before=float(res.data_rmse[0]),  # of the last round, as the reference reports it
        rmse_after=float(res.final_rmse),
        seconds=round(time.time() - t0, 2),
        correspondences=count,
        edges=len(edge_pairs),
        rounds=cfg.corres_rounds,
        harvest_seconds=harvest_s,
        optimize_seconds=opt_s,
    )
    _log("optimize", "done", **stats)
    return stats


# ------------------------------------------------------------------ integrate


def _frame_world_poses(cfg: PipelineConfig):
    """(frame poses (T,4,4), fragment index per frame, local poses (T,4,4),
    fragment poses), in numpy float32 as the reference computes them."""
    frag_dir = cfg.p_fragments()
    pose_path = cfg.p_slac() / "pose_slac.log"
    if not pose_path.exists():
        pose_path = cfg.p_posegraph() / "pose.log"
    if not pose_path.exists():
        pose_path = frag_dir / "fragments.log"
    bases = io_logfmt.read_log(pose_path).matrices().astype(np.float32)
    K = cfg.frames_per_fragment
    frames, fidx, locals_ = [], [], []
    for f in range(len(bases)):
        local = io_logfmt.read_log(frag_dir / f"local_{f}.log").matrices().astype(np.float32)
        for k in range(K):  # overlap frame belongs to the next fragment
            frames.append(bases[f] @ local[k])
            fidx.append(f)
            locals_.append(local[k])
    return np.stack(frames), np.array(fidx), np.stack(locals_), bases


def _contiguous_runs(idxs: np.ndarray) -> list[tuple[int, int]]:
    """Sorted frame indices as ``[start, stop)`` runs of consecutive frames."""
    runs: list[tuple[int, int]] = []
    for k in map(int, idxs):
        if runs and runs[-1][1] == k:
            runs[-1] = (runs[-1][0], k + 1)
        else:
            runs.append((k, k + 1))
    return runs


def run_integrate(ds: Dataset, cfg: PipelineConfig, device="cuda") -> dict:
    """Scene TSDF integration + meshing over a block-grid volume.

    Scenes larger than ``scene_max_shape`` are tiled into overlapping blocks
    (``integrate/blocks.py``): each block fuses only the frames whose
    fragment surface intersects it, meshes are extracted per block, and
    owned-region filtering stitches them. Writes ``mesh.ply`` and
    ``trajectory.log``; returns the stage's numbers.
    """
    dev = resolve_device(device)
    out = cfg.p_integrate()
    out.mkdir(parents=True, exist_ok=True)
    frame_poses, fidx, local_poses, bases = _frame_world_poses(cfg)
    n = min(len(ds), len(frame_poses))
    intr = ds.intrinsics

    # Volume bounds: global + per-fragment (for per-block frame culling).
    clouds = load_fragment_clouds(cfg)
    frag_lo = np.full((len(clouds), 3), np.inf)
    frag_hi = np.full((len(clouds), 3), -np.inf)
    for f, c in enumerate(clouds):
        if not c.mask.any():
            continue
        w = c.points[c.mask] @ bases[f][:3, :3].T + bases[f][:3, 3]
        frag_lo[f] = w.min(0)
        frag_hi[f] = w.max(0)
    margin = 4 * cfg.scene_voxel_size
    lo = frag_lo.min(0) - margin
    hi = frag_hi.max(0) + margin
    want = tuple(int(np.ceil((hi[a] - lo[a]) / cfg.scene_voxel_size) + 1) for a in range(3))
    plan = blocks_mod.plan_blocks(want, cfg.scene_max_shape, overlap=cfg.scene_block_overlap)
    scfg = SceneConfig(volume_shape=plan.tile_shape, voxel_size=cfg.scene_voxel_size, origin=tuple(lo))
    _log("integrate", "volume plan", wanted=list(want), tile=list(plan.tile_shape),
         blocks=len(plan.blocks), origin=[round(v, 3) for v in lo])
    # Lattice correction when the optimiser learned one: the fragment's
    # lattice warps every frame of it.
    slac_dir = cfg.p_slac()
    use_lattice = cfg.slac_mode in ("slac", "nonrigid") and (
        (slac_dir / "ctr.txt").exists() or (slac_dir / "ctr_0.txt").exists()
    )
    if use_lattice:
        scfg_s = cfg.slac_config()
        lat = Lattice(scfg_s.resolution, scfg_s.length, scfg_s.origin)
        rest = lat.rest_positions().numpy()
        if (slac_dir / "ctr.txt").exists():
            pos, _, _ = io_logfmt.read_ctr(slac_dir / "ctr.txt")
            disp_per_frag = np.tile((pos - rest)[None], (len(bases), 1, 1)).astype(np.float32)
        else:
            disp_per_frag = np.stack([io_logfmt.read_ctr(slac_dir / f"ctr_{f}.txt")[0] - rest
                                      for f in range(len(bases))]).astype(np.float32)
        fuse_slac = integrate_frames_slac_scatter if cfg.scene_use_scatter else integrate_frames_slac
        frame_args = [torch.from_numpy(x).to(dev) for x in (
            bases[fidx[:n]], local_poses[:n], disp_per_frag[fidx[:n]])]

        def fuse(vol, depths, s, intr, scfg):
            k = slice(s, s + len(depths))
            return fuse_slac(vol, depths, *(x[k] for x in frame_args), lat, intr, scfg)
    else:
        fuse_rigid = integrate_frames_scatter if cfg.scene_use_scatter else integrate_frames
        poses_dev = torch.from_numpy(frame_poses[:n]).to(dev)

        def fuse(vol, depths, s, intr, scfg):
            return fuse_rigid(vol, depths, poses_dev[s : s + len(depths)], intr, scfg)

    chunk = 16
    multi = len(plan.blocks) > 1
    frame_lo = frag_lo[fidx[:n]]
    frame_hi = frag_hi[fidx[:n]]
    soup = []
    frames_fused = 0
    fuse_s = extract_s = 0.0
    for blk in plan.blocks:
        _sync(dev)
        t0 = time.time()
        vol = tsdf_mod.make_volume(
            plan.tile_shape, cfg.scene_voxel_size, blk.world_origin(lo, cfg.scene_voxel_size), device=dev
        )
        if multi:
            sel = blocks_mod.cull_frames(blk, plan, lo, cfg.scene_voxel_size, frame_lo, frame_hi, margin=0.5)
        else:
            sel = np.ones(n, bool)
        idxs = np.nonzero(sel)[0]
        for a, b in _contiguous_runs(idxs):
            for s in range(a, b, chunk):
                depths = torch.from_numpy(ds.depth_chunk(s, min(chunk, b - s))).to(dev)
                vol = fuse(vol, depths, s, intr, scfg)
        frames_fused += len(idxs)
        _sync(dev)
        t1 = time.time()
        tris, mask = mesh_mod.extract_mesh(vol, capacity_per_slab=cfg.mesh_capacity_per_slab)
        # Only the kept rows leave the device: the full soup is (nz-1) x capacity.
        t_np = tris[mask].cpu().numpy()
        del vol, tris, mask
        t2 = time.time()
        fuse_s += t1 - t0
        extract_s += t2 - t1
        if multi:
            t_np, m_np = blocks_mod.filter_owned_triangles(
                t_np, np.ones(len(t_np), bool), blk, plan, lo, cfg.scene_voxel_size
            )
            _log("integrate", "block", index=list(blk.index), frames=len(idxs), triangles=int(m_np.sum()))
        soup.append(t_np)
    fps = frames_fused / max(fuse_s + extract_s, 1e-9)
    _log("integrate", "fused", frames=n, frame_fusions=frames_fused, frames_per_second=round(fps, 2))

    t0 = time.time()
    all_tris = np.concatenate(soup, axis=0) if soup else np.zeros((0, 3, 3), np.float32)
    v, f = mesh_mod.weld_mesh(all_tris, np.ones(len(all_tris), bool))
    weld_s = time.time() - t0
    io_logfmt.write_ply_mesh(out / "mesh.ply", v, f)
    io_logfmt.write_log(out / "trajectory.log", io_logfmt.Trajectory.from_matrices(frame_poses[:n].astype(np.float64)))
    stats = dict(vertices=len(v), faces=len(f), frames=n, frame_fusions=frames_fused, blocks=len(plan.blocks),
                 lattice=use_lattice,
                 wanted=list(want), tile=list(plan.tile_shape), fuse_seconds=fuse_s, extract_seconds=extract_s,
                 weld_seconds=weld_s, write_seconds=time.time() - t0 - weld_s)
    _log("integrate", "done", **stats)
    return stats


# ------------------------------------------------------------------ evaluate


def run_make_gt_benchmark(ds: Dataset, cfg: PipelineConfig, device="cuda") -> None:
    """Derive the registration gt.log/gt.info pair benchmark from the dataset's
    ground-truth trajectory and the fragment clouds (``eval/gt_benchmark.py``),
    next to the registration outputs, with ``gt_benchmark_health.json``
    naming the suspect fragments whose clouds it inherits."""
    dev = resolve_device(device)
    if ds.gt_poses is None:
        raise ValueError(f"{ds.root}: the dataset has no gt.log")
    out = cfg.p_registration()
    out.mkdir(parents=True, exist_ok=True)
    rcfg = cfg.registration
    # Overlap testing needs registration-scale resolution only: full clouds
    # would make the all-pairs sweep dominate the evaluation.
    clouds = [voxel_grid.voxel_downsample(c, rcfg.icp_voxel_size, rcfg.fine_capacity)
              for c in clouds_to(load_fragment_clouds(cfg), dev)]
    frag_poses = gtb.gt_fragment_poses(ds.gt_poses, cfg.frames_per_fragment, len(clouds))
    edges, infos = gtb.make_gt_edges(
        clouds, frag_poses, max_distance=rcfg.inlier_threshold, capacity=cfg.corres_capacity_per_edge
    )
    gtb.write_gt_benchmark(out, edges, infos, len(clouds))
    health = load_fragment_health(cfg, len(clouds))
    suspects = [h["fragment"] for h in health if h.get("suspect", False)]
    with open(out / "gt_benchmark_health.json", "w") as hf:
        json.dump({"suspect_fragments": suspects, "num_fragments": len(clouds)}, hf, indent=2)
    _log("evaluate", "gt benchmark", gt_edges=len(edges), suspect_fragments=len(suspects))


def run_evaluate(ds: Dataset, cfg: PipelineConfig, device="cuda") -> dict:
    """ATE of ``trajectory.log`` against the dataset's gt.log (``ate.json``),
    and when ``loop.log`` exists, its precision/recall against the
    ground-truth pair benchmark (``registration_pr.json``), made first if
    absent. Loop proposals are scored before line-process pruning, as the
    CVPR'15 protocol does."""
    dev = resolve_device(device)
    if ds.gt_poses is None:
        raise ValueError(f"{ds.root}: the dataset has no gt.log")
    est = io_logfmt.read_log(cfg.p_integrate() / "trajectory.log").matrices().astype(np.float32)
    n = min(len(est), len(ds.gt_poses))
    res = ate_mod.absolute_trajectory_error(torch.from_numpy(est[:n]).to(dev),
                                            torch.from_numpy(ds.gt_poses[:n]).to(dev))
    metrics = {
        "ate_rmse": float(res.rmse),
        "ate_mean": float(res.mean),
        "ate_median": float(res.median),
        "ate_max": float(res.max),
        "frames": n,
    }
    with open(cfg.p_integrate() / "ate.json", "w") as f:
        json.dump(metrics, f, indent=2)

    reg = cfg.p_registration()
    if (reg / "loop.log").exists():
        if not (reg / "gt.log").exists():
            run_make_gt_benchmark(ds, cfg, device=dev)
        gt_edges, gt_infos = gtb.read_gt_benchmark(reg)
        loop = io_logfmt.read_log(reg / "loop.log")
        est_edges = [(e.i, e.j, e.transform) for e in loop.entries]
        pr = prmod.precision_recall(est_edges, gt_edges, gt_infos)
        with open(reg / "registration_pr.json", "w") as f:
            json.dump(pr, f, indent=2)
        metrics.update({"registration_precision": pr["precision"], "registration_recall": pr["recall"]})
        _log("evaluate", "registration P/R", **pr)
    _log("evaluate", "done", **metrics)
    return metrics


def run_all(ds: Dataset, cfg: PipelineConfig, device="cuda") -> dict:
    """Every stage in order; the evaluation's metrics when the dataset has a gt.log."""
    run_fragments(ds, cfg, device=device)
    run_registration(cfg, device=device)
    run_posegraph(cfg, device=device)
    run_optimize(cfg, device=device)
    run_integrate(ds, cfg, device=device)
    return run_evaluate(ds, cfg, device=device) if ds.gt_poses is not None else {}
