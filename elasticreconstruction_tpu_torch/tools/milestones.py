"""The milestone-config ladder on livingroom-scale synthetic data, on the card.

Counterpart of the repository's root ``milestones.py``: the same configs in
the same order, on synthetic stand-ins the port renders itself at the
reference's production scale (2550 frames, 51 fragments of K = 50, 320x240
depth with 1% multiplicative noise, full-orbit loop-closing trajectories),
with the same flags and defaults and the same record keys, so that its
results file compares line by line with ``milestones.json``:

  2.  ``config2_odometry_chain``: the first 10 fragments, odometry edges only
  3.  ``config3_full_rigid``: every stage, all-pairs registration run cold and
      warm in one process, ATE and registration P/R
  4.  ``config4_slac`` / ``config4_nonrigid``: config 3's artifacts through
      the fragment optimiser
  4d. ``config4_slac_distorted``: the orbit rendered through an injected depth
      distortion; rigid against slac, the learned lattice scored against it
  4s. ``config4_slac_survey``: the same on the survey trajectory
  4n. ``config4_nonrigid_deformed``: config 3's fragment clouds through known
      per-fragment warps; rigid against nonrigid
  3d. ``config3_degenerate``: the bare -z wall; tracking health and the
      repair path
  5.  ``config5_office`` / ``config5_livingroom2``: two more scenes, and
      ``config5_ring4seq``: every sequence's fragments through the
      registration ring (``tools/ring_scale.py``)

Every config is a module-level function ``(root, args, device)``. A config
that fails is recorded with its error and the ladder goes on; an error that
leaves the CUDA context unusable (an illegal address, a launch failure, an
ECC error) re-executes the ladder with ``--resume``, which skips configs
done (or failed twice) and reuses datasets and stage artifacts on disk.

    python -m elasticreconstruction_tpu_torch.tools.milestones [--only config3_full_rigid,...] [--resume]

Runs on ``--device`` (default ``cuda``). Writes ``--results`` (default
``milestones_gpu.json``) after each config, and its datasets and artifacts
under ``--out`` (default ``milestone_runs_gpu``, so that neither the
reference's ``milestones.json`` nor its ``milestone_runs/`` is touched).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from ..core import camera as cam
from ..core import io_logfmt
from ..core.types import resolve_device
from ..elastic.lattice import Lattice, deform
from ..elastic.slac import SlacConfig
from ..eval import ate as ate_mod
from ..eval.lattice_recovery import lattice_recovery
from ..eval.surface_error import surface_error
from ..odometry.fragments import FragmentConfig
from ..odometry.kinfu import OdometryConfig
from ..pipeline import stages
from ..pipeline.config import PipelineConfig
from ..pipeline.dataset import Dataset, generate_synthetic
from ..registration.pair import RegistrationConfig
from ..synthetic import distortion as dist_mod
from ..synthetic import scenes as scenes_mod
from ..synthetic import warps as warps_mod

INTR = cam.Intrinsics(fx=262.5, fy=262.5, cx=159.5, cy=119.5, width=320, height=240)
# Substrings of errors after which the process's CUDA context is unusable.
CRASH_MARKERS = ("illegal memory access", "illegal address", "unspecified launch failure", "ecc error",
                 "cudaerror 700", "cudaerror 719", "cudaerror 214")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="elasticreconstruction_tpu_torch.tools.milestones")
    ap.add_argument("--frames", type=int, default=2550)
    ap.add_argument("--frames-scenes", type=int, default=1000)
    ap.add_argument("--out", default="milestone_runs_gpu", help="datasets and stage artifacts")
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--only", default="", help="comma list of config keys to run (default all)")
    ap.add_argument("--resume", action="store_true", help="continue from an existing results file")
    ap.add_argument("--fragment-volume", type=int, default=128)
    ap.add_argument("--fragment-voxel", type=float, default=0.024)
    ap.add_argument("--scene-voxel", type=float, default=0.03)
    ap.add_argument("--raycast-steps", type=int, default=96)
    ap.add_argument("--raycast-scale", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="torch device the ladder runs on")
    ap.add_argument("--results", default="milestones_gpu.json", help="the results file")
    # Not flags: the ladder's camera, fragment length, fragment cloud capacity,
    # stage preset and the angle its trajectories sweep (2 pi closes the loop).
    # Tests set them on the parsed namespace to run the ladder at toy size
    # ("fast": the CLI's reduced registration and optimiser); a cut in depth
    # renders the first frames of the full orbit with sweep 2 pi * frames / 2550.
    ap.set_defaults(intr=INTR, frames_per_fragment=50, cloud_capacity=1 << 16, preset="full",
                    sweep=2.0 * np.pi)
    return ap


def make_cfg(args, data: Path, out: Path, **kw) -> PipelineConfig:
    """The ladder's configuration (``milestones.py:143-161``), rigid (``slac_mode="none"``)."""
    K, fv = args.frames_per_fragment, args.fragment_volume
    fast = args.preset == "fast"
    cfg = PipelineConfig(
        data_dir=str(data),
        out_dir=str(out),
        frames_per_fragment=K,
        fragment=FragmentConfig(
            frames_per_fragment=K,
            volume_shape=(fv, fv, fv),
            voxel_size=args.fragment_voxel,
            cloud_capacity=args.cloud_capacity,
            odometry=OdometryConfig(raycast_steps=args.raycast_steps, raycast_scale=args.raycast_scale),
        ),
        slac_mode="none",
        scene_voxel_size=args.scene_voxel,
        registration_batch=16,
    )
    if fast:
        cfg = replace(
            cfg,
            registration=RegistrationConfig(coarse_capacity=2048, fine_capacity=4096, num_hypotheses=1024),
            slac=SlacConfig(resolution=6, cg_iterations=24, outer_iterations=3),
            corres_capacity_per_edge=2048,
        )
    return replace(cfg, **kw)


def gen(args, data: Path, device, *, frames: int, scene: str, radius: float, distortion=None,
        trajectory: str = "orbit") -> Dataset:
    """The dataset under ``data``, rendered first unless it holds ``frames`` frames."""
    if not (data / "gt.log").exists() or len(list((data / "depth").glob("*.png"))) < frames:
        print(json.dumps({"stage": "generate", "dir": str(data), "frames": frames}), flush=True)
        generate_synthetic(
            data, num_frames=frames, intr=args.intr, scene=scene, trajectory=trajectory, radius=radius,
            height=1.3, sweep=args.sweep, seed=0, depth_noise=args.noise, distortion=distortion,
            device=device,
        )
    return Dataset(data)


def main_dataset(root: Path, args, device) -> Dataset:
    return gen(args, root / "data", device, frames=args.frames, scene="livingroom", radius=1.1)


def base_cfg(root: Path, args) -> PipelineConfig:
    return make_cfg(args, root / "data", root / "out_full")


def frag_pose_ate(cfg: PipelineConfig, ds: Dataset, device, pose_file: str = "pose_slac.log") -> dict:
    """ATE of the optimised fragment base poses against the ground-truth poses
    of the fragments' first frames."""
    est = io_logfmt.read_log(Path(cfg.out_dir) / "slac" / pose_file).matrices()
    gt = ds.gt_poses[:: cfg.frames_per_fragment][: len(est)]
    res = ate_mod.absolute_trajectory_error(
        torch.from_numpy(est[: len(gt)].astype(np.float32)).to(device), torch.from_numpy(gt).to(device)
    )
    return {"frag_ate_rmse": float(res.rmse), "frag_ate_max": float(res.max)}


def cloud_surface_error(cfg: PipelineConfig, scene_sdf, mode: str, ds: Dataset, device) -> dict:
    """Surface error of the posed fragment clouds, through their learned
    lattice(s) in slac and nonrigid mode.

    The reconstruction lives in fragment 0's camera frame and the analytic
    scene in the world, so the estimated fragment trajectory is first aligned
    rigidly to the ground-truth one (Kabsch over the base translations): the
    metric scores the shape, not the placement, as ATE does.
    """
    clouds = stages.load_fragment_clouds(cfg)
    slac_dir = Path(cfg.out_dir) / "slac"
    poses = io_logfmt.read_log(slac_dir / "pose_slac.log").matrices().astype(np.float32)
    gt = ds.gt_poses[:: cfg.frames_per_fragment][: len(poses)]
    est_t = poses[: len(gt), :3, 3]
    gt_t = gt[:, :3, 3]
    mu_e, mu_g = est_t.mean(0), gt_t.mean(0)
    U, _, Vt = np.linalg.svd((est_t - mu_e).T @ (gt_t - mu_g))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R_a = (U @ S @ Vt).T
    A = np.eye(4, dtype=np.float32)
    A[:3, :3] = R_a
    A[:3, 3] = mu_g - R_a @ mu_e
    poses = np.einsum("ij,njk->nik", A, poses).astype(np.float32)
    scfg = cfg.slac_config() if mode != "rigid" else None
    pts_w = []
    rng = np.random.default_rng(0)
    for f, c in enumerate(clouds):
        p = c.points[c.mask]
        if len(p) > 20000:
            p = p[rng.choice(len(p), 20000, replace=False)]
        ctr = {"slac": slac_dir / "ctr.txt", "nonrigid": slac_dir / f"ctr_{f}.txt"}.get(mode)
        if ctr is not None and ctr.exists():
            lat = Lattice(scfg.resolution, scfg.length, scfg.origin)
            pos, _, _ = io_logfmt.read_ctr(ctr)
            disp = torch.from_numpy((pos - lat.rest_positions().numpy()).astype(np.float32)).to(device)
            p = deform(lat, disp, torch.from_numpy(p).to(device)).cpu().numpy()
        T = poses[f]
        pts_w.append(p @ T[:3, :3].T + T[:3, 3])
    err = surface_error(scene_sdf, np.concatenate(pts_w), device=device)
    return {"surface_mean": err["mean"], "surface_rmse": err["rmse"], "surface_p95": err["p95"]}


# ------------------------------------------------------------------ configs


def run_config2(root: Path, args, device) -> dict:
    """The first 10 fragments' frames, odometry edges only (no loop closure)."""
    ds = main_dataset(root, args, device)
    K = args.frames_per_fragment
    sub = root / "data_m2"
    (sub / "depth").mkdir(parents=True, exist_ok=True)
    n2 = 10 * K + 1
    for p in ds.depth_paths[:n2]:
        dst = sub / "depth" / p.name
        if not dst.exists():
            dst.symlink_to(p.resolve())
    (sub / "intrinsics.json").write_text((root / "data" / "intrinsics.json").read_text())
    io_logfmt.write_log(sub / "gt.log", io_logfmt.Trajectory.from_matrices(ds.gt_poses[:n2].astype(np.float64)))
    ds2 = Dataset(sub)
    cfg2 = replace(base_cfg(root, args), data_dir=str(sub), out_dir=str(root / "out_m2"))
    stages.run_fragments(ds2, cfg2, device=device)
    stages.run_registration(cfg2, all_pairs=False, device=device)
    stages.run_posegraph(cfg2, device=device)
    stages.run_optimize(cfg2, device=device)
    stages.run_integrate(ds2, cfg2, device=device)
    return stages.run_evaluate(ds2, cfg2, device=device)


def run_config3(root: Path, args, device) -> dict:
    """Every stage on the main dataset; registration run twice in one process,
    cold then warm (the rate a resumed or multi-scene run reaches)."""
    ds = main_dataset(root, args, device)
    cfg3 = base_cfg(root, args)
    t0 = time.time()
    if not (Path(cfg3.out_dir) / "fragments" / "fragments.log").exists():
        stages.run_fragments(ds, cfg3, device=device)
    t_frag = time.time() - t0
    t1 = time.time()
    reg_cold = stages.run_registration(cfg3, all_pairs=True, device=device)
    t_reg = time.time() - t1
    reg_warm = stages.run_registration(cfg3, all_pairs=True, device=device)
    t1 = time.time()
    stages.run_posegraph(cfg3, device=device)
    stages.run_optimize(cfg3, device=device)
    stages.run_integrate(ds, cfg3, device=device)
    m = stages.run_evaluate(ds, cfg3, device=device)
    return {
        **m,
        "fragments_seconds": round(t_frag, 1),
        "registration_seconds": round(t_reg, 1),
        "rest_seconds": round(time.time() - t1, 1),
        "pair_rate_cold": reg_cold["pair_loop_pairs_per_second"],
        "pair_rate_warm": reg_warm["pair_loop_pairs_per_second"],
        "pairs_per_second_warm": reg_warm["pairs_per_second"],
    }


def run_config4(root: Path, args, device, mode: str) -> dict:
    """Config 3's artifacts through the fragment optimiser in ``mode``."""
    ds = main_dataset(root, args, device)
    cfg4 = replace(base_cfg(root, args), slac_mode=mode)
    stages.run_optimize(cfg4, device=device)
    stages.run_integrate(ds, cfg4, device=device)
    return stages.run_evaluate(ds, cfg4, device=device)


def distortion():
    """Config 4d's injected depth distortion, ~1.5% at the image corner."""
    return dist_mod.make_distortion(42, radial_a=0.015, depth_b=0.004, grid_sigma=0.006)


def distorted_cfg(cfg: PipelineConfig) -> PipelineConfig:
    """Config 4d's settings on the ladder's ``cfg``: rigid mode, five coarse-to-fine
    correspondence rounds and the lattice's weights; registration as config 3's."""
    slac_cfg = cfg.slac._replace(disp_prior_weight=0.01, arap_weight=1.0, outer_iterations=8)
    return replace(cfg, slac_mode="rigid", slac=slac_cfg, corres_max_distance=0.07, corres_rounds=5,
                   corres_distance_decay=0.7, corres_baseline_weight=4.0)


def run_distorted(root: Path, args, device, data_name: str = "data_dist2", out_name: str = "out_dist2",
                  trajectory: str = "orbit") -> dict:
    """The sequence rendered through a consumer-camera-scale depth distortion
    (~1.5% at the image corner); rigid against slac with five coarse-to-fine
    correspondence rounds, and the learned lattice scored against the field."""
    dist = distortion()
    data_d = root / data_name
    ds_d = gen(args, data_d, device, frames=args.frames, scene="livingroom", radius=1.1, distortion=dist,
               trajectory=trajectory)
    scene_sdf = scenes_mod.livingroom_scene()
    cfg_d = distorted_cfg(make_cfg(args, data_d, root / out_name))
    out = {}
    od = Path(cfg_d.out_dir)
    if not (od / "fragments" / "fragments.log").exists():
        stages.run_fragments(ds_d, cfg_d, device=device)
    if not (od / "registration" / "loop.log").exists():
        stages.run_registration(cfg_d, all_pairs=True, device=device)
    if not (od / "posegraph" / "pose.log").exists():
        stages.run_posegraph(cfg_d, device=device)
    for mode in ("rigid", "slac"):
        c = replace(cfg_d, slac_mode=mode)
        stages.run_optimize(c, device=device)
        stages.run_integrate(ds_d, c, device=device)
        m = stages.run_evaluate(ds_d, c, device=device)
        out[mode] = {
            **{k: m[k] for k in ("ate_rmse", "ate_mean", "ate_max")},
            **frag_pose_ate(c, ds_d, device),
            **cloud_surface_error(c, scene_sdf, mode, ds_d, device),
        }
    lat = Lattice(cfg_d.slac.resolution, cfg_d.slac.length, cfg_d.slac.origin)
    pos, _, _ = io_logfmt.read_ctr(od / "slac" / "ctr.txt")
    disp = (pos - lat.rest_positions().numpy()).astype(np.float32)
    clouds = stages.load_fragment_clouds(cfg_d)
    rec = lattice_recovery(lat, disp, clouds, dist, ds_d.intrinsics, device=device)
    rec0 = lattice_recovery(lat, np.zeros_like(disp), clouds, dist, ds_d.intrinsics, device=device)
    out["lattice_recovery"] = rec
    # The similarity alignment alone absorbs the field's gauge component; the
    # number to read is how much the learned lattice shrinks the aligned
    # residual against doing nothing (1 = all of it, 0 = nothing).
    out["lattice_recovery_zero_baseline"] = rec0
    out["recovery_vs_zero"] = round(
        1.0 - rec["residual_rms_aligned"] / max(rec0["residual_rms_aligned"], 1e-12), 4
    )
    out["ate_improvement"] = round(out["rigid"]["ate_rmse"] / max(out["slac"]["ate_rmse"], 1e-9), 2)
    return out


def run_survey(root: Path, args, device) -> dict:
    """Config 4d on the view-diverse survey trajectory."""
    return run_distorted(root, args, device, "data_dsurvey", "out_dsurvey", "survey")


def run_deformed(root: Path, args, device) -> dict:
    """Config 3's clean fragment clouds through known smooth per-fragment warps,
    then rigid against nonrigid: fragment-pose ATE and the surface error of the
    corrected clouds (the frames themselves were never warped)."""
    ds = main_dataset(root, args, device)
    base = base_cfg(root, args)
    src = base.p_fragments()
    out_dir = root / "out_deformed"
    dst_cfg = deformed_cfg(base, out_dir)
    dst = dst_cfg.p_fragments()
    dst.mkdir(parents=True, exist_ok=True)
    lat = Lattice(8, 3.0, (-1.5, -1.5, 0.0))
    nf = 0
    while (src / f"cloud_bin_{nf}.pcd").exists():
        nf += 1
    for f in range(nf):
        pts, nrm = io_logfmt.read_pcd(src / f"cloud_bin_{f}.pcd")
        w = warps_mod.make_fragment_warp(1000 + f, lat, amplitude=0.03)
        warped = warps_mod.warp_points(lat, w, torch.from_numpy(pts.astype(np.float32)).to(device))
        io_logfmt.write_pcd(dst / f"cloud_bin_{f}.pcd", warped.cpu().numpy(), nrm)
        (dst / f"local_{f}.log").write_text((src / f"local_{f}.log").read_text())
        hp = src / f"health_{f}.json"
        if hp.exists():
            (dst / f"health_{f}.json").write_text(hp.read_text())
    (dst / "fragments.log").write_text((src / "fragments.log").read_text())
    if not (out_dir / "registration" / "loop.log").exists():
        stages.run_registration(dst_cfg, all_pairs=True, device=device)
    if not (out_dir / "posegraph" / "pose.log").exists():
        stages.run_posegraph(dst_cfg, device=device)
    return score_deformed(dst_cfg, ds, device)


def deformed_cfg(base: PipelineConfig, out_dir: Path) -> PipelineConfig:
    """Config 4n's settings on config 3's ``base``: three correspondence rounds
    re-associated through the pair transforms and the lattice's weights;
    registration and pose graph as config 3's."""
    return replace(
        base, out_dir=str(out_dir), corres_max_distance=0.06, corres_rounds=3, corres_distance_decay=0.6,
        corres_reassoc_pair_transforms=True,
        slac=base.slac._replace(disp_prior_weight=0.003, arap_weight=1.0, outer_iterations=10),
    )


def score_deformed(cfg: PipelineConfig, ds: Dataset, device) -> dict:
    """``run_optimize`` on 4n's registered clouds in rigid and nonrigid mode:
    fragment-pose ATE and the corrected clouds' surface error of each."""
    scene_sdf = scenes_mod.livingroom_scene()
    out = {}
    for mode in ("rigid", "nonrigid"):
        cfg_m = replace(cfg, slac_mode=mode)
        opt = stages.run_optimize(cfg_m, device=device)
        out[mode] = {
            "data_rmse": opt.get("rmse_after"),
            **frag_pose_ate(cfg_m, ds, device),
            **cloud_surface_error(cfg_m, scene_sdf, mode, ds, device),
        }
    out["surface_improvement"] = round(
        out["rigid"]["surface_rmse"] / max(out["nonrigid"]["surface_rmse"], 1e-9), 2
    )
    return out


def run_degenerate(root: Path, args, device) -> dict:
    """The livingroom with its -z wall stripped bare: the camera faces
    featureless geometry for ~60 degrees of the orbit. Tracking health must
    flag those fragments; ATE is also scored over the healthy ones alone."""
    K = args.frames_per_fragment
    data_b = root / "data_bare"
    ds_b = gen(args, data_b, device, frames=args.frames, scene="livingroom_bare", radius=1.1)
    cfg_b = make_cfg(args, data_b, root / "out_bare")
    if not (Path(cfg_b.out_dir) / "fragments" / "fragments.log").exists():
        stages.run_fragments(ds_b, cfg_b, device=device)
    reg = stages.run_registration(cfg_b, all_pairs=True, device=device)
    stages.run_posegraph(cfg_b, device=device)
    stages.run_optimize(cfg_b, device=device)
    stages.run_integrate(ds_b, cfg_b, device=device)
    m = stages.run_evaluate(ds_b, cfg_b, device=device)
    health = stages.load_fragment_health(cfg_b, args.frames // K)
    est = io_logfmt.read_log(Path(cfg_b.out_dir) / "integrate" / "trajectory.log").matrices()
    n = min(len(est), len(ds_b.gt_poses))
    ok = np.ones(n, bool)
    for h in health:
        if h.get("suspect", False):
            f = h["fragment"]
            ok[f * K : (f + 1) * K] = False
    if ok.any():
        res_h = ate_mod.absolute_trajectory_error(
            torch.from_numpy(est[:n][ok].astype(np.float32)).to(device),
            torch.from_numpy(ds_b.gt_poses[:n][ok]).to(device),
        )
        m["ate_rmse_healthy"] = float(res_h.rmse)
        m["ate_max_healthy"] = float(res_h.max)
        m["healthy_frames"] = int(ok.sum())
    return {
        **m,
        "suspect_fragments": sum(1 for h in health if h.get("suspect", False)),
        "suspect_odometry_edges": reg["suspect_odometry_edges"],
    }


SCENE_RADII = {"office": 0.9, "livingroom2": 0.8}  # config 5's orbits, m


def run_scene(root: Path, args, device, scene: str, radius: float) -> dict:
    """Another scene stand-in at the default configuration (the derived drift gate)."""
    data_s = root / f"data_{scene}"
    ds_s = gen(args, data_s, device, frames=args.frames_scenes, scene=scene, radius=radius)
    cfg_s = make_cfg(args, data_s, root / f"out_{scene}")
    if not (Path(cfg_s.out_dir) / "fragments" / "fragments.log").exists():
        stages.run_fragments(ds_s, cfg_s, device=device)
    stages.run_registration(cfg_s, all_pairs=True, device=device)
    stages.run_posegraph(cfg_s, device=device)
    stages.run_optimize(cfg_s, device=device)
    stages.run_integrate(ds_s, cfg_s, device=device)
    return stages.run_evaluate(ds_s, cfg_s, device=device)


def run_ring(root: Path, args, device) -> dict:
    """Every sequence's fragments through the registration ring at world size 1
    (NCCL on a card, gloo on the CPU), in a process of its own."""
    frag_dirs = [
        str(root / d / "fragments")
        for d in ("out_full", "out_bare", "out_office", "out_livingroom2")
        if (root / d / "fragments" / "cloud_bin_0.pcd").exists()
    ]
    if len(frag_dirs) < 2:
        raise ValueError(f"the ring needs two sequences' fragments or more, found {frag_dirs}")
    out_json = root / "ring_scale.json"
    dev = torch.device(device)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(Path(__file__).resolve().parents[2]), env.get("PYTHONPATH", "")])
    subprocess.run(
        [sys.executable, "-m", "elasticreconstruction_tpu_torch.tools.ring_scale", "--out", str(out_json),
         "--ranks", "1", "--backend", "nccl" if dev.type == "cuda" else "gloo", "--device", str(dev), *frag_dirs],
        check=True, env=env, timeout=3600,
    )
    with open(out_json) as f:
        return json.load(f)


CONFIGS = (
    ("config2_odometry_chain", run_config2),
    ("config3_full_rigid", run_config3),
    ("config4_slac", lambda root, args, device: run_config4(root, args, device, "slac")),
    ("config4_nonrigid", lambda root, args, device: run_config4(root, args, device, "nonrigid")),
    ("config4_slac_distorted", run_distorted),
    ("config4_slac_survey", run_survey),
    ("config4_nonrigid_deformed", run_deformed),
    ("config3_degenerate", run_degenerate),
    ("config5_office", lambda root, args, device: run_scene(root, args, device, "office", SCENE_RADII["office"])),
    ("config5_livingroom2",
     lambda root, args, device: run_scene(root, args, device, "livingroom2", SCENE_RADII["livingroom2"])),
    ("config5_ring4seq", run_ring),
)


# ------------------------------------------------------------------- ladder


def _write(results: dict, path: Path) -> None:
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({"milestone_update": list(results.keys())}), flush=True)


def describe_device(dev: torch.device) -> dict:
    """The card's name and power limit (as ``nvidia-smi`` gives them), or the CPU."""
    if dev.type != "cuda":
        return {"platform": dev.type}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": torch.cuda.device_count(),
            "nvidia_smi": smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None}


def crashed_context(msg: str) -> bool:
    """Whether an error message says the CUDA context is unusable."""
    low = msg.lower()
    return any(m in low for m in CRASH_MARKERS)


def attempt(name: str, fn, root: Path, args, device, results: dict, results_path: Path, reexec: bool) -> None:
    """Run one config and record its result, or its error, and go on. With
    ``reexec``, an error that leaves the CUDA context unusable restarts the
    ladder with ``--resume``."""
    prior = results.get(name)
    if prior is not None and ("error" not in prior or prior.get("attempts", 1) >= 2):
        return  # done, or failed twice: do not loop
    attempts = (prior or {}).get("attempts", 0) + 1
    t0 = time.time()
    try:
        m = fn(root, args, device)
        results[name] = {**m, "seconds": round(time.time() - t0, 1)}
        _write(results, results_path)
    except Exception as e:  # noqa: BLE001 -- record the failure and go on with the ladder
        msg = f"{type(e).__name__}: {e}"[:300]
        results[name] = {"error": msg, "attempts": attempts, "seconds": round(time.time() - t0, 1)}
        _write(results, results_path)
        if reexec and crashed_context(msg):
            print(json.dumps({"milestones": f"CUDA context lost in {name}: re-exec with --resume"}), flush=True)
            argv = [a for a in sys.argv[1:] if a != "--resume"] + ["--resume"]
            os.execv(sys.executable, [sys.executable, "-m", __spec__.name, *argv])


def run_ladder(args, reexec: bool = False) -> dict:
    """Every config ``args.only`` names (all by default), in the reference's order."""
    device = resolve_device(args.device)
    only = {s for s in args.only.split(",") if s}
    unknown = only - {name for name, _ in CONFIGS}
    if unknown:
        raise ValueError(f"unknown configs {sorted(unknown)}")
    root = Path(args.out)
    root.mkdir(parents=True, exist_ok=True)
    results_path = Path(args.results)
    results: dict = {"frames": args.frames, "noise": args.noise}
    if args.resume and results_path.exists():
        with open(results_path) as f:
            results = json.load(f)
    results["device"] = describe_device(device)
    t0 = time.time()
    main_dataset(root, args, device)
    results["generate_seconds"] = round(time.time() - t0, 1)
    _write(results, results_path)
    for name, fn in CONFIGS:
        if not only or name in only:
            attempt(name, fn, root, args, device, results, results_path, reexec)
    print(json.dumps({"milestones": "done"}), flush=True)
    return results


def main(argv=None) -> int:
    run_ladder(build_parser().parse_args(argv), reexec=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
