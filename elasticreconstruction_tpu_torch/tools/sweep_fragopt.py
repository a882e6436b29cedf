"""Fragment-optimiser settings swept on existing stage artifacts.

Counterpart of the repository's ``tools/sweep_fragopt.py``. The capability
metrics of configs 4d and 4n (the learned lattice against the injected field,
fragment-pose ATE, the surface error of the corrected clouds) need only the
optimiser's output, so this tool loads the ladder's fragments and pose graph
from disk and runs ``run_optimize`` once a variant, without ``integrate`` and
``evaluate``:

    python -m elasticreconstruction_tpu_torch.tools.sweep_fragopt nonrigid        # on <root>/out_deformed
    python -m elasticreconstruction_tpu_torch.tools.sweep_fragopt nonrigid-tight  # tight-start variants
    python -m elasticreconstruction_tpu_torch.tools.sweep_fragopt slac            # on <root>/out_dist2

``--root`` is the ladder's ``--out`` (default ``milestone_runs_gpu``). Each
variant prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

from ..core import io_logfmt
from ..core.types import resolve_device
from ..elastic.lattice import Lattice
from ..elastic.slac import SlacConfig
from ..eval.lattice_recovery import lattice_recovery
from ..odometry.fragments import FragmentConfig
from ..pipeline import stages
from ..pipeline.config import PipelineConfig
from ..pipeline.dataset import Dataset
from ..synthetic import distortion as dist_mod
from ..synthetic import scenes as scenes_mod
from .milestones import cloud_surface_error, frag_pose_ate

K = 50


def base_cfg(root: Path, out_dir: Path, **kw) -> PipelineConfig:
    return PipelineConfig(
        data_dir=str(root / "data"),
        out_dir=str(out_dir),
        frames_per_fragment=K,
        fragment=FragmentConfig(frames_per_fragment=K, cloud_capacity=1 << 16),
        **kw,
    )


def tight_variants():
    """Tight-start: the rigid poses of config 4n are good, so a 6 cm first-round
    radius mostly buys wrong matches that free per-fragment lattices then bake
    in; start near the exact-association oracle's 2 cm and tighten gently."""
    return [
        ("r5d-a1-tight", dict(corres_max_distance=0.04, corres_rounds=5,
                              corres_distance_decay=0.85, arap_anneal=2.0),
         SlacConfig(disp_prior_weight=0.003, arap_weight=1.0, outer_iterations=10)),
        ("r5d-a.3-tight", dict(corres_max_distance=0.03, corres_rounds=4,
                               corres_distance_decay=0.85, arap_anneal=2.0),
         SlacConfig(disp_prior_weight=0.003, arap_weight=0.3, outer_iterations=10)),
    ]


def sweep_nonrigid(root: Path, device, variants=None) -> dict:
    """Rigid against nonrigid on config 4n's warped fragments, a variant at a time."""
    out_dir = root / "out_deformed"
    ds = Dataset(root / "data")
    sdf = scenes_mod.livingroom_scene()
    variants = variants or [
        # ARAP annealing: a stiff lattice while association is loose, relaxing
        # to the target weight in the final round.
        ("r5c-a.3-an3", dict(corres_max_distance=0.06, corres_rounds=5,
                             corres_distance_decay=0.7, arap_anneal=3.0),
         SlacConfig(disp_prior_weight=0.003, arap_weight=0.3, outer_iterations=10)),
        ("r5c-a1-an3", dict(corres_max_distance=0.06, corres_rounds=5,
                            corres_distance_decay=0.7, arap_anneal=3.0),
         SlacConfig(disp_prior_weight=0.003, arap_weight=1.0, outer_iterations=10)),
    ]
    results = {}
    for name, pkw, scfg in variants:
        for mode in ("rigid", "nonrigid"):
            cfg = replace(base_cfg(root, out_dir, **pkw), slac_mode=mode, slac=scfg)
            t0 = time.time()
            opt = stages.run_optimize(cfg, device=device)
            m = {
                "data_rmse": opt.get("rmse_after"),
                **frag_pose_ate(cfg, ds, device),
                **cloud_surface_error(cfg, sdf, mode, ds, device),
                "seconds": round(time.time() - t0, 1),
            }
            results[f"{name}/{mode}"] = m
            print(json.dumps({f"{name}/{mode}": m}), flush=True)
        si = results[f"{name}/rigid"]["surface_rmse"] / max(results[f"{name}/nonrigid"]["surface_rmse"], 1e-9)
        print(json.dumps({f"{name}/surface_improvement": round(si, 3)}), flush=True)
    return results


def sweep_slac(root: Path, device, variants=None) -> dict:
    """The slac lattice's recovery of config 4d's injected field, a variant at a time."""
    out_dir = root / "out_dist2"
    dist = dist_mod.make_distortion(42, radial_a=0.015, depth_b=0.004, grid_sigma=0.006)
    intr = Dataset(root / "data_dist2").intrinsics
    variants = variants or [
        ("r5-base", dict(corres_max_distance=0.07, corres_rounds=3, corres_distance_decay=0.7,
                         corres_baseline_weight=4.0),
         SlacConfig(disp_prior_weight=0.01, arap_weight=1.0, outer_iterations=8)),
        ("pr003-o16", dict(corres_max_distance=0.07, corres_rounds=3, corres_distance_decay=0.7,
                           corres_baseline_weight=4.0),
         SlacConfig(disp_prior_weight=0.003, arap_weight=1.0, outer_iterations=16, cg_iterations=96)),
    ]
    results = {}
    for name, pkw, scfg in variants:
        cfg = replace(base_cfg(root, out_dir, **pkw), slac_mode="slac", slac=scfg)
        t0 = time.time()
        stages.run_optimize(cfg, device=device)
        lat = Lattice(scfg.resolution, scfg.length, scfg.origin)
        pos, _, _ = io_logfmt.read_ctr(Path(cfg.out_dir) / "slac" / "ctr.txt")
        disp = (pos - lat.rest_positions().numpy()).astype(np.float32)
        clouds = stages.load_fragment_clouds(cfg)
        rec = lattice_recovery(lat, disp, clouds, dist, intr, device=device)
        rec0 = lattice_recovery(lat, np.zeros_like(disp), clouds, dist, intr, device=device)
        m = {
            "recovery_vs_zero": round(1.0 - rec["residual_rms_aligned"] / max(rec0["residual_rms_aligned"], 1e-12), 4),
            "recovery_fraction": round(rec["recovery_fraction"], 4),
            "seconds": round(time.time() - t0, 1),
        }
        results[name] = m
        print(json.dumps({name: m}), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="elasticreconstruction_tpu_torch.tools.sweep_fragopt")
    ap.add_argument("what", nargs="?", default="nonrigid", choices=["nonrigid", "nonrigid-tight", "slac"])
    ap.add_argument("--root", default="milestone_runs_gpu", help="the ladder's --out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root, device = Path(args.root), resolve_device(args.device)
    if args.what == "nonrigid":
        sweep_nonrigid(root, device)
    elif args.what == "nonrigid-tight":
        sweep_nonrigid(root, device, tight_variants())
    else:
        sweep_slac(root, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
