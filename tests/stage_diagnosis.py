"""Both packages' stage on one directory that the port wrote on the card.

A milestone config's figures differ between the two packages, but each ran on
its own render; this script runs one stage of both packages on the same
upstream files, on the CPU, and scores both outputs with the port's
evaluation, so that a departure is pinned to the stage or to its inputs.

    python tests/stage_diagnosis.py posegraph RUN DATA
    python tests/stage_diagnosis.py optimize RUN DATA [--fragments K] [--capacity N] [--package jax|torch]

``posegraph``: config 3d. ``RUN`` holds the port's ``fragments/`` (with the
local trajectories and health files), ``registration/`` and ``posegraph/``;
``DATA`` the dataset's ``gt.log``. Prints, for the JAX stage's ``pose.log``,
the port's stage's and the port's own from the card: the frame trajectory's
ATE over every frame and over the healthy fragments' frames alone (the
ladder's ``ate_rmse_healthy``), and the kept edges. Then both packages' line
process on the graph the stage built, at 8, 16 and 32 Gauss-Newton steps,
against each other and a float64 run (``pgo_precision``).

``optimize``: config 4n (``tools/milestones.py::run_deformed``'s settings).
``RUN`` holds the warped ``fragments/``, ``registration/`` and ``posegraph/``;
``--fragments K`` cuts them to the first K fragments (the edges among them).
Runs both packages' ``run_optimize`` in rigid and nonrigid mode and prints
each one's fragment-pose ATE, corrected-cloud surface error and
``surface_improvement`` (rigid surface RMSE over nonrigid).

Prints one JSON object a result. Imports both packages, as the tests do.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from elasticreconstruction_tpu.odometry.fragments import FragmentConfig as JFragmentConfig  # noqa: E402
from elasticreconstruction_tpu.odometry.kinfu import OdometryConfig as JOdometryConfig  # noqa: E402
from elasticreconstruction_tpu.pipeline import stages as j_stages  # noqa: E402
from elasticreconstruction_tpu.pipeline.config import PipelineConfig as JPipelineConfig  # noqa: E402
from elasticreconstruction_tpu.posegraph import robust_pgo as j_pgo  # noqa: E402
from elasticreconstruction_tpu_torch import interop  # noqa: E402
from elasticreconstruction_tpu_torch.core import io_logfmt  # noqa: E402
from elasticreconstruction_tpu_torch.eval import ate as ate_mod  # noqa: E402
from elasticreconstruction_tpu_torch.pipeline import stages as t_stages  # noqa: E402
from elasticreconstruction_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from elasticreconstruction_tpu_torch.posegraph import robust_pgo as t_pgo  # noqa: E402
from elasticreconstruction_tpu_torch.synthetic import scenes  # noqa: E402
from elasticreconstruction_tpu_torch.tools import milestones  # noqa: E402

K = 50  # frames a fragment on the ladder


def ladder_cfg(out: Path, **kw) -> JPipelineConfig:
    """The ladder's configuration (``milestones.py:143-161``) in the JAX package's types."""
    return JPipelineConfig(
        out_dir=str(out), frames_per_fragment=K,
        fragment=JFragmentConfig(frames_per_fragment=K, volume_shape=(128, 128, 128), voxel_size=0.024,
                                 cloud_capacity=1 << 16, odometry=JOdometryConfig(raycast_steps=96)),
        slac_mode="none", scene_voxel_size=0.03, registration_batch=16, **kw,
    )


def gt_dataset(data: Path) -> SimpleNamespace:
    return SimpleNamespace(gt_poses=io_logfmt.read_log(data / "gt.log").matrices().astype(np.float32))


def frame_ate(out: Path, pose_log: Path, gt: np.ndarray) -> dict:
    """ATE of the frame trajectory ``pose.log`` x local poses (``_frame_world_poses``),
    over every frame and over the frames of fragments their health files call healthy."""
    cfg = PipelineConfig(out_dir=str(out), frames_per_fragment=K)
    bases = io_logfmt.read_log(pose_log).matrices().astype(np.float32)
    frames, fidx = [], []
    for f in range(len(bases)):
        local = io_logfmt.read_log(out / "fragments" / f"local_{f}.log").matrices().astype(np.float32)
        frames += [bases[f] @ local[k] for k in range(K)]
        fidx += [f] * K
    est, fidx = np.stack(frames), np.array(fidx)
    n = min(len(est), len(gt))
    health = t_stages.load_fragment_health(cfg, len(bases))
    suspect = {h["fragment"] for h in health if h.get("suspect", False)}
    ok = ~np.isin(fidx[:n], sorted(suspect))

    def ate(sel):
        res = ate_mod.absolute_trajectory_error(torch.from_numpy(est[:n][sel]), torch.from_numpy(gt[:n][sel]))
        return float(res.rmse)

    return {"ate_rmse": ate(np.ones(n, bool)), "ate_rmse_healthy": ate(ok), "healthy_frames": int(ok.sum()),
            "suspect_fragments": sorted(suspect)}


def diagnose_posegraph(run: Path, data: Path) -> None:
    gt = gt_dataset(data).gt_poses
    graph = {}
    real = t_stages.optimize_pose_graph

    def capture(init, edges, cfg):
        graph.update(init=init, edges=edges)
        return real(init, edges, cfg)

    with tempfile.TemporaryDirectory() as tmp:
        outs = {}
        for pkg in ("jax", "torch"):
            out = Path(tmp) / pkg
            shutil.copytree(run / "fragments", out / "fragments")
            shutil.copytree(run / "registration", out / "registration")
            t0 = time.time()
            if pkg == "jax":
                j_stages.run_posegraph(ladder_cfg(out))
            else:
                t_stages.optimize_pose_graph = capture
                try:
                    t_stages.run_posegraph(interop.pipeline_config_from(ladder_cfg(out)), device="cpu")
                finally:
                    t_stages.optimize_pose_graph = real
            outs[pkg] = out
            print(json.dumps({"posegraph": pkg, "seconds": time.time() - t0,
                              **frame_ate(out, out / "posegraph" / "pose.log", gt)}), flush=True)
        card = run / "posegraph" / "pose.log"
        if card.exists():
            print(json.dumps({"posegraph": "torch on the card", **frame_ate(outs["torch"], card, gt)}))
        j_pose = io_logfmt.read_log(outs["jax"] / "posegraph" / "pose.log").matrices()
        t_pose = io_logfmt.read_log(outs["torch"] / "posegraph" / "pose.log").matrices()
        kept = {pkg: (outs[pkg] / "posegraph" / "kept_edges.txt").read_text() for pkg in outs}
        print(json.dumps({"pose_log_max_abs_diff": float(np.abs(j_pose - t_pose).max()),
                          "kept_edges_equal": kept["jax"] == kept["torch"],
                          "kept_edges": len(kept["jax"].splitlines())}))
    trunk = min(int(ln.split()[0]) for ln in (run / "registration" / "odometry_suspect.txt").read_text().splitlines()
                if ln.strip()) + 1
    pgo_precision(graph["init"], graph["edges"], trunk)


def pgo_precision(init: torch.Tensor, edges, trunk: int) -> None:
    """The line process of both packages at 8, 16 and 32 Gauss-Newton steps an
    alternation on one graph, each against a float64 run of the port's solver:
    the largest pose difference on the trunk (fragments before ``trunk``) and on all."""
    j_edges = j_pgo.EdgeList.build(*(x.numpy() for x in edges))
    e64 = t_pgo.EdgeList(edges.i, edges.j, edges.transform.double(), edges.information.double(),
                         edges.is_odometry, edges.mask)
    for inner in (8, 16, 32):
        j_cfg, t_cfg = j_pgo.PGOConfig(inner_iterations=inner), t_pgo.PGOConfig(inner_iterations=inner)
        poses = {
            "jax": np.array(j_pgo.optimize_pose_graph(jnp.asarray(init.numpy()), j_edges, j_cfg).poses, np.float64),
            "torch": t_pgo.optimize_pose_graph(init, edges, t_cfg).poses.numpy().astype(np.float64),
            "float64": t_pgo.alternate(init.double(), e64, t_cfg,
                                       lambda p, w: t_pgo._gn_step(p, e64, w.double(), t_cfg)).poses.numpy(),
        }
        rec = {}
        for a, b in (("jax", "torch"), ("jax", "float64"), ("torch", "float64")):
            d = np.abs(poses[a] - poses[b]).max((1, 2))
            rec[f"{a}_vs_{b}"] = {"trunk": float(d[:trunk].max()), "all": float(d.max()), "worst_fragment": int(d.argmax())}
        print(json.dumps({"pgo_inner_iterations": inner, **rec}), flush=True)


def cut(run: Path, dst: Path, k: int) -> None:
    """The first ``k`` fragments of ``run`` and the edges among them, under ``dst``."""
    (dst / "fragments").mkdir(parents=True)
    for f in range(k):
        for name in (f"cloud_bin_{f}.pcd", f"local_{f}.log", f"health_{f}.json"):
            if (run / "fragments" / name).exists():
                shutil.copy(run / "fragments" / name, dst / "fragments" / name)
    for sub, name in (("fragments", "fragments.log"), ("posegraph", "pose.log")):
        (dst / sub).mkdir(exist_ok=True)
        traj = io_logfmt.read_log(run / sub / name)
        io_logfmt.write_log(dst / sub / name, io_logfmt.Trajectory(traj.entries[:k]))
    (dst / "registration").mkdir()
    for name in ("odometry", "loop"):
        log = io_logfmt.read_log(run / "registration" / f"{name}.log")
        io_logfmt.write_log(dst / "registration" / f"{name}.log",
                            io_logfmt.Trajectory([e for e in log.entries if e.j < k]))
    kept = [ln for ln in (run / "posegraph" / "kept_edges.txt").read_text().splitlines()
            if ln.strip() and max(map(int, ln.split())) < k]
    (dst / "posegraph" / "kept_edges.txt").write_text("".join(ln + "\n" for ln in kept))


def deformed_cfg(out: Path, capacity: int) -> JPipelineConfig:
    """``run_deformed``'s settings (``milestones.py:414-489``), clouds padded to ``capacity``."""
    base = ladder_cfg(out)
    return dataclasses.replace(
        base, fragment=base.fragment._replace(cloud_capacity=capacity),
        corres_max_distance=0.06, corres_rounds=3, corres_distance_decay=0.6,
        corres_reassoc_pair_transforms=True,
        slac=base.slac._replace(disp_prior_weight=0.003, arap_weight=1.0, outer_iterations=10),
    )


def diagnose_optimize(run: Path, data: Path, k: int | None, capacity: int, packages) -> None:
    ds = gt_dataset(data)
    scene_sdf = scenes.livingroom_scene()
    with tempfile.TemporaryDirectory() as tmp:
        src = run
        if k is not None:
            src = Path(tmp) / "cut"
            cut(run, src, k)
        for pkg in packages:
            out = Path(tmp) / pkg
            for sub in ("fragments", "registration", "posegraph"):
                shutil.copytree(src / sub, out / sub)
            most = max(len(io_logfmt.read_pcd(p)[0]) for p in (out / "fragments").glob("cloud_bin_*.pcd"))
            if most > capacity:
                raise ValueError(f"--capacity {capacity} would cut a cloud of {most} points")
            rec = {}
            for mode in ("rigid", "nonrigid"):
                jcfg = dataclasses.replace(deformed_cfg(out, capacity), slac_mode=mode)
                tcfg = interop.pipeline_config_from(jcfg)
                t0 = time.time()
                opt = j_stages.run_optimize(jcfg) if pkg == "jax" else t_stages.run_optimize(tcfg, device="cpu")
                rec[mode] = {"seconds": time.time() - t0, "data_rmse": opt.get("rmse_after"),
                             **milestones.frag_pose_ate(tcfg, ds, "cpu"),
                             **milestones.cloud_surface_error(tcfg, scene_sdf, mode, ds, "cpu")}
            rec["surface_improvement"] = rec["rigid"]["surface_rmse"] / max(rec["nonrigid"]["surface_rmse"], 1e-9)
            print(json.dumps({"optimize": pkg, "fragments": k, "capacity": capacity, **rec}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stage", choices=["posegraph", "optimize"])
    ap.add_argument("run", type=Path, help="the port's stage directory from the card")
    ap.add_argument("data", type=Path, help="the dataset directory holding gt.log")
    ap.add_argument("--fragments", type=int, default=None, help="optimize: cut to the first K fragments")
    ap.add_argument("--capacity", type=int, default=1 << 16,
                    help="optimize: rows a cloud is padded to (the ladder's 1 << 16 by default; the padding is "
                         "masked, so any capacity that holds every cloud harvests the same rows)")
    ap.add_argument("--package", choices=["jax", "torch"], default=None, help="optimize: one package only")
    args = ap.parse_args(argv)
    if args.stage == "posegraph":
        diagnose_posegraph(args.run, args.data)
    else:
        diagnose_optimize(args.run, args.data, args.fragments, args.capacity,
                          [args.package] if args.package else ["jax", "torch"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
