"""Both packages' stage on one directory that the port wrote on the card.

A milestone config's figures differ between the two packages, but each ran on
its own render; this script runs one stage of both packages on the same
upstream files, on the CPU, and scores both outputs with the port's
evaluation, so that a departure is pinned to the stage or to its inputs.

    python tests/stage_diagnosis.py posegraph RUN DATA
    python tests/stage_diagnosis.py optimize RUN DATA [--fragments K] [--capacity N] [--package jax|torch] [--stages-from DIR] [--modes M,...]
    python tests/stage_diagnosis.py render RUN DATA --frames XZ [--scene livingroom|livingroom_bare|office|livingroom2]
    python tests/stage_diagnosis.py fragments RUN DATA --frames XZ --trace JSON [--reference DIR] [--port-cpu N] [--nudge]
    python tests/stage_diagnosis.py register RUN DATA [--window A-B] [--card DIR] [--nudge] [--save DIR] [--load DIR]
    python tests/stage_diagnosis.py draws FILE [--batches N]
    python tests/stage_diagnosis.py cut RUN DST --window A-B [--no-normals]

``posegraph``: config 3d. ``RUN`` holds the port's ``fragments/`` (with the
local trajectories and health files), ``registration/`` and ``posegraph/``;
``DATA`` the dataset's ``gt.log``. Prints, for the JAX stage's ``pose.log``,
the port's stage's and the port's own from the card: the frame trajectory's
ATE over every frame and over the healthy fragments' frames alone (the
ladder's ``ate_rmse_healthy``), and the kept edges. Then both packages' line
process on the graph the stage built, at 8, 16 and 32 Gauss-Newton steps,
against each other and a float64 run (``pgo_precision``).

``optimize``: config 4n (``RUN`` named ``deformed``; ``run_deformed``'s
settings, rigid and nonrigid) or 4d (``dist2``; ``run_distorted``'s, rigid and
slac; ``--modes`` picks some). ``RUN`` holds the ``fragments/``, ``registration/`` and ``posegraph/``;
``--fragments K`` cuts them to the first K fragments (the edges among them);
``--stages-from DIR`` takes ``registration/`` and ``posegraph/`` from ``DIR``
(a ``register --save`` run) in place of ``RUN``'s.
Runs both packages' ``run_optimize`` in each mode and prints each one's
fragment-pose ATE, corrected-cloud surface error and, for 4n,
``surface_improvement`` (rigid surface RMSE over nonrigid).

``render``, ``fragments`` and ``register`` take what ``tests/ladder_card.py
pack`` brought back from the card: ``RUN`` and ``DATA`` are one config's
directory of the pack, named by its ``ladder_card.CONFIGS`` key (``full``
for config 3, ``bare`` for 3d, ``deformed`` for 4n, ``dist2`` for 4d,
``office`` and ``livingroom2`` for 5); each stage runs at that config's
settings (``stage_cfg``).

``render``: the JAX package's render of the frames in ``--frames`` (a packed
``frames_<config>_render.xz``) at the ladder's settings (``--scene``, its
orbit's radius (``RADII``), height 1.3 m, the full orbit, 1% noise from the
numpy stream of seed 0), written to millimetres as its PNG writer does, against the card's frames:
per frame the share of pixels whose validity differs, the share whose value
differs and the largest difference in mm where both are valid; the bound is
``tests/test_torch_synthetic.py``'s (0.1% of the pixels, 1 mm).

``fragments``: the JAX ``build_fragment`` over the card's frames of each
fragment in ``--frames`` (a packed ``frames_<config>_odometry.xz``), started
from the velocity the card's run started it from (``--trace``, the
``odometry_trace.json`` of ``ladder_card.py ladder``), against the card's
fragment: local poses (bound 1e-3, ``tests/test_torch_bench.py``'s), the
health record's fields, the per-frame fitness and observability, and the
count of cloud points. ``--reference DIR`` prints the reference's own
``health_<f>.json`` of those fragments beside them (a different render);
``--port-cpu N`` runs the port's ``build_fragment`` on the CPU over the first N
frames too, which splits a departure into the card's arithmetic and the code,
with the JAX package's own ``fuse`` and ``track_frame`` run one by one for
frame 1; ``--nudge`` runs the JAX
``build_fragment`` again on the frames moved by one f32 ulp, the yardstick of
its own rounding.

``register``: the JAX ``run_registration`` and the port's, the latter on the
JAX stage's own RANSAC draws (``tests/test_torch_stages.py``), on copies of
``RUN/fragments`` (``--window A-B`` cuts them to fragments A..B, renumbered
from 0). Compares the drift gate's admitted, suspect-path and content sets,
``odometry.log``, and every pair's success flag and transform, pairs matched by
``(i, j)`` and attempt and each called right where accepted within 10 cm and
0.1 rad of ground truth; then each package's ``run_posegraph`` on its own registration,
scored by frame ATE (every frame and the healthy fragments' frames) and by
P/R against ``RUN/registration/gt.log``, beside the card's own run.
``--card DIR`` reads the port's run on the JAX draws from the card
(``ladder_card.py register``, fed by ``draws FILE``, which writes the JAX
stage's draws) instead of running it on the CPU. ``--nudge`` adds the JAX
stage on clouds moved by one f32 ulp: how far the stage's own rounding carries
a pair, the yardstick for the two packages' difference. ``--save DIR`` keeps
each run's capture, ``registration/`` and ``posegraph/``; ``--load DIR`` takes
the runs it holds instead of running them again.

``draws`` writes the JAX stage's draws for a card-side run; ``cut`` writes
fragments A..B of ``RUN`` under ``DST`` (``DATA``'s place), renumbered from 0,
as ``register --window`` cuts them (the fixture of
``tests/test_torch_register_ladder.py``).

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
from elasticreconstruction_tpu_torch import bench_scene, interop  # noqa: E402
from elasticreconstruction_tpu_torch.core import io_logfmt  # noqa: E402
from elasticreconstruction_tpu_torch.eval import ate as ate_mod  # noqa: E402
from elasticreconstruction_tpu_torch.eval import gt_benchmark as gtb  # noqa: E402
from elasticreconstruction_tpu_torch.eval import registration_pr as prmod  # noqa: E402
from elasticreconstruction_tpu_torch.pipeline import stages as t_stages  # noqa: E402
from elasticreconstruction_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from elasticreconstruction_tpu_torch.posegraph import robust_pgo as t_pgo  # noqa: E402
from elasticreconstruction_tpu_torch.synthetic import scenes  # noqa: E402
from elasticreconstruction_tpu_torch.tools import milestones  # noqa: E402

import ladder_card  # noqa: E402  (tests/, beside this script)

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
    # The trunk ends after the first suspect odometry edge (3d's blind wall); without one it is every fragment.
    trunk = min((int(ln.split()[0]) + 1 for ln in (run / "registration" / "odometry_suspect.txt").read_text().splitlines()
                 if ln.strip()), default=len(graph["init"]))
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


def distorted_cfg(out: Path, capacity: int) -> JPipelineConfig:
    """``run_distorted``'s settings (``milestones.py:344-358``), clouds padded to ``capacity``."""
    base = ladder_cfg(out)
    return dataclasses.replace(
        base, fragment=base.fragment._replace(cloud_capacity=capacity), slac_mode="rigid",
        slac=base.slac._replace(disp_prior_weight=0.01, arap_weight=1.0, outer_iterations=8),
        corres_max_distance=0.07, corres_rounds=5, corres_distance_decay=0.7, corres_baseline_weight=4.0,
    )


# The configs ``optimize`` runs: each one's settings and its ``--slac-mode``s.
OPTIMIZE = {"deformed": (deformed_cfg, ("rigid", "nonrigid")), "dist2": (distorted_cfg, ("rigid", "slac"))}


def stage_cfg(key: str, out: Path) -> JPipelineConfig:
    """The JAX configuration of config ``key``'s stages (a ``ladder_card.CONFIGS``
    key): 4n's and 4d's are ``run_deformed``'s and ``run_distorted``'s, the others
    the ladder's. Every config registers and builds its pose graph as config 3
    does; they differ from ``optimize`` on."""
    return OPTIMIZE[key][0](out, 1 << 16) if key in OPTIMIZE else ladder_cfg(out)


def diagnose_optimize(run: Path, data: Path, k: int | None, capacity: int, packages,
                      stages_from: Path | None, modes: list[str] | None) -> None:
    make_cfg, config_modes = OPTIMIZE[run.name]
    ds = gt_dataset(data)
    scene_sdf = scenes.livingroom_scene()
    with tempfile.TemporaryDirectory() as tmp:
        src = run
        if stages_from is not None:
            src = Path(tmp) / "stages_from"
            shutil.copytree(run / "fragments", src / "fragments")
            for sub in ("registration", "posegraph"):
                shutil.copytree(stages_from / sub, src / sub)
        if k is not None:
            whole, src = src, Path(tmp) / "cut"
            cut(whole, src, k)
        for pkg in packages:
            out = Path(tmp) / pkg
            for sub in ("fragments", "registration", "posegraph"):
                shutil.copytree(src / sub, out / sub)
            most = max(len(io_logfmt.read_pcd(p)[0]) for p in (out / "fragments").glob("cloud_bin_*.pcd"))
            if most > capacity:
                raise ValueError(f"--capacity {capacity} would cut a cloud of {most} points")
            rec = {}
            for mode in modes or config_modes:
                jcfg = dataclasses.replace(make_cfg(out, capacity), slac_mode=mode)
                tcfg = interop.pipeline_config_from(jcfg)
                t0 = time.time()
                opt = j_stages.run_optimize(jcfg) if pkg == "jax" else t_stages.run_optimize(tcfg, device="cpu")
                rec[mode] = {"seconds": time.time() - t0, "data_rmse": opt.get("rmse_after"),
                             **milestones.frag_pose_ate(tcfg, ds, "cpu"),
                             **milestones.cloud_surface_error(tcfg, scene_sdf, mode, ds, "cpu")}
            if "rigid" in rec and "nonrigid" in rec:
                rec["surface_improvement"] = rec["rigid"]["surface_rmse"] / max(rec["nonrigid"]["surface_rmse"], 1e-9)
            print(json.dumps({"optimize": pkg, "fragments": k, "capacity": capacity,
                              "stages_from": str(stages_from or run), **rec}), flush=True)


# ----------------------------------------------------------- render, fragments, register

NOISE, HEIGHT = 0.01, 1.3  # the ladder's dataset (tools/milestones.py::gen)
RADII = {"livingroom": 1.1, "livingroom_bare": 1.1, **milestones.SCENE_RADII}  # each scene's orbit, m
RENDER_BOUND = {"share": 1e-3, "mm": 1}  # tests/test_torch_synthetic.py: 0.1% of the pixels, 1 mm
POSE_BOUND = 1e-3  # tests/test_torch_bench.py: build_fragment's local poses


def jax_intrinsics(data: Path):
    from elasticreconstruction_tpu.pipeline.dataset import read_intrinsics

    return read_intrinsics(data / "intrinsics.json")


def diagnose_render(run: Path, data: Path, frames_xz: Path, scene: str) -> None:
    from elasticreconstruction_tpu.synthetic import render as j_render
    from elasticreconstruction_tpu.synthetic import scenes as j_scenes

    frames, card = ladder_card.read_frames(frames_xz)
    intr = jax_intrinsics(data)
    n = len(io_logfmt.read_log(data / "gt.log").entries)
    poses = j_scenes.orbit_trajectory(n, radius=RADII[scene], height=HEIGHT, sweep=2.0 * np.pi)
    gt_err = float(np.abs(poses - gt_dataset(data).gt_poses).max())
    sdf = {"office": j_scenes.office_scene, "livingroom2": j_scenes.livingroom2_scene}.get(
        scene, lambda: j_scenes.livingroom_scene(bare_minus_z=scene == "livingroom_bare"))()
    render = jax.jit(lambda ps: j_render.render_sequence(sdf, ps, intr, max_depth=6.0))
    # generate_synthetic's noise: one normal draw a pixel, 16 frames a chunk, in order.
    rng = np.random.default_rng(0)
    noise = {}
    want = set(frames)
    for s in range(0, n, 16):
        chunk = rng.normal(0, NOISE, size=(min(16, n - s), intr.height, intr.width)).astype(np.float32)
        noise.update({k: chunk[k - s] for k in range(s, s + len(chunk)) if k in want})
    t0 = time.time()
    rows = []
    for b in range(0, len(frames), 16):
        idx = frames[b:b + 16]
        ps = poses[idx + [idx[-1]] * (16 - len(idx))]
        depths = np.array(render(jnp.asarray(ps)))[: len(idx)]
        for k, d in zip(idx, depths):
            d = np.where(d > 0, np.maximum(d + noise[k] * d, 0.05), 0.0)
            mm = np.clip(np.round(np.asarray(d) * 1000.0), 0, 65535).astype(np.int32)
            got = card[frames.index(k)].astype(np.int32)
            both = (mm > 0) & (got > 0)
            rows.append({"frame": k, "valid_differs": float(((mm > 0) != (got > 0)).mean()),
                         "value_differs": float((mm != got).mean()),
                         "max_mm": int(np.abs(mm - got)[both].max()) if both.any() else 0})
    over = [r for r in rows if max(r["valid_differs"], r["value_differs"]) > RENDER_BOUND["share"]
            or r["max_mm"] > RENDER_BOUND["mm"]]
    worst = max(rows, key=lambda r: r["value_differs"])
    print(json.dumps({"render": scene, "frames": len(rows), "seconds": time.time() - t0,
                      "trajectory_vs_gt_log": gt_err,
                      "valid_differs_max": max(r["valid_differs"] for r in rows),
                      "valid_differs_mean": float(np.mean([r["valid_differs"] for r in rows])),
                      "value_differs_max": worst["value_differs"], "worst_frame": worst["frame"],
                      "value_differs_mean": float(np.mean([r["value_differs"] for r in rows])),
                      "max_mm": max(r["max_mm"] for r in rows),
                      "frames_beyond_bound": [r["frame"] for r in over], "bound": RENDER_BOUND}), flush=True)
    for r in sorted(rows, key=lambda r: -r["value_differs"])[:5]:
        print(json.dumps({"render_frame": r}), flush=True)


def health_record(f: int, fit, rmse, obs, ocfg) -> dict:
    """``run_fragments``' health record from a fragment's per-frame telemetry."""
    fit, rmse, obs = (np.asarray(x)[1:] for x in (fit, rmse, obs))
    return {"fragment": f, "min_fitness": float(fit.min()), "max_rmse": float(rmse.max()),
            "min_obs_ratio": float(obs.min()),
            "frames_unhealthy": int(np.sum((obs < ocfg.healthy_obs_ratio) | (fit < ocfg.healthy_fitness))),
            "suspect": bool(np.any(obs < ocfg.healthy_obs_ratio) or np.any(fit < ocfg.healthy_fitness))}


def diagnose_fragments(run: Path, data: Path, frames_xz: Path, trace_file: Path, trace_key: str,
                       reference: Path | None, only, port_cpu: int, nudge: bool) -> None:
    from elasticreconstruction_tpu.core import se3 as j_se3
    from elasticreconstruction_tpu.kernels import tsdf as j_tsdf
    from elasticreconstruction_tpu.odometry import fragments as j_frag
    from elasticreconstruction_tpu.odometry import kinfu as j_kinfu
    from elasticreconstruction_tpu.odometry.fragments import build_fragment as j_build
    from elasticreconstruction_tpu_torch.odometry import build_fragment as t_build

    frames, card = ladder_card.read_frames(frames_xz)
    trace = json.loads(trace_file.read_text())[trace_key]
    intr = jax_intrinsics(data)
    fcfg = ladder_cfg(run).fragment
    depth = dict(zip(frames, card.astype(np.float32) / 1000.0))  # read_depth_batch's metres
    whole = {k // K for k in frames if k % K == 0 and all(k + i in depth for i in range(K + 1))}
    for f in sorted(whole if only is None else whole & set(only)):
        t0 = time.time()
        res = j_build(jnp.asarray(np.stack([depth[f * K + i] for i in range(K + 1)])), intr, fcfg,
                      init_velocity=jnp.asarray(trace[f]["init_velocity"], jnp.float32))
        local = np.array(res.local_poses, np.float64)
        card_local = io_logfmt.read_log(run / "fragments" / f"local_{f}.log").matrices()
        d = np.abs(local - card_local).max((1, 2))
        fit, rmse, obs = (np.array(x) for x in (res.fitness, res.rmse, res.obs_ratio))
        tr = trace[f]
        card_pts = len(io_logfmt.read_pcd(run / "fragments" / f"cloud_bin_{f}.pcd")[0])
        rec = {
            "fragment": f, "seconds": time.time() - t0,
            "local_pose_max_abs_diff": float(d.max()), "worst_frame": int(d.argmax()),
            "poses_within_bound": int((d <= POSE_BOUND).sum()), "of": len(d), "bound": POSE_BOUND,
            "fitness_max_abs_diff": float(np.abs(fit - np.array(tr["fitness"])).max()),
            "obs_ratio_max_abs_diff": float(np.abs(obs - np.array(tr["obs_ratio"])).max()),
            "rmse_max_abs_diff": float(np.abs(rmse - np.array(tr["rmse"])).max()),
            "final_velocity_max_abs_diff": float(np.abs(np.array(res.final_velocity) - tr["final_velocity"]).max()),
            "health_jax": health_record(f, fit, rmse, obs, fcfg.odometry),
            "health_card": json.loads((run / "fragments" / f"health_{f}.json").read_text()),
            "cloud_points_jax": int(np.array(res.cloud.mask).sum()), "cloud_points_card": card_pts,
        }
        if reference is not None and (reference / f"health_{f}.json").exists():
            rec["health_reference"] = json.loads((reference / f"health_{f}.json").read_text())
        if nudge:
            # The JAX stage on frames moved by one f32 ulp: how far its own rounding carries a pose.
            rng = np.random.default_rng(f)
            frames_f = np.stack([depth[f * K + i] for i in range(K + 1)])
            step = np.where(rng.random(frames_f.shape) < 0.5, -np.inf, np.inf).astype(np.float32)
            nudged = np.where(frames_f > 0, np.nextafter(frames_f, step), frames_f)
            n_res = j_build(jnp.asarray(nudged), intr, fcfg,
                            init_velocity=jnp.asarray(trace[f]["init_velocity"], jnp.float32))
            d_n = np.abs(np.array(n_res.local_poses, np.float64) - local).max((1, 2))
            rec["jax_nudged"] = {"vs_jax_max_abs_diff": float(d_n.max()), "worst_frame": int(d_n.argmax()),
                                 "poses_within_bound": int((d_n <= POSE_BOUND).sum()),
                                 "per_frame": [float(x) for x in d_n]}
        if port_cpu:
            # The port's own build_fragment on the CPU over the first ``port_cpu``
            # frames: splits a departure into the card's arithmetic (CPU against
            # card) and the code (CPU against JAX). And the JAX package's own fuse
            # then track_frame run one by one for frame 1, the step its
            # build_fragment compiles into one program.
            first = np.stack([depth[f * K + i] for i in range(port_cpu)])
            v0 = np.asarray(trace[f]["init_velocity"], np.float32)
            t_res = t_build(torch.from_numpy(first), interop.intrinsics_from(intr),
                            interop.pipeline_config_from(ladder_cfg(run)).fragment,
                            init_velocity=torch.from_numpy(v0))
            t_local = t_res.local_poses.numpy().astype(np.float64)
            d_j = np.abs(t_local - local[:port_cpu]).max((1, 2))
            d_c = np.abs(t_local - card_local[:port_cpu]).max((1, 2))
            kw = dict(max_weight=fcfg.max_weight, depth_min=fcfg.depth_min, depth_max=fcfg.depth_max)
            vol = j_tsdf.fuse(j_tsdf.make_volume(fcfg.volume_shape, fcfg.voxel_size, j_frag._volume_origin(fcfg)),
                              jnp.asarray(first[0]), j_se3.identity(), intr, **kw)
            pred = j_se3.exp(fcfg.odometry.velocity_gain * jnp.asarray(v0))
            one = np.array(j_kinfu.track_frame(vol, jnp.asarray(first[1]), pred, intr, fcfg.odometry).pose, np.float64)
            rec["port_cpu"] = {"frames": port_cpu, "vs_jax_max_abs_diff": float(d_j.max()),
                               "vs_card_max_abs_diff": float(d_c.max()),
                               "jax_one_by_one_frame1_vs_jax": float(np.abs(one - local[1]).max()),
                               "jax_one_by_one_frame1_vs_port_cpu": float(np.abs(one - t_local[1]).max())}
        rec["per_frame_vs_card"] = [float(x) for x in d]
        print(json.dumps(rec), flush=True)


def cut_window(run: Path, dst: Path, a: int, b: int, normals: bool = True) -> None:
    """Fragments ``a..b`` of ``run`` renumbered from 0, with their health files
    and ``fragments.log`` rows (the gate reads the bases), and the ground-truth
    edges among them, and ``gt_bases.log``, the ground-truth poses of their
    first frames. ``normals=False`` leaves the clouds' normals out, which
    registration never reads (``estimate_normals_radius`` recomputes them)."""
    (dst / "fragments").mkdir(parents=True)
    (dst / "registration").mkdir()
    for f in range(a, b + 1):
        pts, nrm = io_logfmt.read_pcd(run / "fragments" / f"cloud_bin_{f}.pcd")
        io_logfmt.write_pcd(dst / "fragments" / f"cloud_bin_{f - a}.pcd", pts, nrm if normals else None)
        shutil.copy(run / "fragments" / f"local_{f}.log", dst / "fragments" / f"local_{f - a}.log")
        h = json.loads((run / "fragments" / f"health_{f}.json").read_text())
        (dst / "fragments" / f"health_{f - a}.json").write_text(json.dumps({**h, "fragment": f - a}, indent=2))
    bases = io_logfmt.read_log(run / "fragments" / "fragments.log").matrices()[a:b + 1]
    io_logfmt.write_log(dst / "fragments" / "fragments.log", io_logfmt.Trajectory.from_matrices(bases))
    n = b - a + 1
    if (run / "gt.log").exists():  # the ground-truth poses of the fragments' first frames
        frames = io_logfmt.read_log(run / "gt.log").matrices()
        io_logfmt.write_log(dst / "gt_bases.log", io_logfmt.Trajectory.from_matrices(frames[a * K:(b + 1) * K:K]))
    gt = io_logfmt.read_log(run / "registration" / "gt.log").entries
    info = io_logfmt.read_info(run / "registration" / "gt.info").entries
    keep = [k for k, e in enumerate(gt) if a <= e.i and e.j <= b]
    io_logfmt.write_log(dst / "registration" / "gt.log", io_logfmt.Trajectory(
        [io_logfmt.TrajectoryEntry(gt[k].i - a, gt[k].j - a, n, gt[k].transform) for k in keep]))
    io_logfmt.write_info(dst / "registration" / "gt.info", io_logfmt.InfoFile(
        [io_logfmt.InfoEntry(info[k].i - a, info[k].j - a, n, info[k].info) for k in keep]))


def jax_draws(seed: int, batch: int, hypotheses: int):
    """The draws the JAX stage makes for the batch starting at pair ``start``
    (``pipeline/stages.py:352,360``: one key a pair, split from the stage seed
    folded with the batch's start; ``ransac`` draws ``randint(key, (H, 3), 0,
    2^30)``), as ``draws_for(start, n)`` of ``ladder_card.port_registration``."""

    def draws_for(start, n):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), start), batch)[:n]
        draws = jax.vmap(lambda k: jax.random.randint(k, (hypotheses, 3), 0, 1 << 30))(keys)
        return torch.from_numpy(np.array(draws))

    return draws_for


def write_draws(out: Path, batches: int) -> None:
    """The JAX stage's draws for the ladder's first ``batches`` batches, for a
    card-side ``ladder_card.py register``."""
    cfg = ladder_cfg(out.parent)
    B, H = cfg.registration_batch, cfg.registration.num_hypotheses
    draws_for = jax_draws(cfg.seed, B, H)
    np.savez(out, **{f"start_{s}": draws_for(s, B).numpy().astype(np.int32) for s in range(0, batches * B, B)})
    print(json.dumps({"draws": str(out), "batches": batches, "batch": B, "hypotheses": H}), flush=True)


def run_register(pkg: str, out: Path, key: str) -> dict:
    """One package's ``run_registration`` at config ``key``'s settings (the port's
    on the JAX stage's draws), with what its drift gate chose and every pair's result."""
    import elasticreconstruction_tpu.registration as j_reg
    import elasticreconstruction_tpu.registration.retrieval as j_retrieval

    jcfg = stage_cfg(key, out)
    if pkg == "torch":
        return ladder_card.port_registration(interop.pipeline_config_from(jcfg), "cpu",
                                             jax_draws(jcfg.seed, jcfg.registration_batch,
                                                       jcfg.registration.num_hypotheses))
    seen: dict = {"suspect_path": set(), "content": set()}
    calls: list = []
    real = j_reg.register_prepped_batch

    def batch(prepped, ii, jj, keys, rcfg):
        res = real(prepped, ii, jj, keys, rcfg)
        calls.append((ii, jj, res))
        return res

    patch = ladder_card.Patch()
    patch(j_reg, "register_prepped_batch", batch)
    patch(j_retrieval, "mutual_topk_pairs", ladder_card.capture_topk(seen, j_retrieval.mutual_topk_pairs))
    try:
        stats = j_stages.run_registration(jcfg)
    finally:
        patch.undo()
    return ladder_card.collect(calls, seen, stats)


def ensure_gt_benchmark(run: Path, data: Path) -> None:
    """``RUN/registration/gt.log`` and ``gt.info``, the ground-truth pair benchmark
    that ``evaluate`` writes, made by the port's ``run_make_gt_benchmark`` where
    the ladder ran no ``evaluate`` on ``RUN`` (4n)."""
    if not (run / "registration" / "gt.log").exists():
        cfg = interop.pipeline_config_from(stage_cfg(run.name, run))
        t_stages.run_make_gt_benchmark(SimpleNamespace(root=data, **vars(gt_dataset(data))), cfg, device="cpu")


def loop_pr(out: Path, gt_dir: Path) -> dict:
    gt_edges, gt_infos = gtb.read_gt_benchmark(gt_dir)
    loop = io_logfmt.read_log(out / "registration" / "loop.log")
    pr = prmod.precision_recall([(e.i, e.j, e.transform) for e in loop.entries], gt_edges, gt_infos)
    return {"precision": pr["precision"], "recall": pr["recall"], "loop_edges": len(loop.entries)}


def diagnose_register(run: Path, data: Path, window: str | None, packages, save: Path | None,
                      card: Path | None, load: Path | None) -> None:
    gt = gt_dataset(data).gt_poses
    key = run.name
    ensure_gt_benchmark(run, data)
    with tempfile.TemporaryDirectory() as tmp:
        src, a = run, 0
        if window:
            a, b = (int(x) for x in window.split("-"))
            src = Path(tmp) / "cut"
            cut_window(run, src, a, b)
            gt = gt[a * K:(b + 1) * K + 1]
        got = {}
        for pkg in packages:
            out = Path(tmp) / pkg
            shutil.copytree(src / "fragments", out / "fragments")
            t0 = time.time()
            saved = card if pkg == "torch" and card is not None else None
            if saved is None and load is not None and (load / pkg / "register_capture.json").exists():
                saved = load / pkg
            if saved is not None:
                got[pkg] = ladder_card.load_capture(saved)
                shutil.copytree(saved / "registration", out / "registration")
            elif pkg == "jax_nudged":
                nudge_clouds(out / "fragments")
                got[pkg] = run_register("jax", out, key)
            else:
                got[pkg] = run_register(pkg, out, key)
            stats, t_reg = got[pkg]["stats"], time.time() - t0
            got[pkg]["odometry"] = io_logfmt.read_log(out / "registration" / "odometry.log").matrices()
            got[pkg]["odometry_suspect"] = (out / "registration" / "odometry_suspect.txt").read_text()
            if pkg != "torch":
                j_stages.run_posegraph(stage_cfg(key, out))
            else:
                t_stages.run_posegraph(interop.pipeline_config_from(stage_cfg(key, out)), device="cpu")
            print(json.dumps({"register": pkg, "window": window, "seconds": t_reg,
                              "where": "card" if pkg == "torch" and card is not None else "CPU",
                              **{k: stats.get(k) for k in ("pairs", "accepted", "suspect_odometry_edges",
                                                            "gate_admitted", "gate_suspect_path",
                                                            "gate_content_admitted")},
                              **loop_pr(out, src / "registration"),
                              **frame_ate(out, out / "posegraph" / "pose.log", gt)}), flush=True)
            if save is not None:
                ladder_card.save_capture(got[pkg], save / pkg)
                for sub in ("registration", "posegraph"):
                    shutil.copytree(out / sub, save / pkg / sub, dirs_exist_ok=True)
        if not window:
            card = {"register": "torch on the card (its own draws)", **loop_pr(run, run / "registration"),
                    **frame_ate(run, run / "posegraph" / "pose.log", gt)}
            print(json.dumps(card), flush=True)
        for other in ("torch", "jax_nudged"):
            if "jax" in got and other in got:
                compare_registrations(got["jax"], got[other], f"jax vs {other}", gt[::K])


def nudge_clouds(frag: Path, seed: int = 0) -> None:
    """Every fragment cloud's coordinates moved by one f32 ulp, up or down at
    random: the least change of the input, to show how far the stage's own
    f32 arithmetic carries it."""
    rng = np.random.default_rng(seed)
    for p in sorted(frag.glob("cloud_bin_*.pcd")):
        pts, nrm = io_logfmt.read_pcd(p)
        pts = np.asarray(pts, np.float32)
        step = np.where(rng.random(pts.shape) < 0.5, -np.inf, np.inf).astype(np.float32)
        io_logfmt.write_pcd(p, np.nextafter(pts, step), nrm)


RIGHT = (0.1, 0.1)  # m, rad: a pair registered within these of ground truth is registered right


def compare_registrations(j: dict, t: dict, label: str, gt_bases: np.ndarray) -> None:
    """Two runs' gate sets, odometry edges and pair results, the pairs matched by
    ``(i, j)`` and attempt. A pair is registered right when accepted within
    ``RIGHT`` of the ground truth ``gt_bases`` give; where neither run registers
    it right (an aliased view), RANSAC has no true optimum to agree on."""
    rec = {"compare": label, "admitted_equal": j["admitted"] == t["admitted"],
           "suspect_path_equal": j["suspect_path"] == t["suspect_path"],
           "content_equal": j["content"] == t["content"], "pairs_equal": j["pairs"] == t["pairs"],
           "admitted": len(j["admitted"]), "suspect_path": len(j["suspect_path"]), "content": len(j["content"])}
    d_odo = np.abs(j["odometry"] - t["odometry"]).max((1, 2))
    rec.update(odometry_suspect_equal=j["odometry_suspect"] == t["odometry_suspect"],
               odometry_max_abs_diff=float(d_odo.max()) if len(d_odo) else 0.0,
               odometry_beyond_1e3=[int(f) for f in np.flatnonzero(d_odo > 1e-3)])

    def attempts(run):
        seen: dict = {}
        for k, p in enumerate(run["pairs"]):
            seen.setdefault(p, []).append(k)
        return seen

    def right(run, k):
        i, jj = run["pairs"][k]
        te, re = bench_scene.pose_error(run["transform"][k], np.linalg.inv(gt_bases[i]) @ gt_bases[jj])
        return bool(run["success"][k]) and te < RIGHT[0] and re < RIGHT[1]

    aj, at = attempts(j), attempts(t)
    common = [(p, a, b) for p in aj if p in at for a, b in zip(aj[p], at[p])]
    flips, flips_right, both, both_right, d_right = [], 0, 0, 0, []
    for p, a, b in common:
        sj, st = bool(j["success"][a]), bool(t["success"][b])
        rj, rt = right(j, a), right(t, b)
        if sj != st:
            flips.append(p)
            flips_right += rj or rt
        both += sj and st
        if rj and rt:
            both_right += 1
            d_right.append(float(np.abs(j["transform"][a] - t["transform"][b]).max()))
    d_right = np.array(d_right or [0.0])
    rec.update(pairs_matched=len(common), pairs_unmatched=len(j["pairs"]) + len(t["pairs"]) - 2 * len(common),
               success_flips=len(flips), flips_on_a_pair_either_registers_right=flips_right, both_success=both,
               both_right=both_right, both_right_max_abs_diff=float(d_right.max()),
               both_right_beyond_1e3=int((d_right > 1e-3).sum()), flipped_pairs=flips)
    print(json.dumps({"register_compare": rec}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stage", choices=["posegraph", "optimize", "render", "fragments", "register", "draws", "cut"])
    ap.add_argument("run", type=Path, help="the port's stage directory from the card (draws: the file to write)")
    ap.add_argument("data", type=Path, nargs="?", help="the dataset directory holding gt.log")
    ap.add_argument("--fragments", type=int, default=None, help="optimize: cut to the first K fragments")
    ap.add_argument("--capacity", type=int, default=1 << 16,
                    help="optimize: rows a cloud is padded to (the ladder's 1 << 16 by default; the padding is "
                         "masked, so any capacity that holds every cloud harvests the same rows)")
    ap.add_argument("--package", choices=["jax", "torch", "jax_nudged"], default=None,
                    help="optimize, register: one package only")
    ap.add_argument("--nudge", action="store_true",
                    help="register, fragments: the JAX stage again on inputs moved by one f32 ulp (nudge_clouds; the "
                         "depth frames)")
    ap.add_argument("--frames", type=Path, default=None, help="render, fragments: a packed frames_*.xz")
    ap.add_argument("--scene", choices=sorted(RADII), default="livingroom", help="render: the scene the frames show")
    ap.add_argument("--modes", default=None, help="optimize: these --slac-modes only (comma list)")
    ap.add_argument("--stages-from", type=Path, default=None,
                    help="optimize: registration/ and posegraph/ from this directory (a register --save run)")
    ap.add_argument("--trace", type=Path, default=None, help="fragments: the card's odometry_trace.json")
    ap.add_argument("--reference", type=Path, default=None,
                    help="fragments: the reference's fragments/ (health_<f>.json) to print beside")
    ap.add_argument("--fragment-list", default=None, help="fragments: only these (comma list)")
    ap.add_argument("--port-cpu", type=int, default=0, metavar="N",
                    help="fragments: the port's build_fragment on the CPU over each fragment's first N frames too")
    ap.add_argument("--window", default=None, help="register: fragments A-B only, renumbered from 0")
    ap.add_argument("--save", type=Path, default=None, help="register: keep both packages' outputs here")
    ap.add_argument("--card", type=Path, default=None,
                    help="register: the port's run on the JAX draws from the card (ladder_card.py register) in "
                         "place of a CPU run")
    ap.add_argument("--load", type=Path, default=None,
                    help="register: take each run that DIR/<run>/ holds (as --save wrote it) instead of running it")
    ap.add_argument("--batches", type=int, default=48, help="draws: batches to write")
    ap.add_argument("--no-normals", action="store_true", help="cut: write the clouds without normals")
    args = ap.parse_args(argv)
    packages = [args.package] if args.package else ["jax", "torch"] + (["jax_nudged"] if args.nudge else [])
    if args.stage == "posegraph":
        diagnose_posegraph(args.run, args.data)
    elif args.stage == "render":
        diagnose_render(args.run, args.data, args.frames, args.scene)
    elif args.stage == "fragments":
        key = ladder_card.CONFIGS[args.run.name][2]  # the trace is keyed by the config's artifact directory
        only = None if args.fragment_list is None else [int(x) for x in args.fragment_list.split(",")]
        diagnose_fragments(args.run, args.data, args.frames, args.trace, key, args.reference, only, args.port_cpu,
                           args.nudge)
    elif args.stage == "register":
        diagnose_register(args.run, args.data, args.window, packages, args.save, args.card, args.load)
    elif args.stage == "draws":
        write_draws(args.run, args.batches)
    elif args.stage == "cut":
        a, b = (int(x) for x in args.window.split("-"))
        ensure_gt_benchmark(args.run, args.run)
        cut_window(args.run, args.data, a, b, normals=not args.no_normals)
    else:
        diagnose_optimize(args.run, args.data, args.fragments, args.capacity, packages, args.stages_from,
                          args.modes and args.modes.split(","))
    return 0


if __name__ == "__main__":
    sys.exit(main())
