"""Entry: the ``fragments`` stage, ``pipeline/stages.py::run_fragments``, on one-fragment datasets.

Set-up renders ``fragments`` consecutive fragments of the livingroom orbit
(``traffic/livingroom.py``) on the card and writes each as a dataset of
``frames_per_fragment + 1`` frames; a warm-up call runs the stage on the first
``warm_frames`` frames at the same shapes. Each timed call runs the whole verb
on the next dataset in turn: PNG decoding, ``build_fragment``, the readback and
the files. The judge follows each call's poses with the reference
(``reference/odometry.py::follow``) and compares poses, cloud and health.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

from benchmark.entries import common
from benchmark.reference import compare, files, prec
from benchmark.reference import odometry as ref
from benchmark.reference.geometry import Intrinsics
from benchmark.traffic import livingroom

FILES = ("local_0.log", "cloud_bin_0.pcd", "health_0.json")
NUMBERS = ("pose_gap_m", "pose_gap_rad", "pose_gap_median_m", "pose_gap_median_rad", "cloud_gap_m",
           "cloud_gap_median_m", "health_gap")


def settings(config: dict) -> ref.Settings:
    frag, odo = config["fragment"], config["odometry"]
    return ref.Settings(
        tuple(frag["volume_shape"]), frag["voxel_size"], frag["volume_min_z"], frag["cloud_capacity"],
        frag["max_weight"], frag["depth_min"], frag["depth_max"], odo["levels"], tuple(odo["iterations"]),
        odo["dist_threshold"], odo["depth_min"], odo["depth_max"], odo["raycast_steps"], odo["raycast_scale"],
        odo["damping"], odo["min_support"], odo["max_step"], odo["velocity_gain"], odo["prior_beta"],
        odo["healthy_obs_ratio"], odo["healthy_fitness"])


def program_config(config: dict, frames_per_fragment: int):
    from elasticreconstruction_tpu_torch.odometry import FragmentConfig, OdometryConfig
    from elasticreconstruction_tpu_torch.pipeline.config import PipelineConfig
    from elasticreconstruction_tpu_torch.registration import RegistrationConfig

    frag = dict(config["fragment"], volume_shape=tuple(config["fragment"]["volume_shape"]))
    odo = dict(config["odometry"], iterations=tuple(config["odometry"]["iterations"]))
    return PipelineConfig(frames_per_fragment=frames_per_fragment,
                          fragment=FragmentConfig(frames_per_fragment=frames_per_fragment,
                                                  odometry=OdometryConfig(**odo), **frag),
                          registration=RegistrationConfig(**config["registration"]),
                          slac_mode=config["slac_mode"])


def setup(cell: dict, seed: int, device, workdir: Path) -> dict:
    from elasticreconstruction_tpu_torch.pipeline.dataset import Dataset
    from elasticreconstruction_tpu_torch.pipeline.stages import run_fragments

    config, traffic = cell["config"], cell["traffic"]
    dev = torch.device(device)
    intr = Intrinsics(**config["camera"])
    K = config["frames_per_fragment"]
    mm, gt = livingroom.orbit_frames(dict(traffic, frames=traffic["fragments"] * K + 1), intr, seed, dev)
    datasets = []
    for f in range(traffic["fragments"]):
        root = workdir / f"data_{f}"
        livingroom.write_dataset(root, mm[f * K : f * K + K + 1], gt[f * K : f * K + K + 1], intr)
        datasets.append(Dataset(root))
    warm = traffic["warm_frames"]
    livingroom.write_dataset(workdir / "data_warm", mm[:warm], gt[:warm], intr)
    cfg = program_config(config, K)
    with common.program_stdout_to_stderr():
        run_fragments(Dataset(workdir / "data_warm"),
                      dataclasses.replace(program_config(config, warm - 1), out_dir=str(workdir / "warm")),
                      device=dev)
    return {"cell": cell, "dev": dev, "intr": intr, "K": K, "mm": mm, "datasets": datasets, "cfg": cfg,
            "workdir": workdir, "calls": []}


def call(state: dict) -> int:
    """One ``run_fragments`` call on the next dataset; returns the frames it tracked and fused."""
    from elasticreconstruction_tpu_torch.pipeline.stages import run_fragments

    n = len(state["calls"])
    f = n % len(state["datasets"])
    out = state["workdir"] / "out" / f"call_{n}"
    with common.program_stdout_to_stderr():
        run_fragments(state["datasets"][f], dataclasses.replace(state["cfg"], out_dir=str(out)), device=state["dev"])
    state["calls"].append((f, out / "fragments"))
    return state["K"] + 1


def trace(state: dict) -> dict:
    """One call under the profiler, one under the sync counter."""
    prof = common.profiled(lambda: call(state), state["dev"])
    syncs = common.count_host_syncs(lambda: call(state), state["dev"])
    return {"device": prof, "odometry": {"frames": state["K"] + 1, "host_syncs": syncs}}


def release(state: dict) -> None:
    if state["dev"].type == "cuda":
        torch.cuda.empty_cache()


def _depths(state: dict, f: int) -> torch.Tensor:
    K = state["K"]
    return torch.from_numpy(livingroom.from_millimetres(state["mm"][f * K : f * K + K + 1])).to(state["dev"])


def _health(fr: ref.Fragment, odo: dict) -> dict:
    """The health record of a walk's tracked frames (all but frame 0)."""
    return files.health(fr.fitness[1:].cpu().numpy(), fr.rmse[1:].cpu().numpy(), fr.obs_ratio[1:].cpu().numpy(),
                        odo["healthy_obs_ratio"], odo["healthy_fitness"])


def judge(state: dict, calls=None) -> list[dict]:
    """Each call's files against the reference following that call's poses."""
    st = settings(state["cell"]["config"])
    odo = state["cell"]["config"]["odometry"]
    followed = {}
    verdicts = []
    for f, out in state["calls"] if calls is None else calls:
        try:
            poses = files.read_log(out / FILES[0])
            pts, _ = files.read_pcd(out / FILES[1])
            health = files.read_health(out / FILES[2])
        except (OSError, ValueError, KeyError) as e:
            print(f"judge: {out}: {e}", file=sys.stderr, flush=True)
            verdicts.append({k: float("inf") for k in NUMBERS})
            continue
        print(f"judge: {out.name}: {len(pts)} cloud points", file=sys.stderr)
        key = (f, poses.astype(np.float32).tobytes())
        if key not in followed:
            given = torch.from_numpy(poses.astype(np.float32)).to(state["dev"])
            if given.shape[0] != state["K"] + 1:
                given = torch.eye(4, device=state["dev"]).expand(state["K"] + 1, 4, 4)
            followed[key] = ref.follow(_depths(state, f), state["intr"], st, given)
        fr = followed[key]
        verdicts.append({
            **compare.pose_gaps(poses, fr.poses.double().cpu().numpy()),
            **compare.cloud_gaps(torch.from_numpy(pts).to(state["dev"]), fr.cloud.points),
            "health_gap": compare.health_gap(health, _health(fr, odo)),
        })
    return verdicts


def control(state: dict) -> list[tuple[int, Path]]:
    """The reference one precision below the configuration's (matrix products in TF32, the TSDF stored in
    bfloat16) in the program's place: each dataset's files written as the stage writes them."""
    st = settings(state["cell"]["config"])
    odo = state["cell"]["config"]["odometry"]
    outs = []
    for f in range(len(state["datasets"])):
        with prec.tf32_products(), prec.bf16_storage():
            fr = ref.chain(_depths(state, f), state["intr"], st)
        out = state["workdir"] / "control" / f"call_{f}"
        out.mkdir(parents=True, exist_ok=True)
        files.write_log(out / FILES[0], fr.poses.double().cpu().numpy())
        files.write_pcd(out / FILES[1], fr.cloud.points.cpu().numpy(), fr.cloud.normals.cpu().numpy())
        files.write_health(out / FILES[2], _health(fr, odo))
        outs.append((f, out))
    return outs
