"""Pipeline CLI: ``python -m elasticreconstruction_tpu_torch.pipeline.run <stage>``.

Counterpart of ``elasticreconstruction_tpu/pipeline/run.py``, with its verbs
``synth``, ``fragments``, ``register``, ``posegraph``, ``optimize``,
``integrate``, ``evaluate`` and ``all``. Every stage resumes from the previous
stage's file artifacts under ``--out`` (``synth`` writes the dataset under
``--data``). Stages run on ``--device`` (default ``cuda``, which raises if no
card is present), in every ``--slac-mode`` (default ``slac``, as the
reference's). ``--profile DIR`` writes a ``torch.profiler`` Chrome trace of
the stage under ``DIR/<stage>/``.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

import torch

from ..elastic.slac import SlacConfig
from ..odometry.fragments import FragmentConfig
from ..odometry.kinfu import OdometryConfig
from ..registration.pair import RegistrationConfig
from .config import PipelineConfig
from .dataset import Dataset, generate_synthetic
from .stages import (
    run_all,
    run_evaluate,
    run_fragments,
    run_integrate,
    run_optimize,
    run_posegraph,
    run_registration,
)

STAGES = ("synth", "fragments", "register", "posegraph", "optimize", "integrate", "evaluate", "all")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="elasticreconstruction_tpu_torch")
    p.add_argument("stage", choices=list(STAGES))
    p.add_argument("--data", default="data", help="dataset directory")
    p.add_argument("--out", default="out", help="artifact directory")
    p.add_argument("--frames-per-fragment", type=int, default=50)
    p.add_argument("--slac-mode", default="slac", choices=["rigid", "slac", "nonrigid", "none"])
    p.add_argument("--scene-voxel", type=float, default=None, help="default 0.015 (full) / 0.03 (fast)")
    p.add_argument("--fragment-voxel", type=float, default=None, help="default 0.012 (full) / 0.024 (fast)")
    p.add_argument("--fragment-volume", type=int, default=None,
                   help="fragment TSDF resolution per axis; default 256 (full) / 128 (fast)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--spill-corres", action="store_true", help="optimize: write corres_<i>_<j>.txt point pairs")
    p.add_argument("--spill-deformed", action="store_true",
                   help="optimize: dump deformed fragment clouds (.xyzn); none under --slac-mode none")
    p.add_argument(
        "--preset",
        default="full",
        choices=["full", "fast"],
        help="fast = reduced capacities/hypotheses for quick looks & CI",
    )
    p.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="write a torch.profiler Chrome trace of the stage under DIR/<stage>/ (one file a "
        "stage run; open it in Perfetto or chrome://tracing). A fragments trace is large: "
        "about 11 700 kernels a frame",
    )
    p.add_argument("--odometry-only", action="store_true", help="register: skip loop candidates")
    # synth options
    p.add_argument("--num-frames", type=int, default=200)
    p.add_argument("--depth-noise", type=float, default=0.0)
    p.add_argument("--size", default="160x120", help="synthetic image WxH")
    p.add_argument("--device", default="cuda", help="torch device the stage runs on")
    return p


def config_from_args(args) -> PipelineConfig:
    fast = args.preset == "fast"
    # The whole record the reference's CLI builds for the same flags, fields
    # of unported stages included, so both packages read one configuration.
    # Volumetric resolutions scale with the preset unless set: "fast" halves
    # the fragment grid and doubles both voxel sizes (same metric extent).
    fragment_volume = args.fragment_volume or (128 if fast else 256)
    frag = FragmentConfig(
        frames_per_fragment=args.frames_per_fragment,
        volume_shape=(fragment_volume,) * 3,
        voxel_size=args.fragment_voxel or (0.024 if fast else 0.012),
        cloud_capacity=(1 << 14) if fast else (1 << 17),
        odometry=OdometryConfig(levels=2, raycast_steps=128) if fast else OdometryConfig(),
    )
    reg = (
        RegistrationConfig(coarse_capacity=2048, fine_capacity=4096, num_hypotheses=1024)
        if fast
        else RegistrationConfig()
    )
    return PipelineConfig(
        data_dir=args.data,
        out_dir=args.out,
        frames_per_fragment=args.frames_per_fragment,
        fragment=frag,
        registration=reg,
        slac=SlacConfig(resolution=6, cg_iterations=24, outer_iterations=3) if fast else SlacConfig(),
        slac_mode=args.slac_mode,
        corres_capacity_per_edge=2048 if fast else 4096,
        scene_voxel_size=args.scene_voxel or (0.03 if fast else 0.015),
        seed=args.seed,
    )


def synth_intrinsics(size: str):
    """The ``synth`` verb's camera for a ``WxH`` image: ~43 deg horizontal field of view."""
    from ..core import camera as cam

    w, h = (int(v) for v in size.split("x"))
    f = 1.25 * w
    return cam.Intrinsics(fx=f, fy=f, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w, height=h)


@contextlib.contextmanager
def profiled(trace_dir: Path | None, device: torch.device):
    """A ``torch.profiler`` trace of the enclosed work, written on exit as one
    Chrome trace ``trace_<time>.json`` under ``trace_dir`` (nothing when it is
    None). CPU activity always; CUDA activity too when ``device`` is a card,
    so the trace holds the kernels' device spans (CUPTI)."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    trace_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(trace_dir / f"trace_{time.strftime('%Y%m%d-%H%M%S')}.json"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.stage == "synth":
        generate_synthetic(args.data, num_frames=args.num_frames, intr=synth_intrinsics(args.size),
                           depth_noise=args.depth_noise, seed=args.seed, device=args.device)
        print(f"synthetic dataset written to {args.data}")
        return 0
    cfg = config_from_args(args)
    ds = Dataset(args.data) if args.stage in ("fragments", "integrate", "evaluate", "all") else None
    trace_dir = Path(args.profile) / args.stage if args.profile else None
    with profiled(trace_dir, torch.device(args.device)):
        if args.stage == "fragments":
            run_fragments(ds, cfg, device=args.device)
        elif args.stage == "register":
            run_registration(cfg, all_pairs=not args.odometry_only, device=args.device)
        elif args.stage == "posegraph":
            run_posegraph(cfg, device=args.device)
        elif args.stage == "optimize":
            run_optimize(cfg, spill_corres=args.spill_corres, spill_deformed=args.spill_deformed, device=args.device)
        elif args.stage == "integrate":
            run_integrate(ds, cfg, device=args.device)
        elif args.stage == "evaluate":
            run_evaluate(ds, cfg, device=args.device)
        elif args.stage == "all":
            run_all(ds, cfg, device=args.device)
    if trace_dir is not None:
        print(f"profiler trace written under {trace_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
