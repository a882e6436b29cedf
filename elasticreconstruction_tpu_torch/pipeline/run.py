"""Pipeline CLI: ``python -m elasticreconstruction_tpu_torch.pipeline.run <stage>``.

Counterpart of ``elasticreconstruction_tpu/pipeline/run.py`` for the stages
the port has: ``register`` and ``posegraph``. Every stage resumes from the
previous stage's file artifacts under ``--out``. Stages run on ``--device``
(default ``cuda``, which raises if no card is present).
"""

from __future__ import annotations

import argparse
import sys

from ..elastic.slac import SlacConfig
from ..odometry.fragments import FragmentConfig
from ..odometry.kinfu import OdometryConfig
from ..registration.pair import RegistrationConfig
from .config import PipelineConfig
from .stages import run_posegraph, run_registration

STAGES = ("register", "posegraph")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="elasticreconstruction_tpu_torch")
    p.add_argument("stage", choices=list(STAGES))
    p.add_argument("--data", default="data", help="dataset directory")
    p.add_argument("--out", default="out", help="artifact directory")
    p.add_argument("--frames-per-fragment", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--preset",
        default="full",
        choices=["full", "fast"],
        help="fast = reduced capacities/hypotheses for quick looks & CI",
    )
    p.add_argument("--odometry-only", action="store_true", help="register: skip loop candidates")
    p.add_argument("--device", default="cuda", help="torch device the stage runs on")
    return p


def config_from_args(args) -> PipelineConfig:
    fast = args.preset == "fast"
    # The whole record the reference's CLI builds for the same flags, fields
    # of unported stages included, so both packages read one configuration.
    frag = FragmentConfig(
        frames_per_fragment=args.frames_per_fragment,
        volume_shape=(128 if fast else 256,) * 3,
        voxel_size=0.024 if fast else 0.012,
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
        corres_capacity_per_edge=2048 if fast else 4096,
        scene_voxel_size=0.03 if fast else 0.015,
        seed=args.seed,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.stage == "register":
        run_registration(cfg, all_pairs=not args.odometry_only, device=args.device)
    elif args.stage == "posegraph":
        run_posegraph(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
