"""Where the registration stage's time goes, on existing fragment artifacts.

Counterpart of the repository's ``tools/reg_profile.py``. Runs
``run_registration`` twice in one process on the fragments of ``out_dir``
(default: the ladder's config 3 directory), cold then warm, and prints both
stats records, whose phase split attributes the stage's rate: prep (fragment
prep and the odometry refine), dispatch (the host loop queueing the batches),
drain (what the device still had queued, and the read-back) and io (result
filtering and the ``.log``/``.info`` writes).

    python -m elasticreconstruction_tpu_torch.tools.reg_profile [out_dir] [--batch N] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

from ..core.types import resolve_device
from ..odometry.fragments import FragmentConfig
from ..pipeline import stages
from ..pipeline.config import PipelineConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="elasticreconstruction_tpu_torch.tools.reg_profile")
    ap.add_argument("out_dir", nargs="?", default="milestone_runs_gpu/out_full")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    return ap


def profile(out_dir: str, batch: int = 16, device="cuda") -> dict:
    """The cold and warm stats records of ``run_registration`` on ``out_dir``."""
    cfg = PipelineConfig(
        data_dir="milestone_runs_gpu/data",
        out_dir=out_dir,
        frames_per_fragment=50,
        fragment=FragmentConfig(frames_per_fragment=50, cloud_capacity=1 << 16),
        registration_batch=batch,
    )
    device = resolve_device(device)
    cold = stages.run_registration(cfg, all_pairs=True, device=device)
    warm = stages.run_registration(cfg, all_pairs=True, device=device)
    return {"cold": cold, "warm": warm, "batch": batch}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(json.dumps(profile(args.out_dir, args.batch, args.device), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
