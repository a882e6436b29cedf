"""The readings a cell's limits are set from: the program's numbers and the control's, seed by seed.

    python3 -m benchmark.readings --workload <cell> --seeds 11,12,... --control-seeds 11,12,13 \
        [--out FILE]

For each seed: the cell's set-up, then (program seeds) the timed path once
(one call per dataset, or one pass) judged as a run judges it, and (control
seeds) the reference in TF32 put in the program's place (``entry.control``)
and judged the same way. One JSON line a seed, with each number's worst over
the seed's calls; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from benchmark import harness
from benchmark.entries import common


def summary(verdicts: list[dict]) -> dict:
    """Each number's worst over the judged calls, every number the judge gives (limited or not)."""
    return {k: max(v[k] for v in verdicts) for k in verdicts[0]}


def seed_readings(cell: dict, entry, seed: int, program: bool, control: bool, device: str, calls: int) -> dict:
    rec = {"seed": seed}
    workdir = Path(tempfile.mkdtemp(prefix="readings-"))
    try:
        t0 = time.perf_counter()
        state = entry.setup(cell, seed, device, workdir)
        rec["setup_s"] = time.perf_counter() - t0
        if program:
            t0 = time.perf_counter()
            for _ in range(calls):
                entry.call(state)
            rec["program_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rec["program"] = summary(entry.judge(state))
            rec["judge_s"] = time.perf_counter() - t0
        if control:
            t0 = time.perf_counter()
            outs = entry.control(state)
            rec["control_s"] = time.perf_counter() - t0
            rec["control"] = summary(entry.judge(state, outs))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--calls", type=int, default=0, help="timed calls a seed (default: one a dataset, or one pass)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    common.env_threads()
    cell = harness.load_cell(args.workload)
    entry = harness.load_entry(cell["entry"])
    calls = args.calls or cell["traffic"].get("fragments", 1) if cell["entry"] == "odometry" else args.calls or 1
    prog = [int(s) for s in args.seeds.split(",") if s]
    ctrl = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in dict.fromkeys(prog + ctrl):
        rec = seed_readings(cell, entry, seed, seed in prog, seed in ctrl, "cuda", calls)
        rec["workload"] = args.workload
        line = json.dumps(rec, default=str)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
