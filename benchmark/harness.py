"""One run of one cell: set-up, the measured window or the traced calls, the judge, the result line.

Everything a cell needs is found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``) and its entry
(``entries/<entry>.py``); the cell's end-to-end metrics are those
``BENCHMARK.json`` lists for it, each but ``setup_s`` the rate of the units
the entry's calls return over the window; each per-layer metric of
``BENCHMARK.json`` is read by ``metrics/<metric>.py``. The result is the last
line of standard output; the numbers the judge compared, each with its limit,
are the last lines of standard error and the last key of the result.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# Top-level module names that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "elasticreconstruction_tpu")


class RunError(RuntimeError):
    """A run that must end without a result (exit code 2)."""


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.exists():
        raise RunError(f"no {kind} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def load_cell(name: str) -> dict:
    """The workload file of cell ``name`` with its configuration file under ``"config"``."""
    cell = load_json("workloads", name)
    cell["name"] = name
    cell["config_name"] = cell["config"]
    cell["config"] = load_json("configs", cell["config"])
    return cell


def load_entry(name: str):
    return importlib.import_module(f"benchmark.entries.{name}")


def load_reader(metric: str):
    """The reader module ``metrics/<metric>.py`` (metric names may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.reader_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's or the JAX package's."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def run_window(call, seconds: float, clock=time.perf_counter) -> tuple[int, int, float]:
    """Timed calls from the first until ``seconds`` have passed; the call in flight then
    completes and counts, and the window ends with it. Returns (calls, units, window s)."""
    start = clock()
    calls = units = 0
    while True:
        units += call()
        calls += 1
        end = clock()
        if end - start >= seconds:
            return calls, units, end - start


def rate(units: int, window_s: float) -> float:
    return units / window_s


def end_to_end_names(man: dict, cell: str) -> list[str]:
    return [m["name"] for m in man["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_metrics(man: dict, cell: str) -> list[dict]:
    mine = set(end_to_end_names(man, cell))
    return [m for m in man["per_layer"] if cell in m.get("workloads", [cell] if m["moves"] in mine else [])]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def judge_summary(verdicts: list[dict], limits: dict) -> tuple[int, int, dict]:
    """(attempted, failed, {number: {"value": worst, "limit": limit}}) over the judged calls."""
    worst = {k: 0.0 for k in limits}
    failed = 0
    for v in verdicts:
        bad = False
        for k, lim in limits.items():
            x = v[k]
            worst[k] = max(worst[k], x) if not math.isnan(x) else math.inf
            bad |= not (x <= lim)
        failed += bad
    return len(verdicts), failed, {k: {"value": worst[k] if math.isfinite(worst[k]) else "inf", "limit": limits[k]}
                                   for k in limits}


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str = "cuda", overrides: dict | None = None) -> dict:
    """The result record of one run. ``device`` and ``overrides`` (merged into the
    workload file) are for the benchmark's own tests on the CPU."""
    import torch

    from benchmark.entries import common

    man = manifest()
    cell = load_cell(cell_name)
    for k, v in (overrides or {}).items():
        cell[k] = {**cell[k], **v} if k != "limits" and isinstance(v, dict) and isinstance(cell.get(k), dict) else v
    chips = next((w["chips"] for w in man["workloads"] if w["name"] == cell_name), 1)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is False: this benchmark measures a CUDA card")
        if torch.cuda.device_count() < chips:
            raise RunError(f"the cell asks for {chips} cards, {torch.cuda.device_count()} present")
    common.env_threads()
    entry = load_entry(cell["entry"])
    workdir = Path(tempfile.mkdtemp(prefix="bench-"))
    try:
        state = entry.setup(cell, seed, device, workdir)
        setup_s = time.perf_counter() - t_start
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        obs = None
        if trace:
            obs = entry.trace(state)
        else:
            durations, cpu = [], []

            def timed_call():
                t0, c0 = time.perf_counter(), time.process_time()
                units = entry.call(state)
                durations.append(time.perf_counter() - t0)
                cpu.append(time.process_time() - c0)
                return units

            _, units, window_s = run_window(timed_call, seconds)
            print("calls_s " + " ".join(f"{d:.3f}" for d in durations), file=sys.stderr)
            print("calls_cpu_s " + " ".join(f"{d:.3f}" for d in cpu), file=sys.stderr)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        entry.release(state)
        attempted, failed, checks = judge_summary(entry.judge(state), cell["limits"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    metrics = {}
    if trace:
        from benchmark import trace as tr

        red = tr.reduce(obs["device"])
        obs["device"] = red
        for m in per_layer_metrics(man, cell_name):
            value = load_reader(m["name"]).read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        units_of = {m["name"]: m["unit"] for m in man["end_to_end"]}
        for name in end_to_end_names(man, cell_name):
            value = setup_s if name == "setup_s" else rate(units, window_s)
            metrics[name] = {"value": value, "unit": units_of[name]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": attempted > 0 and failed == 0, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = red["busy_s"], red["window_s"]
        out["breakdown"] = red["breakdown"]
    out["checks"] = checks
    return out


def main(argv=None, *, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; it may load neither JAX nor the JAX package",
              file=sys.stderr)
        return 3
    if args.trace:
        print(f"card: {card_line()}", file=sys.stderr)
        print(f"trace: {out['device']['busy_s']!r} s busy of {out['device']['window_s']!r} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
