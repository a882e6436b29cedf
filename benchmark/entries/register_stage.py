"""Entry: the registration stage, ``pipeline/stages.py::run_registration``, over every fragment of a scene.

Set-up writes the scene's fragment files once (``traffic/scene.py``: the
whole orbit's fragments, their clouds, drifted base poses and health) and
warms one whole stage call on them. A timed call is one
``run_registration(all_pairs=True)`` as a deployment runs it: load, prep,
odometry edges, the drift gate, every batch, the drain and the files. Each
call writes to its own output directory, whose ``fragments`` links to the
shared one, and returns the pairs it sent through the registrar. The judge
computes the reference's stage once (``reference/stage.py``) and compares
every call's files with it.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from benchmark.entries import common
from benchmark.reference import prec
from benchmark.reference import stage as ref
from benchmark.traffic import scene


def program_config(config: dict, out_dir: Path):
    from elasticreconstruction_tpu_torch.odometry import FragmentConfig
    from elasticreconstruction_tpu_torch.pipeline.config import PipelineConfig
    from elasticreconstruction_tpu_torch.registration import RegistrationConfig

    K = config["frames_per_fragment"]
    frag = dict(config["fragment"], volume_shape=tuple(config["fragment"]["volume_shape"]))
    radius = config["loop_candidate_radius"]
    return PipelineConfig(out_dir=str(out_dir), frames_per_fragment=K,
                          fragment=FragmentConfig(frames_per_fragment=K, **frag),
                          registration=RegistrationConfig(**config["registration"]),
                          registration_batch=config["registration_batch"], slac_mode=config["slac_mode"],
                          loop_candidate_radius=float("inf") if radius is None else radius,
                          **{k: config[k] for k in ("loop_gating", "drift_per_fragment", "drift_suspect", "gate_margin",
                                                    "gate_near_diagonal", "retrieval_topk", "seed")})


def _out(workdir: Path, name: str) -> Path:
    """An output directory of its own whose ``fragments`` is the scene's."""
    out = workdir / "calls" / name
    out.mkdir(parents=True)
    (out / "fragments").symlink_to(workdir / "scene" / "fragments", target_is_directory=True)
    return out


def setup(cell: dict, seed: int, device, workdir: Path) -> dict:
    config = cell["config"]
    dev = torch.device(device)
    centroids = scene.write_fragments(workdir / "scene" / "fragments", cell["traffic"], config, seed, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    state = {"cell": cell, "dev": dev, "workdir": workdir, "centroids": centroids, "calls": []}
    _stage(state, "warm")
    return state


def _stage(state: dict, name: str) -> tuple[Path, dict]:
    from elasticreconstruction_tpu_torch.pipeline.stages import run_registration

    cfg = program_config(state["cell"]["config"], _out(state["workdir"], name))
    with common.program_stdout_to_stderr():
        stats = run_registration(cfg, all_pairs=True, device=state["dev"])
    return cfg.p_registration(), stats


def call(state: dict) -> int:
    """One stage call; returns the pairs it sent through the registrar."""
    out, stats = _stage(state, f"call_{len(state['calls'])}")
    state["calls"].append((out, stats))
    return stats["pairs"]


def trace(state: dict) -> dict:
    """One call under the profiler."""
    return {"device": common.profiled(lambda: call(state), state["dev"])}


def release(state: dict) -> None:
    if state["dev"].type == "cuda":
        torch.cuda.empty_cache()


def reference(state: dict) -> ref.Outcome:
    return ref.stage(state["workdir"] / "scene" / "fragments", ref.Settings.of(state["cell"]["config"]), state["dev"])


def judge(state: dict, outcomes=None) -> list[dict]:
    """Every call's files (or the given outcomes) against the reference's stage, computed once."""
    rr = reference(state)
    print(f"judge: the reference sends {len(rr.candidates)} pairs and accepts {len(rr.loops)}", file=sys.stderr)
    if outcomes is None:
        outcomes = []
        for out, stats in state["calls"]:
            try:
                outcomes.append(ref.read_outcome(out, stats))
            except (OSError, ValueError) as e:
                print(f"judge: {out}: {e}", file=sys.stderr, flush=True)
                outcomes.append(None)
    inf = float("inf")
    return [ref.gaps(o, rr, state["centroids"]) if o is not None else {k: inf for k in state["cell"]["limits"]}
            for o in outcomes]


def control(state: dict) -> list:
    """The reference, in TF32, in the program's place: one stage's outcome."""
    with prec.tf32_products():
        return [reference(state)]

