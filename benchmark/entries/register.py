"""Entry: pair registration, ``registration/pair.py`` ``prep_fragments_batch`` then
``register_prepped_batch``, on consecutive fragments of the livingroom orbit.

Set-up makes the fragments' clouds (``traffic/fragments.py``) and the pairs the
registration stage sends through the registrar: every non-adjacent pair
(``j >= i + 2``), in batches of the configuration's ``registration_batch``,
the last one short; then it warms one prep and one batch. A timed call is a
pass: prep of every fragment, then every batch, queued back to back, batch
``s`` drawing its RANSAC hypotheses from a generator seeded from
(``--seed``, ``s``), and one readback at the pass's end. Every pass does the
same work and keeps its results; the judge compares each with the
reference's one pass (``reference/registration.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark.entries import common
from benchmark.reference import compare, prec
from benchmark.reference import registration as ref
from benchmark.reference.geometry import Intrinsics
from benchmark.traffic.fragments import fragment_clouds


def pair_lists(num: int) -> tuple[np.ndarray, np.ndarray]:
    """The registration stage's loop candidates among ``num`` consecutive fragments."""
    pairs = [(i, j) for i in range(num) for j in range(i + 2, num)]
    return np.array([i for i, _ in pairs]), np.array([j for _, j in pairs])


def setup(cell: dict, seed: int, device, workdir: Path) -> dict:
    from elasticreconstruction_tpu_torch.core.types import PointCloud
    from elasticreconstruction_tpu_torch.registration import RegistrationConfig

    config, traffic = cell["config"], cell["traffic"]
    dev = torch.device(device)
    pts, nrm, mask = fragment_clouds(traffic, config, Intrinsics(**config["camera"]), seed, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ii, jj = pair_lists(traffic["fragments"])
    batch = config["registration_batch"]
    state = {"cell": cell, "dev": dev, "pts": pts, "mask": mask, "clouds": PointCloud(pts, nrm, mask),
             "ii": ii, "jj": jj, "batch": batch, "starts": list(range(0, len(ii), batch)),
             "gen_seeds": [common.sub_seed(seed, 1, s) for s in range(0, len(ii), batch)],
             "cfg": RegistrationConfig(**config["registration"]), "passes": []}
    _one_pass(state, state["starts"][:1])
    state["passes"].clear()
    return state


def _one_pass(state: dict, starts=None, per_batch=None):
    """Prep, then the batches at ``starts`` (default all), one readback at the end."""
    from elasticreconstruction_tpu_torch.kernels.cuda import nn as cuda_nn
    from elasticreconstruction_tpu_torch.registration import prep_fragments_batch, register_prepped_batch

    cfg, dev, b = state["cfg"], state["dev"], state["batch"]
    prepped = prep_fragments_batch(state["clouds"], cfg, device=dev)
    results = []
    for s in state["starts"] if starts is None else starts:
        k = state["starts"].index(s)
        if per_batch is not None:
            cuda_nn.launches_by_shape.clear()
        results.append(register_prepped_batch(prepped, state["ii"][s : s + b], state["jj"][s : s + b],
                                              torch.Generator().manual_seed(state["gen_seeds"][k]), cfg,
                                              device=dev))
        if per_batch is not None:
            per_batch.append((s, dict(cuda_nn.launches_by_shape)))
    fields = [torch.cat([getattr(r, f) for r in results]) for f in ("transform", "information", "fitness", "success")]
    float(sum(x.float().sum() for x in fields[:3]).item())  # the pass's one readback
    state["passes"].append(fields)
    return prepped


def call(state: dict) -> int:
    _one_pass(state)
    return len(state["ii"])


def trace(state: dict) -> dict:
    """Prep timed alone; one pass under the profiler with launches counted a batch; one under the sync counter."""
    from elasticreconstruction_tpu_torch.registration import prep_fragments_batch

    dev = state["dev"]
    prep_s = common.timed(lambda: prep_fragments_batch(state["clouds"], state["cfg"], device=dev), dev)
    per_batch, held = [], {}

    def profiled_pass():
        held["prepped"] = _one_pass(state, per_batch=per_batch)

    prof = common.profiled(profiled_pass, dev)
    valid = held["prepped"].fine.mask.sum(-1).cpu().numpy()
    nr = int(held["prepped"].fine.mask.shape[-1])
    launches = []
    for s, shapes in per_batch:
        refs = int(valid[state["ii"][s : s + state["batch"]]].sum())
        launches += [(b, nq, n, count, refs) for (b, nq, n), count in shapes.items() if n == nr]
    syncs = common.count_host_syncs(lambda: call(state), dev)
    pairs = len(state["ii"])
    return {"device": prof,
            "registration": {"prep_s": prep_s, "fragments": len(state["pts"]), "host_syncs": syncs, "pairs": pairs},
            "nearest": {"launches": launches, "kernel_name": "nearest_kernel"}}


def release(state: dict) -> None:
    if state["dev"].type == "cuda":
        torch.cuda.empty_cache()


def reference(state: dict) -> ref.Result:
    """The reference's one pass, every batch with the program's generator seeds."""
    cfg = ref.Config(*state["cfg"])
    dev = state["dev"]
    rp = ref.prep(torch.from_numpy(state["pts"]).to(dev), torch.from_numpy(state["mask"]).to(dev), cfg)
    b = state["batch"]
    res = [ref.register(rp, state["ii"][s : s + b], state["jj"][s : s + b],
                        torch.Generator().manual_seed(state["gen_seeds"][k]), cfg)
           for k, s in enumerate(state["starts"])]
    return ref.Result(*(torch.cat(x) for x in zip(*res)))


def judge(state: dict, passes=None) -> list[dict]:
    rr = reference(state)
    w = state["mask"][..., None]
    cent = (state["pts"].astype(np.float64) * w).sum(1) / np.maximum(w.sum(1), 1)
    cj = torch.from_numpy(cent[state["jj"]]).to(state["dev"])
    return [compare.registration_gaps(T, info, fit, ok, rr, cj)
            for T, info, fit, ok in (state["passes"] if passes is None else passes)]


def control(state: dict) -> list:
    """The reference, in TF32, in the program's place: one pass's results."""
    with prec.tf32_products():
        r = reference(state)
    return [[r.transform, r.information, r.fitness, r.success]]
