"""Several sequences' all-pairs registration through the ring, at scale.

Counterpart of the repository's root ``ring_scale.py``, on ``dist/ring.py``
(``register_all_pairs_ring``) and ``dist/mesh.py`` (``spawn_ranks``). The ring
exists for the regime where the union of several sequences' fragments no
longer fits replicated on one device: each rank owns a block and the blocks
travel around the ring. This tool loads the fragment clouds the ladder's
per-scene runs wrote (every ``--stride``-th fragment of each directory),
preps them once, registers every non-adjacent pair through the ring and
reports coverage, successes within and across sequences, each rank's useful
lanes and their balance, the prep bytes, each rank's peak device memory
(``torch.cuda.max_memory_allocated``) and the prep memory a rank holds
against a replicated copy.

It runs at the reference's production capacities (``RegistrationConfig()``;
:func:`run` takes another configuration). On one card: ``--ranks 1`` under
NCCL, in this process, or ``--ranks 2 --backend gloo`` (two processes sharing
``cuda:0``; NCCL cannot place two ranks on one card); a rank a card under
NCCL where there are several.

    python -m elasticreconstruction_tpu_torch.tools.ring_scale --out ring_scale.json out1/fragments out2/fragments
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..core import io_logfmt
from ..core.types import PointCloud, resolve_device
from ..dist import mesh, ring
from ..registration import PreppedFragments, RegistrationConfig, prep_fragments_batch

BASE_KEY = 7
CAPACITY = 1 << 14


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="elasticreconstruction_tpu_torch.tools.ring_scale")
    ap.add_argument("frag_dirs", nargs="+")
    ap.add_argument("--out", default="ring_scale.json")
    ap.add_argument("--stride", type=int, default=2, help="take every k-th fragment")
    ap.add_argument("--ranks", type=int, default=1, help="world size")
    ap.add_argument("--backend", default="nccl", choices=mesh.BACKENDS)
    ap.add_argument("--device", default="cuda", help="torch device of the ranks")
    return ap


def load_clouds(frag_dirs, stride: int) -> tuple[PointCloud, list[int]]:
    """Every ``stride``-th fragment cloud of each directory, padded to
    ``CAPACITY`` rows (numpy), and the sequence each came from."""
    pts_all, nrm_all, mask_all, seq_of = [], [], [], []
    for s, d in enumerate(frag_dirs):
        d = Path(d)
        f = n_seq = 0
        while (d / f"cloud_bin_{f}.pcd").exists():
            if f % stride == 0:
                pts, nrm = io_logfmt.read_pcd(d / f"cloud_bin_{f}.pcd")
                n = min(len(pts), CAPACITY)
                p, m, k = (np.zeros((CAPACITY, 3), np.float32), np.zeros((CAPACITY, 3), np.float32),
                           np.zeros(CAPACITY, bool))
                p[:n] = pts[:n]
                if nrm is not None:
                    m[:n] = nrm[:n]
                k[:n] = True
                pts_all.append(p)
                nrm_all.append(m)
                mask_all.append(k)
                seq_of.append(s)
                n_seq += 1
            f += 1
        print(json.dumps({"ring_scale": f"seq {s}: {n_seq} fragments (stride {stride})"}), flush=True)
    return PointCloud(np.stack(pts_all), np.stack(nrm_all), np.stack(mask_all)), seq_of


def _flat(p: PreppedFragments) -> list[torch.Tensor]:
    return [*p.coarse, p.features, *p.fine]


def _unflat(ts: list[torch.Tensor]) -> PreppedFragments:
    return PreppedFragments(PointCloud(*ts[:3]), ts[3], PointCloud(*ts[4:]))


def ring_rank(rank: int, group, dev: torch.device, path: str, cfg: RegistrationConfig,
              draws: np.ndarray | None = None) -> dict:
    """One rank's ring over the prep stack saved at ``path``: every rank's
    lanes (gathered), this rank's wall time and its peak device memory."""
    prepped = _unflat(torch.load(path, weights_only=True))
    draws_for = None if draws is None else (lambda i, j: torch.from_numpy(draws[i, j]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    res = ring.register_all_pairs_ring(prepped, BASE_KEY, cfg, draws_for=draws_for, group=group, device=dev)
    out = {k: getattr(res, k).cpu().numpy() for k in ("i", "j", "success")}
    out["ring_seconds"] = time.time() - t0
    out["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else None
    return out


def run(frag_dirs, *, stride: int = 2, ranks: int = 1, backend: str = "nccl", device="cuda",
        cfg: RegistrationConfig = RegistrationConfig(), draws: np.ndarray | None = None) -> dict:
    """Prep every fragment once on ``device``, run the ring at ``ranks`` ranks
    under ``cfg`` and return the report (see the module docstring).

    ``draws``, an ``(F, F, H, 3)`` int64 table of the padded stack, gives pair
    ``(lo, hi)`` the RANSAC draws ``draws[lo, hi]`` in place of
    ``ring.pair_key``'s, so that the run can be held against another
    implementation's draws."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    clouds, seq_of = load_clouds(frag_dirs, stride)
    f_real = len(seq_of)
    pad = (-f_real) % ranks
    idx = np.r_[np.arange(f_real), np.zeros(pad, int)]  # pad with repeats of fragment 0
    clouds = PointCloud(*(x[idx] for x in clouds))
    seq_of = seq_of + [-1] * pad
    f = len(seq_of)

    t0 = time.time()
    prepped = prep_fragments_batch(clouds, cfg, device=dev)
    flat = [t.cpu() for t in _flat(prepped)]
    t_prep = time.time() - t0
    del prepped
    prep_bytes = sum(t.numel() * t.element_size() for t in flat)

    with tempfile.TemporaryDirectory(prefix="ring_scale-") as tmp:
        path = os.path.join(tmp, "prepped.pt")
        torch.save(flat, path)
        if ranks == 1:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            mesh.init_group(backend, 1, 0, "file://" + os.path.join(tmp, "store"))
            try:
                per_rank = [ring_rank(0, dist.group.WORLD, dev, path, cfg, draws)]
            finally:
                dist.destroy_process_group()
        else:
            devices = ([f"cuda:{r}" for r in range(ranks)] if dev.type == "cuda" and backend == "nccl"
                       else str(dev))
            # The ranks share this process's intra-op threads.
            per_rank = mesh.spawn_ranks(ring_rank, ranks, backend, devices, path, cfg, draws, timeout_s=3600.0,
                                        threads=max(1, torch.get_num_threads() // ranks))
    res = per_rank[0]

    i, j, ok = res["i"], res["j"], res["success"]
    lane_ok = ring.lanes_wanted(ranks, f)
    useful = lane_ok & (j < f_real)
    wanted = {(a, b) for a in range(f_real) for b in range(a + 2, f_real)}
    got_lanes = [(int(a), int(b)) for a, b in zip(i[useful], j[useful])]
    succ = sorted((int(a), int(b)) for a, b in zip(i[ok & useful], j[ok & useful]))
    intra = sum(1 for a, b in succ if seq_of[a] == seq_of[b])
    lanes_per_rank = len(i) // ranks
    per_rank_useful = [int(useful[r * lanes_per_rank:(r + 1) * lanes_per_rank].sum()) for r in range(ranks)]
    t_ring = max(r["ring_seconds"] for r in per_rank)
    resident = (2 if ranks > 1 else 1) * prep_bytes // ranks  # own block + the travelling one
    return {
        "sequences": len(frag_dirs),
        "fragments": f_real,
        "fragments_padded": f,
        "devices": ranks,
        "backend": backend,
        "device": str(dev),
        "config": {k: getattr(cfg, k) for k in ("coarse_capacity", "fine_capacity", "num_hypotheses",
                                                "icp_iterations")},
        "pairs_wanted": len(wanted),
        "pairs_covered": len(set(got_lanes) & wanted),
        "pairs_missing": len(wanted - set(got_lanes)),
        "pairs_in_two_lanes": len(got_lanes) - len(set(got_lanes)),
        "successes": len(succ),
        "successes_intra_sequence": intra,
        "successes_cross_sequence": len(succ) - intra,
        "success_pairs": [list(p) for p in succ],
        "per_device_useful_pairs": per_rank_useful,
        "lanes_per_device": lanes_per_rank,
        "useful_balance_max_over_mean": round(max(per_rank_useful) / max(sum(per_rank_useful) / ranks, 1e-9), 3),
        "prep_seconds": round(t_prep, 1),
        "ring_seconds": round(t_ring, 1),
        "pairs_per_second": round(len(wanted) / max(t_ring, 1e-9), 2),
        "prep_bytes_total": int(prep_bytes),
        "per_device_prep_bytes_ring": int(resident),
        "per_device_bytes_replicated": int(prep_bytes),
        "memory_ratio_vs_replicated": round(resident / prep_bytes, 3),
        "per_device_peak_bytes_ring": (max(r["peak_bytes"] for r in per_rank)
                                       if dev.type == "cuda" else None),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = run(args.frag_dirs, stride=args.stride, ranks=args.ranks, backend=args.backend, device=args.device)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({"ring_scale": {k: v for k, v in out.items() if k != "success_pairs"}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
