"""The ceiling of SLAC's field recovery, a real-world degradation at a time.

Counterpart of the repository's ``tools/slac_oracle.py``. Each rung replaces
one degradation with ground truth, to isolate what caps config 4s's
``recovery_vs_zero``:

  direct_fit     -- the lattice fitted directly to the injected field at the
                    cloud points (how much of the field a lattice can hold)
  exact_assoc_gn -- the optimiser on the real fragment clouds with exact
                    associations: both clouds corrected by the analytic field
                    before the mutual-NN match at ground-truth poses, the raw
                    observed points fed to the optimiser

    python -m elasticreconstruction_tpu_torch.tools.slac_oracle [out_dir] [data_dir] [--device cuda]

(defaults: the ladder's ``milestone_runs_gpu/out_dsurvey`` and
``milestone_runs_gpu/data_dsurvey``). Each rung prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..core import io_logfmt, se3
from ..core.types import PointCloud, resolve_device
from ..elastic.correspondence import CorresSet
from ..elastic.lattice import Lattice, embed_weights
from ..elastic.slac import SlacConfig, SlacMode, optimize_fragments
from ..eval.lattice_recovery import lattice_recovery
from ..kernels import knn as _knn
from ..pipeline.dataset import read_intrinsics
from ..synthetic import distortion as D

K = 50


def load_clouds(frag_dir: Path, dev: torch.device, cap: int = 16384, seed: int = 0) -> list[PointCloud]:
    """Each fragment cloud, subsampled to ``cap`` points with a seeded draw and padded to ``cap``."""
    rng = np.random.default_rng(seed)
    clouds, nf = [], 0
    while (frag_dir / f"cloud_bin_{nf}.pcd").exists():
        nf += 1
    for f in range(nf):
        pts, nrm = io_logfmt.read_pcd(frag_dir / f"cloud_bin_{f}.pcd")
        if len(pts) > cap:
            sel = rng.choice(len(pts), cap, replace=False)
            pts, nrm = pts[sel], nrm[sel]
        n = len(pts)
        p, m, k = np.zeros((cap, 3), np.float32), np.zeros((cap, 3), np.float32), np.zeros(cap, bool)
        p[:n], m[:n], k[:n] = pts, nrm, True
        clouds.append(PointCloud(*(torch.from_numpy(x).to(dev) for x in (p, m, k))))
    return clouds


def vs_zero(lat, disp, clouds, dist, intr, dev) -> tuple[float, float]:
    """(recovery against a zero lattice, recovery fraction) of ``disp``."""
    pc = [PointCloud(c.points[c.mask], c.normals[c.mask], c.mask[c.mask]) for c in clouds]
    rec = lattice_recovery(lat, disp, pc, dist, intr, device=dev)
    rec0 = lattice_recovery(lat, np.zeros_like(np.asarray(torch.as_tensor(disp).cpu())), pc, dist, intr, device=dev)
    return 1.0 - rec["residual_rms_aligned"] / max(rec0["residual_rms_aligned"], 1e-12), rec["recovery_fraction"]


def direct_fit(lat: Lattice, clouds, dist, intr, dev) -> np.ndarray:
    """Least-squares lattice displacements reproducing the field at up to 200 000 cloud points."""
    rng = np.random.default_rng(0)
    allp = torch.cat([c.points[c.mask] for c in clouds]).cpu().numpy()
    if len(allp) > 200000:
        allp = allp[rng.choice(len(allp), 200000, replace=False)]
    p = torch.from_numpy(allp).to(dev)
    y = D.gt_correction(dist, p, intr).cpu().numpy()
    ids, w = (x.cpu().numpy() for x in embed_weights(lat, p))
    M = lat.num_vertices
    A = np.zeros((M, M))
    b = np.zeros((M, 3))
    for k in range(8):
        np.add.at(b, ids[:, k], w[:, k, None] * y)
        for l in range(8):
            np.add.at(A, (ids[:, k], ids[:, l]), w[:, k] * w[:, l])
    A += 1e-3 * np.eye(M)
    return np.linalg.solve(A, b).astype(np.float32)


def exact_association(clouds, gt: np.ndarray, dist, intr, edges, dev, cap_e: int = 2048) -> CorresSet:
    """Mutual nearest neighbours within 2 cm of the field-corrected clouds at the
    ground-truth poses, the raw observed points as the rows (``cap_e`` an edge)."""
    corr = [c.points + D.gt_correction(dist, c.points, intr) for c in clouds]
    gt_t = torch.from_numpy(gt).to(dev)
    fi, fj, ps, qs, ns, ms = [], [], [], [], [], []
    for i, j in edges:
        pi_w = se3.apply(gt_t[i], corr[i])
        pj_w = se3.apply(gt_t[j], corr[j])
        d2, idx = _knn.nearest_auto(pj_w, pi_w, clouds[i].mask)
        idx = idx.long()
        close = clouds[j].mask & torch.isfinite(d2) & (d2 < 0.02**2)
        _, idxb = _knn.nearest_auto(pi_w, pj_w, clouds[j].mask)
        mutual = idxb.long()[idx] == torch.arange(idx.shape[0], device=dev)
        ok = close & mutual
        order = torch.argsort((~ok).to(torch.int8), stable=True)[:cap_e]
        m = ok[order]
        z = m[:, None]
        fi.append(torch.full((cap_e,), i, dtype=torch.int32, device=dev))
        fj.append(torch.full((cap_e,), j, dtype=torch.int32, device=dev))
        ps.append(torch.where(z, clouds[i].points[idx[order]], 0.0))
        qs.append(torch.where(z, clouds[j].points[order], 0.0))
        ns.append(torch.where(z, clouds[i].normals[idx[order]], 0.0))
        ms.append(m)
    return CorresSet(torch.cat(fi), torch.cat(fj), torch.cat(ps), torch.cat(qs), torch.cat(ms), torch.cat(ns), None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="elasticreconstruction_tpu_torch.tools.slac_oracle")
    ap.add_argument("out_dir", nargs="?", default="milestone_runs_gpu/out_dsurvey")
    ap.add_argument("data_dir", nargs="?", default="milestone_runs_gpu/data_dsurvey")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out_dir, data_dir = Path(args.out_dir), Path(args.data_dir)
    dist = (
        D.DepthDistortion.from_json((data_dir / "distortion.json").read_text())
        if (data_dir / "distortion.json").exists()
        else D.make_distortion(42, radial_a=0.015, depth_b=0.004, grid_sigma=0.006)
    )
    intr = read_intrinsics(data_dir / "intrinsics.json")
    clouds = load_clouds(out_dir / "fragments", dev)
    nf = len(clouds)
    gt = io_logfmt.read_log(data_dir / "gt.log").matrices().astype(np.float32)[::K][:nf]
    cfg = SlacConfig(mode=SlacMode.SLAC, disp_prior_weight=0.003, arap_weight=1.0, outer_iterations=8)
    lat = Lattice(cfg.resolution, cfg.length, cfg.origin)

    vz, fr = vs_zero(lat, direct_fit(lat, clouds, dist, intr, dev), clouds, dist, intr, dev)
    print(json.dumps({"rung": "direct_fit", "vs_zero": round(vz, 3), "frac": round(fr, 3)}), flush=True)

    edges = ([(i, i + 1) for i in range(nf - 1)] + [(i, i + 2) for i in range(nf - 2)]
             + [(i, i + 3) for i in range(nf - 3)])
    kept = out_dir / "posegraph" / "kept_edges.txt"
    if kept.exists():
        seen = set(edges)
        for line in kept.read_text().splitlines():
            i, j = map(int, line.split())
            if (i, j) not in seen:
                edges.append((i, j))
                seen.add((i, j))
    cs = exact_association(clouds, gt, dist, intr, edges, dev)
    res = optimize_fragments(torch.from_numpy(gt).to(dev), cs, cfg, num_fragments=nf)
    vz, fr = vs_zero(res.lattice, res.displacement[0], clouds, dist, intr, dev)
    print(json.dumps({"rung": "exact_assoc_gn", "corres": int(cs.count()), "edges": len(edges),
                      "vs_zero": round(vz, 3), "frac": round(fr, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
