"""One step of every distributed path, on ranks started here.

Counterpart of ``__graft_entry__.py::dryrun_multichip``, at its sizes:
512-point pairs (one a rank) through both pair-sharding functions, the
4096-point production-shape batch, an 8-pose chain through the edge-sharded
pose graph, 512 correspondences through the sharded SLAC PCG, the ring over
two fragments a rank, and an x-sharded TSDF fused from one depth plane and
meshed. Every output must be finite.

    python -m elasticreconstruction_tpu_torch.dist.dryrun 2 gloo cpu
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from ..core import camera, se3
from ..core.types import PointCloud
from ..elastic import CorresSet, SlacConfig, SlacMode
from ..kernels import tsdf
from ..posegraph import EdgeList, PGOConfig
from ..registration import RegistrationConfig, prep_fragments_batch
from . import pair_sharding, pgo_dist, ring, slac_dist, volume_sharding
from .mesh import spawn_ranks


def tiny_pair(dev: torch.device, seed: int = 0, n: int = 1024) -> tuple[PointCloud, PointCloud]:
    """The reference dry run's pair: a wavy patch and its copy under a known motion."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, n).astype(np.float32)
    y = rng.uniform(-1.5, 1.5, n).astype(np.float32)
    z = (0.35 * np.sin(2.3 * x) * np.cos(1.7 * y) + 0.2 * np.sin(4.1 * y)).astype(np.float32)
    world = torch.from_numpy(np.stack([x, y, z], 1)).to(dev)
    T = se3.exp(torch.tensor([0.3, -0.2, 0.25, 0.2, -0.1, 0.3], device=dev))
    return PointCloud.from_points(world, device=dev), PointCloud.from_points(se3.apply(se3.inverse(T), world),
                                                                          device=dev)


def _finite(name: str, *xs: torch.Tensor) -> None:
    if not all(bool(torch.isfinite(x).all()) for x in xs):
        raise RuntimeError(f"dryrun: {name} gave non-finite values")


def _stack(clouds: list[PointCloud]) -> PointCloud:
    return PointCloud(*(torch.stack(xs) for xs in zip(*clouds)))


def dryrun_rank(rank: int, group: dist.ProcessGroup, dev: torch.device) -> dict:
    """The dry run's work on one rank; returns what each path gave, as numbers."""
    d = dist.get_world_size(group)
    out = {}
    gen = torch.Generator().manual_seed(0)

    # Pair-sharded registration: one pair a rank, prepped inline, then prepped once.
    ci, cj = tiny_pair(dev, n=512)
    cfg = RegistrationConfig(coarse_capacity=512, fine_capacity=512, num_hypotheses=256)
    res = pair_sharding.register_pairs_sharded(_stack([ci] * d), _stack([cj] * d), gen, cfg, group=group,
                                               device=dev)
    _finite("register_pairs_sharded", res.transform)
    prepped = prep_fragments_batch(_stack([ci, cj]), cfg, device=dev)
    ii, jj = np.resize([0, 1], d), np.resize([1, 0], d)
    res = pair_sharding.register_prepped_sharded(prepped, ii, jj, gen, cfg, group=group, device=dev)
    _finite("register_prepped_sharded", res.transform)

    # The registration stage's real working set: 4096-point clouds.
    ci_p, cj_p = tiny_pair(dev, n=4096)
    cfg_p = RegistrationConfig(coarse_capacity=2048, fine_capacity=4096, num_hypotheses=2048, icp_iterations=10)
    prepped_p = prep_fragments_batch(_stack([ci_p, cj_p]), cfg_p, device=dev)
    res = pair_sharding.register_prepped_sharded(prepped_p, ii, jj, gen, cfg_p, group=group, device=dev)
    _finite("register_prepped_sharded (production shape)", res.transform)
    if not bool(res.success.any()):
        raise RuntimeError("dryrun: production-shape pairs all failed")
    out["production_success"] = res.success.tolist()

    # Edge-sharded pose graph on an 8-pose chain.
    n = 8
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, 0, 3] = 0.3 * np.arange(n)
    meas = np.tile(np.eye(4, dtype=np.float32), (n - 1, 1, 1))
    meas[:, 0, 3] = 0.3
    edges = EdgeList.build(np.arange(n - 1), np.arange(1, n), meas,
                           np.tile(np.eye(6, dtype=np.float32) * 10, (n - 1, 1, 1)), np.ones(n - 1, bool), device=dev)
    pg = pgo_dist.optimize_pose_graph_sharded(torch.from_numpy(poses).to(dev), edges,
                                              PGOConfig(outer_iterations=1, inner_iterations=2), group=group)
    _finite("optimize_pose_graph_sharded", pg.poses)

    # Correspondence-sharded SLAC PCG.
    rng = np.random.default_rng(1)
    m = 512
    world = torch.from_numpy(rng.uniform(-1, 1, (m, 3)).astype(np.float32)).to(dev)
    cs = CorresSet(torch.zeros(m, dtype=torch.int32, device=dev), torch.ones(m, dtype=torch.int32, device=dev),
                   world, world + 0.01, torch.ones(m, dtype=torch.bool, device=dev))
    scfg = SlacConfig(mode=SlacMode.SLAC, resolution=2, length=4.0, origin=(-2.0, -2.0, -2.0),
                      outer_iterations=1, cg_iterations=8)
    sres = slac_dist.optimize_fragments_sharded(se3.identity((2,), device=dev), cs, scfg, group=group)
    _finite("optimize_fragments_sharded", sres.poses, sres.final_rmse)

    # The ring over two fragments a rank.
    frags = _stack([ci, cj] * d)
    rres = ring.register_all_pairs_ring(prep_fragments_batch(frags, cfg, device=dev), 7, cfg, group=group,
                                        device=dev)
    _finite("register_all_pairs_ring", rres.transform)
    out["ring_lanes"] = int(rres.success.shape[0])

    # The x-sharded TSDF: fuse one depth plane, then mesh it.
    intr = camera.Intrinsics(fx=40.0, fy=40.0, cx=15.5, cy=11.5, width=32, height=24)
    vol = tsdf.make_volume((64 * max(d // 8, 1), 32, 32), 0.05, origin=(-1.0, -1.0, 0.5), device=dev)
    slab = volume_sharding.fuse_sharded(volume_sharding.shard_volume(vol, group),
                                        torch.full((1, 24, 32), 2.0, device=dev), se3.identity((1,), device=dev),
                                        intr)
    _finite("fuse_sharded", slab.vol.tsdf)
    tris = volume_sharding.extract_mesh_sharded(slab, group)
    _finite("extract_mesh_sharded", tris)
    out["triangles"] = int(tris.shape[0])
    return out


def dryrun_multirank(world_size: int, backend: str, device: str, timeout_s: float = 600.0,
                     threads: int | None = None) -> list[dict]:
    """One step of every distributed path on ``world_size`` new ranks; each
    rank's numbers, in rank order. Raises if a rank fails or the run
    outlasts ``timeout_s``; ``threads`` as in ``spawn_ranks``."""
    results = spawn_ranks(dryrun_rank, world_size, backend, device, timeout_s=timeout_s, threads=threads)
    print(f"dryrun_multirank OK on {world_size} ranks ({backend}, {device})")
    return results


if __name__ == "__main__":
    dryrun_multirank(int(sys.argv[1]), sys.argv[2], sys.argv[3])
