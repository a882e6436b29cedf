"""PyTorch port, the distributed paths on gloo ranks vs the JAX package's, on the CPU.

The port runs at D = 2 and 4 ranks (``dist.mesh.spawn_ranks``: spawned
processes, gloo, one intra-op thread each), its inputs handed over as numpy
arrays in a temporary directory and its results coming back the same way. The
JAX side runs meanwhile in this process: its single-device paths, and on
``make_mesh(D)`` of the 8-device virtual CPU mesh the sharded paths whose
arithmetic depends on D (the pose graph's sums, the SLAC PCG with its
preconditioner's over-count, the sharded fuse). Its sharded pair registration
has no collective and gives its single-device results (``tests/test_dist.py``
asserts it), so the port is held to those. Sizes are those of
``tests/test_dist.py`` or smaller.
Tolerances, each beside its assertion:

- pair sharding, both functions, fed the JAX package's RANSAC draws: success
  equal and transforms within 1e-3, information within 1e-3 relative (the
  port against JAX, as ``tests/test_torch_slice.py``), RANSAC's inlier counts
  equal where both start from the JAX package's prep (the port's own FPFH
  differs in the last bits, which can move RANSAC's winner); against
  the port's single-device call transforms within 1e-5 and information within
  rtol 1e-4 / atol 1e-2 (``tests/test_ring.py``'s bounds);
- the pose graph (``tests/test_posegraph.py``'s 16-pose circle, one
  alternation of 3 Gauss-Newton steps and 3 more on the pruned graph, where
  ``tests/test_dist.py`` takes 3 x 5 and 5): poses within
  1e-3 of both JAX paths and of the port's single-device solve, ``kept`` equal
  (``tests/test_dist.py``);
- SLAC (``tests/test_dist.py``'s wavy set, slac mode): poses within 5e-3 and
  final RMSE within 2e-3 of the single-device solves (``tests/test_dist.py``),
  and within ``tests/test_torch_elastic_slac.py``'s bounds (poses 2e-4, RMSE
  rtol 5e-5 / atol 2e-6) of the JAX sharded solve at the same D;
- the x-sharded sphere volume: the gathered slabs equal the port's
  single-device fuse bit for bit, and the JAX sharded fuse's weights equal
  and its tsdf within 1e-5 (``tests/test_torch_integrate.py``); the gathered
  triangles equal the port's single-device ``extract_mesh``'s after sorting
  (``tests/test_torch_integrate.py`` holds that one to the JAX package's).

One more case runs D = 1 under gloo in this process: each sharded function
against the port's own single-device call, bit for bit. And ``init_group``
refuses NCCL without a card instead of falling back to gloo.

The spawned ranks import this module by name, so it imports JAX inside its
fixtures only.
"""

from __future__ import annotations

import concurrent.futures
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from elasticreconstruction_tpu_torch.bench_scene import make_fragments
from elasticreconstruction_tpu_torch.core.camera import Intrinsics
from elasticreconstruction_tpu_torch.core.types import PointCloud
from elasticreconstruction_tpu_torch.dist import mesh as t_mesh
from elasticreconstruction_tpu_torch.dist import comm, pair_sharding, pgo_dist, slac_dist, volume_sharding
from elasticreconstruction_tpu_torch.elastic import CorresSet, SlacConfig, SlacMode, optimize_fragments
from elasticreconstruction_tpu_torch.integrate import extract_mesh
from elasticreconstruction_tpu_torch.kernels import tsdf
from elasticreconstruction_tpu_torch.posegraph import EdgeList, PGOConfig, optimize_pose_graph
from elasticreconstruction_tpu_torch.registration import (
    PreppedFragments, RegistrationConfig, register_pairs_batch, register_prepped_batch,
)

TESTS = Path(__file__).resolve().parent
RANKS = [2, 4]
TIMEOUT_S = 240.0
# tests/test_torch_slice.py's scene and configuration: the registration
# benchmark's fragments cut to 2000 points, four pairs that register.
REG = dict(voxel_size=0.15, icp_voxel_size=0.075, coarse_capacity=512, fine_capacity=2048, num_hypotheses=1024,
           icp_iterations=10, inlier_threshold=0.15)
PAIR_I, PAIR_J = np.array([0, 1, 2, 0], np.int32), np.array([1, 2, 3, 2], np.int32)
PGO = dict(outer_iterations=1, inner_iterations=3)
SLAC = dict(mode="slac", resolution=4, length=4.0, origin=(-2.0, -2.0, -2.0), outer_iterations=3,
            cg_iterations=48, arap_weight=0.5)
INTR = dict(fx=60.0, fy=60.0, cx=31.5, cy=23.5, width=64, height=48)
VOLUME = dict(shape=(64, 64, 64), voxel_size=0.04, origin=(-1.25, -1.25, 0.75))
MESH_CAPACITY = 2048


def wavy(rng, n, x0=-1.5, x1=1.5):
    x = rng.uniform(x0, x1, n).astype(np.float32)
    y = rng.uniform(-1.5, 1.5, n).astype(np.float32)
    z = (0.35 * np.sin(2.3 * x) * np.cos(1.7 * y) + 0.2 * np.sin(4.1 * y)).astype(np.float32)
    return np.stack([x, y, z], 1)


def _slac_config() -> SlacConfig:
    return SlacConfig(**{**SLAC, "mode": SlacMode(SLAC["mode"])})


def _cloud(x: dict, key: str) -> PointCloud:
    return PointCloud(*(torch.from_numpy(x[f"{key}_{f}"]) for f in PointCloud._fields))


def _port_inputs(x: dict):
    """The port's containers from the numpy inputs."""
    prepped = PreppedFragments(_cloud(x, "coarse"), torch.from_numpy(x["features"]), _cloud(x, "fine"))
    edges = EdgeList.build(*(x[f"edge_{f}"] for f in EdgeList._fields), device="cpu")
    corres = CorresSet(*(torch.from_numpy(x[f"corres_{f}"]) for f in CorresSet._fields[:5]))
    return prepped, edges, corres


def _as_numpy(res) -> dict:
    return {k: v.numpy() for k, v in res._asdict().items() if torch.is_tensor(v)}


def _sorted_triangles(tris: np.ndarray) -> np.ndarray:
    flat = tris.reshape(-1, 9)
    return flat[np.lexsort(flat.T[::-1])]


def run_paths(group, dev: torch.device, x: dict) -> dict:
    """Every sharded path once on this rank's share; the results, as numpy arrays."""
    reg = RegistrationConfig(**REG)
    prepped, edges, corres = _port_inputs(x)
    out = {
        "pairs": _as_numpy(pair_sharding.register_pairs_sharded(
            _cloud(x, "ci"), _cloud(x, "cj"), None, reg, (PAIR_I, PAIR_J),
            draws=torch.from_numpy(x["draws"]), group=group, device=dev)),
        "prepped": _as_numpy(pair_sharding.register_prepped_sharded(
            prepped, PAIR_I, PAIR_J, None, reg, draws=torch.from_numpy(x["draws"]), group=group, device=dev)),
        "pgo": _as_numpy(pgo_dist.optimize_pose_graph_sharded(
            torch.from_numpy(x["pgo_init"]), edges, PGOConfig(**PGO), group=group)),
        "slac": _as_numpy(slac_dist.optimize_fragments_sharded(
            torch.from_numpy(x["slac_init"]), corres, _slac_config(), group=group)),
    }
    vol = tsdf.make_volume(**VOLUME, device=dev)
    slab = volume_sharding.fuse_sharded(volume_sharding.shard_volume(vol, group), torch.from_numpy(x["depth"])[None],
                                        torch.eye(4)[None], Intrinsics(**INTR))
    whole = volume_sharding.gather_volume(slab, group)
    out["volume"] = {"tsdf": whole.tsdf.numpy(), "weight": whole.weight.numpy(),
                     "triangles": volume_sharding.extract_mesh_sharded(
                         slab, group, capacity_per_slab=MESH_CAPACITY).numpy()}
    mine = torch.arange(3, dtype=torch.float32) + 10 * dist.get_rank(group)
    out["comm"] = {"sum": comm.all_reduce_sum(mine, group).numpy(), "rows": comm.all_gather_rows(mine, group).numpy(),
                   "from_last": comm.broadcast(mine, dist.get_world_size(group) - 1, group).numpy(),
                   "next": comm.ring_shift(mine, group).numpy(),
                   "previous": comm.ring_shift([mine, mine.to(torch.int64)], group, shift=-1)[1].numpy()}
    return out


def _rank_main(rank: int, group, dev: torch.device, inputs: str) -> dict:
    with np.load(inputs) as f:
        return run_paths(group, dev, dict(f))


def run_single(x: dict) -> dict:
    """The port's single-device calls on the same inputs."""
    reg = RegistrationConfig(**REG)
    prepped, edges, corres = _port_inputs(x)
    draws = torch.from_numpy(x["draws"])
    vol = tsdf.fuse(tsdf.make_volume(**VOLUME, device="cpu"), torch.from_numpy(x["depth"]), torch.eye(4),
                    Intrinsics(**INTR))
    tris, mask = extract_mesh(vol, capacity_per_slab=MESH_CAPACITY)
    return {
        "pairs": _as_numpy(register_pairs_batch(_cloud(x, "ci"), _cloud(x, "cj"), None, reg,
                                                (PAIR_I, PAIR_J), draws=draws, device="cpu")),
        "prepped": _as_numpy(register_prepped_batch(prepped, PAIR_I, PAIR_J, None, reg, draws=draws, device="cpu")),
        "pgo": _as_numpy(optimize_pose_graph(torch.from_numpy(x["pgo_init"]), edges, PGOConfig(**PGO))),
        "slac": _as_numpy(optimize_fragments(torch.from_numpy(x["slac_init"]), corres, _slac_config())),
        "volume": {"tsdf": vol.tsdf.numpy(), "weight": vol.weight.numpy(), "triangles": tris[mask].numpy(),
                   "slab_fill": int(mask.sum(1).max())},
    }


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The numpy inputs of every path, the JAX keys and pose-graph fixture
    made with the JAX package, and its single-device results."""
    import jax
    import jax.numpy as jnp

    from elasticreconstruction_tpu.core import se3 as j_se3
    from elasticreconstruction_tpu.core.types import PointCloud as JCloud
    from elasticreconstruction_tpu.elastic import CorresSet as JCorres
    from elasticreconstruction_tpu.registration import pair as j_pair

    sys.path.insert(0, str(TESTS))
    from test_posegraph import build_edges, circle_poses, noisy_odometry_chain

    x = {}
    jcfg = j_pair.RegistrationConfig(**REG)
    clouds, _ = make_fragments(4, n=2000, seed=0)
    for key, rows in (("ci", PAIR_I), ("cj", PAIR_J)):
        x.update({f"{key}_{f}": getattr(clouds, f)[rows] for f in JCloud._fields})
    jprep = j_pair.prep_fragments_batch(JCloud(*(jnp.asarray(v) for v in clouds)), jcfg)
    x.update({f"coarse_{f}": np.array(getattr(jprep.coarse, f)) for f in JCloud._fields})
    x.update({f"fine_{f}": np.array(getattr(jprep.fine, f)) for f in JCloud._fields})
    x["features"] = np.array(jprep.features)
    keys = jax.random.split(jax.random.PRNGKey(3), len(PAIR_I))
    x["draws"] = np.array(jax.vmap(lambda k: jax.random.randint(k, (jcfg.num_hypotheses, 3), 0, 1 << 30))(keys))

    n = 16
    gt = circle_poses(n)
    meas, init = noisy_odometry_chain(gt, np.random.default_rng(1))
    loops = [(0, n - 1, (np.linalg.inv(gt[0]) @ gt[n - 1]).astype(np.float32), 100.0),
             (3, 11, (np.linalg.inv(gt[3]) @ gt[11]).astype(np.float32), 100.0)]
    jedges = build_edges(n, meas, loops)
    x.update({f"edge_{f}": np.array(getattr(jedges, f)) for f in jedges._fields})
    x["pgo_init"] = init.astype(np.float32)

    rng = np.random.default_rng(2)
    sworld = wavy(rng, 2048)
    T_j = np.array(j_se3.exp(jnp.array([0.2, -0.1, 0.15, 0.1, -0.08, 0.12])))
    local_j = np.array(j_se3.apply(j_se3.inverse(jnp.array(T_j)), jnp.array(sworld)))
    m = len(sworld)
    corres = JCorres(frag_i=np.zeros(m, np.int32), frag_j=np.ones(m, np.int32), p=sworld,
                     q=local_j.astype(np.float32), mask=np.ones(m, bool))
    x.update({f"corres_{f}": np.asarray(getattr(corres, f)) for f in JCorres._fields[:5]})
    T_init = np.array(j_se3.exp(jnp.array([0.04, 0.02, -0.03, 0.02, 0.015, -0.02]))) @ T_j
    x["slac_init"] = np.stack([np.eye(4, dtype=np.float32), T_init.astype(np.float32)])

    from elasticreconstruction_tpu.core import camera as j_cam
    from elasticreconstruction_tpu.synthetic import render as j_render
    from elasticreconstruction_tpu.synthetic import sdf as j_sdf

    x["depth"] = np.array(j_render.render_depth(j_sdf.sphere((0.0, 0.0, 2.0), 0.5), j_se3.identity(),
                                                j_cam.Intrinsics(**INTR)))
    path = tmp_path_factory.mktemp("dist_inputs") / "inputs.npz"
    np.savez(path, **x)
    return {"x": x, "path": str(path), "jprep": jprep, "jedges": jedges, "jcorres": corres,
            "keys": keys, "jcfg": jcfg}


def jax_paths(c: dict, d: int | None) -> dict:
    """The JAX package's paths on the case: sharded on ``make_mesh(d)``, or
    single-device for ``d = None``."""
    import jax.numpy as jnp

    from elasticreconstruction_tpu.core.types import PointCloud as JCloud
    from elasticreconstruction_tpu.dist import make_mesh, pgo_dist as jpgo
    from elasticreconstruction_tpu.dist import slac_dist as jslac, volume_sharding as jvol
    from elasticreconstruction_tpu.elastic import CorresSet as JCorres, SlacConfig as JSlac, SlacMode as JMode
    from elasticreconstruction_tpu.elastic import optimize_fragments as j_opt
    from elasticreconstruction_tpu.kernels import tsdf as j_tsdf
    from elasticreconstruction_tpu.core import camera as j_cam, se3 as j_se3
    from elasticreconstruction_tpu.posegraph import PGOConfig as JPGO, optimize_pose_graph as j_pgo
    from elasticreconstruction_tpu.registration import register_pairs_batch as j_rpb
    from elasticreconstruction_tpu.registration import register_prepped_batch as j_rpp

    x, cfg = c["x"], c["jcfg"]
    ci = JCloud(*(jnp.asarray(x[f"ci_{f}"]) for f in JCloud._fields))
    cj = JCloud(*(jnp.asarray(x[f"cj_{f}"]) for f in JCloud._fields))
    corres = JCorres(*(None if v is None else jnp.asarray(v) for v in c["jcorres"]))
    scfg = JSlac(**{**SLAC, "mode": JMode(SLAC["mode"])})
    ii, jj = jnp.asarray(PAIR_I), jnp.asarray(PAIR_J)
    vol = j_tsdf.make_volume(VOLUME["shape"], VOLUME["voxel_size"], VOLUME["origin"])
    depth, intr = jnp.asarray(x["depth"]), j_cam.Intrinsics(**INTR)
    if d is None:
        out = {"pairs": j_rpb(ci, cj, c["keys"], cfg, (ii, jj)),
               "prepped": j_rpp(c["jprep"], ii, jj, c["keys"], cfg),
               "pgo": j_pgo(jnp.asarray(x["pgo_init"]), c["jedges"], JPGO(**PGO)),
               "slac": j_opt(jnp.asarray(x["slac_init"]), corres, scfg)}
    else:
        mesh = make_mesh(d)
        out = {"pgo": jpgo.optimize_pose_graph_sharded(jnp.asarray(x["pgo_init"]), c["jedges"], mesh, JPGO(**PGO)),
               "slac": jslac.optimize_fragments_sharded(jnp.asarray(x["slac_init"]), corres, mesh, scfg)}
        vol = jvol.shard_volume(vol, mesh)
    out = {k: {f: np.asarray(v) for f, v in res._asdict().items() if hasattr(v, "shape")} for k, res in out.items()}
    fused = j_tsdf.fuse(vol, depth, j_se3.identity(), intr)
    out["volume"] = {"tsdf": np.asarray(fused.tsdf), "weight": np.asarray(fused.weight)}
    return out


@pytest.fixture(scope="module")
def single(case):
    """The single-device results of both packages."""
    return {"jax": jax_paths(case, None), "port": run_single(case["x"])}


@pytest.fixture(scope="module", params=RANKS, ids=lambda d: f"D{d}")
def ranks(request, case):
    """Every rank's results at D ranks, and the JAX sharded results on
    make_mesh(D), computed while the ranks run."""
    d = request.param
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(t_mesh.spawn_ranks, _rank_main, d, "gloo", "cpu", case["path"],
                              timeout_s=TIMEOUT_S, threads=1)
        jax_sharded = jax_paths(case, d)
        return {"d": d, "port": running.result(), "jax": jax_sharded}


def _same_on_every_rank(results: list[dict], path: str) -> dict:
    first = results[0][path]
    for other in results[1:]:
        for k, v in first.items():
            np.testing.assert_array_equal(other[path][k], v)
    return first


def _pairs_agree(got, want, port_single, same_features: bool):
    np.testing.assert_array_equal(got["success"], want["success"])
    if same_features:
        np.testing.assert_array_equal(got["num_inliers"], want["num_inliers"])
    np.testing.assert_allclose(got["transform"], want["transform"], atol=1e-3)  # tolerance: 1e-3
    info = want["information"]
    rel = np.abs(got["information"] - info).max(axis=(1, 2)) / np.abs(info).max(axis=(1, 2))
    assert rel.max() < 1e-3, rel  # tolerance: 1e-3 relative
    np.testing.assert_array_equal(got["success"], port_single["success"])
    np.testing.assert_allclose(got["transform"], port_single["transform"], atol=1e-5)  # tolerance: 1e-5
    np.testing.assert_allclose(got["information"], port_single["information"], rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("path", ["pairs", "prepped"])
def test_pair_sharding_matches_jax(ranks, single, path):
    got = _same_on_every_rank(ranks["port"], path)
    _pairs_agree(got, single["jax"][path], single["port"][path], same_features=path == "prepped")
    np.testing.assert_array_equal(got["i"], PAIR_I)
    np.testing.assert_array_equal(got["j"], PAIR_J)
    assert got["success"].all()


def test_pgo_sharded_matches_jax(ranks, single):
    got = _same_on_every_rank(ranks["port"], "pgo")
    e = got["kept"].shape[0]
    for want in (ranks["jax"]["pgo"], single["jax"]["pgo"], single["port"]["pgo"]):
        np.testing.assert_allclose(got["poses"], want["poses"], atol=1e-3)  # tolerance: 1e-3
        np.testing.assert_array_equal(got["kept"], want["kept"][:e])
    assert e == 17


def test_slac_sharded_matches_jax(ranks, single):
    got = _same_on_every_rank(ranks["port"], "slac")
    for want in (single["jax"]["slac"], single["port"]["slac"]):
        np.testing.assert_allclose(got["poses"], want["poses"], atol=5e-3)  # tolerance: 5e-3
        assert abs(float(got["final_rmse"]) - float(want["final_rmse"])) < 2e-3  # tolerance: 2e-3
    same = ranks["jax"]["slac"]
    np.testing.assert_allclose(got["poses"], same["poses"], atol=2e-4)  # tolerance: 2e-4
    np.testing.assert_allclose(got["data_rmse"], same["data_rmse"], rtol=5e-5, atol=2e-6)
    np.testing.assert_allclose(got["final_rmse"], same["final_rmse"], rtol=5e-5, atol=2e-6)
    assert float(got["final_rmse"]) < float(got["data_rmse"][0])


def test_volume_sharding_matches_jax(ranks, single):
    got = _same_on_every_rank(ranks["port"], "volume")
    port = single["port"]["volume"]
    np.testing.assert_array_equal(got["tsdf"], port["tsdf"])
    np.testing.assert_array_equal(got["weight"], port["weight"])
    want = ranks["jax"]["volume"]
    np.testing.assert_array_equal(got["weight"], want["weight"])
    np.testing.assert_allclose(got["tsdf"], want["tsdf"], atol=1e-5)  # tolerance: 1e-5
    assert port["slab_fill"] < MESH_CAPACITY  # no z-slab overflows: the same triangles are kept
    np.testing.assert_array_equal(_sorted_triangles(got["triangles"]), _sorted_triangles(port["triangles"]))
    assert len(got["triangles"]) > 100  # a real sphere mesh came out


def test_collectives(ranks):
    """The four collectives on rank r's ``[10 r, 10 r + 1, 10 r + 2]``."""
    d = ranks["d"]
    base = np.arange(3, dtype=np.float32)
    for r, res in enumerate(ranks["port"]):
        c = res["comm"]
        np.testing.assert_array_equal(c["sum"], d * base + 10 * sum(range(d)))
        np.testing.assert_array_equal(c["rows"], np.concatenate([base + 10 * k for k in range(d)]))
        np.testing.assert_array_equal(c["from_last"], base + 10 * (d - 1))
        np.testing.assert_array_equal(c["next"], base + 10 * ((r + 1) % d))
        np.testing.assert_array_equal(c["previous"], (base + 10 * ((r - 1) % d)).astype(np.int64))


def test_world_size_one_is_the_single_device_path(case, single, tmp_path):
    """D = 1 under gloo, in this process: every sharded call gives the
    single-device call's bits."""
    t_mesh.init_group("gloo", 1, 0, "file://" + str(tmp_path / "store"))
    try:
        got = run_paths(dist.group.WORLD, torch.device("cpu"), case["x"])
    finally:
        dist.destroy_process_group()
    want = single["port"]
    for path in ("pairs", "prepped", "pgo", "slac", "volume"):
        for k, v in got[path].items():
            np.testing.assert_array_equal(v, want[path][k], err_msg=f"{path}.{k}")


def test_nccl_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="nccl"):
        t_mesh.init_group("nccl", 1, 0, "file://" + str(tmp_path / "store"))
    assert not dist.is_initialized()


def test_shard_helpers():
    x = torch.arange(10)
    assert t_mesh.pad_to_multiple(x, 4).tolist() == list(range(10)) + [0, 0]
    assert t_mesh.pad_to_multiple(x, 5) is x
    with pytest.raises(ValueError, match="1 devices for 2 ranks"):
        t_mesh.spawn_ranks(_rank_main, 2, "gloo", ["cpu"], "unused")
    with pytest.raises(ValueError, match="backend"):
        t_mesh.init_group("mpi", 1, 0, "file:///nonexistent")


def _gn_step_before_the_split(poses, edges, weights, cfg):
    """``posegraph/robust_pgo.py::_gn_step`` as it was before it was split
    into ``_partial_blocks`` and ``_damped_solve``, verbatim."""
    from elasticreconstruction_tpu_torch.core import se3, segment
    from elasticreconstruction_tpu_torch.posegraph.robust_pgo import edge_residuals_and_jacobians

    n = poses.shape[0]
    r, Ji, Jj = edge_residuals_and_jacobians(poses, edges)
    w = weights * edges.mask.to(torch.float32)
    L = edges.information * w[:, None, None]
    LJi = L @ Ji
    LJj = L @ Jj
    Hii = torch.einsum("eab,eac->ebc", Ji, LJi)
    Hij = torch.einsum("eab,eac->ebc", Ji, LJj)
    Hjj = torch.einsum("eab,eac->ebc", Jj, LJj)
    Lr = torch.einsum("eab,eb->ea", L, r)
    bi = torch.einsum("eab,ea->eb", Ji, Lr)
    bj = torch.einsum("eab,ea->eb", Jj, Lr)
    blk = torch.cat(
        [edges.i * n + edges.i, edges.i * n + edges.j, edges.j * n + edges.i, edges.j * n + edges.j]
    )
    vals = torch.cat([Hii, Hij, Hij.transpose(-1, -2), Hjj], dim=0)
    Hblocks = segment.segment_sum_by_keys(vals, blk, n * n)
    H = Hblocks.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
    b = segment.segment_sum_by_keys(torch.cat([bi, bj], dim=0), torch.cat([edges.i, edges.j]), n).reshape(6 * n)
    anchor = torch.zeros(6 * n, dtype=H.dtype, device=H.device)
    anchor[:6] = cfg.anchor_weight
    lm = cfg.damping * torch.diagonal(H).clamp_min(1.0) + anchor + 1e-6
    delta = -torch.linalg.solve(H + torch.diag(lm), b)
    return poses @ se3.exp(delta.reshape(n, 6))


def test_single_device_pose_graph_keeps_its_bits(case):
    """The split of ``_gn_step`` for the sharded solve leaves the single-device
    step and ``optimize_pose_graph`` bit for bit as they were."""
    from elasticreconstruction_tpu_torch.posegraph import robust_pgo

    x = case["x"]
    _, edges, _ = _port_inputs(x)
    poses, cfg = torch.from_numpy(x["pgo_init"]), PGOConfig(**PGO)
    weights = torch.linspace(0.5, 1.0, edges.i.shape[0])
    assert torch.equal(robust_pgo._gn_step(poses, edges, weights, cfg),
                       _gn_step_before_the_split(poses, edges, weights, cfg))
    # optimize_pose_graph's loop as it was, verbatim, around the old step.
    from elasticreconstruction_tpu_torch.core import se3

    p = poses
    one = torch.ones((), dtype=torch.float32)
    l = torch.ones(edges.i.shape[0], dtype=torch.float32)
    for _ in range(cfg.outer_iterations):
        w = torch.where(edges.is_odometry, one, l)
        for _ in range(cfg.inner_iterations):
            p = _gn_step_before_the_split(p, edges, w, cfg)
        r2 = robust_pgo._edge_residual_sq(p, edges)
        l = (cfg.mu / (cfg.mu + r2)) ** 2
    kept_soft = edges.is_odometry | (l >= cfg.prune_threshold)
    w = torch.where(edges.is_odometry, one, torch.where(kept_soft, l, torch.zeros_like(l)))
    for _ in range(cfg.inner_iterations):
        p = _gn_step_before_the_split(p, edges, w, cfg)
    r2 = robust_pgo._edge_residual_sq(p, edges)
    l_final = torch.where(edges.is_odometry, one, (cfg.mu / (cfg.mu + r2)) ** 2)
    kept = edges.mask & (edges.is_odometry | (l_final >= cfg.prune_threshold))
    new = optimize_pose_graph(poses, edges, cfg)
    for a, b in zip((se3.orthonormalize(p), l_final, kept, r2), new):
        assert torch.equal(a, b)
