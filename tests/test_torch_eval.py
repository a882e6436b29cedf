"""PyTorch port: file writers, evaluation and the correspondence harvest vs the JAX package.

Seeded numpy inputs go through the JAX function and its port (``device="cpu"``):

- the corres / ctr / xyzn / ply writers write byte-identical files, and the
  readers read them back alike;
- ``eval/ate.py``: ATE statistics and alignment within 1e-6 at an odd and an
  even frame count (the median of an even count is the mean of the two
  middle values, as ``jnp.median``'s), per-frame errors within 5e-6 m
  (positions up to 2 m out); RPE within 1e-6;
- ``eval/registration_pr.py``: equal results on the fixtures of
  ``tests/test_eval_pr.py``;
- ``eval/gt_benchmark.py``: the same edges, ``gt.log`` byte-equal, ``gt.info``
  within 1e-4 relative (the sums run in another order);
- ``elastic/correspondence.py``: per edge the same counts and the same
  matched rows. The port's CPU route is the plain version of the CUDA
  nearest-neighbour kernel, whose contract differs from the reference's
  matmul distances only on near-ties (ROADMAP.md, Queue 3); a differing row
  must be one.
"""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core import io_logfmt as j_io
from elasticreconstruction_tpu.core import se3 as j_se3
from elasticreconstruction_tpu.core.types import PointCloud as JPointCloud
from elasticreconstruction_tpu.elastic import correspondence as j_corr
from elasticreconstruction_tpu.eval import ate as j_ate
from elasticreconstruction_tpu.eval import gt_benchmark as j_gtb
from elasticreconstruction_tpu.eval import registration_pr as j_pr
from elasticreconstruction_tpu_torch import interop
from elasticreconstruction_tpu_torch.bench_scene import make_fragments
from elasticreconstruction_tpu_torch.core import io_logfmt as t_io
from elasticreconstruction_tpu_torch.core.types import PointCloud
from elasticreconstruction_tpu_torch.elastic import correspondence as t_corr
from elasticreconstruction_tpu_torch.elastic.lattice import Lattice
from elasticreconstruction_tpu_torch.eval import ate as t_ate
from elasticreconstruction_tpu_torch.eval import gt_benchmark as t_gtb
from elasticreconstruction_tpu_torch.eval import registration_pr as t_pr
from elasticreconstruction_tpu_torch.kernels.cuda import build
from elasticreconstruction_tpu_torch.kernels.cuda import nn as t_nn


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once, and
    torch's thread pool spinning against the other workers' slows these small
    ops by two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_file(a, b):
    return filecmp.cmp(a, b, shallow=False)


# ------------------------------------------------------------------ writers


def test_writers_write_the_same_bytes(tmp_path):
    rng = np.random.default_rng(0)
    pairs = rng.integers(0, 100000, (57, 2))
    ctr = rng.normal(0, 2, (7 ** 3, 3))
    pts, nrm = rng.normal(0, 1, (40, 3)).astype(np.float32), rng.normal(0, 1, (40, 3)).astype(np.float32)
    verts = rng.normal(0, 3, (90, 3)).astype(np.float32)
    faces = rng.integers(0, 90, (150, 3))
    for name, jw, tw, args in (
        ("c.txt", j_io.write_corres, t_io.write_corres, (pairs,)),
        ("ctr.txt", j_io.write_ctr, t_io.write_ctr, (ctr, 6, 3.0)),
        ("d.xyzn", j_io.write_xyzn, t_io.write_xyzn, (pts, nrm)),
        ("m.ply", j_io.write_ply_mesh, t_io.write_ply_mesh, (verts, faces)),
        ("empty.ply", j_io.write_ply_mesh, t_io.write_ply_mesh, (np.zeros((0, 3)), np.zeros((0, 3), int))),
    ):
        jw(tmp_path / f"j_{name}", *args)
        tw(tmp_path / f"t_{name}", *args)
        assert _same_file(tmp_path / f"j_{name}", tmp_path / f"t_{name}"), name

    np.testing.assert_array_equal(t_io.read_corres(tmp_path / "t_c.txt"), j_io.read_corres(tmp_path / "j_c.txt"))
    for got, want in zip(t_io.read_ctr(tmp_path / "t_ctr.txt"), j_io.read_ctr(tmp_path / "j_ctr.txt")):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(t_io.read_xyzn(tmp_path / "t_d.xyzn"), j_io.read_xyzn(tmp_path / "j_d.xyzn")):
        np.testing.assert_array_equal(got, want)
    assert t_io.corres_filename(3, 12) == j_io.corres_filename(3, 12) == "corres_3_12.txt"
    for name in ("corres_3_12.txt", "corres_3_x.txt", "xcorres_1_2.txt"):
        assert t_io.parse_corres_filename(name) == j_io.parse_corres_filename(name)
    v, f = t_io.read_ply_mesh(tmp_path / "t_m.ply")
    np.testing.assert_allclose(v, verts, atol=5e-7)
    np.testing.assert_array_equal(f, faces)
    v, f = t_io.read_ply_mesh(tmp_path / "t_empty.ply")
    assert v.shape == (0, 3) and f.shape == (0, 3)


def test_readers_refuse_malformed_files(tmp_path):
    (tmp_path / "bad_ctr.txt").write_text("4 1 3.0\n0 0 0\n1 1 1\n")
    with pytest.raises(ValueError, match="claims 4"):
        t_io.read_ctr(tmp_path / "bad_ctr.txt")
    (tmp_path / "bad.ply").write_text("ply\nformat binary_little_endian 1.0\n")
    with pytest.raises(ValueError, match="ASCII"):
        t_io.read_ply_mesh(tmp_path / "bad.ply")
    (tmp_path / "cut.ply").write_text("ply\nformat ascii 1.0\nelement vertex 2\n")
    with pytest.raises(ValueError, match="end_header"):
        t_io.read_ply_mesh(tmp_path / "cut.ply")


# ---------------------------------------------------------------------- ATE


def _trajectories(n, seed):
    rng = np.random.default_rng(seed)
    gt = np.array(j_se3.exp(jnp.asarray(rng.normal(0, 0.6, (n, 6)).astype(np.float32))))
    align = np.array(j_se3.exp(jnp.asarray(np.array([0.4, -0.2, 0.9, 0.3, -0.5, 0.2], np.float32))))
    noise = np.array(j_se3.exp(jnp.asarray(rng.normal(0, 0.01, (n, 6)).astype(np.float32))))
    est = np.linalg.inv(align) @ gt @ noise
    return est.astype(np.float32), gt.astype(np.float32)


@pytest.mark.parametrize("n", [37, 64])
def test_ate_matches_jax(n):
    est, gt = _trajectories(n, seed=n)
    want = j_ate.absolute_trajectory_error(jnp.asarray(est), jnp.asarray(gt))
    got = t_ate.absolute_trajectory_error(torch.from_numpy(est), torch.from_numpy(gt))
    for name in ("rmse", "mean", "median", "max"):
        assert abs(float(getattr(got, name)) - float(getattr(want, name))) < 1e-6, name  # tolerance: 1e-6 m
    # Per frame, one f32 ulp of the alignment's rotation moves a point 2 m out by 1e-6.
    np.testing.assert_allclose(got.per_frame.numpy(), np.asarray(want.per_frame), atol=5e-6)  # tolerance: 5e-6 m
    np.testing.assert_allclose(got.alignment.numpy(), np.asarray(want.alignment), atol=1e-6)
    assert float(got.median) == pytest.approx(float(np.median(got.per_frame.numpy())), abs=1e-7)
    plain = t_ate.absolute_trajectory_error(torch.from_numpy(est), torch.from_numpy(gt), align=False)
    wplain = j_ate.absolute_trajectory_error(jnp.asarray(est), jnp.asarray(gt), align=False)
    assert abs(float(plain.rmse) - float(wplain.rmse)) < 1e-6 and float(plain.rmse) > 0.5
    te, re = t_ate.relative_pose_error(torch.from_numpy(est), torch.from_numpy(gt), delta=2)
    wte, wre = j_ate.relative_pose_error(jnp.asarray(est), jnp.asarray(gt), delta=2)
    np.testing.assert_allclose(te.numpy(), np.asarray(wte), atol=1e-6)
    np.testing.assert_allclose(re.numpy(), np.asarray(wre), atol=1e-6)


def test_median_of_an_even_count_is_the_mean_of_the_middle_values():
    assert float(t_ate.median(torch.tensor([4.0, 1.0, 3.0, 2.0]))) == 2.5
    assert float(t_ate.median(torch.tensor([5.0, 1.0, 3.0]))) == 3.0


# ----------------------------------------------------- registration P/R


def _small_transform(t, r):
    theta = np.linalg.norm(r)
    K = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])
    R = np.eye(3) if theta < 1e-12 else (
        np.eye(3) + np.sin(theta) / theta * K + (1 - np.cos(theta)) / theta**2 * (K @ K))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def test_registration_pr_matches_jax():
    rng = np.random.default_rng(3)
    info = np.eye(6) * 7.0
    info[0, 0] = 200.0
    T_gt = _small_transform(np.array([0.3, -0.1, 0.2]), np.array([0.2, -0.3, 0.1]))
    T_est = T_gt @ _small_transform(np.array([2e-3, -1e-3, 3e-3]), np.array([1e-3, 2e-3, -1e-3]))
    assert t_pr.edge_error_sq(T_est, T_gt, info) == j_pr.edge_error_sq(T_est, T_gt, info)
    assert t_pr.edge_error_sq(T_est, T_gt, info, 50.0) == j_pr.edge_error_sq(T_est, T_gt, info, 50.0)
    T_id, T_bad = np.eye(4), _small_transform(np.array([1.0, 0, 0]), np.zeros(3))
    gt_edges = [(0, 2, T_id), (0, 3, T_id), (1, 3, T_id)]
    gt_infos = {(i, j): np.diag([10.0] * 6) for i, j, _ in gt_edges}
    est_edges = [(0, 2, T_id), (0, 3, T_bad), (2, 4, T_id), (0, 1, T_id),
                 (1, 3, T_id @ _small_transform(rng.normal(0, 0.05, 3), np.zeros(3)))]
    for kw in ({}, {"err_threshold": 0.05}, {"nonconsecutive_only": False}, {"num_points": 3.0}):
        assert t_pr.precision_recall(est_edges, gt_edges, gt_infos, **kw) == \
            j_pr.precision_recall(est_edges, gt_edges, gt_infos, **kw)
    assert t_pr.precision_recall([], [], {}) == j_pr.precision_recall([], [], {})


def test_gt_benchmark_matches_jax(tmp_path):
    """The fixture of ``tests/test_eval_pr.py``: fragments 0 and 2 see one
    surface, fragment 1 lies 50 m away."""
    rng = np.random.default_rng(0)
    base = rng.uniform(-0.5, 0.5, (400, 3)).astype(np.float32)
    pts = [base, base + np.array([50.0, 0, 0], np.float32),
           base + rng.normal(0, 1e-3, base.shape).astype(np.float32)]
    gt_poses = np.stack([np.eye(4)] * 3)
    j_edges, j_infos = j_gtb.make_gt_edges([JPointCloud.from_points(jnp.asarray(p)) for p in pts], gt_poses,
                                           max_distance=0.05, capacity=512)
    t_clouds = [PointCloud.from_points(p, device="cpu") for p in pts]
    t_edges, t_infos = t_gtb.make_gt_edges(t_clouds, gt_poses, max_distance=0.05, capacity=512)
    assert [(i, j) for i, j, _ in t_edges] == [(i, j) for i, j, _ in j_edges] == [(0, 2)]
    np.testing.assert_array_equal(t_edges[0][2], j_edges[0][2])
    np.testing.assert_allclose(t_infos[(0, 2)], j_infos[(0, 2)], rtol=1e-4)  # tolerance: 1e-4 relative
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    j_gtb.write_gt_benchmark(tmp_path / "jax", j_edges, j_infos, 3)
    t_gtb.write_gt_benchmark(tmp_path / "torch", t_edges, t_infos, 3)
    assert _same_file(tmp_path / "jax" / "gt.log", tmp_path / "torch" / "gt.log")
    edges, infos = t_gtb.read_gt_benchmark(tmp_path / "torch")
    assert [(i, j) for i, j, _ in edges] == [(0, 2)] and infos[(0, 2)][0, 0] > 100
    pr = t_pr.precision_recall([(0, 2, np.eye(4))], edges, infos)
    assert pr["precision"] == 1.0 and pr["recall"] == 1.0
    np.testing.assert_array_equal(t_gtb.gt_fragment_poses(np.arange(10)[:, None] * np.ones(3), 3, 3),
                                  j_gtb.gt_fragment_poses(np.arange(10)[:, None] * np.ones(3), 3, 3))


# ------------------------------------------------------ correspondence harvest


def _harvest_inputs():
    """Three overlapping fragments of the registration scene, padded with
    masked rows, and their poses (fragment 1 posed 1 cm off)."""
    clouds, poses = make_fragments(3, n=1500, seed=4)
    pad = 200
    pts = np.concatenate([clouds.points, np.zeros((3, pad, 3), np.float32)], 1)
    nrm = np.concatenate([clouds.normals, np.zeros((3, pad, 3), np.float32)], 1)
    mask = np.concatenate([clouds.mask, np.zeros((3, pad), bool)], 1)
    mask[:, ::37] = False
    poses = poses.copy()
    poses[1, :3, 3] += 0.01
    pair_T = {(0, 1): (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)}
    pair_T[(0, 1)][:3, 3] -= [0.002, 0.0, 0.001]
    return pts, nrm, mask, poses.astype(np.float32), pair_T


@pytest.mark.parametrize("capacity", [128, 4096])
def test_build_correspondences_matches_jax(capacity):
    pts, nrm, mask, poses, pair_T = _harvest_inputs()
    edges = [(0, 1), (1, 2), (0, 2)]
    weights = {(1, 2): 1.5}
    kw = dict(max_distance=0.03, capacity_per_edge=capacity, pair_transforms=pair_T, edge_weights=weights)
    want = j_corr.build_correspondences(
        [JPointCloud(jnp.asarray(p), jnp.asarray(n), jnp.asarray(m)) for p, n, m in zip(pts, nrm, mask)],
        jnp.asarray(poses), edges, **kw)
    got = t_corr.build_correspondences(
        [PointCloud(*map(torch.from_numpy, x)) for x in zip(pts, nrm, mask)], torch.from_numpy(poses), edges, **kw)
    want, got = interop.corres_to_numpy(want), interop.corres_to_numpy(got)
    assert got.p.shape == want.p.shape == (3 * capacity, 3)
    for name in ("frag_i", "frag_j", "mask", "w"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (want.mask.reshape(3, capacity).sum(1) > min(150, capacity - 1)).all()
    # Matched rows: the same q (fragment j's row order) and the same p, n
    # unless the nearest point of fragment i is a near-tie.
    np.testing.assert_array_equal(got.q, want.q)
    diff = np.abs(got.p - want.p).max(1) > 0
    assert diff.sum() <= 2, diff.sum()
    for r in np.nonzero(diff)[0]:
        e = r // capacity
        i, j = edges[e]
        T_i, T_j = (np.eye(4), pair_T[(i, j)]) if (i, j) in pair_T else (poses[i], poses[j])
        qw = T_j[:3, :3].astype(np.float64) @ got.q[r] + T_j[:3, 3]
        d = [np.sum((T_i[:3, :3] @ p + T_i[:3, 3] - qw) ** 2) for p in (got.p[r], want.p[r])]
        assert abs(d[0] - d[1]) < 1e-6, d
    np.testing.assert_array_equal(got.n[~diff], want.n[~diff])
    assert float(t_corr.CorresSet(*map(torch.from_numpy, got)).count()) == want.mask.sum()


def test_harvest_pads_small_clouds_and_refuses_a_lattice():
    """The harvest pads a small cloud's rows to ``capacity``; a lattice at rest
    is accepted and warps nothing: it changes no match (the name is kept
    from when the rigid harvest refused any lattice)."""
    pts, nrm, mask, poses, _ = _harvest_inputs()
    c = [PointCloud(*map(torch.from_numpy, x)) for x in zip(pts, nrm, mask)]
    T = torch.from_numpy(poses)
    p, q, n, m = t_corr.correspondences_for_edge(c[0], c[1], T[0], T[1], capacity=4000)
    assert p.shape == (4000, 3) and m.shape == (4000,) and not m[1700:].any() and m.sum() > 150
    # A lattice at rest warps nothing: the same matches as without one.
    lat = Lattice(8, 3.0, (-1.5, -1.5, 0.0))
    rest = t_corr.correspondences_for_edge(c[0], c[1], T[0], T[1], capacity=4000, lattice=lat,
                                           disp_i=torch.zeros(729, 3), disp_j=torch.zeros(729, 3))
    for x, y in zip(rest, (p, q, n, m)):
        assert torch.equal(x, y)
    at_rest = t_corr.build_correspondences(c, T, [(0, 1)], lattice=lat, displacement=np.zeros((1, 729, 3), np.float32))
    rigid = t_corr.build_correspondences(c, T, [(0, 1)])
    assert all(torch.equal(x, y) for x, y in zip(at_rest, rigid))
    empty = t_corr.build_correspondences(c, T, [])
    assert empty.p.shape == (0, 3) and int(empty.count()) == 0


def test_harvest_shape_plan_and_scratch():
    """The harvest's (1, 131072, 131072) query: 64 or more ref splits on an
    H100's 132 SMs, and a scratch buffer of 2 x splits x padded queries
    floats (about 67 MB), to which the per-device cache grows."""
    geo = t_nn.plan(1, 131072, 131072, 132)
    assert geo.splits >= 64 and geo.splits * geo.range >= 131072
    assert geo.tiles * t_nn.QUERIES_PER_BLOCK == 131072
    floats = 2 * geo.splits * geo.tiles * t_nn.QUERIES_PER_BLOCK
    assert 60e6 < 4 * floats < 80e6
    dev = torch.device("cpu")
    build._scratch.pop(dev, None)
    small = build.scratch(dev, 1000)
    scratch, _ = t_nn.search_scratch(dev, 1, geo)
    assert scratch.numel() >= floats and scratch is not small
    assert build.scratch(dev, 1000) is scratch
    build._scratch.pop(dev, None)
    build._counters.pop(dev, None)
