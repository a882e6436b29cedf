"""PyTorch port, pose graph and retrieval vs the JAX package on the CPU.

The fixtures of ``tests/test_posegraph.py`` (copied here as numpy functions)
go through both ``optimize_pose_graph``: ``kept`` equal, ``line_process``
within 1e-3, poses within 1e-4. The solve is a dense 6N x 6N f32 system whose
gauge prior is 1e8 against entries of ~1e2..1e4, so the two LU factorisations
round differently at ~1e-7 relative per step over 48 steps; 1e-4 leaves an
order of magnitude over what is observed. Jacobians at xi = 0 must be finite
(reverse-mode differentiation gives NaN there) and within 1e-5 of
``jax.jacfwd``. The spanning-tree fixtures of
``tests/test_graph_robustness.py`` and a gauge-consensus fixture go through
both packages' stage helpers. Retrieval: signatures within 1e-6, mutual top-k
sets equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core import se3 as j_se3
from elasticreconstruction_tpu.pipeline import stages as j_stages
from elasticreconstruction_tpu.posegraph import robust_pgo as j_pgo
from elasticreconstruction_tpu.registration import retrieval as j_retrieval
from elasticreconstruction_tpu_torch import interop
from elasticreconstruction_tpu_torch.core import se3 as t_se3
from elasticreconstruction_tpu_torch.pipeline import stages as t_stages
from elasticreconstruction_tpu_torch.posegraph import robust_pgo as t_pgo
from elasticreconstruction_tpu_torch.registration import retrieval as t_retrieval


def _exp(xi):
    return t_se3.exp(torch.tensor(xi, dtype=torch.float32)).numpy()


def circle_poses(n, radius=2.0):
    """Ground-truth poses around a circle (closes the loop)."""
    poses = []
    for k in range(n):
        a = 2 * np.pi * k / n
        T = np.eye(4, dtype=np.float32)
        c, s = np.cos(a), np.sin(a)
        T[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
        T[:3, 3] = [radius * s, 0.0, radius * (1 - c)]
        poses.append(T)
    return np.stack(poses)


def rel(Ti, Tj):
    """Measured That_ij with p_i = That @ p_j, i.e. Ti^-1 Tj."""
    return np.linalg.inv(Ti) @ Tj


def noisy_odometry_chain(gt, rng, t_sigma=0.01, r_sigma=0.005):
    """Integrate noisy odometry measurements into drifted initial poses."""
    meas, poses = [], [np.eye(4, dtype=np.float32)]
    for k in range(len(gt) - 1):
        xi = np.concatenate([rng.normal(0, t_sigma, 3), rng.normal(0, r_sigma, 3)]).astype(np.float32)
        m = (rel(gt[k], gt[k + 1]) @ _exp(xi)).astype(np.float32)
        meas.append(m)
        poses.append((poses[-1] @ m).astype(np.float32))
    return np.stack(meas), np.stack(poses)


def build_edges(n, odom_meas, loops):
    """loops: list of (i, j, That, info_scale) -> the JAX package's EdgeList."""
    ii = list(range(n - 1)) + [l[0] for l in loops]
    jj = list(range(1, n)) + [l[1] for l in loops]
    T = [odom_meas[k] for k in range(n - 1)] + [l[2] for l in loops]
    info = [np.eye(6, dtype=np.float32) * 100.0 for _ in range(n - 1)] + [
        np.eye(6, dtype=np.float32) * l[3] for l in loops
    ]
    is_odom = [True] * (n - 1) + [False] * len(loops)
    return j_pgo.EdgeList.build(np.array(ii), np.array(jj), np.stack(T), np.stack(info), np.array(is_odom))


def _loop_closure():
    n = 24
    gt = circle_poses(n)
    meas, init = noisy_odometry_chain(gt, np.random.default_rng(0))
    loops = [
        (0, n - 1, rel(gt[0], gt[n - 1]).astype(np.float32), 100.0),
        (3, 15, rel(gt[3], gt[15]).astype(np.float32), 100.0),
    ]
    return gt, init, build_edges(n, meas, loops), j_pgo.PGOConfig(), [True, True]


def _false_loops():
    n = 24
    gt = circle_poses(n)
    meas, init = noisy_odometry_chain(gt, np.random.default_rng(1))
    bad1 = _exp([1.5, -0.8, 0.6, 0.4, 0.9, -0.3]) @ rel(gt[2], gt[17])
    bad2 = _exp([-0.9, 1.1, 0.4, 0.8, -0.2, 0.5]) @ rel(gt[5], gt[20])
    loops = [
        (0, n - 1, rel(gt[0], gt[n - 1]).astype(np.float32), 100.0),
        (2, 17, bad1.astype(np.float32), 100.0),
        (8, 19, rel(gt[8], gt[19]).astype(np.float32), 100.0),
        (5, 20, bad2.astype(np.float32), 100.0),
    ]
    return gt, init, build_edges(n, meas, loops), j_pgo.PGOConfig(), [True, False, True, False]


def _masked_edge():
    n = 8
    gt = circle_poses(n)
    meas, init = noisy_odometry_chain(gt, np.random.default_rng(2), t_sigma=0.002, r_sigma=0.001)
    crazy = _exp([5.0, 5, 5, 1, 1, 1.0]).astype(np.float32)
    edges = build_edges(n, meas, [(0, 4, crazy, 1000.0)])
    mask = np.ones(len(np.array(edges.i)), bool)
    mask[-1] = False
    return gt, init, edges._replace(mask=jnp.array(mask)), j_pgo.PGOConfig(outer_iterations=2), [False]


FIXTURES = {"loop_closure": _loop_closure, "false_loops": _false_loops, "masked_edge": _masked_edge}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_optimize_pose_graph_matches_jax(name):
    gt, init, j_edges, j_cfg, loops_kept = FIXTURES[name]()
    want = j_pgo.optimize_pose_graph(jnp.array(init), j_edges, j_cfg)
    got = t_pgo.optimize_pose_graph(
        torch.from_numpy(init), interop.edges_from_numpy(j_edges, "cpu"), t_pgo.PGOConfig(**j_cfg._asdict())
    )
    np.testing.assert_array_equal(got.kept.numpy(), np.asarray(want.kept))
    assert got.kept.numpy()[len(gt) - 1 :].tolist() == loops_kept
    np.testing.assert_allclose(got.line_process.numpy(), np.asarray(want.line_process), atol=1e-3)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=1e-4)
    live = np.asarray(j_edges.mask)
    r2 = np.asarray(want.residual_sq)
    np.testing.assert_allclose(got.residual_sq.numpy()[live], r2[live], atol=1e-3 * max(1.0, r2[live].max()))
    # The optimised trajectory, rigidly aligned, sits on the ground truth (the
    # absolute-trajectory-error bound of tests/test_posegraph.py).
    est, ref = got.poses[:, :3, 3], torch.from_numpy(gt[:, :3, 3])
    err = t_se3.apply(t_se3.kabsch(est, ref), est) - ref
    assert err.square().sum(-1).mean().sqrt() < 0.03


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_edge_jacobians_match_jacfwd(name):
    _, init, j_edges, _, _ = FIXTURES[name]()
    r, Ji, Jj = t_pgo.edge_residuals_and_jacobians(torch.from_numpy(init), interop.edges_from_numpy(j_edges, "cpu"))
    poses = jnp.array(init)
    jr, jJi, jJj = jax.vmap(j_pgo._edge_residual_and_jac)(
        poses[j_edges.i], poses[j_edges.j], j_se3.inverse(j_edges.transform)
    )
    for got, want in ((r, jr), (Ji, jJi), (Jj, jJj)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # At a consistent edge the Jacobians are -Ad(...) and I to first order: full rank.
    assert np.linalg.matrix_rank(Jj.numpy()[0]) == 6


def test_jacobians_finite_at_identity_residual():
    """Exactly consistent edges put every small-angle branch at theta = 0."""
    gt = circle_poses(6)
    edges = t_pgo.EdgeList.build(
        np.arange(5), np.arange(1, 6), np.stack([rel(gt[k], gt[k + 1]) for k in range(5)]),
        np.stack([np.eye(6, dtype=np.float32)] * 5), np.ones(5, bool), device="cpu",
    )
    r, Ji, Jj = t_pgo.edge_residuals_and_jacobians(torch.from_numpy(gt), edges)
    assert torch.isfinite(r).all() and torch.isfinite(Ji).all() and torch.isfinite(Jj).all()
    assert r.abs().max() < 1e-5
    np.testing.assert_allclose(Jj.numpy(), np.broadcast_to(np.eye(6), (5, 6, 6)), atol=1e-5)


def test_orthonormalize_matches_jax():
    rng = np.random.default_rng(3)
    poses = np.stack([_exp(rng.uniform(-1, 1, 6)) for _ in range(5)])
    poses[:, :3, :3] += rng.normal(0, 1e-3, (5, 3, 3)).astype(np.float32)
    got = t_se3.orthonormalize(torch.from_numpy(poses)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_se3.orthonormalize(jnp.asarray(poses))), atol=1e-6)
    np.testing.assert_allclose(got[:, :3, :3] @ got[:, :3, :3].transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), (5, 3, 3)), atol=5e-6)


# ---- stage helpers -----------------------------------------------------------


def _chain_poses(n, step=0.1):
    poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(n)])
    for k in range(n):
        poses[k, 0, 3] = step * k
    return poses


def _suspect_chain():
    """6 fragments in a line; odometry edge (2, 3) is suspect and wrong by 1 m,
    a loop edge (1, 4) carries the correct relative transform."""
    n = 6
    ii, jj, Ts = [], [], []
    for f in range(n - 1):
        T = np.eye(4)
        T[0, 3] = 0.1 + (1.0 if f == 2 else 0.0)
        ii.append(f)
        jj.append(f + 1)
        Ts.append(T)
    T_loop = np.eye(4)
    T_loop[0, 3] = 0.3
    return n, ii + [1], jj + [4], Ts + [T_loop]


def test_spanning_tree_routes_around_suspect_edges():
    n, ii, jj, Ts = _suspect_chain()
    fallback = np.stack([np.eye(4, dtype=np.float32)] * n)
    got = t_stages._spanning_tree_init(n, ii, jj, Ts, {(2, 3)}, fallback)
    np.testing.assert_array_equal(got, j_stages._spanning_tree_init(n, ii, jj, Ts, {(2, 3)}, fallback))
    np.testing.assert_allclose(got[:, 0, 3], [0.0, 0.1, 0.2, 0.3, 0.4, 0.5], atol=1e-6)


def test_spanning_tree_falls_back_for_unreachable():
    fallback = _chain_poses(3, step=0.7)
    got = t_stages._spanning_tree_init(3, [], [], [], set(), fallback)
    np.testing.assert_array_equal(got, j_stages._spanning_tree_init(3, [], [], [], set(), fallback))
    np.testing.assert_allclose(got, fallback, atol=1e-6)


def test_gauge_consensus_matches_jax():
    """Two loop edges across a suspect edge agree with the chain, one asserts a
    half-turn the chain rules out: both packages drop that one."""
    n = 8
    odo_T = {}
    for f in range(n - 1):
        T = np.eye(4)
        T[0, 3] = 0.1
        odo_T[(f, f + 1)] = T
    suspect = {(3, 4)}

    def loop(i, j, dx=0.0, yaw=0.0):
        T = np.eye(4)
        T[0, 3] = 0.1 * (j - i) + dx
        c, s = np.cos(yaw), np.sin(yaw)
        T[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        return (i, j, T)

    loops = [loop(1, 6, dx=0.05), loop(2, 5, dx=0.02), loop(0, 7, yaw=np.pi - 0.05), loop(0, 2)]
    cfg = t_pgo.PGOConfig()
    drop, stats = t_stages._gauge_consensus(n, odo_T, loops, suspect, cfg, trans_per_suspect=0.75)
    j_drop, j_stats = j_stages._gauge_consensus(n, odo_T, loops, suspect, j_pgo.PGOConfig(), trans_per_suspect=0.75)
    assert drop == j_drop == {(0, 7)}
    assert stats == j_stats == {"crossing": 3, "dropped": 1, "component_pairs": 1}


# ---- retrieval ---------------------------------------------------------------


def test_retrieval_matches_jax():
    rng = np.random.default_rng(4)
    feats = rng.gamma(2.0, 10.0, (6, 200, 33)).astype(np.float32)
    feats[1] = feats[0] * 1.5 + rng.normal(0, 0.5, feats[0].shape).astype(np.float32).clip(0)  # same content
    feats[4, :50] = 0.0  # empty histograms
    mask = rng.uniform(size=(6, 200)) > 0.2
    mask[5] = False  # an all-invalid fragment
    sig = t_retrieval.fragment_signatures(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    j_sig = np.asarray(j_retrieval.fragment_signatures(jnp.asarray(feats), jnp.asarray(mask)))
    np.testing.assert_allclose(sig, j_sig, atol=1e-6)
    np.testing.assert_allclose(sig[:5].sum(-1), 1.0, atol=1e-5)
    assert (sig[5] == 0).all()
    dist = t_retrieval.signature_distances(sig)
    np.testing.assert_array_equal(t_retrieval.signature_distances(j_sig), j_retrieval.signature_distances(j_sig))
    assert dist[0, 1] == dist[0, 1:].min()
    cands = {(0, 1), (0, 3), (1, 4), (2, 3), (2, 4), (3, 4)}
    for k, candidates in ((1, None), (2, None), (2, cands), (5, cands)):
        got = t_retrieval.mutual_topk_pairs(dist, k, candidates=candidates)
        assert got == j_retrieval.mutual_topk_pairs(j_retrieval.signature_distances(j_sig), k, candidates=candidates)
        assert candidates is None or got <= candidates
    assert (0, 1) in t_retrieval.mutual_topk_pairs(dist, 1)
