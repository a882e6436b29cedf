"""PyTorch port: the elastic building blocks vs the JAX package on the CPU.

Seeded numpy inputs go through the JAX function and its port (``device="cpu"``):

- ``core/segment.py``: the fixed-order segment sum equals ``index_add_`` bit for
  bit on the CPU (rows of a segment are added in their original order), and a
  float64 sum within float32 rounding;
- ``elastic/lattice.py`` on ``tests/test_elastic.py``'s lattice and the
  production one: vertex ids equal and weights within 1e-6 against the
  reference jitted, as its optimiser and harvest call it (XLA then multiplies
  by the float32 reciprocal of the cell size, as the port does), ``deform``
  within 1e-6; ``edge_list`` and ``rest_positions`` equal;
- ``elastic/arap.py``: rotations within 1e-5 at zero displacement, under a
  rigid rotation and at a random displacement, one lattice and three at once;
  residuals within 1e-6;
- ``synthetic/distortion.py``: the grid equal to the bit; ``field``,
  ``apply_depth``, ``true_depth``, ``distort_points`` and ``gt_correction``
  within 1e-6 relative, ``gt_correction`` within 1e-6 of the points' size
  (it is ``p (d / z - 1)``, a float32 difference near 1; the reference's
  eager calls divide where its jitted ``generate_synthetic`` multiplies by
  reciprocals and fuses multiply-adds);
  ``apply_depth`` on one depth map equal to the bit to the reference's jitted
  form; ``to_json``/``from_json`` both ways;
- ``synthetic/warps.py``: the warp equal to the bit, ``warp_points`` within 1e-6;
- ``build_correspondences`` at a lattice warp (shared and per fragment): equal
  fragment ids and weights; the warp itself bit-equal to the reference's
  jitted ``deform``; per edge the same matches on seeded clouds but for at
  most 5 of ~1300 (a near-tie of the two NN contracts moves a match or the
  mutual check; ``tests/test_torch_eval.py`` holds the rigid harvest so);
- ``eval/lattice_recovery.py`` and ``eval/surface_error.py`` within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core import camera as j_cam
from elasticreconstruction_tpu.core import se3 as j_se3
from elasticreconstruction_tpu.core.types import PointCloud as JPointCloud
from elasticreconstruction_tpu.elastic import arap as j_arap
from elasticreconstruction_tpu.elastic import correspondence as j_corr
from elasticreconstruction_tpu.elastic import lattice as j_lat
from elasticreconstruction_tpu.eval import lattice_recovery as j_rec
from elasticreconstruction_tpu.eval import surface_error as j_surf
from elasticreconstruction_tpu.synthetic import distortion as j_dist
from elasticreconstruction_tpu.synthetic import scenes as j_scenes
from elasticreconstruction_tpu.synthetic import warps as j_warps
from elasticreconstruction_tpu_torch import interop
from elasticreconstruction_tpu_torch.core import segment
from elasticreconstruction_tpu_torch.core.types import PointCloud
from elasticreconstruction_tpu_torch.elastic import arap as t_arap
from elasticreconstruction_tpu_torch.elastic import correspondence as t_corr
from elasticreconstruction_tpu_torch.elastic import lattice as t_lat
from elasticreconstruction_tpu_torch.eval import lattice_recovery as t_rec
from elasticreconstruction_tpu_torch.eval import surface_error as t_surf
from elasticreconstruction_tpu_torch.synthetic import distortion as t_dist
from elasticreconstruction_tpu_torch.synthetic import scenes as t_scenes
from elasticreconstruction_tpu_torch.synthetic import warps as t_warps

J_LAT = j_lat.Lattice(resolution=4, length=2.0, origin=(-1.0, -1.0, -1.0))  # tests/test_elastic.py
T_LAT = interop.lattice_from(J_LAT)
J_LAT8 = j_lat.Lattice(8, 3.0, (-1.5, -1.5, 0.0))  # the production lattice
T_LAT8 = interop.lattice_from(J_LAT8)
INTR = j_cam.Intrinsics(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120)
T_INTR = interop.intrinsics_from(INTR)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- segment sums


@pytest.mark.parametrize("inner", [(), (3,), (6, 6)])
def test_segment_sum_equals_index_add(inner):
    rng = np.random.default_rng(0)
    n, s = 20000, 300
    keys = torch.from_numpy(rng.integers(0, s, n))
    x = torch.from_numpy((rng.normal(size=(n, *inner)) * 100).astype(np.float32))
    got = segment.segment_sum_by_keys(x, keys, s)
    want = torch.zeros((s, *inner)).index_add_(0, keys, x)
    assert torch.equal(got, want) and got.is_contiguous()
    exact = torch.zeros((s, *inner), dtype=torch.float64).index_add_(0, keys, x.double())
    scale = torch.zeros((s, *inner), dtype=torch.float64).index_add_(0, keys, x.double().abs())
    assert ((got.double() - exact).abs() <= 2.0**-23 * scale * 64).all()  # tolerance: f32 rounding of the terms
    # A plan made once serves every sum; sorted keys need no order.
    p = segment.plan(keys, s)
    assert torch.equal(segment.segment_sum(x, p), got)
    sk, order = torch.sort(keys, stable=True)
    assert torch.equal(segment.segment_sum(x[order], segment.plan_sorted(sk, s)), got)
    assert segment.segment_sum(x[:0], segment.plan(keys[:0], s)).abs().sum() == 0


# ---------------------------------------------------------------- lattice


def test_lattice_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-2.0, 2.0, size=(4000, 3)).astype(np.float32)  # incl. outside the cube
    for jl, tl in ((J_LAT, T_LAT), (J_LAT8, T_LAT8)):
        p = pts * jl.length / 2 + np.asarray(jl.origin, np.float32) + jl.length / 2
        # The reference's optimiser and harvest embed inside jitted functions.
        ids, w = jax.jit(j_lat.embed_weights, static_argnums=0)(jl, jnp.asarray(p))
        tids, tw = t_lat.embed_weights(tl, torch.from_numpy(p))
        np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
        assert tids.dtype == torch.int64 and tw.dtype == torch.float32
        np.testing.assert_allclose(tw.numpy(), np.asarray(w), atol=1e-6)  # tolerance: 1e-6
        disp = rng.normal(0, 0.05, (jl.num_vertices, 3)).astype(np.float32)
        np.testing.assert_allclose(t_lat.deform(tl, torch.from_numpy(disp), torch.from_numpy(p)).numpy(),
                                   np.asarray(j_lat.deform(jl, jnp.asarray(disp), jnp.asarray(p))),
                                   atol=1e-6)  # tolerance: 1e-6
    for a, b in ((J_LAT, T_LAT), (J_LAT8, T_LAT8)):
        np.testing.assert_array_equal(t_lat.edge_list(b).numpy(), np.asarray(j_lat.edge_list(a)))
        np.testing.assert_array_equal(b.rest_positions().numpy(), np.asarray(a.rest_positions()))
        assert (b.num_vertices, b.verts_per_axis, b.cell_size) == (a.num_vertices, a.verts_per_axis, a.cell_size)


# ---------------------------------------------------------------- ARAP


def _rotations(disp):
    want = np.asarray(jax.vmap(lambda d: j_arap.estimate_rotations(J_LAT, d))(jnp.asarray(disp)))
    got = t_arap.estimate_rotations(T_LAT, torch.from_numpy(disp)).numpy()
    return got, want


def test_arap_matches_jax():
    m = J_LAT.num_vertices
    rest = np.asarray(J_LAT.rest_positions())
    Rg = np.asarray(j_se3.so3_exp(jnp.array([0.2, -0.3, 0.15])))
    rng = np.random.default_rng(3)
    disp = np.stack([np.zeros((m, 3)), rest @ Rg.T - rest, rng.normal(0, 0.05, (m, 3))]).astype(np.float32)
    got, want = _rotations(disp)
    np.testing.assert_allclose(got, want, atol=1e-5)  # tolerance: 1e-5
    np.testing.assert_allclose(got[0], np.tile(np.eye(3), (m, 1, 1)), atol=1e-5)
    np.testing.assert_allclose(got[1], np.tile(Rg, (m, 1, 1)), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    for k in range(3):  # one lattice at a time gives the same rotations
        np.testing.assert_allclose(t_arap.estimate_rotations(T_LAT, torch.from_numpy(disp[k])).numpy(), got[k],
                                   atol=1e-6)
    r, a, b = t_arap.residuals(T_LAT, torch.from_numpy(disp[2]), torch.from_numpy(got[2]))
    rj, aj, bj = j_arap.residuals(J_LAT, jnp.asarray(disp[2]), jnp.asarray(got[2]))
    np.testing.assert_array_equal(a.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(b.numpy(), np.asarray(bj))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=1e-6)  # tolerance: 1e-6


# ---------------------------------------------------------------- distortion


def _close(got, want, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30), np.abs(got - want).max()


def test_distortion_matches_jax():
    jd = j_dist.make_distortion(7, radial_a=0.03, depth_b=0.01, grid_sigma=0.01)
    td = t_dist.make_distortion(7, radial_a=0.03, depth_b=0.01, grid_sigma=0.01)
    np.testing.assert_array_equal(td.grid.numpy(), np.asarray(jd.grid))
    assert t_dist.DepthDistortion.from_json(jd.to_json()).to_json() == jd.to_json() == td.to_json()
    np.testing.assert_array_equal(np.asarray(j_dist.DepthDistortion.from_json(td.to_json()).grid), td.grid.numpy())
    assert interop.distortion_from(jd).to_json() == td.to_json()
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 5.0, (120, 160)).astype(np.float32)
    depth[:5] = 0.0
    uv = np.asarray(j_cam.pixel_grid(INTR))
    u, v = uv[..., 0], uv[..., 1]
    tu, tv, tdep = (torch.from_numpy(x) for x in (u, v, depth))
    # tolerance: 1e-6 relative on each
    _close(t_dist.field(td, tu, tv, tdep, T_INTR), j_dist.field(jd, u, v, depth, INTR))
    obs = j_dist.apply_depth(jd, jnp.asarray(depth), INTR)
    _close(t_dist.apply_depth(td, tdep, T_INTR), obs)
    _close(t_dist.true_depth(td, torch.from_numpy(np.asarray(obs)), tu, tv, T_INTR),
           j_dist.true_depth(jd, obs, u, v, INTR))
    # The reference distorts rendered depth inside a jitted function: the port's form, to the bit.
    jit_obs = jax.jit(lambda d: j_dist.apply_depth(jd, d, INTR))(jnp.asarray(depth))
    np.testing.assert_array_equal(t_dist.apply_depth(td, tdep, T_INTR).numpy(), np.asarray(jit_obs))
    z = rng.uniform(0.5, 4.0, 512).astype(np.float32)
    p = np.stack([z * rng.uniform(-0.45, 0.45, 512), z * rng.uniform(-0.35, 0.35, 512), z], 1).astype(np.float32)
    p[:3, 2] = 0.0  # no depth: passes through, zero correction
    p_obs = j_dist.distort_points(jd, jnp.asarray(p), INTR)
    _close(t_dist.distort_points(td, torch.from_numpy(p), T_INTR), p_obs)
    got = t_dist.gt_correction(td, torch.from_numpy(np.asarray(p_obs)), T_INTR)
    # The correction is p (d / z - 1), a float32 difference near 1: relative to the points.
    want = np.asarray(j_dist.gt_correction(jd, p_obs, INTR))
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(np.asarray(p_obs)).max()  # tolerance: 1e-6 of |p|
    assert got[:3].abs().max() == 0


# ---------------------------------------------------------------- warps


def test_warps_match_jax():
    for seed in (100, 1001):
        w = t_warps.make_fragment_warp(seed, T_LAT8, amplitude=0.03)
        np.testing.assert_array_equal(w, j_warps.make_fragment_warp(seed, J_LAT8, amplitude=0.03))
    pts = np.random.default_rng(1).uniform(-1.5, 1.5, (3000, 3)).astype(np.float32)
    pts[:, 2] += 1.5
    np.testing.assert_allclose(t_warps.warp_points(T_LAT8, w, pts).numpy(),
                               np.asarray(j_warps.warp_points(J_LAT8, w, pts)), atol=1e-6)  # tolerance: 1e-6


# ---------------------------------------------------------------- harvest at a lattice warp


def _clouds(nf=3, n=3000, seed=0):
    """Noisy samples of one wavy surface seen from ``nf`` poses, local frames."""
    rng = np.random.default_rng(seed)
    poses = np.stack([np.asarray(j_se3.exp(jnp.array([0.05 * f, -0.03 * f, 0.02 * f, 0.03 * f, -0.02 * f, 0.04 * f])))
                      for f in range(nf)]).astype(np.float32)
    pts, nrm, mask = [], [], []
    for f in range(nf):
        x, y = rng.uniform(-1.2, 1.2, (2, n))
        z = 1.5 + 0.3 * np.sin(2 * x) * np.cos(1.5 * y) + rng.normal(0, 0.002, n)
        world = np.stack([x, y, z], 1).astype(np.float32)
        local = (world - poses[f][:3, 3]) @ poses[f][:3, :3]
        normal = rng.normal(size=(n, 3)).astype(np.float32)
        m = np.ones(n, bool)
        m[-200:] = False
        pts.append(local.astype(np.float32))
        nrm.append(normal / np.linalg.norm(normal, axis=1, keepdims=True))
        mask.append(m)
    return pts, nrm, mask, poses


@pytest.mark.parametrize("per_fragment", [False, True])
def test_harvest_at_a_lattice_warp_matches_jax(per_fragment):
    pts, nrm, mask, poses = _clouds()
    edges = [(0, 1), (1, 2), (0, 2)]
    rng = np.random.default_rng(4)
    disp = rng.normal(0, 0.01, (3 if per_fragment else 1, J_LAT8.num_vertices, 3)).astype(np.float32)
    lof = [0, 1, 2] if per_fragment else None
    kw = dict(max_distance=0.03, capacity_per_edge=2048, displacement=disp, lattice_of_fragment=lof)
    want = j_corr.build_correspondences(
        [JPointCloud(jnp.asarray(p), jnp.asarray(n), jnp.asarray(m)) for p, n, m in zip(pts, nrm, mask)],
        jnp.asarray(poses), edges, lattice=J_LAT8, **kw)
    got = t_corr.build_correspondences(
        [PointCloud(*map(torch.from_numpy, x)) for x in zip(pts, nrm, mask)], torch.from_numpy(poses), edges,
        lattice=T_LAT8, **kw)
    want, got = interop.corres_to_numpy(want), interop.corres_to_numpy(got)
    for name in ("frag_i", "frag_j", "w"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (want.mask.reshape(3, -1).sum(1) > 300).all()
    # Per edge, the matches as {fragment j's point: fragment i's point}: the
    # same but for near-ties of the two NN contracts (ROADMAP.md, Queue 3),
    # which also move the mutual check: at most 5 of ~1300 an edge.
    for e in range(3):
        rows = slice(e * 2048, (e + 1) * 2048)
        g, w = ({q.tobytes(): p for q, p, m in zip(c.q[rows], c.p[rows], c.mask[rows]) if m} for c in (got, want))
        assert len(g.keys() ^ w.keys()) <= 5, len(g.keys() ^ w.keys())
        assert sum(not np.array_equal(g[k], w[k]) for k in g.keys() & w.keys()) <= 5
    # The warp moved the matches: the rigid harvest differs.
    rigid = interop.corres_to_numpy(t_corr.build_correspondences(
        [PointCloud(*map(torch.from_numpy, x)) for x in zip(pts, nrm, mask)], torch.from_numpy(poses), edges,
        max_distance=0.03, capacity_per_edge=2048))
    assert not np.array_equal(rigid.mask, got.mask)


# ---------------------------------------------------------------- evaluation


def test_lattice_recovery_and_surface_error_match_jax():
    jd = j_dist.make_distortion(3, radial_a=0.03, depth_b=0.008, grid_sigma=0.01)
    rng = np.random.default_rng(5)
    clouds = []
    for f in range(2):
        z = rng.uniform(0.8, 2.8, 3000).astype(np.float32)
        p = np.stack([z * rng.uniform(-0.4, 0.4, 3000), z * rng.uniform(-0.3, 0.3, 3000), z], 1).astype(np.float32)
        p = np.asarray(j_dist.distort_points(jd, jnp.asarray(p), INTR))
        clouds.append((p, np.zeros_like(p), rng.uniform(size=3000) < 0.9))
    disp = rng.normal(0, 0.01, (J_LAT8.num_vertices, 3)).astype(np.float32)
    want = j_rec.lattice_recovery(J_LAT8, disp, [JPointCloud(*map(jnp.asarray, c)) for c in clouds], jd, INTR,
                                  max_points_per_fragment=2000)
    got = t_rec.lattice_recovery(T_LAT8, disp, [PointCloud(*map(torch.from_numpy, c)) for c in clouds],
                                 interop.distortion_from(jd), T_INTR, max_points_per_fragment=2000,
                                 device="cpu")
    assert got.keys() == want.keys() and got["points"] == want["points"]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), k  # tolerance: 1e-5
    pts = rng.uniform(-2.0, 2.0, (5000, 3)).astype(np.float32)
    pts[:, 1] += 1.3
    want = j_surf.surface_error(j_scenes.livingroom_scene(), pts, max_points=4000)
    got = t_surf.surface_error(t_scenes.livingroom_scene(), pts, max_points=4000, device="cpu")
    assert got.keys() == want.keys() and got["points"] == want["points"] == 4000
    for k in ("mean", "rmse", "median", "p95", "max"):
        assert abs(got[k] - want[k]) <= 1e-5, k  # tolerance: 1e-5 m
    assert t_surf.surface_error(t_scenes.livingroom_scene(), np.zeros((0, 3)), device="cpu") == {"points": 0}
