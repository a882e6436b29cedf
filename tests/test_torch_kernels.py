"""PyTorch port, kernels: each module that holds a kernel vs the JAX package on the CPU.

The Pallas kernels run as ``tests/test_pallas_kernels.py`` runs them
(``interpret=True``). On CPU tensors the port's kernel wrappers run their
plain PyTorch versions, which is what is compared here; the CUDA kernels are
held against those plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core.types import PointCloud as JCloud
from elasticreconstruction_tpu.kernels import eigen33 as j_eigen
from elasticreconstruction_tpu.kernels import fpfh as j_fpfh
from elasticreconstruction_tpu.kernels import knn as j_knn
from elasticreconstruction_tpu.kernels import normals as j_normals
from elasticreconstruction_tpu.kernels import voxel_grid as j_voxel
from elasticreconstruction_tpu.kernels.pallas import icp_step as j_icp_step
from elasticreconstruction_tpu.kernels.pallas import nn as j_pnn
from elasticreconstruction_tpu.registration.icp import _normal_eqs_xla
from elasticreconstruction_tpu_torch.core.types import PointCloud as TCloud
from elasticreconstruction_tpu_torch.kernels import eigen33 as t_eigen
from elasticreconstruction_tpu_torch.kernels import fpfh as t_fpfh
from elasticreconstruction_tpu_torch.kernels import knn as t_knn
from elasticreconstruction_tpu_torch.kernels import normals as t_normals
from elasticreconstruction_tpu_torch.kernels import voxel_grid as t_voxel
from elasticreconstruction_tpu_torch.kernels.cuda import icp_step as t_icp_step
from elasticreconstruction_tpu_torch.kernels.cuda import nn as t_nn


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


# The shapes of tests/test_pallas_kernels.py: (seed, B, Nq, Nr, masked tail).
NN_CASES = {"unbatched_masked": (21, 1, 700, 900, 100), "batched": (22, 3, 500, 600, 0)}


@pytest.mark.parametrize("case", sorted(NN_CASES))
def test_nearest_batch_plain_matches_pallas_and_jnp(case):
    seed, b, nq, nr, tail = NN_CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.uniform(-2, 2, (b, nq, 3)).astype(np.float32)
    r = rng.uniform(-2, 2, (b, nr, 3)).astype(np.float32)
    m = np.ones((b, nr), bool)
    m[:, nr - tail:] = False
    d_t, i_t = t_nn.nearest_batch_plain(*_t(q, r, m))
    d_p, i_p = j_pnn.nearest_batch(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), block_q=256, block_r=256, interpret=True
    )
    d_j, i_j = jax.vmap(lambda a, c, k: j_knn.nearest(a, c, k))(q, r, m)
    assert i_t.dtype == torch.int32 and d_t.dtype == torch.float32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_p), atol=1e-5)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    # CPU tensors route to the plain version (and launch nothing).
    before = t_nn.launches
    d_w, i_w = t_knn.nearest_auto_batch(*_t(q, r, m))
    assert t_nn.launches == before
    assert torch.equal(d_w, d_t) and torch.equal(i_w, i_t)


def test_all_masked_refs_sentinels():
    """Kernel contract: masked refs surface as 3e38 (index 0, like the Pallas
    kernel); the matmul path ``knn.nearest`` gives inf, like the jnp path."""
    rng = np.random.default_rng(23)
    q = rng.uniform(-2, 2, (1, 100, 3)).astype(np.float32)
    r = rng.uniform(-2, 2, (1, 200, 3)).astype(np.float32)
    m = np.zeros((1, 200), bool)
    d_t, i_t = t_nn.nearest_batch_plain(*_t(q, r, m))
    d_p, i_p = j_pnn.nearest(jnp.asarray(q[0]), jnp.asarray(r[0]), jnp.asarray(m[0]), block_q=128, block_r=128, interpret=True)
    assert (d_t.numpy() > 1e30).all() and np.array_equal(d_t.numpy()[0], np.asarray(d_p))
    assert (i_t.numpy() == 0).all() and (np.asarray(i_p) == 0).all()
    d_u, i_u = t_nn.nearest(*_t(q[0], r[0], m[0]))  # unbatched wrapper, CPU route
    assert torch.equal(d_u, d_t[0]) and torch.equal(i_u, i_t[0])
    d_inf, _ = t_knn.nearest(*_t(q[0], r[0], m[0]))
    d_jinf, _ = j_knn.nearest(jnp.asarray(q[0]), jnp.asarray(r[0]), jnp.asarray(m[0]))
    assert torch.isinf(d_inf).all() and np.isinf(np.asarray(d_jinf)).all()


def test_knn_and_nearest_match_jax():
    rng = np.random.default_rng(25)
    q = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    r = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    m = rng.uniform(size=400) > 0.2
    np.testing.assert_allclose(
        t_knn.pairwise_sqdist(*_t(q, r)).numpy(), np.asarray(j_knn.pairwise_sqdist(q, r)), atol=1e-5
    )
    d_t, i_t = t_knn.knn(*_t(q, r, m), k=8, block_size=128)
    d_j, i_j = j_knn.knn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), k=8, block_size=128)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    d_t, i_t = t_knn.nearest(*_t(q, r, m), block_size=128)
    d_j, i_j = j_knn.nearest(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), block_size=128)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)


def _icp_step_inputs():
    """The input of tests/test_pallas_kernels.py::TestFusedICPStep."""
    rng = np.random.default_rng(24)
    B, N, M = 2, 400, 500
    p = rng.uniform(-2, 2, (B, N, 3)).astype(np.float32)
    w = (rng.uniform(size=(B, N)) > 0.1).astype(np.float32)
    d = rng.uniform(-2, 2, (B, M, 3)).astype(np.float32)
    nr = rng.normal(size=(B, M, 3))
    nr = (nr / np.linalg.norm(nr, axis=-1, keepdims=True)).astype(np.float32)
    mask = np.tile(np.r_[np.ones(450, bool), np.zeros(50, bool)], (B, 1))
    return p, w, d, nr, mask


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)


def test_normal_eqs_batch_plain_matches_pallas():
    """Tolerances of test_pallas_kernels.py: the Pallas kernel gathers with
    bf16 hi/lo matmuls and averages exact ties."""
    args = _icp_step_inputs()
    H1, g1, n1, w1 = t_icp_step.normal_eqs_batch_plain(*_t(*args), max_dist=0.5)
    H2, g2, n2, w2 = j_icp_step.normal_eqs_batch(
        *(jnp.asarray(a) for a in args), max_dist=0.5, block_q=128, block_r=256, interpret=True
    )
    np.testing.assert_allclose(n1.numpy(), np.asarray(n2), atol=0.5)
    for a, b, tol in ((H1, H2, 1e-3), (g1, g2, 1e-3), (w1, w2, 1e-4)):
        assert _rel(a.numpy(), b) < tol


def test_normal_eqs_batch_plain_matches_xla_step():
    """The plain version is the port of ``_normal_eqs_xla``: same NN (first
    index on ties), same gathers; only f32 summation order differs."""
    args = _icp_step_inputs()
    H1, g1, n1, w1 = t_icp_step.normal_eqs_batch_plain(*_t(*args), max_dist=0.5)
    H2, g2, n2, w2 = _normal_eqs_xla(*(jnp.asarray(a) for a in args), 0.5)
    np.testing.assert_array_equal(n1.numpy(), np.asarray(n2))
    for a, b in ((H1, H2), (g1, g2), (w1, w2)):
        assert _rel(a.numpy(), b) < 1e-5
    # CPU tensors route to the plain version through the wrapper.
    before = t_icp_step.launches
    H3, g3, n3, w3 = t_icp_step.normal_eqs_batch(*_t(*args), max_dist=0.5)
    assert t_icp_step.launches == before
    assert torch.equal(H3, H1) and torch.equal(g3, g1) and torch.equal(n3, n1)


def _scan_cloud(seed, n=3000):
    """A wavy height field patch with a masked tail and some far outliers."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, n)
    y = rng.uniform(-1.0, 1.0, n)
    z = 0.3 * np.sin(2.3 * x) * np.cos(1.7 * y) + 0.1 * np.cos(5.3 * x)
    pts = np.stack([x, y, z], 1).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-200:] = False
    pts[-210:-200] += 80.0  # beyond the 1023-voxel key range: dropped
    return pts, nrm, mask


@pytest.mark.parametrize("capacity", [4096, 300])
def test_voxel_downsample_matches_jax(capacity):
    """Mask and row ORDER identical (ICP strides over it; overflow keeps a prefix)."""
    pts, nrm, mask = _scan_cloud(31)
    want = j_voxel.voxel_downsample(JCloud(*(jnp.asarray(a) for a in (pts, nrm, mask))), 0.05, capacity)
    got = t_voxel.voxel_downsample(TCloud(*_t(pts, nrm, mask)), 0.05, capacity)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-5)
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(want.normals), atol=1e-5)
    if capacity == 300:
        assert got.mask.all()


def test_voxel_keys_match_jax():
    pts, _, mask = _scan_cloud(32)
    origin = pts[mask].min(0)
    want = np.asarray(j_voxel.voxel_keys(jnp.asarray(pts), jnp.asarray(mask), 0.025, jnp.asarray(origin)))
    got = t_voxel.voxel_keys(*_t(pts, mask), 0.025, torch.from_numpy(origin))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _covariances(seed, n=2000):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3, 3)) * np.array([1.0, 0.5, 0.05])
    cov = (a @ a.transpose(0, 2, 1)).astype(np.float32)
    cov[:10] = np.eye(3, dtype=np.float32) * 0.3  # isotropic: not ok, +z
    cov[10:20] = 0.0
    return cov


def test_eigen33_matches_jax():
    cov = _covariances(41)
    v_j, ok_j = j_eigen.smallest_eigenvector(jnp.asarray(cov))
    v_t, ok_t = t_eigen.smallest_eigenvector(torch.from_numpy(cov))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    v_j, v_t = np.asarray(v_j), v_t.numpy()
    err = np.minimum(np.abs(v_t - v_j).max(1), np.abs(v_t + v_j).max(1))
    assert err.max() < 1e-4
    np.testing.assert_array_equal(v_t[~ok_t.numpy()], np.tile([0.0, 0.0, 1.0], ((~ok_t.numpy()).sum(), 1)))
    ev_j = np.asarray(j_eigen.eigenvalues(jnp.asarray(cov)))
    ev_t = t_eigen.eigenvalues(torch.from_numpy(cov)).numpy()
    # The cubic's roots carry f32 error at the scale of the matrix (|A| ~ 1 here).
    np.testing.assert_allclose(ev_t, ev_j, rtol=1e-4, atol=1e-5)


def _dense_patch(seed, n=1500):
    """Dense enough (~70 neighbours in radius 0.1) that the f32 moment
    covariance is well conditioned in both packages."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, n)
    y = rng.uniform(-0.5, 0.5, n)
    z = 0.15 * np.sin(3.0 * x) * np.cos(2.0 * y)
    pts = np.stack([x, y, z], 1).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-50:] = False
    return pts, mask


def test_estimate_normals_radius_matches_jax():
    pts, mask = _dense_patch(51)
    zeros = np.zeros_like(pts)
    want = j_normals.estimate_normals_radius(JCloud(*(jnp.asarray(a) for a in (pts, zeros, mask))), 0.1)
    got = t_normals.estimate_normals_radius(TCloud(*_t(pts, zeros, mask)), 0.1)
    a, b = got.normals.numpy(), np.asarray(want.normals)
    live = (np.abs(a).sum(1) > 0) & (np.abs(b).sum(1) > 0)
    np.testing.assert_array_equal(np.abs(a).sum(1) > 0, np.abs(b).sum(1) > 0)
    assert live.sum() > 1000
    np.testing.assert_allclose(a[live], b[live], atol=1e-4)


def test_fpfh_radius_matches_jax():
    """Same cloud and normals into both; the 0-100 histograms agree to 1e-3."""
    pts, mask = _dense_patch(52, n=600)
    zeros = np.zeros_like(pts)
    nrm = np.asarray(j_normals.estimate_normals_radius(JCloud(*(jnp.asarray(a) for a in (pts, zeros, mask))), 0.1).normals)
    want = np.asarray(j_fpfh.fpfh_radius(JCloud(*(jnp.asarray(a) for a in (pts, nrm, mask))), 0.2, block_size=256))
    got = t_fpfh.fpfh_radius(TCloud(*_t(pts, nrm, mask)), 0.2, block_size=256).numpy()
    assert got.shape == (600, 33)
    np.testing.assert_allclose(got, want, atol=1e-3)
