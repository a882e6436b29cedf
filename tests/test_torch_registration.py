"""PyTorch port, registration modules vs the JAX package on the CPU.

Matching, RANSAC (fed the JAX package's own hypothesis draws), batched ICP
(both ``fused_step`` values, which on the CPU run the plain versions) and the
information matrix.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core import se3 as j_se3
from elasticreconstruction_tpu.core.types import PointCloud as JCloud
from elasticreconstruction_tpu.kernels import normals as j_normals
from elasticreconstruction_tpu.registration import features as j_features
from elasticreconstruction_tpu.registration import icp as j_icp
from elasticreconstruction_tpu.registration import infomat as j_infomat
from elasticreconstruction_tpu.registration import ransac as j_ransac
from elasticreconstruction_tpu_torch.core.types import PointCloud as TCloud
from elasticreconstruction_tpu_torch.registration import features as t_features
from elasticreconstruction_tpu_torch.registration import icp as t_icp
from elasticreconstruction_tpu_torch.registration import infomat as t_infomat
from elasticreconstruction_tpu_torch.registration import ransac as t_ransac


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("mutual", [True, False])
def test_match_features_matches_jax(mutual):
    rng = np.random.default_rng(1)
    fa = rng.uniform(size=(3, 120, 33)).astype(np.float32)
    fb = np.concatenate([fa[:, :80], rng.uniform(size=(3, 60, 33)).astype(np.float32)], 1)
    fb[:, :80] += rng.normal(0, 0.01, (3, 80, 33)).astype(np.float32)
    ma = rng.uniform(size=(3, 120)) > 0.1
    mb = rng.uniform(size=(3, 140)) > 0.1
    c_t, m_t = t_features.match_features(*_t(fa, ma, fb, mb), mutual=mutual)
    c_j, m_j = jax.vmap(lambda a, b, c, d: j_features.match_features(a, b, c, d, mutual=mutual))(fa, ma, fb, mb)
    assert c_t.dtype == torch.int32
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


def test_match_features_identical_clouds_match_diagonal():
    rng = np.random.default_rng(2)
    f = rng.uniform(size=(64, 33)).astype(np.float32)
    corr, cmask = t_features.match_features(*_t(f, np.ones(64, bool), f, np.ones(64, bool)))
    assert cmask.all()
    assert torch.equal(corr[:, 0], corr[:, 1])


def _ransac_case(seed, n=256, bad=0.4):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    T = np.asarray(j_se3.exp(jnp.array([0.3, 0.1, -0.2, 0.3, -0.2, 0.4], jnp.float32)))
    b = np.array(j_se3.apply(jnp.asarray(T), jnp.asarray(a)))
    n_bad = int(bad * n)
    b[:n_bad] = rng.uniform(-2, 2, size=(n_bad, 3))
    b += rng.normal(0, 0.003, b.shape).astype(np.float32)
    corr = np.stack([np.arange(n), np.arange(n)], 1).astype(np.int32)
    mask = rng.uniform(size=n) > 0.05
    return a, b, corr, mask, T


@pytest.mark.parametrize("num_valid", ["all", "none"])
def test_ransac_matches_jax_with_its_draws(num_valid):
    """Fed the reference's jax.random draws, the port picks the same hypothesis."""
    cases = [_ransac_case(s) for s in (2, 3)]
    a, b, corr, mask, T = (np.stack(x) for x in zip(*cases))
    if num_valid == "none":
        mask[:] = False
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    kw = dict(inlier_threshold=0.02, num_hypotheses=512)
    want = jax.vmap(lambda *x: j_ransac.ransac_alignment(*x, **kw))(a, b, corr, mask, keys)
    draws = jax.vmap(lambda k: jax.random.randint(k, (512, 3), 0, 1 << 30))(keys)
    got = t_ransac.ransac_alignment(*_t(a, b, corr, mask), draws=torch.from_numpy(np.array(draws)), **kw)
    np.testing.assert_array_equal(got.num_inliers.numpy(), np.asarray(want.num_inliers))
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(want.inlier_mask))
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-4)
    np.testing.assert_allclose(got.fitness.numpy(), np.asarray(want.fitness), atol=1e-6)
    if num_valid == "all":
        np.testing.assert_allclose(got.transform.numpy(), T, atol=0.02)
        assert (got.num_inliers.numpy() > 130).all()
    else:
        assert (got.num_inliers.numpy() == 0).all()


def test_ransac_generator_draws_are_reproducible():
    a, b, corr, mask, T = (x[None] for x in _ransac_case(4))
    kw = dict(inlier_threshold=0.02, num_hypotheses=512)
    r1 = t_ransac.ransac_alignment(*_t(a, b, corr, mask), torch.Generator().manual_seed(5), **kw)
    r2 = t_ransac.ransac_alignment(*_t(a, b, corr, mask), torch.Generator().manual_seed(5), **kw)
    assert torch.equal(r1.transform, r2.transform)
    np.testing.assert_allclose(r1.transform[0].numpy(), T[0], atol=0.02)


def test_triangle_align_matches_jax():
    rng = np.random.default_rng(6)
    sa = rng.normal(size=(50, 3, 3)).astype(np.float32)
    sb = rng.normal(size=(50, 3, 3)).astype(np.float32)
    want = np.asarray(j_ransac._triangle_align(jnp.asarray(sa), jnp.asarray(sb)))
    got = t_ransac._triangle_align(*_t(sa, sb)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _wavy(rng, n, x_range=(-1.5, 1.5)):
    x = rng.uniform(*x_range, size=n).astype(np.float32)
    y = rng.uniform(-1.5, 1.5, size=n).astype(np.float32)
    z = (0.35 * np.sin(2.3 * x) * np.cos(1.7 * y) + 0.2 * np.sin(4.1 * y)
         + 0.12 * np.cos(5.3 * x + 1.0)).astype(np.float32)
    return np.stack([x, y, z], 1)


def _icp_batch():
    """Lane 0 converges from a perturbed init, lane 1 has no overlap
    (hopeless after the probe steps), lane 2 is flagged ``dead``."""
    rng = np.random.default_rng(3)
    dst_pts = _wavy(rng, 1500)
    dst = j_normals.estimate_normals(JCloud.from_points(jnp.asarray(dst_pts)), k=12)
    T_gt = np.asarray(j_se3.exp(jnp.array([0.05, -0.03, 0.04, 0.05, 0.03, -0.04], jnp.float32)))
    src0 = np.asarray(j_se3.apply(j_se3.inverse(jnp.asarray(T_gt)), jnp.asarray(_wavy(rng, 1000))))
    src1 = np.zeros((1000, 3), np.float32) + 100.0
    src2 = np.asarray(j_se3.apply(j_se3.inverse(jnp.asarray(T_gt)), jnp.asarray(_wavy(rng, 1000))))
    src_pts = np.stack([src0, src1, src2])
    src_mask = np.ones((3, 1000), bool)
    src_mask[:, -100:] = False
    dst_b = [np.repeat(np.asarray(x)[None], 3, 0) for x in dst]
    dst_b[2][:, -200:] = False  # a padded dst tail
    return src_pts, src_mask, dst_b, np.asarray([False, False, True]), T_gt


@pytest.mark.parametrize("fused_step", [False, True])
def test_icp_batch_matches_jax(fused_step):
    src_pts, src_mask, (dpts, dnrm, dmask), dead, T_gt = _icp_batch()
    init = np.repeat(np.eye(4, dtype=np.float32)[None], 3, 0)
    kw = dict(max_correspondence_distance=0.25, iterations=12, coarse_iterations=4, coarse_stride=4)
    want = j_icp.icp_point_to_plane_batch(
        JCloud(jnp.asarray(src_pts), jnp.zeros_like(jnp.asarray(src_pts)), jnp.asarray(src_mask)),
        JCloud(jnp.asarray(dpts), jnp.asarray(dnrm), jnp.asarray(dmask)),
        jnp.asarray(init), dead=jnp.asarray(dead), **kw,
    )
    got = t_icp.icp_point_to_plane_batch(
        TCloud(*_t(src_pts, np.zeros_like(src_pts), src_mask)), TCloud(*_t(dpts, dnrm, dmask)),
        torch.from_numpy(init), dead=torch.from_numpy(dead), fused_step=fused_step, **kw,
    )
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-4)
    np.testing.assert_allclose(got.fitness.numpy(), np.asarray(want.fitness), atol=1e-3)
    np.testing.assert_array_equal(got.num_inliers.numpy(), np.asarray(want.num_inliers))
    np.testing.assert_allclose(got.transform[0].numpy(), T_gt, atol=5e-3)
    assert got.fitness[0] > 0.9 and got.fitness[1] == 0.0


def test_icp_unbatched_wrapper():
    src_pts, src_mask, (dpts, dnrm, dmask), _, T_gt = _icp_batch()
    res = t_icp.icp_point_to_plane(
        TCloud(*_t(src_pts[0], np.zeros_like(src_pts[0]), src_mask[0])), TCloud(*_t(dpts[0], dnrm[0], dmask[0])),
        torch.eye(4), max_correspondence_distance=0.25, iterations=30,
    )
    assert res.transform.shape == (4, 4)
    np.testing.assert_allclose(res.transform.numpy(), T_gt, atol=5e-3)


def test_information_matrix_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(4, 300, 3)).astype(np.float32)
    mask = rng.uniform(size=(4, 300)) > 0.3
    want = np.asarray(jax.vmap(j_infomat.information_matrix)(jnp.asarray(pts), jnp.asarray(mask)))
    got = t_infomat.information_matrix(*_t(pts, mask)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    np.testing.assert_allclose(t_infomat.information_matrix(*_t(pts[1], mask[1])).numpy(), got[1], rtol=1e-6)
    assert np.allclose(got, got.transpose(0, 2, 1), atol=1e-4)
