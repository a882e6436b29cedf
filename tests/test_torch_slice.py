"""PyTorch port, the registration slice as a whole vs the JAX package on the CPU.

(a) JAX-prepped fragments carried into the port (``interop``) and registered
    with the JAX package's own RANSAC draws isolate matching, RANSAC, ICP and
    the information matrix from prep.
(b) The port's own prep, end to end, on the registration benchmark's scene
    (``bench_scene.make_fragments``, a numpy copy of ``bench.py``'s).

The scene is cut to 4 fragments of 2000 points and the config scaled to it
(15 cm matching voxel, small capacities, 1024 hypotheses, 10 ICP steps) so
the JAX CPU compiles stay small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core.types import PointCloud as JCloud
from elasticreconstruction_tpu.registration import pair as j_pair
from elasticreconstruction_tpu_torch import interop
from elasticreconstruction_tpu_torch.bench_scene import make_fragments, pose_error
from elasticreconstruction_tpu_torch.registration import pair as t_pair

JCFG = j_pair.RegistrationConfig(
    voxel_size=0.15, icp_voxel_size=0.075, coarse_capacity=512, fine_capacity=2048,
    num_hypotheses=1024, icp_iterations=10, inlier_threshold=0.15,
)
TCFG = t_pair.RegistrationConfig(**JCFG._asdict())
# Adjacent pairs overlap ~73%, (0, 2) ~47%, (0, 3) ~20% (rejected).
II = np.array([0, 1, 2, 0, 0], np.int32)
JJ = np.array([1, 2, 3, 2, 3], np.int32)


@pytest.fixture(scope="module")
def scene():
    clouds, poses = make_fragments(4, n=2000, seed=0)
    jclouds = JCloud(*(jnp.asarray(x) for x in clouds))
    jprep = j_pair.prep_fragments_batch(jclouds, JCFG)
    keys = jax.random.split(jax.random.PRNGKey(3), len(II))
    jres = j_pair.register_prepped_batch(jprep, jnp.asarray(II), jnp.asarray(JJ), keys, JCFG)
    draws = jax.vmap(lambda k: jax.random.randint(k, (JCFG.num_hypotheses, 3), 0, 1 << 30))(keys)
    return {"clouds": clouds, "poses": poses, "jprep": jprep, "jres": jres,
            "draws": torch.from_numpy(np.array(draws))}


def _check_against_jax(got, want):
    np.testing.assert_array_equal(got.success, np.asarray(want.success))
    np.testing.assert_array_equal(got.num_inliers, np.asarray(want.num_inliers))
    np.testing.assert_allclose(got.transform, np.asarray(want.transform), atol=1e-3)
    info = np.asarray(want.information)
    rel = np.abs(got.information - info).max(axis=(1, 2)) / np.abs(info).max(axis=(1, 2))
    assert rel.max() < 1e-3, rel


@pytest.mark.parametrize("fused_step", [False, True])
def test_register_prepped_batch_matches_jax(scene, fused_step):
    """(a): same prepped inputs, same draws -> same edges."""
    got = interop.result_to_numpy(t_pair.register_prepped_batch(
        interop.prepped_from_numpy(scene["jprep"], "cpu"), II, JJ, None, TCFG,
        draws=scene["draws"], fused_step=fused_step, device="cpu",
    ))
    _check_against_jax(got, scene["jres"])
    np.testing.assert_array_equal(got.i, II)
    np.testing.assert_array_equal(got.j, JJ)
    assert got.success.tolist() == [True, True, True, True, False]


def test_register_pair_matches_prepped_path(scene):
    """The self-contained batch-1 entry point preps inline to the same edge."""
    clouds = scene["clouds"]
    res = interop.result_to_numpy(t_pair.register_pair(
        type(clouds)(*(x[0] for x in clouds)), type(clouds)(*(x[1] for x in clouds)),
        None, TCFG, draws=scene["draws"][0], device="cpu",
    ))
    ref = interop.result_to_numpy(t_pair.register_prepped_batch(
        t_pair.prep_fragments_batch(clouds, TCFG, device="cpu"), II[:1], JJ[:1], None, TCFG,
        draws=scene["draws"][:1], device="cpu",
    ))
    assert res.success and int(res.i) == 0 and int(res.j) == 1
    np.testing.assert_allclose(res.transform, ref.transform[0], atol=1e-6)
    np.testing.assert_allclose(res.information, ref.information[0], rtol=1e-6)


def test_own_prep_end_to_end(scene):
    """(b): the port's prep and its own RANSAC draws register every pair the
    JAX package registers, adjacent ones within 2 cm / 0.02 rad."""
    prep = t_pair.prep_fragments_batch(scene["clouds"], TCFG, device="cpu")
    jprep = scene["jprep"]
    np.testing.assert_array_equal(prep.coarse.mask.numpy(), np.asarray(jprep.coarse.mask))
    np.testing.assert_array_equal(prep.fine.mask.numpy(), np.asarray(jprep.fine.mask))
    got = interop.result_to_numpy(t_pair.register_prepped_batch(
        prep, II, JJ, torch.Generator().manual_seed(0), TCFG, device="cpu"
    ))
    np.testing.assert_array_equal(got.success, np.asarray(scene["jres"].success))
    for k in np.nonzero(np.abs(II - JJ) == 1)[0]:
        gt = np.linalg.inv(scene["poses"][II[k]]) @ scene["poses"][JJ[k]]
        t_err, r_err = pose_error(got.transform[k], gt)
        assert t_err < 0.02 and r_err < 0.02, (II[k], JJ[k], t_err, r_err)


@pytest.mark.parametrize("fused_step", [False, True])
def test_refine_edges_batch_matches_jax(scene, fused_step):
    jprep = scene["jprep"]
    adj_i, adj_j = II[:3], JJ[:3]
    init = np.array(scene["jres"].transform)[:3]
    j_icp, j_info = j_pair.refine_edges_batch(jprep, jnp.asarray(adj_i), jnp.asarray(adj_j), jnp.asarray(init), JCFG)
    t_icp, t_info = t_pair.refine_edges_batch(
        interop.prepped_from_numpy(jprep, "cpu"), adj_i, adj_j, torch.from_numpy(init), TCFG,
        fused_step=fused_step,
    )
    np.testing.assert_allclose(t_icp.transform.numpy(), np.asarray(j_icp.transform), atol=1e-4)
    np.testing.assert_allclose(t_icp.fitness.numpy(), np.asarray(j_icp.fitness), atol=1e-3)
    j_info = np.asarray(j_info)
    assert np.abs(t_info.numpy() - j_info).max() / np.abs(j_info).max() < 1e-3
    e_info = t_pair.edge_information_batch(
        interop.prepped_from_numpy(jprep, "cpu"), adj_i, adj_j, t_icp.transform, TCFG
    )
    torch.testing.assert_close(e_info, t_info)
