"""PyTorch port, the ``register`` and ``posegraph`` stages vs the JAX package on the CPU.

One fragment directory (``bench_scene.write_fragments_dir``: 5 fragments of
2000 points, the small registration config of ``tests/test_torch_slice.py``)
goes through the JAX ``run_registration`` and the port's:

- ``odometry.log``: all edges but at most one within 1e-4, every edge within
  2e-3; ``odometry.info`` within 1e-2 relative. Both refine the same inits by
  ICP to a 1e-5 step on preps that agree to f32 rounding, and a few boundary
  inliers among ~1000 may differ. Where a near-tie correspondence flips, ICP
  settles on a neighbouring fixed point: over scenes 0 to 4, 18 of the 20
  edges agree within 7e-5 and one edge each of scenes 0 and 2 by 1.1e-3 and
  1.4e-3, a tenth of the 1 to 2 cm these 7.5 cm-voxel edges sit from ground
  truth. More iterations do not move it.
- ``odometry_suspect.txt`` equal; the accepted ``(i, j)`` set of ``loop.log``
  equal and its transforms within 2e-3 (as above; scene 2 showed 1.06e-3) on
  every pair that both packages put within 10 cm of ground truth; a mirrored
  alignment, which this configuration accepts now and then, is arbitrary. The port draws its RANSAC hypotheses
  from a ``torch.Generator`` and the JAX package from ``jax.random``, and at
  this coarse 15 cm configuration a half-overlapping pair can land on a
  mirrored alignment under one set of draws and on the true one under another.
  So for this comparison the port's pair loop is fed the JAX package's own
  draws, batch by batch (as ``tests/test_torch_slice.py`` does for one batch):
  the pair set is then equal because the two compute the same thing, on any
  scene, and ICP lands both on the same optimum. The port's own generator runs
  in the CLI, odometry-only and gate tests below.

Then both ``run_posegraph`` on the JAX-written registration directory:
``kept_edges.txt`` equal, ``pose.log`` within 1e-4 (f32 dense solve under a 1e8
anchor). The CLI verbs, the stage seed and the configuration
are held in ``tests/test_torch_stages_cli.py``.
"""

import dataclasses
import filecmp
import shutil

import jax
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core import io_logfmt as j_io
from elasticreconstruction_tpu.odometry.fragments import FragmentConfig as JFragmentConfig
from elasticreconstruction_tpu.pipeline import stages as j_stages
from elasticreconstruction_tpu.pipeline.config import PipelineConfig as JPipelineConfig
from elasticreconstruction_tpu.registration.pair import RegistrationConfig as JRegistrationConfig
from elasticreconstruction_tpu_torch import interop
from elasticreconstruction_tpu_torch.bench_scene import placement_error, pose_error, write_fragments_dir
from elasticreconstruction_tpu_torch.core import io_logfmt as t_io
from elasticreconstruction_tpu_torch.pipeline import stages as t_stages
from elasticreconstruction_tpu_torch.registration import pair as t_pair

NUM, POINTS = 5, 2000
SCENE_SEED = 0
BATCH = 6
STATS_KEYS = {
    "pairs", "accepted", "odometry_edges", "suspect_odometry_edges", "seconds", "prep_seconds",
    "dispatch_seconds", "drain_seconds", "io_seconds", "pairs_per_second",
    "pair_loop_pairs_per_second", "gate_margin", "gate_admitted", "gate_suspect_path",
    "gate_content_admitted",
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jcfg(out) -> JPipelineConfig:
    return JPipelineConfig(
        out_dir=str(out),
        fragment=JFragmentConfig(cloud_capacity=2048),
        registration=JRegistrationConfig(
            voxel_size=0.15, icp_voxel_size=0.075, coarse_capacity=512, fine_capacity=2048,
            num_hypotheses=1024, icp_iterations=10, inlier_threshold=0.15,
        ),
        registration_batch=BATCH,
    )


def _register_with_jax_draws(prepped, ii, jj, source, rcfg, **kw):
    """``register_prepped_batch`` on the draws the JAX stage makes for the same
    batch (``pipeline/stages.py:352, 360``: one key per pair, split from the
    stage seed folded with the batch's start; ``ransac`` draws
    ``randint(key, (H, 3), 0, 2^30)``). ``source`` is ``(seed, start)``."""
    seed, start = source
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), start), BATCH)[: len(ii)]
    draws = jax.vmap(lambda k: jax.random.randint(k, (rcfg.num_hypotheses, 3), 0, 1 << 30))(keys)
    return t_pair.register_prepped_batch(prepped, ii, jj, None, rcfg,
                                         draws=torch.from_numpy(np.array(draws)), **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same fragment directory registered by both packages, then the JAX
    registration directory optimised by both."""
    root = tmp_path_factory.mktemp("stages")
    j_out, t_out, t_pg_out = root / "jax", root / "torch", root / "torch_on_jax_registration"
    gt, centroids = write_fragments_dir(j_out, NUM, n=POINTS, seed=SCENE_SEED)
    shutil.copytree(j_out / "fragments", t_out / "fragments")
    j_stats = j_stages.run_registration(_jcfg(j_out))
    t_cfg = interop.pipeline_config_from(_jcfg(t_out))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_stages, "_batch_generator", lambda seed, start: (seed, start))
        mp.setattr(t_stages, "register_prepped_batch", _register_with_jax_draws)
        t_stats = t_stages.run_registration(t_cfg, device="cpu")
    shutil.copytree(j_out, t_pg_out)
    j_stages.run_posegraph(_jcfg(j_out))
    t_stages.run_posegraph(dataclasses.replace(t_cfg, out_dir=str(t_pg_out)), device="cpu")
    t_stages.run_posegraph(t_cfg, device="cpu")
    return {"gt": gt, "centroids": centroids, "jax": j_out, "torch": t_out, "torch_pg": t_pg_out,
            "j_stats": j_stats, "t_stats": t_stats}


def test_fragments_dir_reads_back_in_both_packages(runs):
    t_cfg = interop.pipeline_config_from(_jcfg(runs["torch"]))
    clouds = t_stages.load_fragment_clouds(t_cfg)
    j_clouds = j_stages.load_fragment_clouds(_jcfg(runs["jax"]))
    assert len(clouds) == len(j_clouds) == NUM
    for c, jc in zip(clouds, j_clouds):
        for a, b in zip(c, jc):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert c.mask.sum() == POINTS and c.points.shape == (2048, 3)
        np.testing.assert_allclose(np.linalg.norm(c.normals[c.mask], axis=1), 1.0, atol=1e-5)
    assert t_stages.load_fragment_health(t_cfg, NUM) == j_stages.load_fragment_health(_jcfg(runs["jax"]), NUM)
    # fragments.log chains ground truth with a small drift per edge.
    bases = t_io.read_log(runs["torch"] / "fragments" / "fragments.log").matrices()
    for f in range(NUM - 1):
        te, re = pose_error(np.linalg.inv(bases[f]) @ bases[f + 1], np.linalg.inv(runs["gt"][f]) @ runs["gt"][f + 1])
        assert 1e-4 < te < 0.05 and 1e-4 < re < 0.05


def test_odometry_edges_match_jax(runs):
    j_reg, t_reg = runs["jax"] / "registration", runs["torch"] / "registration"
    j_log, t_log = j_io.read_log(j_reg / "odometry.log"), t_io.read_log(t_reg / "odometry.log")
    assert [(e.i, e.j, e.k) for e in t_log.entries] == [(e.i, e.j, e.k) for e in j_log.entries]
    assert len(t_log.entries) == NUM - 1
    diff = np.abs(t_log.matrices() - j_log.matrices()).max((1, 2))
    assert (diff < 2e-3).all() and (diff < 1e-4).sum() >= NUM - 2, diff
    j_info, t_info = j_io.read_info(j_reg / "odometry.info"), t_io.read_info(t_reg / "odometry.info")
    for a, b in zip(t_info.entries, j_info.entries):
        assert (a.i, a.j, a.k) == (b.i, b.j, b.k)
        assert np.abs(a.info - b.info).max() / np.abs(b.info).max() < 1e-2
    assert (t_reg / "odometry_suspect.txt").read_text() == (j_reg / "odometry_suspect.txt").read_text()
    # The refinement took the drift out: every edge within 2 cm / 0.02 rad of ground truth.
    for e in t_log.entries:
        te, re = pose_error(e.transform, np.linalg.inv(runs["gt"][e.i]) @ runs["gt"][e.j])
        assert te < 0.02 and re < 0.02, (e.i, e.j, te, re)


def test_loop_edges_match_jax(runs):
    j_reg, t_reg = runs["jax"] / "registration", runs["torch"] / "registration"
    j_log, t_log = j_io.read_log(j_reg / "loop.log"), t_io.read_log(t_reg / "loop.log")
    assert [(e.i, e.j, e.k) for e in t_log.entries] == [(e.i, e.j, e.k) for e in j_log.entries]
    def near_truth(e):
        return pose_error(e.transform, np.linalg.inv(runs["gt"][e.i]) @ runs["gt"][e.j])[0] < 0.1

    true_edges = [k for k, (a, b) in enumerate(zip(t_log.entries, j_log.entries)) if near_truth(a) and near_truth(b)]
    assert len(true_edges) >= 2
    np.testing.assert_allclose(t_log.matrices()[true_edges], j_log.matrices()[true_edges], atol=2e-3)
    j_info, t_info = j_io.read_info(j_reg / "loop.info"), t_io.read_info(t_reg / "loop.info")
    for k, (a, b) in enumerate(zip(t_info.entries, j_info.entries)):
        assert (a.i, a.j) == (b.i, b.j)
        if k in true_edges:
            assert np.abs(a.info - b.info).max() / np.abs(b.info).max() < 1e-2


def test_registration_stats_record(runs):
    j_stats, t_stats = runs["j_stats"], runs["t_stats"]
    # The port's stats add the second attempts of content-retrieved pairs and the pairs it sent.
    assert set(j_stats) == STATS_KEYS and set(t_stats) == STATS_KEYS | {"content_repeats", "candidates"}
    for key in ("pairs", "accepted", "odometry_edges", "suspect_odometry_edges", "gate_margin",
                "gate_admitted", "gate_suspect_path", "gate_content_admitted"):
        assert t_stats[key] == j_stats[key], key
    assert t_stats["pairs"] == 6 and t_stats["odometry_edges"] == NUM - 1
    assert t_stats["content_repeats"] == j_stats["gate_content_admitted"]
    assert len(t_stats["candidates"]) == t_stats["pairs"]


def test_posegraph_matches_jax_on_the_same_registration(runs):
    j_pg, t_pg = runs["jax"] / "posegraph", runs["torch_pg"] / "posegraph"
    assert (t_pg / "kept_edges.txt").read_text() == (j_pg / "kept_edges.txt").read_text()
    assert (t_pg / "kept_edges.txt").read_text().strip()
    j_pose, t_pose = j_io.read_log(j_pg / "pose.log"), t_io.read_log(t_pg / "pose.log")
    assert [(e.i, e.j, e.k) for e in t_pose.entries] == [(e.i, e.j, e.k) for e in j_pose.entries]
    np.testing.assert_allclose(t_pose.matrices(), j_pose.matrices(), atol=1e-4)


def test_posegraph_end_to_end_on_ground_truth(runs):
    """The port's own register -> posegraph chain lands on the scene's ground truth."""
    pose = t_io.read_log(runs["torch"] / "posegraph" / "pose.log").matrices()
    rel = np.linalg.inv(pose[0]) @ pose
    assert np.linalg.norm(rel[:, :3, 3] - runs["gt"][:, :3, 3], axis=1).max() < 0.02
    # The same, measured where each fragment's points are.
    for f in range(NUM):
        te, re = placement_error(rel[f], runs["gt"][f], runs["centroids"][f])
        assert te < 0.03 and re < 0.02, (f, te, re)


def test_odometry_only_writes_empty_loop_files(runs, tmp_path):
    shutil.copytree(runs["torch"] / "fragments", tmp_path / "fragments")
    cfg = interop.pipeline_config_from(_jcfg(tmp_path))
    stats = t_stages.run_registration(cfg, all_pairs=False, device="cpu")
    assert stats["pairs"] == 0 and stats["accepted"] == 0 and stats["pair_loop_pairs_per_second"] is None
    assert (tmp_path / "registration" / "loop.log").read_text() == ""
    assert (tmp_path / "registration" / "loop.info").read_text() == ""
    assert filecmp.cmp(tmp_path / "registration" / "odometry.log", runs["torch"] / "registration" / "odometry.log",
                       shallow=False)
    t_stages.run_posegraph(cfg, device="cpu")
    assert (tmp_path / "posegraph" / "kept_edges.txt").read_text() == ""
    assert len(t_io.read_log(tmp_path / "posegraph" / "pose.log").entries) == NUM


def test_radius_gate_filters_pairs(runs, tmp_path):
    shutil.copytree(runs["torch"] / "fragments", tmp_path / "fragments")
    cfg = dataclasses.replace(interop.pipeline_config_from(_jcfg(tmp_path)), loop_candidate_radius=1e-3)
    stats = t_stages.run_registration(cfg, device="cpu")
    assert stats["pairs"] == stats["suspect_odometry_edges"] == 0
