"""``bench_gpu.py``, the port of ``bench.py``, on the CPU.

- Its odometry timing's ``build_fragment`` at ``raycast_scale=2`` against the
  JAX package's on the same analytic wall (``bench_gpu.wavy_wall``), cut to 6
  frames of 80x60 in a 64^3 volume of 4.8 cm (the same extent as the bench's
  128^3 of 2.4 cm): every local pose within 1e-3 of the JAX one, the bound of
  ``tests/test_torch_odometry.py``. Its configurations at both scales equal
  ``bench.py``'s.
- ``bench_gpu.run`` with ``device="cpu"`` on 3 fragments of 2000 points (the
  small registration config of ``tests/test_torch_slice.py``): every adjacent
  pair registers, each phase and rate is a positive number, and the record has
  ``bench.py``'s keys plus ``device``, which is null off the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_gpu
from elasticreconstruction_tpu.core import camera as j_cam
from elasticreconstruction_tpu.odometry import FragmentConfig as JFragmentConfig
from elasticreconstruction_tpu.odometry import OdometryConfig as JOdometryConfig
from elasticreconstruction_tpu.odometry import build_fragment as j_build_fragment
from elasticreconstruction_tpu_torch.core import camera as t_cam
from elasticreconstruction_tpu_torch.odometry import build_fragment
from elasticreconstruction_tpu_torch.registration import RegistrationConfig

# bench.py:296-311's keys, and the card's name and power limit.
BENCH_KEYS = [
    "metric", "value", "unit", "vs_baseline", "platform", "batch", "num_fragments", "pairs_timed",
    "passes", "pass_rates", "readback_rtt_ms", "success_rate_adjacent", "phase_ms_per_batch",
    "odometry_frames_per_second",
]
PHASE_KEYS = {"prep_all_fragments_ms", "match_ransac_ms", "icp_ms", "infomat_ms"}
SMALL_INTR = (262.5 / 4, 262.5 / 4, 39.5, 29.5, 80, 60)
SMALL_REG = RegistrationConfig(voxel_size=0.15, icp_voxel_size=0.075, coarse_capacity=512, fine_capacity=2048,
                               num_hypotheses=1024, icp_iterations=10, inlier_threshold=0.15)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_cfg(cfg) -> JFragmentConfig:
    return JFragmentConfig(**{**cfg._asdict(), "odometry": JOdometryConfig(**cfg.odometry._asdict())})


@pytest.mark.parametrize("scale", [1, 2])
def test_odometry_config_matches_bench_py(scale):
    want = JFragmentConfig(frames_per_fragment=50, volume_shape=(128, 128, 128), voxel_size=0.024,
                           cloud_capacity=1 << 16, odometry=JOdometryConfig(raycast_steps=96, raycast_scale=scale))
    assert _jax_cfg(bench_gpu.odometry_config(50, scale)) == want
    assert bench_gpu.ODOMETRY_INTRINSICS == tuple(j_cam.Intrinsics(262.5, 262.5, 159.5, 119.5, 320, 240))


def test_build_fragment_at_raycast_scale_2_matches_jax():
    cfg = bench_gpu.odometry_config(5, 2)._replace(volume_shape=(64, 64, 64), voxel_size=0.048)
    depths = bench_gpu.wavy_wall(6, t_cam.Intrinsics(*SMALL_INTR))
    assert depths.shape == (6, 60, 80) and (depths > 1.0).all() and (depths < 2.5).all()
    want = j_build_fragment(jnp.asarray(depths), j_cam.Intrinsics(*SMALL_INTR), _jax_cfg(cfg))
    got = build_fragment(torch.from_numpy(depths), t_cam.Intrinsics(*SMALL_INTR), cfg)
    np.testing.assert_allclose(got.local_poses.numpy(), np.array(want.local_poses), atol=1e-3)
    np.testing.assert_array_equal(got.local_poses[0].numpy(), np.eye(4, dtype=np.float32))


def test_pair_lists_pad_to_whole_batches():
    ii, jj = bench_gpu.pair_lists(6, 16, 4)  # bench.py's card sizes: 15 pairs x 4 = 60 -> 64
    assert len(ii) == 64 and (ii < jj).all()
    assert list(zip(ii[:15], jj[:15])) == [(i, j) for i in range(6) for j in range(i + 1, 6)]
    ii, jj = bench_gpu.pair_lists(3, 2, 1)  # its CPU sizes: 3 pairs -> 4
    assert list(zip(ii, jj)) == [(0, 1), (0, 2), (1, 2), (0, 1)]


def test_run_on_the_cpu(capsys, monkeypatch):
    sizes = dict(num_frag=3, points=2000, batch=2, passes=1, reps=1, odometry_frames=2)
    rec = bench_gpu.run("cpu", sizes=sizes, cfg=SMALL_REG)
    assert list(rec) == BENCH_KEYS + ["device"]
    assert rec["metric"] == "registration_pairs_per_second" and rec["unit"] == "pairs/s/chip"
    assert rec["platform"] == "cpu" and rec["device"] is None
    assert rec["success_rate_adjacent"] == 1.0
    assert (rec["batch"], rec["num_fragments"], rec["pairs_timed"], rec["passes"]) == (2, 3, 4, 1)
    assert len(rec["pass_rates"]) == 1 and rec["value"] == rec["pass_rates"][0] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 0.5)
    assert set(rec["phase_ms_per_batch"]) == PHASE_KEYS and min(rec["phase_ms_per_batch"].values()) > 0
    assert set(rec["odometry_frames_per_second"]) == {"raycast_scale_1", "raycast_scale_2"}
    assert min(rec["odometry_frames_per_second"].values()) > 0 and rec["readback_rtt_ms"] > 0
    # main prints that record as its one line.
    monkeypatch.setattr(bench_gpu, "run", lambda device: dict(rec, platform=device))
    assert bench_gpu.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and '"platform": "cpu"' in lines[0]
