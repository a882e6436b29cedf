"""PyTorch port: it stands apart from JAX and never runs on the CPU unasked.

- Importing the port pulls in neither ``jax`` nor any module of the JAX package.
- No source file of the port, nor ``chip_smoke.py``, ``kernels_bench_gpu.py``
  or ``bench_gpu.py``, imports either (or ``kernels_bench`` or ``bench``).
- Entry points default to the card and raise where there is none.
- Kernel wrappers refuse devices they have no route for.
- ``chip_smoke.py`` exits non-zero, printing no result, without a card and
  outside a checkout of the repository; ``bench_gpu.py`` exits non-zero,
  printing no result, without a card.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "elasticreconstruction_tpu_torch"
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|elasticreconstruction_tpu|kernels_bench|bench)(\s|\.|,|$)", re.M)


def _run(code_or_args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import elasticreconstruction_tpu_torch, elasticreconstruction_tpu_torch.interop\n"
        "import elasticreconstruction_tpu_torch.registration, elasticreconstruction_tpu_torch.bench_scene\n"
        "import elasticreconstruction_tpu_torch.registration.retrieval, elasticreconstruction_tpu_torch.posegraph\n"
        "import elasticreconstruction_tpu_torch.pipeline.run, elasticreconstruction_tpu_torch.odometry\n"
        "import elasticreconstruction_tpu_torch.elastic, elasticreconstruction_tpu_torch.kernels.cuda.calib\n"
        "import elasticreconstruction_tpu_torch.core.camera, elasticreconstruction_tpu_torch.core.stream\n"
        "import elasticreconstruction_tpu_torch.kernels.tsdf, elasticreconstruction_tpu_torch.kernels.raycast\n"
        "import elasticreconstruction_tpu_torch.odometry.kinfu, elasticreconstruction_tpu_torch.odometry.fragments\n"
        "import elasticreconstruction_tpu_torch.synthetic.sdf, elasticreconstruction_tpu_torch.synthetic.scenes\n"
        "import elasticreconstruction_tpu_torch.synthetic.render, elasticreconstruction_tpu_torch.native.depth_png\n"
        "import elasticreconstruction_tpu_torch.pipeline.dataset, elasticreconstruction_tpu_torch.pipeline.stages\n"
        "import elasticreconstruction_tpu_torch.integrate, elasticreconstruction_tpu_torch.integrate.blocks\n"
        "import elasticreconstruction_tpu_torch.integrate.mesh, elasticreconstruction_tpu_torch.integrate.scene\n"
        "import elasticreconstruction_tpu_torch.eval, elasticreconstruction_tpu_torch.eval.ate\n"
        "import elasticreconstruction_tpu_torch.eval.gt_benchmark, elasticreconstruction_tpu_torch.eval.registration_pr\n"
        "import elasticreconstruction_tpu_torch.elastic.correspondence, elasticreconstruction_tpu_torch.elastic.lattice\n"
        "import elasticreconstruction_tpu_torch.elastic.arap, elasticreconstruction_tpu_torch.elastic.slac\n"
        "import elasticreconstruction_tpu_torch.synthetic.distortion, elasticreconstruction_tpu_torch.synthetic.warps\n"
        "import elasticreconstruction_tpu_torch.eval.lattice_recovery, elasticreconstruction_tpu_torch.eval.surface_error\n"
        "import elasticreconstruction_tpu_torch.core.segment, elasticreconstruction_tpu_torch.tools.repeat_check\n"
        "import elasticreconstruction_tpu_torch.dist, elasticreconstruction_tpu_torch.dist.comm\n"
        "import elasticreconstruction_tpu_torch.dist.ring, elasticreconstruction_tpu_torch.dist.dryrun\n"
        "import elasticreconstruction_tpu_torch.dist.pgo_dist, elasticreconstruction_tpu_torch.dist.slac_dist\n"
        "import elasticreconstruction_tpu_torch.dist.volume_sharding, elasticreconstruction_tpu_torch.dist.pair_sharding\n"
        "import elasticreconstruction_tpu_torch.tools.milestones, elasticreconstruction_tpu_torch.tools.ring_scale\n"
        "import elasticreconstruction_tpu_torch.tools.reg_profile, elasticreconstruction_tpu_torch.tools.sweep_fragopt\n"
        "import elasticreconstruction_tpu_torch.tools.slac_oracle\n"
        "import kernels_bench_gpu, chip_smoke, bench_gpu\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'\n"
        "       or m == 'elasticreconstruction_tpu' or m.startswith('elasticreconstruction_tpu.')\n"
        "       or m in ('kernels_bench', 'bench')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32\n"
        "print('clean')\n"
    )
    proc = _run(code, REPO)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def test_sources_import_no_jax():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / name for name in ("chip_smoke.py", "kernels_bench_gpu.py",
                                                                       "bench_gpu.py")]
    assert len(files) > 30
    offenders = [str(f.relative_to(REPO)) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not offenders, offenders
    # The pattern does catch the forbidden forms.
    for line in ("import jax", "from jax import numpy", "import elasticreconstruction_tpu.core",
                 "from elasticreconstruction_tpu.kernels import knn", "from elasticreconstruction_tpu import x",
                 "import kernels_bench", "from kernels_bench import _sol", "import bench",
                 "from bench import make_fragments"):
        assert _FORBIDDEN.search(line), line
    assert not _FORBIDDEN.search("from elasticreconstruction_tpu_torch import se3")
    assert not _FORBIDDEN.search("import kernels_bench_gpu")
    assert not _FORBIDDEN.search("import bench_gpu") and not _FORBIDDEN.search("from bench_scene import x")


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    from elasticreconstruction_tpu_torch import interop
    from elasticreconstruction_tpu_torch.bench_scene import make_fragments
    from elasticreconstruction_tpu_torch.core.types import PointCloud
    from elasticreconstruction_tpu_torch.registration import (
        RegistrationConfig, prep_fragments_batch, register_pair,
    )

    clouds, _ = make_fragments(2, n=200)
    one = PointCloud(*(x[0] for x in clouds))
    for call in (
        lambda: register_pair(one, one, None, RegistrationConfig()),
        lambda: prep_fragments_batch(clouds),
        lambda: interop.pointcloud_from_numpy(one),
        lambda: PointCloud.from_points(clouds.points[0]),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_stage_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    import numpy as np

    import kernels_bench_gpu
    from elasticreconstruction_tpu_torch import interop
    from elasticreconstruction_tpu_torch.bench_scene import write_fragments_dir
    from elasticreconstruction_tpu_torch.pipeline import PipelineConfig, run, stages
    from elasticreconstruction_tpu_torch.posegraph import EdgeList

    from elasticreconstruction_tpu_torch.core.types import PointCloud
    from elasticreconstruction_tpu_torch.elastic.lattice import Lattice
    from elasticreconstruction_tpu_torch.eval.lattice_recovery import lattice_recovery
    from elasticreconstruction_tpu_torch.eval.surface_error import surface_error
    from elasticreconstruction_tpu_torch.integrate import scene
    from elasticreconstruction_tpu_torch.kernels import tsdf
    from elasticreconstruction_tpu_torch.pipeline import dataset
    from elasticreconstruction_tpu_torch.synthetic import scenes
    from elasticreconstruction_tpu_torch.synthetic.distortion import make_distortion

    write_fragments_dir(tmp_path, 2, n=200)
    cfg = PipelineConfig(out_dir=str(tmp_path))
    rigid = PipelineConfig(out_dir=str(tmp_path), slac_mode="none")
    none = ["--slac-mode", "none"]
    (tmp_path / "data" / "depth").mkdir(parents=True)
    dataset.write_intrinsics(tmp_path / "data" / "intrinsics.json", run.synth_intrinsics("8x6"))
    for k in range(2):
        dataset.write_depth_png(tmp_path / "data" / "depth" / f"{k:06d}.png", np.ones((6, 8), np.float32))
    edge = (np.zeros(1, int), np.ones(1, int), np.eye(4)[None], np.eye(6)[None], np.ones(1, bool))
    for call in (
        lambda: stages.run_registration(cfg),
        lambda: stages.run_posegraph(cfg),
        lambda: run.main(["register", "--out", str(tmp_path)]),
        lambda: run.main(["posegraph", "--out", str(tmp_path)]),
        lambda: stages.run_fragments(dataset.Dataset(tmp_path / "data"), cfg),
        lambda: run.main(["fragments", "--data", str(tmp_path / "data"), "--out", str(tmp_path)]),
        lambda: run.main(["synth", "--data", str(tmp_path / "synth")]),
        lambda: stages.run_optimize(rigid),
        lambda: stages.run_integrate(dataset.Dataset(tmp_path / "data"), cfg),
        lambda: stages.run_make_gt_benchmark(dataset.Dataset(tmp_path / "data"), cfg),
        lambda: stages.run_evaluate(dataset.Dataset(tmp_path / "data"), cfg),
        lambda: stages.run_all(dataset.Dataset(tmp_path / "data"), rigid),
        *(lambda verb=verb: run.main([verb, "--data", str(tmp_path / "data"), "--out", str(tmp_path), *none])
          for verb in ("optimize", "integrate", "evaluate", "all")),
        lambda: scene.make_scene_volume(scene.SceneConfig(volume_shape=(4, 4, 4))),
        lambda: dataset.generate_synthetic(tmp_path / "synth", num_frames=2),
        lambda: tsdf.make_volume((4, 4, 4), 0.1, (0, 0, 0)),
        lambda: interop.volume_from_numpy(np.zeros((2, 2, 2)), np.zeros((2, 2, 2)), (0, 0, 0), 0.1, 0.4),
        lambda: kernels_bench_gpu.bench_kernels({}, {"fuse"}),
        lambda: EdgeList.build(*edge),
        lambda: interop.edges_from_numpy(EdgeList.build(*edge, device="cpu")),
        lambda: kernels_bench_gpu.calibrate(),
        lambda: kernels_bench_gpu.bench_kernels({}, {"nn"}),
        lambda: kernels_bench_gpu.main(["--section", "calibrate"]),
        lambda: surface_error(scenes.livingroom_scene(), np.full((4, 3), 0.5, np.float32)),
        lambda: lattice_recovery(Lattice(2, 1.0, (0.0, 0.0, 0.0)), np.zeros((27, 3), np.float32),
                                 [PointCloud(np.full((4, 3), 0.5, np.float32), np.zeros((4, 3), np.float32),
                                             np.ones(4, bool))], make_distortion(0), run.synth_intrinsics("8x6")),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    with pytest.raises(RuntimeError, match="CUDA card"):
        kernels_bench_gpu.calibrate("cpu")
    assert not (tmp_path / "registration" / "odometry.log").exists()
    assert not (tmp_path / "fragments" / "local_0.log").exists() and not (tmp_path / "synth").exists()
    assert not any((tmp_path / d).exists() for d in ("slac", "integrate", "corres"))


def test_dist_entry_points_default_to_the_card(tmp_path):
    """The distributed entry points that take a device default to the card
    and raise where there is none, before touching a process group; NCCL
    is refused rather than turned into gloo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    import numpy as np
    import torch.distributed as dist

    from elasticreconstruction_tpu_torch.bench_scene import make_fragments
    from elasticreconstruction_tpu_torch.dist import mesh, pair_sharding, ring
    from elasticreconstruction_tpu_torch.registration import RegistrationConfig, prep_fragments_batch

    clouds, _ = make_fragments(2, n=200)
    prepped = prep_fragments_batch(clouds, RegistrationConfig(coarse_capacity=64, fine_capacity=64), device="cpu")
    for call in (
        lambda: pair_sharding.register_pairs_sharded(clouds, clouds, None, RegistrationConfig()),
        lambda: pair_sharding.register_prepped_sharded(prepped, np.zeros(2), np.ones(2)),
        lambda: ring.register_all_pairs_ring(prepped, 0),
        lambda: mesh.init_group("nccl", 1, 0, "file://" + str(tmp_path / "store")),
    ):
        with pytest.raises(RuntimeError, match="cuda|nccl"):
            call()
    assert not dist.is_initialized()


def test_tool_entry_points_default_to_the_card(tmp_path):
    """The ladder, ring_scale and the three tools default to ``--device cuda``
    and raise where there is no card, before writing anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    from elasticreconstruction_tpu_torch.bench_scene import write_fragments_dir
    from elasticreconstruction_tpu_torch.tools import milestones, reg_profile, ring_scale, slac_oracle, sweep_fragopt

    write_fragments_dir(tmp_path, 3, n=200)
    out, results = tmp_path / "ladder", tmp_path / "milestones_gpu.json"
    for call in (
        lambda: milestones.main(["--out", str(out), "--results", str(results)]),
        lambda: ring_scale.main([str(tmp_path / "fragments"), "--out", str(tmp_path / "ring.json")]),
        lambda: ring_scale.main([str(tmp_path / "fragments"), "--backend", "gloo", "--out", str(tmp_path / "r.json")]),
        lambda: reg_profile.main([str(tmp_path)]),
        lambda: sweep_fragopt.main(["nonrigid", "--root", str(tmp_path)]),
        lambda: slac_oracle.main([str(tmp_path), str(tmp_path)]),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not out.exists() and not results.exists()
    assert not (tmp_path / "ring.json").exists() and not (tmp_path / "registration").exists()
    assert not (tmp_path / "slac").exists()
    for parser in (milestones.build_parser(), ring_scale.build_parser(), reg_profile.build_parser()):
        assert parser.get_default("device") == "cuda"


def test_kernel_wrappers_refuse_unsupported_devices():
    from elasticreconstruction_tpu_torch.core import camera as cam
    from elasticreconstruction_tpu_torch.kernels import tsdf
    from elasticreconstruction_tpu_torch.kernels.cuda import icp_step, nn

    q = torch.zeros((1, 4, 3), device="meta")
    m = torch.ones((1, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        nn.nearest_batch(q, q, m)
    with pytest.raises(ValueError, match="unsupported device"):
        icp_step.normal_eqs_batch(q, m.float(), q, q, m, max_dist=0.1)
    vol = tsdf.make_volume((2, 3, 4), 0.1, (0.0, 0.0, 0.0), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsdf.fuse(vol, torch.zeros((3, 4), device="meta"), torch.eye(4, device="meta"),
                  cam.Intrinsics(fx=4.0, fy=4.0, cx=1.5, cy=1.0, width=4, height=3))


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run([str(REPO / "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_bench_gpu_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run([str(REPO / "bench_gpu.py")], REPO)
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines() if ln.lstrip().startswith("{")], proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert [p.name for p in tmp_path.iterdir()] == ["chip_smoke.py"]
