"""PyTorch port: it stands apart from JAX and never runs on the CPU unasked.

- Importing the port pulls in neither ``jax`` nor any module of the JAX package.
- No source file of the port, nor ``chip_smoke.py``, imports either.
- Entry points default to the card and raise where there is none.
- Kernel wrappers refuse devices they have no route for.
- ``chip_smoke.py`` exits non-zero, printing no result, without a card and
  outside a checkout of the repository.
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
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|elasticreconstruction_tpu)(\s|\.|,|$)", re.M)


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
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'\n"
        "       or m == 'elasticreconstruction_tpu' or m.startswith('elasticreconstruction_tpu.')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32\n"
        "print('clean')\n"
    )
    proc = _run(code, REPO)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def test_sources_import_no_jax():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    offenders = [str(f.relative_to(REPO)) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not offenders, offenders
    # The pattern does catch the forbidden forms.
    for line in ("import jax", "from jax import numpy", "import elasticreconstruction_tpu.core",
                 "from elasticreconstruction_tpu.kernels import knn", "from elasticreconstruction_tpu import x"):
        assert _FORBIDDEN.search(line), line
    assert not _FORBIDDEN.search("from elasticreconstruction_tpu_torch import se3")


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


def test_kernel_wrappers_refuse_unsupported_devices():
    from elasticreconstruction_tpu_torch.kernels.cuda import icp_step, nn

    q = torch.zeros((1, 4, 3), device="meta")
    m = torch.ones((1, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        nn.nearest_batch(q, q, m)
    with pytest.raises(ValueError, match="unsupported device"):
        icp_step.normal_eqs_batch(q, m.float(), q, q, m, max_dist=0.1)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run([str(REPO / "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert [p.name for p in tmp_path.iterdir()] == ["chip_smoke.py"]
