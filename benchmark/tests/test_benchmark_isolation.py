"""No module a run loads is JAX's or the JAX package's; the reference and the generators load nothing of the port."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tests import toy

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def test_names_are_compared_whole():
    loaded = ["elasticreconstruction_tpu_torch", "elasticreconstruction_tpu_torch.core.se3", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(loaded) == []
    assert harness.forbidden_modules(loaded + ["elasticreconstruction_tpu.core.se3"]) == ["elasticreconstruction_tpu"]
    assert harness.forbidden_modules(["jax._src.api", "jaxlib.xla_client", "flax"]) == ["flax", "jax", "jaxlib"]


RUN = """
import json, sys, time
t0 = time.perf_counter()
from benchmark import harness, readings, trace
from benchmark.tests import toy
out = harness.run_cell(sys.argv[1], toy.SEED, 0.01, bool(int(sys.argv[2])), t_start=t0, device="cpu",
                       overrides=toy.CELLS[sys.argv[1]])
import benchmark.entries.odometry, benchmark.entries.register
for m in harness.manifest()["per_layer"]:
    harness.load_reader(m["name"])
print(json.dumps({"correct": out["correct"], "forbidden": harness.forbidden_modules(),
                  "port": any(m.split(".")[0] == "elasticreconstruction_tpu_torch" for m in sys.modules)}))
"""


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(toy.CELLS))
def test_a_run_loads_neither_jax_nor_the_jax_package(cell, trace):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", RUN, cell, str(trace)], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec == {"correct": True, "forbidden": [], "port": True}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("folder", ["reference", "traffic"])
def test_the_yardstick_imports_nothing_of_the_port_or_jax(folder):
    for path in sorted((BENCH / folder).glob("*.py")):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert tops <= {"__future__", "contextlib", "json", "math", "struct", "zlib", "pathlib", "typing", "numpy",
                        "torch", "benchmark"}, (path.name, tops)
        assert not any(n.startswith("benchmark.") and n.split(".")[1] not in ("reference", "traffic")
                       for n in _imports(path)), path.name


def test_importing_the_yardstick_loads_nothing_of_the_port():
    code = ("import sys, benchmark.reference.odometry, benchmark.reference.registration, benchmark.reference.compare, "
            "benchmark.reference.files, benchmark.traffic.livingroom, benchmark.traffic.fragments, "
            "benchmark.metrics.bound_a\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'elasticreconstruction_tpu_torch', 'elasticreconstruction_tpu', 'jax', 'jaxlib', 'flax'}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"


def test_no_benchmark_file_reads_the_old_scripts():
    old = {"bench", "bench_gpu", "milestones", "kernels_bench", "kernels_bench_gpu", "chip_smoke"}
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in old and not name.endswith(".milestones"), (path, name)
        assert "bench_gpu" not in path.read_text() or path.name == "test_benchmark_isolation.py", path


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import time, sys\nfrom benchmark import harness\n"
            "harness.run_cell('register.livingroom_full_640', 1, 0.01, False, t_start=time.perf_counter(), device='cpu')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == "" and "elasticreconstruction_tpu_torch" in res.stderr
    res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "register.livingroom_full_640", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
