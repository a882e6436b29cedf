"""BENCHMARK.json keeps to the contract's shapes: keys, names, units, files found by name, bounds and budget."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|expansion|experts_per")


def _read(cfg: dict, key: str):
    """The value of a key of a configuration file, nested keys joined by dots."""
    for part in key.split("."):
        if not isinstance(cfg, dict) or part not in cfg:
            return None
        cfg = cfg[part]
    return cfg


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert all(LINE.match(w) for w in MAN["command"]) and len(MAN["command"]) <= 32
    assert MAN["paths"] == ["benchmark"]


def test_every_name_and_unit_uses_the_allowed_characters():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in MAN[k]]
    names += [w[k] for w in MAN["workloads"] for k in ("config", "traffic")]
    names += [r for c in MAN["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in MAN[k]}) == len(MAN[k])
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert all(LINE.match(x["why"]) for k in ("configs", "workloads") for x in MAN[k])
    assert all(LINE.match(m["layer"]) for m in MAN["per_layer"])
    assert all(LINE.match(c["source"]) for c in MAN["configs"])


def test_entries_have_just_the_contract_keys():
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in MAN["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in MAN["workloads"])
    assert all(set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"} for m in MAN["end_to_end"])
    assert all(set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
               for m in MAN["per_layer"])


def test_configs_files_and_reduced_keys():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        path = ROOT / c["file"]
        assert path.is_relative_to(ROOT / "benchmark") and path.exists()
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert all(_read(cfg, r) is not None for r in c["reduced"]) and not any(WIDTH.search(r) for r in c["reduced"])
    assert len({c["file"] for c in MAN["configs"]}) == len(MAN["configs"])


def test_workloads_are_found_by_name():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) == len(MAN["workloads"])
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4)
        cell = harness.load_cell(w["name"])
        assert cell["config_name"] == w["config"] and set(harness.end_to_end_names(MAN, w["name"])) <= set(e2e)
        entry = harness.load_entry(cell["entry"])
        assert all(hasattr(entry, f) for f in ("setup", "call", "trace", "release", "judge", "control"))
        assert cell["limits"] and all(v > 0 for v in cell["limits"].values())


def test_metrics_bounds_and_readers():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", [])) <= cells
        assert all(c in e2e[m["moves"]].get("workloads", [c]) for c in m.get("workloads", []))
        assert callable(harness.load_reader(m["name"]).read)
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"].split(".")[0])
    assert set(layers) == {"odometry", "registration", "kernels", "device"}


def test_the_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("path", sorted(p for p in (ROOT / "benchmark").rglob("*") if p.is_file()
                                        and "__pycache__" not in p.parts))
def test_files_are_named_from_name_characters(path):
    rel = path.relative_to(ROOT).as_posix()
    assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
