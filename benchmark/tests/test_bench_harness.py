"""The harness finds every cell's files by name, each driver runs a cell
end to end at a tiny size on the CPU and gives a well-formed last line,
``run.py`` refuses a machine without a card, and a cell, configuration
and metric added as new files alone run."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_helpers import ROOT, dry_run
from benchmark import harness

REGISTRY = harness.Registry(ROOT)
CELLS = REGISTRY.cells()


def test_benchmark_json_keys_and_files():
    spec = REGISTRY.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names
    for m in spec["per_layer"]:
        assert m["moves"] in names


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = REGISTRY.cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.workload["config"] == cell.entry["config"]
    assert cell.workload["traffic"] == cell.entry["traffic"]
    assert hasattr(cell.driver, "run")
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        reader = cell.readers[m["name"]]
        assert reader.LAYER == m["layer"]
        assert reader.MOVES == m["moves"] and m["moves"] in reported


def _well_formed(line, trace):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    if not trace:
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"} and m["value"] >= 0
    json.dumps(line)


@pytest.mark.parametrize("name", ["vnet_la.self_k4", "vnet_la.infer"])
@pytest.mark.parametrize("trace", [False, True])
def test_driver_dry_run(name, trace, vnet_root):
    root = vnet_root if name == "vnet_la.self_k4" else ROOT
    cell, line = dry_run(name, trace, root=root)
    _well_formed(line, trace)
    assert line["correct"], line["checks"]
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    else:
        # no device number from a CPU run
        assert line["metrics"] == {}


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_cell_added_as_files_alone(tmp_path):
    """A configuration, a cell and a per-layer metric that exist only as
    new files (and entries) in a copy of the benchmark run."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    cfg = json.loads((root / "benchmark/configs/vnet_la.json").read_text())
    cfg["name"] = "vnet_la_wide"
    (root / "benchmark/configs/vnet_la_wide.json").write_text(
        json.dumps(cfg))
    work = json.loads(
        (root / "benchmark/workloads/vnet_la.infer.json").read_text())
    work["config"] = "vnet_la_wide"
    work["traffic"] = "infer_more"
    work["warm_volumes"] = 1
    (root / "benchmark/workloads/vnet_la_wide.infer_more.json").write_text(
        json.dumps(work))
    (root / "benchmark/metrics/volumes_done.infer.py").write_text(
        'LAYER = "evaluator (eval/sliding_window.py)"\n'
        'MOVES = "infer_s_per_volume"\n\n\n'
        'def read(ctx):\n    return float(ctx["volumes"])\n')
    spec["configs"].append(dict(spec["configs"][0], name="vnet_la_wide",
                                file="benchmark/configs/vnet_la_wide.json"))
    spec["workloads"].append({"name": "vnet_la_wide.infer_more",
                              "config": "vnet_la_wide",
                              "traffic": "infer_more", "chips": 1,
                              "why": "a test cell"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "vnet_la.infer" in m["workloads"]:
            m["workloads"].append("vnet_la_wide.infer_more")
    spec["per_layer"].append({
        "name": "volumes_done.infer", "unit": "volumes", "better": "higher",
        "source": "host_clock", "layer": "evaluator (eval/sliding_window.py)",
        "moves": "infer_s_per_volume",
        "workloads": ["vnet_la_wide.infer_more"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell, line = dry_run("vnet_la_wide.infer_more", trace=True,
                         root=str(root))
    assert cell.config["name"] == "vnet_la_wide"
    assert line["metrics"]["volumes_done.infer"]["value"] >= 1
    assert line["correct"]
