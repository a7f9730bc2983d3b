"""The benchmark's harness: finds a cell's files by name, runs its traffic
driver, reads its per-layer metrics and builds the result line.

Everything that belongs to one configuration, cell, traffic driver or
per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives it:

- ``benchmark/configs/<config>.json``: one configuration;
- ``benchmark/workloads/<cell>.json``: one cell (its configuration, its
  traffic driver by name, the traffic's parameters, the limits of its
  correctness check);
- ``benchmark/traffic/<driver>.py``: a traffic driver, ``run(cell, seed,
  seconds, trace, device, shrink)``;
- ``benchmark/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(ctx)`` -> a number or None, with its ``LAYER`` and ``MOVES``.
  ``ctx`` is the driver's: the window's numbers, the traces, and the
  merged configuration (``ctx["config"]``) and the workload
  (``ctx["workload"]``), from whose shapes a reader can work out a
  kernel's bound;
- ``benchmark/reference/archs/<reference_net>.py``: the plain reference
  of the architecture a configuration names in ``reference_net``:
  ``build(widths, quantize)``, ``dropout_shapes(widths, patch, n)`` and
  optionally ``extra_flops(widths, patch, n)`` and ``seed_free(named,
  generator)``, as ``benchmark/reference/nets.py`` sets out.

Nothing here lists them, so a later change adds a configuration, a cell,
a metric or an architecture as new files and entries alone.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List

import torch

from benchmark import counts, trace as tr

#: modules that no run of the benchmark may have loaded: JAX, its
#: libraries and the JAX package the port was made from (compared by
#: top-level name: ``bcp_tpu_torch`` is the port and allowed)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "bcp_tpu")


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell: its ``BENCHMARK.json`` entry, its workload file, its
    configuration file, its driver, its metrics and their readers."""
    name: str
    entry: dict
    workload: dict
    config: dict
    driver: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, ModuleType] = field(default_factory=dict)

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


class Registry:
    """The benchmark under ``root`` (a directory holding ``BENCHMARK.json``
    and the ``benchmark/`` folder)."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self.dir = os.path.join(root, "benchmark")

    def _json(self, kind: str, name: str) -> dict:
        with open(os.path.join(self.dir, kind, f"{name}.json")) as f:
            return json.load(f)

    def cells(self) -> List[str]:
        return [w["name"] for w in self.spec["workloads"]]

    def cell(self, name: str) -> Cell:
        entries = [w for w in self.spec["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json; have "
                           f"{self.cells()}")
        entry = entries[0]
        workload = self._json("workloads", name)
        config = self._json("configs", entry["config"])
        driver = load_module(
            os.path.join(self.dir, "traffic", f"{workload['driver']}.py"),
            f"bench_traffic_{workload['driver']}")
        e2e = [m for m in self.spec["end_to_end"]
               if name in m.get("workloads", [name])]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in self.spec["per_layer"]
                     if (name in m["workloads"] if "workloads" in m
                         else m["moves"] in reported)]
        readers = {m["name"]: load_module(
            os.path.join(self.dir, "metrics", f"{m['name']}.py"),
            "bench_metric_" + m["name"].replace(".", "_"))
            for m in per_layer}
        return Cell(name, entry, workload, config, driver, e2e, per_layer,
                    readers)


def merged_config(cell: Cell, shrink=None) -> dict:
    """The cell's configuration with the workload's ``config_overrides``
    and, for a dry run at a small size, ``shrink`` laid over it (a nested
    group is updated key by key)."""
    cfg = dict(cell.config)
    cfg.update(cell.workload.get("config_overrides", {}))
    if shrink:
        for k, v in shrink.items():
            if isinstance(v, dict) and isinstance(cfg.get(k), dict):
                cfg[k] = {**cfg[k], **v}
            else:
                cfg[k] = v
    return cfg


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                device))}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def start_trace(device: torch.device, phase: str):
    """A started ``torch.profiler`` of the card's activity ("device") or
    of the card's and the host's ("host"), once the device has caught up;
    None off the card, where no device number is read."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if phase == "host" else [])
    prof = profile(activities=acts)
    prof.start()
    sync(device)
    return prof


def stop_trace(prof, tmp: str, phase: str) -> list:
    """The trace's complete events (the caller synchronised first)."""
    if prof is None:
        return []
    prof.stop()
    path = os.path.join(tmp, f"{phase}.json")
    prof.export_chrome_trace(path)
    events = tr.load(path)
    os.remove(path)
    return events


def card_peaks(device: torch.device):
    """(FLOP/s, bytes/s) of the card, or None off the card."""
    if device.type != "cuda":
        return None
    return counts.peaks(torch.cuda.get_device_name(device))


def add_trace_device(out: dict, traces: dict) -> None:
    """A traced run's ``busy_s`` and ``window_s`` (the device trace's busy
    seconds and the host seconds between the two synchronisations around
    it) and its breakdown: the device operations that took most time and
    the longest idle gaps by what the host was doing (the host trace)."""
    if out["device"]["platform"] != "gpu" or "device" not in traces:
        return
    spans = tr.device_spans(traces["device"]["events"])
    out["device"]["busy_s"] = tr.busy_s(spans)
    out["device"]["window_s"] = traces["device"]["window_s"]
    out["breakdown"] = {"device_ops": tr.top_ops(spans)}
    if "host" in traces:
        out["breakdown"]["idle_gaps"] = tr.idle_gaps(
            traces["host"]["events"])


def result_line(cell: Cell, out: dict, trace: bool) -> dict:
    """The last line of a run from a driver's outcome: the cell's
    end-to-end metrics (``trace`` off) or the per-layer metrics its
    readers find (``trace`` on); ``correct`` when every compared number
    is within its limit and no attempt failed. The compared numbers come
    last, each with its limit."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = out["metrics"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = out["checks"]
    correct = bool(checks) and out["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": out["device"]}
    if trace and out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    return line


def print_checks(checks: dict) -> None:
    """Each compared number beside its limit, on standard error."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
