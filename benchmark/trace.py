"""Reading ``torch.profiler`` Chrome traces: device busy time, kernel time
by name, host launches and synchronisations, and the breakdown a traced
run's result line carries. The arithmetic of ``chip_smoke.py``'s
``device_summary`` / ``host_summary`` / ``kernels_by_name``, copied so
that the yardstick does not move with the program's scripts."""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path: str) -> List[dict]:
    with open(path) as f:
        return [e for e in json.load(f).get("traceEvents", [])
                if e.get("ph") == "X"]


def device_spans(events) -> List[Tuple[float, float, str]]:
    """(start us, end us, name) of each device operation."""
    return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") in DEVICE_CATS]


def merged(spans) -> List[Tuple[float, float]]:
    """The union of the spans as disjoint (start, end) intervals."""
    out: List[List[float]] = []
    for start, end, _ in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def busy_s(spans) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(b - a for a, b in merged(spans)) / 1e6


def by_name(spans) -> Dict[str, Tuple[float, int]]:
    """name -> (device seconds, calls)."""
    out: Dict[str, Tuple[float, int]] = {}
    for start, end, name in spans:
        s, n = out.get(name, (0.0, 0))
        out[name] = (s + (end - start) / 1e6, n + 1)
    return out


def top_ops(spans, n: int = 10) -> List[list]:
    """The ``n`` device operations that took most time, [name, seconds]."""
    ranked = sorted(by_name(spans).items(), key=lambda kv: -kv[1][0])
    return [[name[:200], s] for name, (s, _) in ranked[:n]]


def host_counts(events) -> Optional[Dict[str, int]]:
    """CUDA runtime calls of a trace of CPU and CUDA activity: kernel
    launches (a CUDA graph's replay counts as one) and synchronisations
    (stream, event and device synchronisations, which is how a host read
    of a device value waits)."""
    api = [e for e in events if e.get("cat") == "cuda_runtime"]
    if not any(e.get("cat") == "cpu_op" for e in events):
        return None
    graphs = sum("GraphLaunch" in e["name"] for e in api)
    return {"launches": graphs + sum("LaunchKernel" in e["name"]
                                     for e in api),
            "graph_launches": graphs,
            "syncs": sum("Synchronize" in e["name"] for e in api)}


def idle_gaps(events, n: int = 10) -> List[list]:
    """The ``n`` longest gaps between device operations of a trace of CPU
    and CUDA activity, each named by the outermost host op running when
    the gap opened: [name, seconds]."""
    busy = merged(device_spans(events))
    ops = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in ("cpu_op", "user_annotation",
                                      "python_function")),
                 key=lambda t: (t[0], -t[1]))
    gaps = []
    for (_, end), (start, _) in zip(busy, busy[1:]):
        if start <= end:
            continue
        host = "idle host"
        for a, b, name in ops:
            if a > end:
                break
            if b >= end:
                host = name
                break
        gaps.append([host[:200], (start - end) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    return gaps[:n]


# ----------------------------------------- what the metric readers take
def device_spans_of(ctx) -> Optional[List[Tuple[float, float, str]]]:
    """The device spans of a traced run's device trace; None off the card
    or without one."""
    info = ctx["traces"].get("device")
    if ctx["device"].type != "cuda" or info is None:
        return None
    return device_spans(info["events"])


def idle_percent(ctx) -> Optional[float]:
    """100 * (1 - busy / window) of the device-traced groups or volumes."""
    spans = device_spans_of(ctx)
    if not spans:
        return None
    return 100.0 * (1.0 - busy_s(spans) / ctx["traces"]["device"]
                    ["window_s"])


def host_counts_of(ctx) -> Optional[Dict[str, int]]:
    """:func:`host_counts` of a traced run's host trace (None off the
    card)."""
    info = ctx["traces"].get("host")
    if ctx["device"].type != "cuda" or info is None:
        return None
    return host_counts(info["events"])
