"""``benchmark/spans.py`` and the readers of the program's spans on small
synthetic Chrome traces: device operations by the innermost span open at
their launch, idle gaps by the span open when they began, counts, None off
the card and for a program without spans; and every span name a reader
reads is one the port opens."""

from __future__ import annotations

import glob
import os
import re

import pytest
import torch

from bench_helpers import ROOT
from benchmark import harness, spans
from bcp_tpu_torch.utils.spans import NAMES

MAIN, WORKER = 11, 12


def _span(name, ts, end, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": end - ts, "tid": tid}


def _launch(corr, ts, name="cudaLaunchKernel", tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 1.0, "tid": tid, "args": {"correlation": corr}}


def _op(corr, ts, end, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts,
            "dur": end - ts, "tid": 7, "args": {"correlation": corr}}


def _train_events():
    """One sub-step, times in us: feed [0, 10), teacher [10, 20), NMS
    [20, 60) of two rounds, update [60, 70); a worker thread's span; an
    optimizer annotation that is no program span; device work from a
    launch before the trace (left out) and one whose launch is missing."""
    return [
        _span("feed.batch", 0, 10), _span("step.teacher", 10, 20),
        _span("step.nms", 20, 60), _span("nms.round", 20, 40),
        _span("nms.round", 40, 60), _span("step.update", 60, 70),
        _span("Optimizer.step#SGD.step", 61, 69),
        _span("val.eval", 0, 70, tid=WORKER),
        _launch(1, 5), _launch(2, 12, "cudaGraphLaunch"), _launch(3, 25),
        _launch(6, 26, "cudaMemcpyAsync"), _launch(4, 45),
        _launch(5, 62, "cudaGraphLaunch"), _launch(8, 3, tid=WORKER),
        _op(0, -20, -5),                      # before the window
        _op(1, 6, 9), _op(2, 13, 30), _op(6, 28, 33, "gpu_memcpy"),
        _op(3, 30, 35), _op(4, 50, 52), _op(5, 65, 100),
        _op(9, 100, 101),                     # its launch is not traced
        _op(8, 101, 103, "gpu_memset"),
    ]


def test_device_time_by_innermost_span_at_launch():
    att = spans.attribute(_train_events())
    us = {k: round(v * 1e6, 6) for k, v in att.busy.items()}
    assert us == {("feed.batch",): 3.0, ("step.teacher",): 17.0,
                  ("step.nms", "nms.round"): 3.0 + 2.0 + 2.0,
                  ("step.update",): 35.0, (): 1.0, ("val.eval",): 2.0}
    # time two operations share counts once: the busy seconds are the
    # union of the operations in the window
    assert sum(att.busy.values()) == pytest.approx(
        (3 + 22 + 2 + 35 + 1 + 2) / 1e6)
    assert att.busy_s("step.nms") == pytest.approx(7e-6)
    inner = att.by_innermost()
    assert inner["nms.round"][0] == pytest.approx(7e-6)
    assert inner[None] == (pytest.approx(1e-6), 0.0)


def test_idle_gaps_by_span_open_when_they_began():
    att = spans.attribute(_train_events())
    us = {k: round(v * 1e6, 6) for k, v in att.idle.items()}
    # [0, 6) and [9, 13) in the feed, [35, 50) in round 1, [52, 65) in
    # round 2; no gap after the last operation
    assert us == {("feed.batch",): 10.0, ("step.nms", "nms.round"): 28.0}
    assert att.by_innermost()["nms.round"][1] == pytest.approx(28e-6)


def test_counts_and_host_time():
    att = spans.attribute(_train_events())
    assert att.counts == {"feed.batch": 1, "step.teacher": 1,
                          "step.nms": 1, "nms.round": 2, "step.update": 1,
                          "val.eval": 1}
    assert att.host_s["nms.round"] == pytest.approx(40e-6)


def test_trailing_gap_to_the_last_span():
    """A volume whose fetch ends after its last operation: that gap
    belongs to the fetch."""
    events = [_span("eval.upload", 0, 4), _span("eval.chunk", 4, 8),
              _span("eval.fetch", 8, 30), _launch(1, 5), _op(1, 6, 20)]
    att = spans.attribute(events)
    us = {k: round(v * 1e6, 6) for k, v in att.idle.items()}
    assert us == {("eval.upload",): 6.0, ("eval.fetch",): 10.0}


def test_open_at_nested_and_disjoint():
    s = [(0, 10, "a"), (2, 5, "b"), (5, 8, "c"), (12, 14, "d")]
    assert spans.open_at(s, [11, 0, 3, 5, 9, 13, 14]) == [
        (), ("a",), ("a", "b"), ("a", "c"), ("a",), ("d",), ()]


def _ctx(events, device="cuda", steps=1):
    return {"device": torch.device(device),
            "traces": {"host": {"events": events, "window_s": 1.0,
                                "steps": steps}}}


READERS = {name: harness.load_module(path, "test_reader_" + name.replace(
    ".", "_")) for path in sorted(glob.glob(os.path.join(
        ROOT, "benchmark", "metrics", "*.py")))
    for name in [os.path.basename(path)[:-3]]}
NEW = ("feed_host_ms_per_step.train", "teacher_ms_per_step.train",
       "update_ms_per_step.train", "nms_ms_per_step.train",
       "nms_rounds_per_step.train")


def test_train_readers_on_a_synthetic_trace(capsys):
    ctx = _ctx(_train_events(), steps=2)
    got = {n: READERS[n].read(ctx) for n in NEW if n.endswith(".train")}
    assert got == {
        "feed_host_ms_per_step.train": pytest.approx(10e-3 / 2),
        "teacher_ms_per_step.train": pytest.approx(17e-3 / 2),
        "update_ms_per_step.train": pytest.approx(35e-3 / 2),
        "nms_ms_per_step.train": pytest.approx(7e-3 / 2),
        "nms_rounds_per_step.train": 1.0}
    table = capsys.readouterr().err
    assert table.startswith("program spans (busy ms, idle ms a step")
    assert "no span 0.0005 0.0" in table


def test_evaluator_spans_on_a_synthetic_trace():
    events = [_span("eval.prepare", 0, 2), _span("eval.upload", 2, 6),
              _span("eval.chunk", 6, 9), _span("eval.chunk", 9, 12),
              _span("eval.finish", 12, 14), _span("eval.fetch", 14, 40),
              _launch(1, 3, "cudaMemcpyAsync"), _launch(2, 7),
              dict(_launch(3, 10, "cuLaunchKernel"), cat="cuda_driver"),
              _launch(4, 13), _op(1, 5, 6, "gpu_memcpy"), _op(2, 8, 11),
              _op(3, 15, 20), _op(4, 20, 40)]
    att = spans.attribute(events)
    us = {k: round(v * 1e6, 6) for k, v in att.idle.items()}
    # [0, 5) began in the prepare span, [6, 8) in the first chunk and
    # [11, 15) in the second; the last operation ends with the fetch
    assert us == {("eval.prepare",): 5.0, ("eval.chunk",): 6.0}
    # a cuLaunchKernel launch (a CUTLASS kernel's) is attributed too
    assert att.busy_s("eval.chunk") == pytest.approx(8e-6)
    assert att.busy_s("eval.upload") == pytest.approx(1e-6)
    assert () not in att.busy


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_off_the_card_and_without_spans(name):
    events = _train_events() + [_span("eval.prepare", 1, 2),
                                _span("eval.upload", 2, 3),
                                _span("eval.chunk", 3, 4)]
    assert READERS[name].read(_ctx(events, device="cpu")) is None
    # a program that opens no span (one older than the spans)
    bare = [e for e in events if e["cat"] != "user_annotation"]
    assert READERS[name].read(_ctx(bare)) is None
    assert READERS[name].read({"device": torch.device("cuda"),
                               "traces": {}}) is None


def test_every_name_a_reader_reads_is_a_port_span():
    read = set()
    for name, mod in READERS.items():
        with open(mod.__file__) as f:
            found = set(re.findall(r'"([a-z_]+\.[a-z_]+)"', f.read()))
        read |= found
        if name in NEW:
            assert found, name
    assert read and read <= set(NAMES), read - set(NAMES)
    assert all(spans.NAME.match(n) for n in NAMES)
