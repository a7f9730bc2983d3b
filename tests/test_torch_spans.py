"""The port's spans (``bcp_tpu_torch.utils.spans``) on the CPU: totals with
and without a profiler, the spans in a CPU ``torch.profiler`` trace, the
closed set of names, totals from several threads, the counts a tiny LA
self-train stage at K = 4 and the sliding-window evaluator emit, and the
trainer's log lines that ``scripts/run_full_torch.py`` reads."""

import json
import math
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bcp_tpu_torch.config import la_config
from bcp_tpu_torch.data.datasets import VolumeList
from bcp_tpu_torch.data.synthetic import la_cases
from bcp_tpu_torch.eval.sliding_window import (SlidingWindowEvaluator,
                                               window_starts)
from bcp_tpu_torch.models import VNet3D
from bcp_tpu_torch.train.steps import clean_masks
from bcp_tpu_torch.train.trainer import BCPTrainer
from bcp_tpu_torch.utils import spans
from bcp_tpu_torch.utils.spans import span

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import run_full_torch  # noqa: E402

K = 4


def _annotations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def _masks():
    """Two 12^3 masks of three blobs each: the NMS keeps the largest."""
    m = torch.zeros((2, 12, 12, 12), dtype=torch.int32)
    m[:, 1:4, 1:4, 1:4] = 1
    m[:, 6:11, 6:11, 6:11] = 1
    m[0, 1:3, 8:10, 1:3] = 1
    return m


def test_span_without_profiler_adds_to_totals_only(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    spans.reset()
    with span("step.nms") as s:
        pass
    with span("step.nms") as t:
        pass
    assert entered == []
    assert spans.totals() == {"step.nms": (2, s.seconds + t.seconds)}
    assert s.seconds >= 0.0
    spans.reset()
    assert spans.totals() == {}


def test_spans_land_in_a_cpu_profiler_trace(tmp_path):
    cfg = la_config(labelnum=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kept = clean_masks(_masks(), cfg)
    assert kept.sum() == 2 * 125
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    ann = _annotations(path)
    nms = [e for e in ann if e["name"] == "step.nms"]
    rounds = [e for e in ann if e["name"] == "nms.round"]
    assert len(nms) == 1 and len(rounds) >= 2
    (outer,) = nms
    for r in rounds:
        assert r["tid"] == outer["tid"]
        assert outer["ts"] <= r["ts"]
        assert r["ts"] + r["dur"] <= outer["ts"] + outer["dur"]


def test_unknown_name_raises():
    with pytest.raises(ValueError, match="unknown span 'step.nmss'"):
        span("step.nmss")


def test_totals_from_several_threads():
    """Eight threads, more than the cores a test worker has, add spans
    with a short switch interval: no count or second is lost."""
    spans.reset()
    n, per = 8, 2000
    seconds = [0.0] * n

    def work(i):
        for _ in range(per):
            with span("val.eval") as s:
                pass
            seconds[i] += s.seconds

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    count, total = spans.totals()["val.eval"]
    assert count == n * per
    assert math.isclose(total, sum(seconds), rel_tol=1e-9, abs_tol=1e-12)


@pytest.fixture(scope="module")
def k4_run(tmp_path_factory):
    """A tiny LA run, pre-train and self-train at K = 4 from the device
    store, two groups a stage, validating every group in the background:
    (the trainer, the self stage's span counts, its log)."""
    root = tmp_path_factory.mktemp("spans")
    cfg = la_config(labelnum=4).replace(
        patch_size=(16, 16, 16), n_filters=4, eval_every=K,
        compute_dtype="float32", pre_iterations=2 * K,
        self_iterations=2 * K, steps_per_dispatch=K, device_data_cache=True,
        snapshot_root=str(root))
    trainer = BCPTrainer(cfg, device="cpu",
                         train_dataset=VolumeList(la_cases(8, (20, 20, 18),
                                                           seed=11)),
                         val_cases=la_cases(1, (24, 22, 20), seed=12))
    trainer.pretrain()
    before = spans.totals()
    trainer.selftrain()
    after = spans.totals()
    counts = {k: n - before.get(k, (0, 0.0))[0]
              for k, (n, _) in after.items()}
    with open(os.path.join(trainer.self_dir, "log.txt")) as f:
        log = f.read()
    return trainer, counts, log


def test_self_stage_span_counts_at_k4(k4_run):
    _, counts, _ = k4_run
    groups = 2
    assert counts["feed.batch"] == groups
    for name in ("step.draws", "step.teacher", "step.nms", "step.update"):
        assert counts[name] == groups * K, name
    assert counts["nms.round"] >= groups * K
    assert counts["train.readback"] == groups
    # the store came from the pre-train stage's feeder
    assert counts["feed.store_upload"] == 1
    # two validations, one checkpoint job each, and the background
    # evaluator's warm-up
    assert counts["val.eval"] == 2 and counts["val.checkpoint"] == 2
    assert counts["train.val_pause"] == 3
    # one volume a validation, one chunk of windows each
    assert counts["eval.upload"] == counts["eval.finish"] == 3
    assert "graph.capture" not in counts      # no graph on the CPU


def test_log_lines_read_by_run_full_torch(k4_run):
    trainer, counts, log = k4_run
    stage = run_full_torch.STAGE_RE.search(log)
    assert stage and stage["stage"] == "self" and int(stage["steps"]) == 8
    assert 0.0 <= float(stage["val"]) <= float(stage["wall"])
    assert re.search(r"\d+ iterations per epoch \(device-store init "
                     r"[\d.]+s\)", log)
    vals = re.findall(r"validation@(\d+): dice \S+ \(eval [\d.]+s, ckpt "
                      r"[\d.]+s\)", log)
    assert vals == ["4", "8"]
    line = re.search(r"spans: (.*)", log)[1]
    assert f"step.update {2 * K} x " in line
    assert f"feed.batch 2 x " in line
    # the spans line is not an iteration line to the script's parser
    assert not run_full_torch.ITER_RE.match(
        next(x for x in log.splitlines() if "spans: " in x))


def test_evaluator_spans_per_volume():
    torch.manual_seed(0)
    model = VNet3D(n_channels=1, n_classes=2, n_filters=2).eval()
    patch, stride = (16, 16, 16), 8
    ev = SlidingWindowEvaluator(model, patch, 2, stride, stride, batch=4,
                                device="cpu")
    shapes = [(24, 20, 18), (16, 30, 16)]
    images = [np.random.default_rng(i).normal(size=s).astype(np.float32)
              for i, s in enumerate(shapes)]
    spans.reset()
    labels = list(ev.infer_cases(images))
    assert [lab.shape for lab in labels] == shapes
    chunks = sum(-(-len(window_starts(s, patch, stride, stride)) // 4)
                 for s in shapes)
    got = {k: n for k, (n, _) in spans.totals().items()}
    # two prepare spans a volume: before the upload and after it
    assert got == {"eval.prepare": 4, "eval.upload": 2, "eval.chunk": chunks,
                   "eval.finish": 2, "eval.fetch": 2}
    assert chunks > 2
