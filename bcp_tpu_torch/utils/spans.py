"""The port's one timing mechanism: named spans around the places where the
time goes.

``with span("step.nms") as s: ...`` reads ``time.perf_counter()`` at entry
and exit, adds (1, the seconds) to the name's total in :func:`totals` (a
table shared by every thread of the process, under a lock: the trainer's
validation and checkpoint workers add to it too), and leaves its seconds
in ``s.seconds`` for the operator's log lines. Only while a
``torch.profiler`` records on the calling thread does a span also enter
``torch.profiler.record_function(name)``, so that it lands in the
profiler's trace on the same clock as the CUDA activity it launched (the
trainer's ``profile_dir`` traces and the benchmark's traced runs). The
profiler's check costs a fraction of a microsecond; ``record_function``
about ten, so it is never entered with tracing off.

A span is never opened inside a body that a CUDA graph captures: a replay
runs no Python, so it would time the capture once and no replay. A step
has no span of its own: its sub-steps' spans end with ``step.update``, and
a volume's with ``eval.finish``, so order alone tells steps and volumes
apart in a trace.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple

import torch

#: every span name of the port, and what it covers
NAMES = {
    # the train loop
    "feed.batch": "one batch of the feed (a K-stacked one at K > 1): the "
                  "device store's draws and crop launches, or the host "
                  "path's queue wait and copy",
    "feed.store_upload": "the device store's upload of the training split",
    "step.draws": "a sub-step's copy-paste mask, keep masks and sub-batch "
                  "copy",
    "step.teacher": "the teacher's forward and threshold (graph T's replay "
                    "at K > 1 on the card)",
    "step.nms": "the largest-component NMS of the pseudo-labels",
    "nms.round": "one fixpoint round of the NMS, its flag read included",
    "step.update": "the student's update (graph S's or the pre-train "
                   "graph's replay at K > 1 on the card)",
    "train.readback": "a step's or a group's losses read back to the host",
    "graph.capture": "one CUDA graph capture",
    "kernels.build": "one nvcc build of a kernel library",
    # the sliding-window evaluator
    "eval.prepare": "a volume's pad and window grid (before the upload), "
                    "or its count map and score allocation (after it)",
    "eval.upload": "a volume's copy to the device",
    "eval.chunk": "one chunk of windows: gather, forward, overlap-add",
    "eval.finish": "a volume's all-reduce, normalisation, label and copies "
                   "to the host",
    "eval.fetch": "the wait for a volume's copies and the crop",
    # the trainer's workers
    "val.eval": "one validation",
    "val.checkpoint": "one checkpoint write",
    "train.val_pause": "the training loop's exposed wait at an eval "
                       "boundary or at the end of a stage",
}

_lock = threading.Lock()
_totals: Dict[str, Tuple[int, float]] = {}
_profiling = torch._C._autograd._profiler_enabled


class span:
    """A named span (one of :data:`NAMES`); ``seconds`` after exit."""

    __slots__ = ("name", "seconds", "_t0", "_record")

    def __init__(self, name: str):
        if name not in NAMES:
            raise ValueError(f"unknown span {name!r}: add it to "
                             f"bcp_tpu_torch.utils.spans.NAMES")
        self.name = name
        self.seconds = 0.0
        self._record = None

    def __enter__(self) -> "span":
        if _profiling():
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        if self._record is not None:
            self._record.__exit__(*exc)
            self._record = None
        with _lock:
            n, s = _totals.get(self.name, (0, 0.0))
            _totals[self.name] = (n + 1, s + self.seconds)


def totals() -> Dict[str, Tuple[int, float]]:
    """name -> (spans ended, their seconds), since the process started or
    the last :func:`reset`."""
    with _lock:
        return dict(_totals)


def reset() -> None:
    with _lock:
        _totals.clear()
