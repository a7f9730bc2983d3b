"""The host cost of one of the port's spans (``bcp_tpu_torch.utils.spans``)
a call: an empty ``with span(...)`` timed over many calls with no profiler,
then under a ``torch.profiler`` recording CPU activity (and CUDA activity
on the card), beside the empty loop's own cost:

    PYTHONPATH=. python3 scripts/torch_span_cost.py [--calls 100000]

prints one JSON line: microseconds a call each way, the calls, and the
machine's device (the card's name and power limit when there is one).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from bcp_tpu_torch.utils import spans
from bcp_tpu_torch.utils.spans import span


def per_call_us(calls: int, make) -> float:
    t0 = time.perf_counter()
    for _ in range(calls):
        with make():
            pass
    return 1e6 * (time.perf_counter() - t0) / calls


def device() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except OSError:
        limit = "power limit not read"
    return f"{torch.cuda.get_device_name(0)} ({limit})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--calls", type=int, default=100000)
    args = p.parse_args(argv)
    n = args.calls
    per_call_us(n // 10, lambda: span("step.nms"))      # warm-up
    out = {"calls": n, "device": device(),
           "empty_loop_us": per_call_us(n, contextlib.nullcontext),
           "span_us": per_call_us(n, lambda: span("step.nms"))}
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        out["span_profiled_us"] = per_call_us(n, lambda: span("step.nms"))
    out["spans_ended"] = spans.totals()["step.nms"][0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
