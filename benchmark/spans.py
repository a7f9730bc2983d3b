"""The program's spans in a traced run's host trace (CPU and CUDA activity
on one clock): where the device's busy and idle time falls by program
span, the spans' counts and their host time.

A program span is a ``user_annotation`` event whose name is the port's
``layer.stage`` form (``step.nms``, ``eval.chunk``; the port's
``utils.spans`` enters ``torch.profiler.record_function`` under a
profiler). Other annotations (``Optimizer.step#SGD.step``) are not
program spans. The program's thread is the one that opened the most
program spans.

- A device operation belongs to the spans open, on the launching thread,
  at its launch: the CUDA API call with the same ``correlation`` (for a
  graph replay, ``cudaGraphLaunch``). An operation whose launch is not in
  the trace belongs to none.
- The window runs from the first program span's start on the program's
  thread to the later of the last device operation's end and the last
  program span's end; operations that ended before it (work launched
  before the trace) are left out. Time two operations share counts once,
  for the one that started first, so the busy seconds by span add up to
  the union of the operations.
- An idle gap (window time in which the device ran nothing) belongs to the
  spans open on the program's thread when it began.

Nothing here imports the program: a trace of a program without spans
gives None, and every reader then returns None.
"""

from __future__ import annotations

import re
import sys
from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark import trace

#: the form of a program span's name
NAME = re.compile(r"^[a-z][a-z_]*\.[a-z][a-z_]*$")
#: the trace categories of the host calls that launch device work: the
#: runtime API's, and the low-level API's ``cuLaunchKernel`` (the CUTLASS
#: and cuDNN kernels)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

Stack = Tuple[str, ...]


@dataclass
class Attribution:
    """Seconds of device busy and idle time by the stack of program spans
    (outermost first) they belong to, ``()`` for none; each span name's
    count and host seconds."""
    busy: Dict[Stack, float]
    idle: Dict[Stack, float]
    counts: Dict[str, int]
    host_s: Dict[str, float]

    def busy_s(self, *names: str) -> float:
        """Busy seconds of the operations launched inside any of ``names``
        (their nested spans included)."""
        return sum(v for st, v in self.busy.items()
                   if any(n in st for n in names))

    def by_innermost(self) -> Dict[Optional[str], Tuple[float, float]]:
        """innermost span (None: no span) -> (busy s, idle s)."""
        out: Dict[Optional[str], List[float]] = defaultdict(
            lambda: [0.0, 0.0])
        for i, part in enumerate((self.busy, self.idle)):
            for st, v in part.items():
                out[st[-1] if st else None][i] += v
        return {k: (b, s) for k, (b, s) in out.items()}


def program_spans(events) -> List[Tuple[float, float, str, object]]:
    """(start us, end us, name, thread) of each program span."""
    return [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid"))
            for e in events if e.get("cat") == "user_annotation"
            and NAME.match(e.get("name", ""))]


def open_at(spans, times: List[float]) -> List[Stack]:
    """The stack of ``spans`` ((start, end, name, ...), properly nested)
    open at each of ``times``: a span is open at t when start <= t <
    end."""
    order = sorted(range(len(times)), key=times.__getitem__)
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out: List[Stack] = [()] * len(times)
    stack: list = []
    i = 0
    for q in order:
        t = times[q]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[q] = tuple(s[2] for s in stack)
    return out


def attribute(events) -> Optional[Attribution]:
    """The :class:`Attribution` of a host trace's events, or None when it
    holds no program span."""
    spans = program_spans(events)
    if not spans:
        return None
    threads: Dict[object, list] = defaultdict(list)
    for s in spans:
        threads[s[3]].append(s)
    main = max(threads, key=lambda t: len(threads[t]))
    t0 = min(s[0] for s in threads[main])
    launches = {e["args"]["correlation"]: (e["ts"], e.get("tid"))
                for e in events if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    ops = [(e["ts"], e["ts"] + e["dur"],
            launches.get(e.get("args", {}).get("correlation")))
           for e in events if e.get("cat") in trace.DEVICE_CATS
           and e["ts"] + e["dur"] > t0]
    ops.sort(key=lambda o: o[0])
    # each operation's stack at its launch, on the launching thread
    stacks: List[Stack] = [()] * len(ops)
    asked: Dict[object, List[int]] = defaultdict(list)
    for i, (_, _, launch) in enumerate(ops):
        if launch is not None:
            asked[launch[1]].append(i)
    for tid, idx in asked.items():
        got = open_at(threads.get(tid, []), [ops[i][2][0] for i in idx])
        for i, st in zip(idx, got):
            stacks[i] = st
    busy: Dict[Stack, float] = defaultdict(float)
    idle: Dict[Stack, float] = defaultdict(float)
    frontier = t0
    gaps: List[Tuple[float, float]] = []
    for (start, end, _), st in zip(ops, stacks):
        if start > frontier:
            gaps.append((frontier, start))
        a = max(start, frontier)
        if end > a:
            busy[st] += (end - a) / 1e6
            frontier = end
    t1 = max([frontier] + [s[1] for s in threads[main]])
    if t1 > frontier:
        gaps.append((frontier, t1))
    for (a, b), st in zip(gaps, open_at(threads[main],
                                        [a for a, _ in gaps])):
        idle[st] += (b - a) / 1e6
    host: Dict[str, float] = defaultdict(float)
    for s in spans:
        host[s[2]] += (s[1] - s[0]) / 1e6
    return Attribution(dict(busy), dict(idle),
                       dict(Counter(s[2] for s in spans)), dict(host))


def of(ctx, names: Iterable[str]) -> Optional[Tuple[Attribution, int]]:
    """(the attribution of a traced run's host trace, its steps or
    volumes), or None off the card, without a host trace, or when the
    trace holds none of ``names`` (a program without them)."""
    info = ctx["traces"].get("host")
    if ctx["device"].type != "cuda" or info is None:
        return None
    att = attribute(info["events"])
    if att is None or not any(n in att.counts for n in names):
        return None
    return att, info["steps"]


def print_table(att: Attribution, per: int, unit: str) -> None:
    """Each innermost program span's device busy and idle ms a step or
    volume, and those no span covers, on standard error."""
    rows = sorted(att.by_innermost().items(),
                  key=lambda kv: -(kv[1][0] + kv[1][1]))
    busy = sum(att.busy.values())
    idle = sum(att.idle.values())
    print(f"program spans (busy ms, idle ms a {unit}; innermost span): "
          + ", ".join(f"{k or 'no span'} {1e3 * b / per!r} "
                      f"{1e3 * i / per!r}" for k, (b, i) in rows)
          + f"; covered busy {1e3 * (busy - att.busy.get((), 0.0)) / per!r}"
            f" of {1e3 * busy / per!r}, idle "
            f"{1e3 * (idle - att.idle.get((), 0.0)) / per!r} of "
            f"{1e3 * idle / per!r}", file=sys.stderr)
