"""Ramp schedules (`bcp_tpu/ops/ramps.py`, `code/utils/ramps.py:19-41`) on
host floats. LA computes and logs the consistency weight but never applies
it (`LA_BCP_train.py:246,260`)."""

from __future__ import annotations

import math


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """exp(-5 * (1 - t)^2)."""
    if rampup_length == 0:
        return 1.0
    current = min(max(float(current), 0.0), float(rampup_length))
    phase = 1.0 - current / rampup_length
    return float(math.exp(-5.0 * phase * phase))


def linear_rampup(current: float, rampup_length: float) -> float:
    if rampup_length == 0:
        return 1.0
    return min(max(float(current) / rampup_length, 0.0), 1.0)


def cosine_rampdown(current: float, rampdown_length: float) -> float:
    return float(0.5 * (math.cos(math.pi * current / rampdown_length) + 1.0))
