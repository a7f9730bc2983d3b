"""Mean-teacher EMA, parameters only (`bcp_tpu/ops/ema.py:30-34`, the LA
flavour, `BCP_utils.py:78-81`): teacher <- alpha * teacher + (1 - alpha) *
student, in place over the parameter lists."""

from __future__ import annotations

import torch


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module,
               alpha: float) -> None:
    """Update ``teacher``'s parameters from ``student``'s; buffers (BN
    running statistics) are left as they are."""
    t = list(teacher.parameters())
    s = list(student.parameters())
    torch._foreach_mul_(t, alpha)
    torch._foreach_add_(t, torch._foreach_mul(s, 1.0 - alpha))
