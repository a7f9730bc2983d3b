"""Mean-teacher EMA (`bcp_tpu/ops/ema.py:30-40`): teacher <- alpha *
teacher + (1 - alpha) * student, in place. The LA flavour
(`BCP_utils.py:78-81`) moves the parameters only; ACDC's
(`ACDC_BCP_train.py:123-129`, ``Config.ema_full_state``) the whole state,
the BatchNorms' running statistics included. The two-student flavour
(`ema.py:50-55`) averages two students into the teacher."""

from __future__ import annotations

import torch


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module,
               alpha: float, full_state: bool = False) -> None:
    """Update ``teacher``'s parameters from ``student``'s, and with
    ``full_state`` its floating-point buffers too (the BN running mean and
    variance). ``num_batches_tracked``, an integer counter with no JAX
    counterpart that no forward reads (the momentum is fixed), is left as
    it is."""
    t = list(teacher.parameters())
    s = list(student.parameters())
    if full_state:
        t += [b for b in teacher.buffers() if b.is_floating_point()]
        s += [b for b in student.buffers() if b.is_floating_point()]
    torch._foreach_mul_(t, alpha)
    torch._foreach_add_(t, torch._foreach_mul(s, 1.0 - alpha))


@torch.no_grad()
def ema_update_two_students(teacher: torch.nn.Module,
                            student1: torch.nn.Module,
                            student2: torch.nn.Module, alpha: float) -> None:
    """teacher <- alpha * teacher + (1 - alpha) / 2 * (s1 + s2) over the
    parameters, in place (`update_ema_students`, `BCP_utils.py:83-86`)."""
    t = list(teacher.parameters())
    both = torch._foreach_add(list(student1.parameters()),
                              list(student2.parameters()))
    torch._foreach_mul_(t, alpha)
    torch._foreach_add_(t, torch._foreach_mul(both, 0.5 * (1.0 - alpha)))
