"""The convolutions and linear layers a step or a forward calls, recorded
by a forward hook during warm-up: their operations, with the products
the architecture's file adds, for ``mfu.*``, and each conv timed alone
at its shapes for ``conv_roofline.*``: the same work whatever implements
it."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from benchmark import counts
from benchmark.reference import nets

CONVS = (nn.Conv3d, nn.ConvTranspose3d)
RECORDED = CONVS + (nn.Linear,)


class Recorder:
    """Records each conv and linear module call while ``role`` is set (a
    string such as "teacher" or "student"): the module, its input's shape,
    dtype, layout and whether it needs a gradient, and its output's shape;
    and, by :meth:`forward`, the samples each role's whole-net forwards
    took."""

    def __init__(self, train_only: bool = True):
        self.role = None
        self.train_only = train_only
        self.calls: List[dict] = []
        self.samples: Dict[str, int] = {}
        self.handle = nn.modules.module.register_module_forward_hook(
            self._hook)

    def forward(self, x: torch.Tensor) -> None:
        """Counts a whole-net forward of ``x`` for the current role."""
        if self.role is not None:
            self.samples[self.role] = (self.samples.get(self.role, 0)
                                       + x.shape[0])

    def _hook(self, module, args, output):
        # ``train_only``: the train-mode nets only (the trainer's evaluator
        # runs on a thread of its own meanwhile)
        if self.role is None or not isinstance(module, RECORDED) \
                or (self.train_only and not module.training):
            return
        x = args[0]
        self.calls.append({
            "role": self.role, "module": module, "x": tuple(x.shape),
            "dtype": x.dtype,
            "channels_last": x.dim() == 5 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last_3d),
            "dx": x.requires_grad, "y": tuple(output.shape),
            "w": tuple(module.weight.shape),
            "linear": isinstance(module, nn.Linear),
            "transposed": isinstance(module, nn.ConvTranspose3d),
            "bias": module.bias is not None})

    def close(self) -> None:
        self.handle.remove()


def work(call: dict, backward: bool) -> Tuple[int, int]:
    """(operations, bytes) of a recorded conv call, forward or
    backward."""
    x, w, y = call["x"], call["w"], call["y"]
    item = torch.empty((), dtype=call["dtype"]).element_size()
    if backward:
        return (counts.backward_flops(x, w, y, call["transposed"],
                                      call["dx"]),
                counts.backward_bytes(x, w, y, call["bias"], call["dx"],
                                      item))
    return (counts.conv_flops(x, w, y, call["transposed"]),
            counts.conv_bytes(x, w, y, call["bias"], item))


def call_flops(call: dict, backward: bool) -> int:
    """Operations of a recorded conv or linear call, forward or backward
    (dW, and dx when the input needs a gradient: each costs a
    forward)."""
    if not call["linear"]:
        return work(call, backward)[0]
    f = counts.linear_flops(call["x"], call["w"])
    return f * (1 + call["dx"]) if backward else f


def flops(calls: List[dict], backward_roles=()) -> int:
    """Operations of the recorded calls: every forward, and the backward
    of the calls whose role is in ``backward_roles``."""
    total = 0
    for c in calls:
        total += call_flops(c, False)
        if c["role"] in backward_roles:
            total += call_flops(c, True)
    return total


def extra_flops(net: str, widths: dict, patch, samples: Dict[str, int],
                backward_roles=()) -> int:
    """Operations of the products the architecture's file adds
    (``nets.extra_flops``) for the samples each role's forwards took:
    the forward, and for the roles in ``backward_roles`` twice it again
    for the backward."""
    return sum(nets.extra_flops(net, widths, patch, n)
               * (3 if role in backward_roles else 1)
               for role, n in samples.items())


def _input(call: dict, device) -> torch.Tensor:
    x = torch.randn(call["x"], device=device).to(call["dtype"])
    if call["channels_last"]:
        x = x.contiguous(memory_format=torch.channels_last_3d)
    return x


def _time(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def time_calls(calls: List[dict], backward_roles=(), reps: int = 5
               ) -> List[Dict[str, float]]:
    """Each distinct recorded call alone on the card, timed with CUDA
    events (forward, and the backward through autograd for the roles in
    ``backward_roles``), with its count in the recording: a list of
    {"flops", "bytes", "seconds", "count", "backward"}; empty off the
    card. Linear calls are not timed."""
    calls = [c for c in calls if not c["linear"]]
    if not calls or calls[0]["module"].weight.device.type != "cuda":
        return []
    seen: Dict[tuple, dict] = {}
    for c in calls:
        for bwd in (False, True):
            if bwd and c["role"] not in backward_roles:
                continue
            key = (id(c["module"]), c["x"], c["dx"], bwd)
            if key in seen:
                seen[key]["count"] += 1
            else:
                seen[key] = {"call": c, "count": 1, "backward": bwd}
    out = []
    for item in seen.values():
        c, mod = item["call"], item["call"]["module"]
        dev = mod.weight.device
        x = _input(c, dev).requires_grad_(c["dx"] and item["backward"])
        if item["backward"]:
            y = mod(x)
            dy = torch.randn_like(y)
            ins = ([x] if c["dx"] else []) + [p for p in mod.parameters()]

            def fn(y=y, dy=dy, ins=ins):
                torch.autograd.grad(y, ins, dy, retain_graph=True)
        else:
            def fn(x=x, mod=mod):
                with torch.no_grad():
                    mod(x)
        seconds = _time(fn, reps)
        f, b = work(c, item["backward"])
        out.append({"flops": f, "bytes": b, "seconds": seconds,
                    "count": item["count"], "backward": item["backward"]})
        del x
    return out
