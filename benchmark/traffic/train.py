"""Traffic driver ``train``: the LA self-train stage of ``cli/train_la.py``
(``BCPTrainer.selftrain`` at ``--steps_per_dispatch K``) on the LA split,
timed over whole dispatch groups.

Set-up makes the split's volumes and the net's weights from the seed,
writes the weights where the self stage reads the pre-train stage's best
checkpoint, builds the trainer as the CLI does and starts the stage. Its
first group runs eagerly (the trainer's own warm-up: kernels built,
variants picked, optimizer state made), the second captures the CUDA
graphs and replays them, the third replays them as every group of the
window does; the trainer's background evaluator warm-up is waited for
after the first. The window then opens at a group's end and closes at
the first group's end ``seconds`` later, both after a device
synchronisation: the patches of the window's whole steps over its time.
No validation falls inside it (``eval_every`` is the stage's length). A
traced run then traces whole groups on the device, then on the host, and
times each conv the step calls alone at its shapes.

Correctness: a forward pre-hook on every module, on during the first
group only, keeps the first step's gradients before the student's second
forward and its parameters before the fourth (after step 3), and finds
the student and the teacher; at the end of the last two warm-up groups,
before the window opens, their parameters are copied to the host (the
state before and after the last warm-up group, whose steps are graph
replays as the window's); the trainer's ``on_metrics`` gives each step's
loss. Once the window has closed and the trainer is freed, the plain
reference (``benchmark/reference/bcp.py``) makes the same updates from
the same weights and volumes, up to the window's first step, and the
numbers of ``compare.train_numbers`` are held to the cell's limits: the
first checked steps' losses, the first gradient and the parameters'
change over those steps, and the last warm-up group's losses and the
student's and the teacher's change over it, leaf by leaf.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

from benchmark import compare, convs, data, harness
from benchmark.reference import bcp, nets


class Closed(Exception):
    """Raised from the trainer's ``on_step`` hook to end the stage once the
    window (and a traced run's traces) is done."""


class Clock:
    """The trainer's ``on_step`` hook: warm-up (``on_warm_group(it)`` at
    each of its groups' ends), the window, the traces."""

    def __init__(self, trainer, device, K: int, warm_groups: int,
                 seconds: float, trace: bool, trace_groups: int,
                 last_it: int, recorder, hooks, tmp: str, on_warm_group):
        self.trainer, self.device, self.K = trainer, device, K
        self.on_warm_group = on_warm_group
        self.warm_groups, self.seconds = warm_groups, seconds
        self.trace, self.trace_groups = trace, trace_groups
        self.last_it, self.recorder, self.hooks = last_it, recorder, hooks
        self.tmp = tmp
        self.t_start = self.t_end = None
        self.start_it = self.end_it = None
        self.traces: Dict[str, dict] = {}
        self._prof = None
        self.conv_times: List[dict] = []

    def __call__(self, stage: str, it: int) -> None:
        if it % self.K:
            return
        group = it // self.K
        if group == 1:
            # the module hooks watched the first group only: none may run
            # inside a CUDA graph capture
            for h in self.hooks:
                h.remove()
            self.recorder.close()
            self.trainer.wait_for_validations()
        if self.t_start is None:
            self.on_warm_group(it)
        if group == self.warm_groups:
            harness.sync(self.device)
            self.t_start, self.start_it = time.perf_counter(), it
            return
        if self.t_start is None:
            return
        if self.t_end is None:
            if (time.perf_counter() - self.t_start < self.seconds
                    and it < self.last_it):
                return
            harness.sync(self.device)
            self.t_end, self.end_it = time.perf_counter(), it
            if not self.trace:
                raise Closed
            self._next_trace(it, "device")
            return
        phase, first, _ = self._prof
        if it - first < self.trace_groups * self.K and it < self.last_it:
            return
        self._stop(it)
        if phase == "device":
            self._next_trace(it, "host")
            return
        self.conv_times = convs.time_calls(self.recorder.calls,
                                           ("student",))
        raise Closed

    def _next_trace(self, it: int, phase: str) -> None:
        prof = harness.start_trace(self.device, phase)
        self._prof = (phase, it, (prof, time.perf_counter()))

    def _stop(self, it: int) -> None:
        phase, first, (prof, t_a) = self._prof
        harness.sync(self.device)
        t_b = time.perf_counter()
        self.traces[phase] = {
            "events": harness.stop_trace(prof, self.tmp, phase),
            "window_s": t_b - t_a, "steps": it - first}


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float, shrink: Optional[dict] = None) -> dict:
    from bcp_tpu_torch.cli import train_la
    from bcp_tpu_torch.data.datasets import VolumeList
    from bcp_tpu_torch.train.checkpoints import best_model_path, snapshot_dir
    from bcp_tpu_torch.train.trainer import BCPTrainer

    cfg = harness.merged_config(cell, shrink)
    w = cell.workload
    dev = torch.device(device)
    K = int(w["steps_per_dispatch"])
    d = cfg["data"]
    volumes = data.blob_volumes(seed, 0, d["train_volumes"],
                                d["volume_shape"], dev)
    val = data.blob_volumes(seed, 3, d["validation_volumes"],
                            d["volume_shape"], dev)
    weights = data.seeded_weights(cfg["reference_net"], cfg["widths"], seed,
                                  dev)
    tmp = tempfile.mkdtemp(prefix="bcp_bench_")
    try:
        iters = int(w["stage_iterations"])
        flags = ["--model", cfg["net_type"], "--stage", "self",
                 "--steps_per_dispatch", str(K),
                 "--labelnum", str(d["labelled"]),
                 "--max_samples", str(d["train_volumes"]),
                 "--batch_size", str(cfg["batch_size"]),
                 "--labeled_bs", str(cfg["labeled_bs"]),
                 "--seed", str(seed), "--snapshot_root", tmp,
                 "--self_max_iteration", str(iters),
                 "--compute_dtype", cfg["compute_dtype"],
                 "--device", device]
        args = train_la.build_parser().parse_args(flags)
        over = {"patch_size": tuple(cfg["patch_size"]), "eval_every": iters,
                **cfg.get("program_config", {})}
        pcfg = train_la.config_from_args(args, **over)
        pre = snapshot_dir(pcfg, "pre_train")
        os.makedirs(pre)
        torch.save({k: v.cpu() for k, v in weights.items()},
                   best_model_path(pre, pcfg.net_type))
        weights = {k: v.cpu() for k, v in weights.items()}

        losses: Dict[int, float] = {}

        def on_metrics(stage, it, host):
            losses[it] = host["loss"]

        trainer = BCPTrainer(pcfg, device=device,
                             train_dataset=VolumeList(volumes),
                             val_cases=val, on_metrics=on_metrics)
        root_cls = type(trainer.eval_model)
        kept: Dict = {}
        mods: Dict[str, torch.nn.Module] = {}
        recorder = convs.Recorder()
        seen = {"student": 0}
        checked = int(w["checked_steps"])
        warm = int(w["warm_groups"])
        # the last warm-up group, graph replays as the window's groups
        group = range((warm - 1) * K + 1, warm * K + 1)

        def host(m):
            return {k: v.detach().to("cpu", copy=True).float()
                    for k, v in m.named_parameters()}

        def pre_hook(module, args_):
            if type(module) is not root_cls or not module.training:
                return
            params = dict(module.named_parameters())
            if not next(iter(params.values())).requires_grad:
                mods.setdefault("teacher", module)
                recorder.role = "teacher" if seen["student"] == 0 else None
                return
            mods.setdefault("student", module)
            seen["student"] += 1
            n = seen["student"]
            recorder.role = "student" if n == 1 else None
            # kept on the host: the device's peak is the program's
            if n == 2:
                kept["g1"] = {k: v.grad.detach().to("cpu", copy=True)
                              for k, v in params.items()}
            elif n == checked + 1:
                kept[checked] = (host(module), None)

        def on_warm_group(it):
            if it in (group[0] - 1, group[-1]):
                kept[it] = (host(mods["student"]), host(mods["teacher"]))
            if it == group[-1]:
                mods.clear()

        hook = torch.nn.modules.module.register_module_forward_pre_hook(
            pre_hook)
        clock = Clock(trainer, dev, K, warm, seconds, trace,
                      int(w["trace_groups"]), iters, recorder, [hook], tmp,
                      on_warm_group)
        trainer.on_step = clock
        try:
            trainer.selftrain()
        except Closed:
            pass
        finally:
            hook.remove()
            recorder.close()
        window_s = clock.t_end - clock.t_start
        steps = clock.end_it - clock.start_it
        setup_s = clock.t_start - t0
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        device_info = harness.device_info(dev)
        window_losses = [v for it, v in losses.items()
                         if clock.start_it < it <= clock.end_it]
        failed = sum(not math.isfinite(v) for v in window_losses)
        calls = recorder.calls
        step_flops = convs.flops(calls, ("student",))
        ctx = {"device": dev, "window_s": window_s, "steps": steps,
               "step_flops": step_flops, "traces": clock.traces,
               "conv_times": clock.conv_times,
               "peaks": harness.card_peaks(dev)}
        out = {"metrics": {
            "train_patches_per_s": steps * cfg["batch_size"] / window_s,
            "train_peak_gib": peak / 2**30, "setup_s": setup_s},
            "attempted": steps, "failed": failed, "ctx": ctx,
            "device": device_info}
        if trace:
            harness.add_trace_device(out, clock.traces)
        del trainer, clock, recorder, calls, hook, pre_hook, mods
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # ---- the reference, once the window has closed
        t_ref = time.perf_counter()
        nets.strict_f32()
        feed = bcp.Feed(volumes, d["labelled"], cfg["batch_size"],
                        cfg["batch_size"] - cfg["labeled_bs"],
                        cfg["patch_size"], seed)
        stage = bcp.SelfTrain(cfg, weights, dev)
        ref_losses, ref_g1, ref_kept = stage.run(
            feed, group[-1], seed, (checked, group[0] - 1, group[-1]))
        on_dev = {n: v.to(dev) for n, v in weights.items()}
        prog = {"losses": losses, "g1": kept.pop("g1"),
                "states": {0: (weights, weights), **kept}}
        ref = {"losses": dict(enumerate(ref_losses, 1)), "g1": ref_g1,
               "states": {0: (on_dev, on_dev), **ref_kept}}
        nums = compare.train_numbers(prog, ref, checked, group)
        print(f"reference: {group[-1]} steps in "
              f"{time.perf_counter() - t_ref!r} s", file=sys.stderr)
        out["checks"] = compare.held(nums, w["limits"])
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
