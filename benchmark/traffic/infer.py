"""Traffic driver ``infer``: ``SlidingWindowEvaluator.infer_cases`` as
``cli/test_la.py`` calls it, one closed-loop caller.

Set-up makes the test volumes and the net's weights from the seed (its
BatchNorm statistics set from one window of the first volume, so that an
eval-mode net's activations stay at unit scale), writes the weights where
the test CLI reads the self stage's best checkpoint, builds the evaluator
with ``test_la.build_evaluator`` and runs it over a few volumes (kernels
built, the count map cached). The window then feeds the volumes in a
fixed order, cycling, until ``seconds`` have passed, and takes every
label the evaluator yields until it has drained: the time a volume takes
and the tail of the times between consecutive results, over all of them.
A traced run then traces whole volumes on the device, then on the host,
and times each conv of the forward alone at its shapes.

Correctness: a sample of the window's results, drawn from the seed, is
kept; once the window has closed and the evaluator is freed, the plain
reference (``benchmark/reference/sliding.py``, f32) scores the same
volumes, and the widest gap by which a voxel the program labelled
otherwise than the reference has its reference class-1 score away from
0.5 is held to the cell's limit (``compare.label_numbers``).
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from benchmark import compare, convs, data, harness
from benchmark.reference import nets, sliding


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float, shrink: Optional[dict] = None) -> dict:
    from bcp_tpu_torch.cli import test_la
    from bcp_tpu_torch.config import la_config
    from bcp_tpu_torch.train.checkpoints import best_model_path, snapshot_dir

    cfg = harness.merged_config(cell, shrink)
    w = cell.workload
    dev = torch.device(device)
    d, ev = cfg["data"], cfg["eval"]
    patch = tuple(cfg["patch_size"])
    vols = data.blob_volumes(seed, 4, d["test_volumes"], d["volume_shape"],
                             dev)
    images = [v[0] for v in vols]
    calib = torch.from_numpy(np.ascontiguousarray(
        images[0][:patch[0], :patch[1], :patch[2]]))[None, None]
    weights = data.seeded_weights(cfg["reference_net"], cfg["widths"], seed,
                                  dev, calibrate=calib)
    weights = {k: v.cpu() for k, v in weights.items()}
    tmp = tempfile.mkdtemp(prefix="bcp_bench_")
    try:
        flags = ["--model", cfg["net_type"], "--snapshot_root", tmp,
                 "--labelnum", str(d["labelled"]),
                 "--stride_xy", str(ev["stride_xy"]),
                 "--stride_z", str(ev["stride_z"]),
                 "--eval_batch", str(ev["eval_batch"]),
                 "--patch_size", *map(str, patch), "--device", device,
                 *cfg.get("test_flags", [])]
        args = test_la.build_parser().parse_args(flags)
        where = snapshot_dir(la_config(labelnum=args.labelnum).replace(
            exp=args.exp, snapshot_root=tmp), args.stage_name)
        os.makedirs(where)
        torch.save(weights, best_model_path(where, args.model))
        pcfg, evaluator = test_la.build_evaluator(args, device)
        recorder = convs.Recorder(train_only=False)
        recorder.role = "eval"
        list(evaluator.infer_cases(images[:1], rule=pcfg.eval_rule))
        recorder.role = None
        recorder.close()
        list(evaluator.infer_cases(images[1:1 + int(w["warm_volumes"])],
                                   rule=pcfg.eval_rule))

        n = len(images)
        harness.sync(dev)
        t_start = time.perf_counter()
        setup_s = t_start - t0

        def feed():
            i = 0
            while time.perf_counter() - t_start < seconds:
                yield images[i % n]
                i += 1

        times, keep = [], []
        rng = np.random.default_rng([seed, 7])
        k = int(w["sampled_volumes"])
        failed = 0
        for j, lab in enumerate(evaluator.infer_cases(feed(),
                                                      rule=pcfg.eval_rule)):
            times.append(time.perf_counter())
            failed += lab.shape != images[j % n].shape
            slot = j if j < k else int(rng.integers(0, j + 1))
            if slot < k:
                item = (j % n, lab.astype(np.uint8))
                if slot < len(keep):
                    keep[slot] = item
                else:
                    keep.append(item)
        volumes = len(times)
        window_s = times[-1] - t_start
        gaps = np.diff(np.array([t_start] + times))

        traces = {}
        conv_times = []
        if trace:
            traces = trace_volumes(evaluator, images, pcfg.eval_rule,
                                   int(w["trace_volumes"]), dev, tmp)
            conv_times = convs.time_calls(recorder.calls)
        windows = len(sliding.window_origins(
            d["volume_shape"], patch, ev["stride_xy"], ev["stride_z"]))
        computed = -(-windows // ev["eval_batch"]) * ev["eval_batch"]
        ctx = {"device": dev, "window_s": window_s, "volumes": volumes,
               "volume_flops": convs.flops(recorder.calls) * windows
               / computed, "traces": traces, "conv_times": conv_times,
               "peaks": harness.card_peaks(dev)}
        out = {"metrics": {
            "infer_s_per_volume": window_s / volumes,
            "infer_s_per_volume_p95": float(np.percentile(gaps, 95)),
            "setup_s": setup_s},
            "attempted": volumes, "failed": failed, "ctx": ctx,
            "device": harness.device_info(dev)}
        if trace:
            harness.add_trace_device(out, traces)
        del evaluator, recorder
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # ---- the reference, once the window has closed
        nets.strict_f32()
        model = nets.build(cfg["reference_net"], cfg["widths"]).to(dev)
        model.load_state_dict(weights)
        model.eval()
        p1 = [sliding.scores(model, images[i], patch, ev["stride_xy"],
                             ev["stride_z"], cfg["widths"]["n_classes"],
                             dev, ev["eval_batch"])[1] for i, _ in keep]
        nums = compare.label_numbers([lab for _, lab in keep], p1)
        out["checks"] = compare.held(nums, w["limits"])
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def trace_volumes(evaluator, images, rule, n: int, dev, tmp: str) -> dict:
    """A device trace of ``n`` whole volumes, then a host trace of as
    many, each between two synchronisations."""
    out = {}
    for phase in ("device", "host"):
        prof = harness.start_trace(dev, phase)
        t_a = time.perf_counter()
        list(evaluator.infer_cases(images[:n], rule=rule))
        harness.sync(dev)
        t_b = time.perf_counter()
        out[phase] = {"events": harness.stop_trace(prof, tmp, phase),
                      "window_s": t_b - t_a, "steps": n}
    return out
