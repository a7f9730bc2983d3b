#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bcp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no final line):

1. the card's name and power limit, torch/CUDA versions, and the build of
   every hand-written kernel from ``bcp_tpu_torch/kernels/csrc`` (one nvcc
   per source, in parallel);
2. each kernel against its plain PyTorch version on the card at the main
   path's shapes: the overlap-add bit for bit on one LA chunk (8 windows of
   112x112x80x2 into a 240x200x96x2 score map); the 3^3 conv at the five
   V-Net stage shapes at batch 8, f32 to rtol = atol = 1e-4 and bf16 to
   max|kernel - plain| <= 1e-2 max|plain|; with CUDA-event times (median of
   >= 10) of the kernel, the plain version and, for the conv, ``F.conv3d``;
3. the whole slice in f32 on the card against the same slice on the CPU:
   the full-width V-Net (n_filters 16, seeded weights, saved as a
   reference-layout .pth) through the evaluator on one 112x112x80 volume,
   score maps to atol 1e-3;
4. the main path: ``bcp_tpu_torch.cli.test_la``'s core function at full
   width on two synthetic 240x200x96 LA volumes (270 windows each), stride
   18/4, eval batch 8, bf16, NMS on, from that .pth, with every kernel's
   launch count reset before and read after; two case lines of four finite
   metrics, and class probabilities of the cropped score map summing to
   1 +- 1e-2 per voxel. Then the steady-state time of the same evaluator
   over both volumes, and a ``torch.profiler`` trace of one volume: device
   time by kernel name, busy time and idle share.

It then prints the kernels' JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. TF32 is off for matmuls and cuDNN, so
the f32 comparisons compare f32 arithmetic.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
DEVICE = "cuda"
LA_VOLUME = (240, 200, 96)
PATCH = (112, 112, 80)
EVAL_BATCH = 8
# the 20 3^3 convs of one V-Net forward that the kernel takes:
# (channels, X, Y, Z) at a 112x112x80 window -> convs per forward
CONV_STAGES = [((32, 56, 56, 40), 4), ((64, 28, 28, 20), 6),
               ((128, 14, 14, 10), 6), ((256, 7, 7, 5), 3),
               ((16, 112, 112, 80), 1)]
# NVIDIA data sheets, dense: (bf16 tensor FLOP/s, f32 FLOP/s, HBM bytes/s)
PEAKS = {"H100 PCIe": (756e12, 51e12, 2.0e12),
         "H100 NVL": (835e12, 60e12, 3.9e12),
         "H100": (989e12, 67e12, 3.35e12)}      # SXM5, 700 W


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key if key != "H100" else "H100 SXM", val
    fail(f"no peak rates known for {name!r}")


def cuda_ms(torch, fn, n: int = 10) -> float:
    """Median CUDA-event time of ``fn`` over ``n`` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_kernels(torch, rates):
    import torch.nn.functional as F
    from bcp_tpu_torch.eval.sliding_window import window_starts
    from bcp_tpu_torch.ops.conv3d import (conv3x3x3_same,
                                          conv3x3x3_same_reference)
    from bcp_tpu_torch.ops.scatter import (scatter_add_windows,
                                           scatter_add_windows_reference)
    bf16_peak, f32_peak, hbm = rates
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # -- A: overlap-add, one chunk of real overlapping LA windows
    starts = window_starts(LA_VOLUME, PATCH, 18, 4)[:EVAL_BATCH]
    score = torch.rand((*LA_VOLUME, 2), generator=gen, device=dev)
    probs = torch.rand((EVAL_BATCH, *PATCH, 2), generator=gen, device=dev)
    got = scatter_add_windows(score.clone(), probs, starts)
    want = scatter_add_windows_reference(score.clone(), probs, starts)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("overlap-add kernel differs from the in-order loop")
    covered = np.zeros(LA_VOLUME, bool)
    for sx, sy, sz in starts:
        covered[sx:sx + PATCH[0], sy:sy + PATCH[1], sz:sz + PATCH[2]] = True
    a_bytes = probs.numel() * 4 + 2 * int(covered.sum()) * 2 * 4
    a_bound = max(a_bytes / hbm, probs.numel() / f32_peak) * 1e3
    work = score.clone()
    scatter = {
        "name": "scatter_add_windows", "route": "cuda",
        "source": "bcp_tpu_torch/kernels/csrc/scatter_add.cu",
        "replaces": "bcp_tpu/ops/scatter.py:79",
        "max_abs_err": float((got - want).abs().max().item()),
        "ms": cuda_ms(torch, lambda: scatter_add_windows(work, probs,
                                                         starts)),
        "plain_ms": cuda_ms(torch, lambda: scatter_add_windows_reference(
            work, probs, starts)),
        "bound_ms": a_bound,
        "bound_by": "bytes" if a_bytes / hbm >= probs.numel() / f32_peak
        else "operations",
        "library_ms": None,
        "per": "one launch: 8 windows of 112x112x80x2 into 240x200x96x2",
    }
    print(f"kernel A scatter_add_windows: bit-exact, {scatter['ms']:.4f} ms "
          f"(plain {scatter['plain_ms']:.4f} ms, bound "
          f"{scatter['bound_ms']:.4f} ms)", flush=True)
    del score, probs, got, want, work

    # -- B: 3^3 conv at the five stage shapes, batch 8, bf16 and f32
    shapes = []
    for (c, X, Y, Z), per_forward in CONV_STAGES:
        row = {"shape": f"{EVAL_BATCH}x{c}@{X}x{Y}x{Z}",
               "per_forward": per_forward}
        M = EVAL_BATCH * X * Y * Z
        for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = torch.randn((EVAL_BATCH, c, X, Y, Z), generator=gen,
                            device=dev).to(dt).contiguous(
                memory_format=torch.channels_last_3d)
            w = (torch.randn((c, c, 3, 3, 3), generator=gen, device=dev)
                 / (27 * c) ** 0.5).to(dt)
            k = conv3x3x3_same(x, w)
            p = conv3x3x3_same_reference(x, w)
            torch.cuda.synchronize()
            err = float((k.float() - p.float()).abs().max().item())
            pmax = float(p.float().abs().max().item())
            if dt == torch.float32:
                if not torch.allclose(k, p, rtol=1e-4, atol=1e-4):
                    fail(f"conv f32 {row['shape']}: max err {err}")
            elif err > 1e-2 * pmax:
                fail(f"conv bf16 {row['shape']}: max err {err} > 1e-2 * "
                     f"{pmax}")
            flop = 2 * M * 27 * c * c
            nbytes = (2 * M * c + 27 * c * c) * x.element_size()
            peak = bf16_peak if dt == torch.bfloat16 else f32_peak
            row[f"{name}_max_abs_err"] = err
            row[f"{name}_ms"] = cuda_ms(torch, lambda: conv3x3x3_same(x, w))
            row[f"{name}_plain_ms"] = cuda_ms(
                torch, lambda: conv3x3x3_same_reference(x, w))
            row[f"{name}_library_ms"] = cuda_ms(
                torch, lambda: F.conv3d(x, w, padding=1))
            row[f"{name}_bound_ms"] = max(flop / peak, nbytes / hbm) * 1e3
            row[f"{name}_bound_by"] = ("operations" if flop / peak
                                       >= nbytes / hbm else "bytes")
            del x, w, k, p
        shapes.append(row)
        print(f"kernel B conv3x3x3 {row['shape']}: bf16 "
              f"{row['bf16_ms']:.4f} ms (F.conv3d {row['bf16_library_ms']:.4f}"
              f", plain {row['bf16_plain_ms']:.3f}, bound "
              f"{row['bf16_bound_ms']:.4f}, err {row['bf16_max_abs_err']:.3g})"
              f"; f32 {row['f32_ms']:.4f} ms (err "
              f"{row['f32_max_abs_err']:.3g})", flush=True)

    def total(key):
        return sum(r[key] * r["per_forward"] for r in shapes)

    ops_ms = sum(r["per_forward"] * r["bf16_bound_ms"] for r in shapes
                 if r["bf16_bound_by"] == "operations")
    conv = {
        "name": "conv3x3x3_same", "route": "cuda",
        "source": "bcp_tpu_torch/kernels/csrc/conv3x3x3.cu",
        "replaces": "bcp_tpu/ops/conv3d.py:188",
        "max_abs_err": max(r["bf16_max_abs_err"] for r in shapes),
        "ms": total("bf16_ms"), "plain_ms": total("bf16_plain_ms"),
        "bound_ms": total("bf16_bound_ms"),
        "bound_by": "operations" if ops_ms >= total("bf16_bound_ms") / 2
        else "bytes",
        "library_ms": total("bf16_library_ms"),
        "per": "the 20 bf16 launches of one batch-8 V-Net forward",
        "shapes": shapes,
    }
    return [scatter, conv]


def seeded_vnet(torch, device, seed: int):
    """Full-width V-Net with torch's default init drawn from a numpy
    generator, and BN statistics calibrated on one window so that the
    random net's activations stay at unit scale."""
    from bcp_tpu_torch.models import create_model
    from bcp_tpu_torch.models.layers import TorchBatchNorm
    model = create_model("VNet", 2, device=device)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 1:      # conv weight: U(+-1/sqrt(fan_in))
                b = 1.0 / np.sqrt(p.shape[1] * np.prod(p.shape[2:]))
                p.copy_(torch.from_numpy(rng.uniform(-b, b, p.shape)
                                         .astype(np.float32)))
            elif name.endswith(".bias"):
                p.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, p.shape)
                                         .astype(np.float32)))
    calib = torch.from_numpy(rng.normal(size=(1, 1, *PATCH))
                             .astype(np.float32)).to(device)

    def set_stats(mod, inputs):
        x = inputs[0].float()
        mod.running_mean.copy_(x.mean(dim=(0, 2, 3, 4)))
        mod.running_var.copy_(x.var(dim=(0, 2, 3, 4)))

    hooks = [m.register_forward_pre_hook(set_stats) for m in model.modules()
             if isinstance(m, TorchBatchNorm)]
    with torch.no_grad():
        model(calib)
    for h in hooks:
        h.remove()
    return model


def phase_slice(torch, pth: str):
    from bcp_tpu_torch.cli.common import load_eval_model
    from bcp_tpu_torch.config import la_config
    from bcp_tpu_torch.data.synthetic import la_cases
    from bcp_tpu_torch.eval.sliding_window import SlidingWindowEvaluator
    cfg = la_config(compute_dtype="float32")
    image, _ = la_cases(1, PATCH, seed=SEED + 1)[0]
    scores = {}
    for dev in (DEVICE, "cpu"):
        model = load_eval_model(cfg, pth, device=dev)
        ev = SlidingWindowEvaluator(model, PATCH, 2, 18, 4, batch=1,
                                    device=dev)
        t0 = time.perf_counter()
        scores[dev] = ev.infer(image)[1]
        print(f"f32 slice on {dev}: {time.perf_counter() - t0:.3f} s",
              flush=True)
    err = float(np.abs(scores[DEVICE] - scores["cpu"]).max())
    print(f"f32 slice card vs cpu: max |score diff| {err:.3g}", flush=True)
    if not np.isfinite(scores[DEVICE]).all() or err > 1e-3:
        fail(f"f32 slice on the card differs from the CPU by {err}")
    return err


def device_profile(torch, fn, trace_path: str, top: int = 12):
    """Kernel time by name, device busy time and idle share of one call of
    ``fn`` under ``torch.profiler`` (None when the trace holds no device
    activity). Only device activity is traced, and the spans are read from
    the exported Chrome trace rather than ``prof.events()``, which builds a
    Python object per event and takes minutes on a long trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        trace = json.load(f)
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"])
             for e in trace.get("traceEvents", [])
             if e.get("ph") == "X"
             and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not spans:
        return None
    by_name = {}
    for start, end, name in spans:
        ms, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, calls + 1)
    busy, cur_start, cur_end = 0.0, None, None
    for start, end, _ in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy = (busy + cur_end - cur_start) / 1e3
    window = (max(e for _, e, _ in spans) - min(s for s, _, _ in spans)) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"busy_ms": busy, "window_ms": window,
            "idle_share": 1.0 - busy / window,
            "kernel_ms": sum(ms for ms, _ in by_name.values()),
            "top": [{"name": n[:90], "ms": ms, "calls": c}
                    for n, (ms, c) in ranked[:top]]}


def phase_main_path(torch, pth: str, workdir: str):
    from bcp_tpu_torch.cli import test_la
    from bcp_tpu_torch.data.datasets import VolumeList
    from bcp_tpu_torch.data.synthetic import la_cases
    from bcp_tpu_torch.eval.sliding_window import window_starts
    from bcp_tpu_torch.ops.conv3d import conv3x3x3_same
    from bcp_tpu_torch.ops.scatter import scatter_add_windows
    cases = la_cases(2, LA_VOLUME, seed=SEED + 2)
    args = test_la.build_parser().parse_args(
        ["--torch_ckpt", pth, "--snapshot_root", workdir, "--root_path",
         workdir, "--stride_xy", "18", "--stride_z", "4", "--eval_batch",
         str(EVAL_BATCH), "--nms", "1", "--device", DEVICE,
         "--patch_size", *map(str, PATCH)])
    n_win = len(window_starts(LA_VOLUME, PATCH, 18, 4))
    chunks = -(-n_win // EVAL_BATCH)

    scatter_add_windows.launches = 0
    conv3x3x3_same.launches = 0
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        avg = test_la.test_calculate_metric(args, dataset=VolumeList(cases))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"scatter_add_windows": scatter_add_windows.launches,
                "conv3x3x3_same": conv3x3x3_same.launches}
    print(out.getvalue(), end="")
    want = {"scatter_add_windows": 2 * chunks,
            "conv3x3x3_same": 2 * chunks * sum(n for _, n in CONV_STAGES)}
    print(f"main path launches {launches} (expected {want})", flush=True)
    if launches != want:
        fail(f"main path launches {launches}, expected {want}")
    rows = re.findall(r"^\d\d,\t(\S+), (\S+), (\S+), (\S+)$", out.getvalue(),
                      re.M)
    vals = np.array(rows, dtype=np.float64)
    if vals.shape != (2, 4) or not np.isfinite(vals).all() \
            or not np.isfinite(avg).all():
        fail(f"expected 2 case lines of 4 finite metrics, got {rows}")

    # steady state, and the score map's check, on the same evaluator path
    _, evaluator = test_la.build_evaluator(args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = list(evaluator.infer_cases(img for img, _ in cases))
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    _, score = evaluator.infer(cases[0][0])
    sums = score.sum(axis=0)
    if score.shape != (2, *LA_VOLUME) or len(preds) != 2 \
            or not np.isfinite(score).all() \
            or np.abs(sums - 1.0).max() > 1e-2:
        fail(f"score map: shape {score.shape}, max |sum - 1| "
             f"{np.abs(sums - 1.0).max()}")
    # where one volume's device time goes
    prof = device_profile(torch, lambda: evaluator.infer(
        cases[1][0], return_score=False), os.path.join(workdir, "trace.json"))
    print("main path profile, one volume: " + (
        json.dumps(prof) if prof else "no device activity in the trace "
        "(not measured)"), flush=True)
    result = {"volumes": 2, "windows_per_volume": n_win,
              "cli_s": wall, "cli_windows_per_s": 2 * n_win / wall,
              "cli_s_per_volume": wall / 2,
              "steady_s_per_volume": steady / 2,
              "steady_windows_per_s": 2 * n_win / steady,
              "max_abs_prob_sum_err": float(np.abs(sums - 1.0).max()),
              "average_metric": [float(v) for v in avg]}
    print("main path: " + json.dumps(result), flush=True)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    import bcp_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from bcp_tpu_torch import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    card, rates = peaks(name)
    print(f"card: {smi} ({card} peaks: {rates[0] / 1e12:.0f} TFLOP/s bf16, "
          f"{rates[1] / 1e12:.0f} TFLOP/s f32, {rates[2] / 1e12:.2f} TB/s)")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"kernels built in {kernels.build_all():.2f} s", flush=True)

    entries = phase_kernels(torch, rates)
    # scratch inside the checkout (git-ignored), removed on the way out
    work_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "_work")
    os.makedirs(work_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work_root) as workdir:
        pth = os.path.join(workdir, "VNet_best_model.pth")
        torch.save(seeded_vnet(torch, DEVICE, SEED).state_dict(), pth)
        phase_slice(torch, pth)
        launches = phase_main_path(torch, pth, workdir)
    for e in entries:
        e["launches"] = launches[e["name"]]
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
