#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bcp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no final line):

1. the card's name and power limit, torch/CUDA versions, and the build of
   every hand-written kernel from ``bcp_tpu_torch/kernels/csrc`` (one nvcc
   per source, in parallel);
2. each kernel against its plain PyTorch version on the card at the main
   path's shapes. Kernel A, the overlap-add, on LA chunks (8 windows of
   112x112x80x2 into a 240x200x96x2 score map): its probs entry bit for
   bit against the in-order loop, its fused entry (softmax over the
   classes, then the overlap-add of the real windows) to max|kernel -
   plain| <= 1e-6 max|plain| against ``torch.softmax`` then the loop on
   the grid's first and last chunk, both the same bits on a second run;
   each timed with a cold L2 (CUDA events after a 512 MB read) and a warm
   one (a CUDA graph), at vector widths 4 and 2, beside its bound, its
   plain version, ``index_add_`` and the chain the fused entry replaced
   (softmax, valid mask, copy, probs entry). The 3^3 conv at the five
   V-Net stage shapes at batch 8 and batch 4, f32 to rtol = atol = 1e-4 and
   bf16 to max|kernel - plain| <= 1e-2 max|plain|, bit-identical over two
   runs, with the variant (box, N tile, warpgroups, stages, weights staged
   once or streamed, K split, grid) its wrapper picks for the shape; with
   CUDA-event times (median of >= 10) of the kernel, the plain version and,
   for the conv, ``F.conv3d``.
   Then the conv's backward at the same five stage shapes at batch 4 (the
   self-train student's concat batch), bf16 and f32: kernel C (dW) to
   max|kernel - plain| <= 1e-3 max|plain| (the same exact products summed
   in f32 in another order) and bit-identical over two runs; kernel B as
   dx with the forward's limits and bit-identical over two runs;
   ``Conv3x3x3Function``'s (dx, dW) against autograd through the plain
   conv (f32 1e-3, bf16 1e-2 of max|plain|);
   CUDA-event times of C, B-as-dx, their plain versions and
   ``torch.nn.grad.conv3d_weight`` / ``conv3d_input``, and C and
   ``conv3d_weight`` on the device alone (CUDA graphs) with the variant C's
   wrapper picks. At the same shapes
   kernel D (dx and dW in one launch): dx to B's limits, dW to C's,
   bit-identical over two runs, timed beside B-as-dx followed by C,
   beside its plain version and beside the two library calls
   ``conv3d_input`` + ``conv3d_weight`` together, and D and B-as-dx then C
   on the device alone (CUDA graphs), with the variant D's wrapper picks;
3. the whole slice in f32 on the card against the same slice on the CPU:
   the full-width V-Net (n_filters 16, seeded weights, saved as a
   reference-layout .pth) through the evaluator on one 112x112x80 volume,
   score maps to atol 1e-3. Then one pre-train and one self-train update
   in f32 (n_filters 16 at 32^3), card against CPU: the update of every
   student and teacher tensor and every momentum buffer within 0.15 of
   its module's largest update, once with the unfused backward and once
   with ``fused_bwd=True`` on the card (``phase_train_step``);
4. the inference path: ``bcp_tpu_torch.cli.test_la``'s core function at full
   width on two synthetic 240x200x96 LA volumes (270 windows each), stride
   18/4, eval batch 8, bf16, NMS on, from that .pth, with every kernel's
   launch count reset before and read after; two case lines of four finite
   metrics, and class probabilities of the cropped score map summing to
   1 +- 1e-2 per voxel. Every chunk takes kernel A's fused entry (no
   launch of its probs entry). Then the steady-state time of the same
   evaluator over both volumes, and a ``torch.profiler`` trace of one
   volume: device time by kernel name, busy time and idle share, one
   fused overlap-add a chunk (its device ms a launch) and no softmax
   kernel;
5. the training path: ``bcp_tpu_torch.cli.train_la``'s core function at
   full width (V-Net n_filters 16, 112x112x80 patches, batch 8 with
   labeled_bs 4, bf16, NMS on) on 8 synthetic 140x140x90 train volumes
   (labelnum 4) and one 240x200x96 validation volume, with the CLI's
   defaults (training volumes in the device store, validation on the
   background workers through kernel A's fused entry, ``fused_bwd`` off):
   15 pre-train iterations and a
   validation that writes the stage's best .pth, then 15 self-train
   iterations from it. Launch counts reset before and read after, finite
   losses, both .pth files loading strictly into the eval model. Inside
   the trainer's own loop (its ``on_step`` hook): the steady ms/step and
   patches/s of both stages over iterations 4-13, their launches, and
   ``torch.profiler`` traces of step 14 on the device and step 15 on the
   host (``phase_training``). Then the fused-backward path
   (``phase_training_fused``): a second self-train stage from the same
   pre-train checkpoint with ``--fused_bwd 1`` in a snapshot root of its
   own, timed and traced the same way (20 launches of kernel D a step, none
   of B-as-dx or C), ``--resume --self_max_iteration 18`` on that
   stage, which must go on from step 15 to step 18, and the unfused
   self-train stage once more (unfused, fused, unfused in one process:
   the spread of the host beside the difference).

Each path's launch counts are set to 0 just before it runs and read just
after. It then prints the kernels' JSON line, the nvidia-smi line, and last
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
# the self-train student's concat batch (two mixed sub-batches of 2), at
# which the backward kernels run
TRAIN_CONCAT = 4
# the f32 train step compared with the CPU, and its limit on each update
# relative to the largest update in the tensor's module (see
# phase_train_step: f32 noise reaches 5.5 %, a fault 100 %)
STEP_PATCH = (32, 32, 32)
STEP_REL = 0.15
# the training main path: synthetic LA train volumes, and the iterations
# of each stage: warm-up, timed, then traced
TRAIN_VOLUME = (140, 140, 90)
TRAIN_VOLUMES = 8
WARMUP_STEPS = 3
STEADY_STEPS = 10
# a step after the timed ones traced on the device, one on the host
STAGE_ITERS = WARMUP_STEPS + STEADY_STEPS + 2
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


def device_ms(torch, fn, n: int = 20) -> float:
    """Device time of one call of ``fn``: ``n`` calls captured in a CUDA
    graph, replayed (median of 7), so that the host's launch path does not
    show."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms = cuda_ms(torch, graph.replay, 7) / n
    del graph
    return ms


def cold_ms(torch, fn, flush, n: int = 20) -> float:
    """Median CUDA-event time of ``fn`` after a read of ``flush`` (larger
    than the L2) has emptied the L2 of ``fn``'s data, as an evaluator
    chunk finds it after the net's forward. The read also hides the host's
    launch path of a single launch: it is queued before the card gets to
    it."""
    times = []
    for _ in range(n + 1):
        flush.sum()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times[1:]))


def phase_overlap_add(torch, rates, workdir: str):
    """Kernel A's two entries on LA chunks (8 windows of 112x112x80x2 into
    a 240x200x96x2 score map): the probs entry bit for bit against the
    in-order loop on the grid's first chunk; the fused entry against
    ``torch.softmax`` then the loop, to max|kernel - plain| <= 1e-6
    max|plain|, on the first chunk and on the last, whose padded windows
    it does not read; both the same bits on a second run. Times on the
    first chunk with a cold L2 (:func:`cold_ms`) and a warm one (the same
    launch 20 times in a CUDA graph, :func:`device_ms`), beside the bound,
    the plain versions, the ``index_add_`` yardstick (its flat index built
    outside the timing) and the chain the fused entry replaced in the
    evaluator (``torch.softmax`` over the classes of the net's
    channels_last_3d logits, the valid-mask multiply, the permuted copy,
    the probs entry), with the device kernels of one chain and of one
    fused launch from ``torch.profiler``; and both entries at vector width
    2, on the first chunk of a 240x200x97 grid, whose odd last z start
    halves the vectors."""
    from bcp_tpu_torch import kernels
    from bcp_tpu_torch.eval.sliding_window import window_starts
    from bcp_tpu_torch.ops.scatter import (
        scatter_add_windows, scatter_add_windows_reference,
        softmax_scatter_add_windows, softmax_scatter_add_windows_reference)
    _, f32_peak, hbm = rates
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, C = EVAL_BATCH, 2
    grid = window_starts(LA_VOLUME, PATCH, 18, 4)
    n_last = len(grid) - (len(grid) - 1) // B * B
    first = grid[:B]
    last = np.concatenate([grid[len(grid) - n_last:],
                           np.zeros((B - n_last, 3), np.int32)])
    score = torch.rand((*LA_VOLUME, C), generator=gen, device=dev)
    probs = torch.rand((B, *PATCH, C), generator=gen, device=dev)
    logits = 4 * torch.randn((B, *PATCH, C), generator=gen, device=dev)

    got = scatter_add_windows(score.clone(), probs, first)
    again = scatter_add_windows(score.clone(), probs, first)
    want = scatter_add_windows_reference(score.clone(), probs, first)
    torch.cuda.synchronize()
    probs_err = float((got - want).abs().max().item())
    if not (torch.equal(got, want) and torch.equal(got, again)):
        fail(f"overlap-add probs entry differs from the in-order loop (max "
             f"err {probs_err}) or between two runs")
    checks = {}
    for tag, st, n in (("first", first, B), ("last", last, n_last)):
        got = softmax_scatter_add_windows(score.clone(), logits, st, n)
        again = softmax_scatter_add_windows(score.clone(), logits, st, n)
        want = softmax_scatter_add_windows_reference(score.clone(), logits,
                                                     st, n)
        torch.cuda.synchronize()
        err = float((got - want).abs().max().item())
        pmax = float(want.abs().max().item())
        checks[tag] = {"n_valid": n, "max_abs_err": err,
                       "bit_exact": bool(torch.equal(got, want))}
        if not torch.equal(got, again):
            fail(f"overlap-add fused entry, {tag} chunk: two runs differ")
        if err > 1e-6 * pmax:
            fail(f"overlap-add fused entry, {tag} chunk: max err {err} > "
                 f"1e-6 * {pmax}")
    del got, again, want

    # the bound: each window's probs or logits read once, each covered
    # score element read and written once; one add per probs element, and
    # for the fused entry five f32 operations more a logit (max, subtract,
    # exp, sum, divide)
    covered = np.zeros(LA_VOLUME, bool)
    for sx, sy, sz in first:
        covered[sx:sx + PATCH[0], sy:sy + PATCH[1], sz:sz + PATCH[2]] = True
    nbytes = probs.numel() * 4 + 2 * int(covered.sum()) * C * 4

    def bound(ops):
        return (max(nbytes / hbm, ops / f32_peak) * 1e3,
                "bytes" if nbytes / hbm >= ops / f32_peak else "operations")

    # index_add_ into the flattened map, the index built once here
    st = torch.from_numpy(first).to(dev).long()
    ax = [torch.arange(p, device=dev) for p in PATCH]
    flat = ((st[:, 0, None, None, None] + ax[0][None, :, None, None])
            * LA_VOLUME[1] + st[:, 1, None, None, None]
            + ax[1][None, None, :, None]) * LA_VOLUME[2] \
        + st[:, 2, None, None, None] + ax[2][None, None, None, :]
    idx = (flat[..., None] * C + torch.arange(C, device=dev)).reshape(-1)
    del flat
    lib = score.clone().view(-1).index_add_(0, idx, probs.view(-1))
    if not torch.allclose(lib.view(score.shape), scatter_add_windows_reference(
            score.clone(), probs, first), rtol=1e-6, atol=1e-6):
        fail("the index_add_ yardstick computes another function")
    del lib
    valid = torch.ones(B, device=dev)
    logits_cl = logits.permute(0, 4, 1, 2, 3)    # as the net gives them
    work = score.clone()

    def chain():
        p = torch.softmax(logits_cl, dim=1) * valid.view(-1, 1, 1, 1, 1)
        scatter_add_windows(work, p.permute(0, 2, 3, 4, 1).contiguous(),
                            first)

    fns = {"probs": lambda: scatter_add_windows(work, probs, first),
           "fused": lambda: softmax_scatter_add_windows(work, logits, first,
                                                        B),
           "index_add": lambda: work.view(-1).index_add_(0, idx,
                                                         probs.view(-1)),
           "chain": chain}
    # vector width 2: the 240x200x97 grid's first chunk (z starts 0..17)
    vol2 = (*LA_VOLUME[:2], LA_VOLUME[2] + 1)
    first2 = window_starts(vol2, PATCH, 18, 4)[:B]
    work2 = torch.rand((*vol2, C), generator=gen, device=dev)
    vec = kernels.library("scatter_add").overlap_add_vector_width(
        work2.data_ptr(), logits.data_ptr(), first2.ctypes.data, B,
        vol2[2], C, PATCH[2])
    if vec != 2:
        fail(f"the {vol2} grid's first chunk takes width {vec}, not 2")
    fns["probs_w2"] = lambda: scatter_add_windows(work2, probs, first2)
    fns["fused_w2"] = lambda: softmax_scatter_add_windows(work2, logits,
                                                          first2, B)
    flush = torch.zeros(128 << 20, device=dev)      # 512 MB, 10x the L2
    t = {k: (cold_ms(torch, fn, flush), device_ms(torch, fn))
         for k, fn in fns.items()}
    t["probs_plain"] = cold_ms(torch, lambda: scatter_add_windows_reference(
        work, probs, first), flush)
    t["fused_plain"] = cold_ms(
        torch, lambda: softmax_scatter_add_windows_reference(work, logits,
                                                             first, B),
        flush)
    kernels_of = {k: device_profile(torch, fns[k], os.path.join(
        workdir, f"overlap_add_{k}.json")) for k in ("chain", "fused")}
    print("kernel A, device kernels of one call: " + json.dumps(
        {k: v and [(e["name"][:60], e["calls"]) for e in v["top"]]
         for k, v in kernels_of.items()}), flush=True)
    del idx, work, work2, score, probs, logits, logits_cl, flush

    base = {"route": "cuda",
            "source": "bcp_tpu_torch/kernels/csrc/scatter_add.cu",
            "replaces": "bcp_tpu/ops/scatter.py:79",
            "per": f"one launch: {B} windows of {'x'.join(map(str, PATCH))}"
                   f"x{C} into {'x'.join(map(str, LA_VOLUME))}x{C}"}
    probs_bound = bound(B * int(np.prod(PATCH)) * C)
    fused_bound = bound(6 * B * int(np.prod(PATCH)) * C)
    # ms: cold L2 (events after a 512 MB read); warm_l2_device_ms: the
    # same launch 20 times in a CUDA graph
    entries = [
        dict(base, name="scatter_add_windows", max_abs_err=probs_err,
             ms=t["probs"][0], warm_l2_device_ms=t["probs"][1],
             width2_ms=t["probs_w2"][0],
             width2_warm_l2_device_ms=t["probs_w2"][1],
             plain_ms=t["probs_plain"], bound_ms=probs_bound[0],
             bound_by=probs_bound[1], library_ms=t["index_add"][0],
             library_warm_l2_device_ms=t["index_add"][1],
             library="score.view(-1).index_add_(0, idx, probs.view(-1))",
             on_main_path=False),
        dict(base, name="softmax_scatter_add_windows",
             max_abs_err=max(c["max_abs_err"] for c in checks.values()),
             checks=checks, ms=t["fused"][0],
             warm_l2_device_ms=t["fused"][1], width2_ms=t["fused_w2"][0],
             width2_warm_l2_device_ms=t["fused_w2"][1],
             plain_ms=t["fused_plain"], bound_ms=fused_bound[0],
             bound_by=fused_bound[1], library_ms=None,
             index_add_ms=t["index_add"][0],
             index_add_warm_l2_device_ms=t["index_add"][1],
             chain_ms=t["chain"][0], chain_warm_l2_device_ms=t["chain"][1],
             chain="torch.softmax(dim=1) * valid, permuted copy, "
                   "scatter_add_windows")]
    for e in entries:
        print(f"kernel A {e['name']}, ms with a cold / warm L2: "
              f"{e['ms']:.4f} / {e['warm_l2_device_ms']:.4f}, at width 2 "
              f"{e['width2_ms']:.4f} / {e['width2_warm_l2_device_ms']:.4f} "
              f"(plain {e['plain_ms']:.4f}, bound {e['bound_ms']:.4f}, "
              f"index_add_ {t['index_add'][0]:.4f} / "
              f"{t['index_add'][1]:.4f}, the chain {t['chain'][0]:.4f} / "
              f"{t['chain'][1]:.4f})", flush=True)
    print(f"kernel A fused entry against torch.softmax then the loop: "
          f"{json.dumps(checks)}", flush=True)
    return entries


def phase_kernels(torch, rates):
    import torch.nn.functional as F
    from bcp_tpu_torch.ops.conv3d import (conv_variant, conv3x3x3_same,
                                          conv3x3x3_same_reference)
    bf16_peak, f32_peak, hbm = rates
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # -- B: 3^3 conv at the five stage shapes, bf16 and f32, at batch 8 (the
    # evaluator's chunk and the student's forward) and batch 4 (the
    # teacher's forward and the pre-train step)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def conv_rows(batch):
        rows = []
        for (c, X, Y, Z), per_forward in CONV_STAGES:
            row = {"shape": f"{batch}x{c}@{X}x{Y}x{Z}",
                   "per_forward": per_forward,
                   "variant": conv_variant(batch, X, Y, Z, c, c,
                                           sms)._asdict()}
            M = batch * X * Y * Z
            for dt, name in ((torch.float32, "f32"),
                             (torch.bfloat16, "bf16")):
                x = torch.randn((batch, c, X, Y, Z), generator=gen,
                                device=dev).to(dt).contiguous(
                    memory_format=torch.channels_last_3d)
                w = (torch.randn((c, c, 3, 3, 3), generator=gen, device=dev)
                     / (27 * c) ** 0.5).to(dt)
                k = conv3x3x3_same(x, w)
                k2 = conv3x3x3_same(x, w)
                p = conv3x3x3_same_reference(x, w)
                torch.cuda.synchronize()
                if not torch.equal(k, k2):
                    fail(f"conv {name} {row['shape']}: two runs differ")
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
                row[f"{name}_ms"] = cuda_ms(torch,
                                            lambda: conv3x3x3_same(x, w))
                row[f"{name}_plain_ms"] = cuda_ms(
                    torch, lambda: conv3x3x3_same_reference(x, w))
                row[f"{name}_library_ms"] = cuda_ms(
                    torch, lambda: F.conv3d(x, w, padding=1))
                row[f"{name}_bound_ms"] = max(flop / peak,
                                              nbytes / hbm) * 1e3
                row[f"{name}_bound_by"] = ("operations" if flop / peak
                                           >= nbytes / hbm else "bytes")
                del x, w, k, k2, p
            rows.append(row)
            v = row["variant"]
            print(f"kernel B conv3x3x3 {row['shape']}: bf16 "
                  f"{row['bf16_ms']:.4f} ms (F.conv3d "
                  f"{row['bf16_library_ms']:.4f}, plain "
                  f"{row['bf16_plain_ms']:.3f}, bound "
                  f"{row['bf16_bound_ms']:.4f}, err "
                  f"{row['bf16_max_abs_err']:.3g}); f32 {row['f32_ms']:.4f} "
                  f"ms (err {row['f32_max_abs_err']:.3g}); variant box "
                  f"8x8x{v['tiles']}, N tile {v['bn']}, "
                  f"{v['warpgroups']} warpgroup(s), {v['stages']} stages, "
                  f"weights {'once per CTA' if v['persist_w'] else 'streamed'}"
                  f", K split {v['ksplit']}, grid {v['grid_x']} x "
                  f"{c // v['bn'] * v['ksplit']}", flush=True)
        return rows

    shapes = conv_rows(EVAL_BATCH)
    shapes_batch4 = conv_rows(TRAIN_CONCAT)
    for what, rows in (("8", shapes), ("4", shapes_batch4)):
        ms, lib, bound = (sum(r[key] * r["per_forward"] for r in rows)
                          for key in ("bf16_ms", "bf16_library_ms",
                                      "bf16_bound_ms"))
        print(f"kernel B over the 20 bf16 launches of a batch-{what} forward: "
              f"{ms:.4f} ms (F.conv3d {lib:.4f}, bound {bound:.4f})",
              flush=True)

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
        "shapes_batch4": shapes_batch4,
    }
    return [conv]


def phase_backward_kernels(torch, rates):
    """Kernel B as the conv's dx and kernel C (dW) at the five stage shapes
    of the self-train student's batch-4 backward, bf16 and f32."""
    from torch.nn.grad import conv3d_input, conv3d_weight
    from bcp_tpu_torch.ops.conv3d import (Conv3x3x3Function, conv3x3x3_dw,
                                          conv3x3x3_dw_reference,
                                          conv3x3x3_dx, conv3x3x3_dxdw,
                                          conv3x3x3_dxdw_reference,
                                          conv3x3x3_same_reference,
                                          dw_variant, dxdw_variant,
                                          flip_transpose)
    bf16_peak, f32_peak, hbm = rates
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    B = TRAIN_CONCAT
    rows = []
    for (c, X, Y, Z), per_backward in CONV_STAGES:
        row = {"shape": f"{B}x{c}@{X}x{Y}x{Z}", "per_backward": per_backward}
        M = B * X * Y * Z
        for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            def rand(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(dt)
            x = rand(B, c, X, Y, Z).contiguous(
                memory_format=torch.channels_last_3d)
            dy = rand(B, c, X, Y, Z).contiguous(
                memory_format=torch.channels_last_3d)
            w = (rand(c, c, 3, 3, 3) / (27 * c) ** 0.5).to(dt)
            # C: f32 sums of exact products in another order than the plain
            # version's; the same bits on a second run (no float atomics)
            k = conv3x3x3_dw(x, dy)
            k2 = conv3x3x3_dw(x, dy)
            p = conv3x3x3_dw_reference(x, dy)
            torch.cuda.synchronize()
            err = float((k - p).abs().max().item())
            pmax = float(p.abs().max().item())
            if not torch.equal(k, k2):
                fail(f"dW kernel {row['shape']} {name}: two runs differ")
            if err > 1e-3 * pmax:
                fail(f"dW kernel {row['shape']} {name}: max err {err} > "
                     f"1e-3 * {pmax}")
            row[f"{name}_dw_max_abs_err"] = err
            # B as dx: the forward kernel's limits
            kx = conv3x3x3_dx(dy, w)
            kx2 = conv3x3x3_dx(dy, w)
            px = conv3x3x3_same_reference(dy, flip_transpose(w))
            torch.cuda.synchronize()
            if not torch.equal(kx, kx2):
                fail(f"dx kernel {row['shape']} {name}: two runs differ")
            xerr = float((kx.float() - px.float()).abs().max().item())
            xmax = float(px.float().abs().max().item())
            if (dt == torch.float32 and not torch.allclose(
                    kx, px, rtol=1e-4, atol=1e-4)) or xerr > 1e-2 * xmax:
                fail(f"dx kernel {row['shape']} {name}: max err {xerr}")
            row[f"{name}_dx_max_abs_err"] = xerr
            # D: dx to B's limits, dW to C's, the same bits on a second run
            ddx, ddw = conv3x3x3_dxdw(x, dy, w)
            ddx2, ddw2 = conv3x3x3_dxdw(x, dy, w)
            torch.cuda.synchronize()
            if not (torch.equal(ddx, ddx2) and torch.equal(ddw, ddw2)):
                fail(f"dxdw kernel {row['shape']} {name}: two runs differ")
            dxerr = float((ddx.float() - px.float()).abs().max().item())
            dwerr = float((ddw - p).abs().max().item())
            if ddx.dtype != dt or (dt == torch.float32 and not torch.allclose(
                    ddx, px, rtol=1e-4, atol=1e-4)) or dxerr > 1e-2 * xmax:
                fail(f"dxdw kernel {row['shape']} {name}: dx max err "
                     f"{dxerr}")
            if ddw.dtype != torch.float32 or dwerr > 1e-3 * pmax:
                fail(f"dxdw kernel {row['shape']} {name}: dW max err "
                     f"{dwerr} > 1e-3 * {pmax}")
            row[f"{name}_dxdw_dx_max_abs_err"] = dxerr
            row[f"{name}_dxdw_dw_max_abs_err"] = dwerr
            row[f"{name}_dxdw_max_abs_err"] = max(dxerr, dwerr)
            del k, k2, p, kx, kx2, px, ddx, ddx2, ddw, ddw2
            # the Function's (dx, dW) against autograd through the plain
            # conv: f32 within 1e-3 max|plain| (sums in another order),
            # bf16 within 1e-2 max|plain| (one bf16 rounding of each)
            xg = x.detach().requires_grad_()
            wg = w.detach().requires_grad_()
            got = torch.autograd.grad(Conv3x3x3Function.apply(xg, wg),
                                      (xg, wg), dy)
            want = torch.autograd.grad(conv3x3x3_same_reference(xg, wg),
                                       (xg, wg), dy)
            torch.cuda.synchronize()
            tol = 1e-3 if dt == torch.float32 else 1e-2
            for what, g, q in zip(("dx", "dW"), got, want):
                e = float((g.float() - q.float()).abs().max().item())
                if g.dtype != dt or e > tol * q.float().abs().max().item():
                    fail(f"Conv3x3x3Function {what} {row['shape']} {name}: "
                         f"max err {e}")
            del xg, wg, got, want
            peak = bf16_peak if dt == torch.bfloat16 else f32_peak
            es = x.element_size()
            for kind, nbytes, fn, plain, lib in (
                    ("dw", 2 * M * c * es + 27 * c * c * 4,
                     lambda: conv3x3x3_dw(x, dy),
                     lambda: conv3x3x3_dw_reference(x, dy),
                     lambda: conv3d_weight(x, w.shape, dy, padding=1)),
                    ("dx", (2 * M * c + 27 * c * c) * es,
                     lambda: conv3x3x3_dx(dy, w),
                     lambda: conv3x3x3_same_reference(dy, flip_transpose(w)),
                     lambda: conv3d_input(x.shape, w, dy, padding=1)),
                    # D does both halves' operations and moves x, dy, w in
                    # and dx, dW out; its library time is the two calls
                    ("dxdw", (3 * M * c + 27 * c * c) * es + 27 * c * c * 4,
                     lambda: conv3x3x3_dxdw(x, dy, w),
                     lambda: conv3x3x3_dxdw_reference(x, dy, w),
                     lambda: (conv3d_input(x.shape, w, dy, padding=1),
                              conv3d_weight(x, w.shape, dy, padding=1)))):
                flop = (2 if kind == "dxdw" else 1) * 2 * M * 27 * c * c
                row[f"{name}_{kind}_ms"] = cuda_ms(torch, fn)
                row[f"{name}_{kind}_plain_ms"] = cuda_ms(torch, plain)
                row[f"{name}_{kind}_library_ms"] = cuda_ms(torch, lib)
                row[f"{name}_{kind}_bound_ms"] = max(flop / peak,
                                                     nbytes / hbm) * 1e3
                row[f"{name}_{kind}_bound_by"] = (
                    "operations" if flop / peak >= nbytes / hbm else "bytes")
            # what D replaces, back to back in this same process
            row[f"{name}_dx_then_dw_ms"] = cuda_ms(
                torch, lambda: (conv3x3x3_dx(dy, w), conv3x3x3_dw(x, dy)))
            if dt == torch.bfloat16:
                # C's and D's variants; C, conv3d_weight, D and B-as-dx
                # then C on the device alone (CUDA graphs)
                row["bf16_dw_variant"] = str(tuple(dw_variant(
                    B, X, Y, Z, c, c, sms)))
                row["bf16_dw_device_ms"] = device_ms(
                    torch, lambda: conv3x3x3_dw(x, dy))
                row["bf16_dw_library_device_ms"] = device_ms(
                    torch, lambda: conv3d_weight(x, w.shape, dy, padding=1))
                row["bf16_dxdw_variant"] = str(tuple(dxdw_variant(
                    B, X, Y, Z, c, sms)))
                row["bf16_dxdw_device_ms"] = device_ms(
                    torch, lambda: conv3x3x3_dxdw(x, dy, w))
                row["bf16_dx_then_dw_device_ms"] = device_ms(
                    torch, lambda: (conv3x3x3_dx(dy, w),
                                    conv3x3x3_dw(x, dy)))
            del x, dy, w
        rows.append(row)
        print(f"backward {row['shape']}: C bf16 {row['bf16_dw_ms']:.4f} ms "
              f"(device {row['bf16_dw_device_ms']:.4f}, variant "
              f"{row['bf16_dw_variant']}; conv3d_weight "
              f"{row['bf16_dw_library_ms']:.4f}, device "
              f"{row['bf16_dw_library_device_ms']:.4f}, plain "
              f"{row['bf16_dw_plain_ms']:.3f}, bound "
              f"{row['bf16_dw_bound_ms']:.4f}, err "
              f"{row['bf16_dw_max_abs_err']:.3g}), f32 "
              f"{row['f32_dw_ms']:.4f}; B-as-dx bf16 {row['bf16_dx_ms']:.4f} "
              f"ms (conv3d_input {row['bf16_dx_library_ms']:.4f}, plain "
              f"{row['bf16_dx_plain_ms']:.3f}, bound "
              f"{row['bf16_dx_bound_ms']:.4f}), f32 {row['f32_dx_ms']:.4f}"
              f"; D bf16 {row['bf16_dxdw_ms']:.4f} ms, device "
              f"{row['bf16_dxdw_device_ms']:.4f}, variant "
              f"{row['bf16_dxdw_variant']} (B-as-dx then C "
              f"{row['bf16_dx_then_dw_ms']:.4f}, device "
              f"{row['bf16_dx_then_dw_device_ms']:.4f}, conv3d_input + "
              f"conv3d_weight {row['bf16_dxdw_library_ms']:.4f}, plain "
              f"{row['bf16_dxdw_plain_ms']:.3f}, bound "
              f"{row['bf16_dxdw_bound_ms']:.4f}, err dx "
              f"{row['bf16_dxdw_dx_max_abs_err']:.3g} dW "
              f"{row['bf16_dxdw_dw_max_abs_err']:.3g}), f32 "
              f"{row['f32_dxdw_ms']:.4f} (B-as-dx then C "
              f"{row['f32_dx_then_dw_ms']:.4f})", flush=True)

    def entry(kind, name, source, replaces, what):
        def total(key):
            return sum(r[f"bf16_{kind}_{key}"] * r["per_backward"]
                       for r in rows)
        ops = sum(r["per_backward"] * r[f"bf16_{kind}_bound_ms"]
                  for r in rows
                  if r[f"bf16_{kind}_bound_by"] == "operations")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "max_abs_err": max(r[f"bf16_{kind}_max_abs_err"]
                                   for r in rows),
                "ms": total("ms"), "plain_ms": total("plain_ms"),
                "bound_ms": total("bound_ms"),
                "bound_by": "operations" if ops >= total("bound_ms") / 2
                else "bytes",
                "library_ms": total("library_ms"),
                "per": f"the 20 bf16 launches of {what} of one self-train "
                       f"step (batch {B})",
                "shapes": [{k: v for k, v in r.items()
                            if k in ("shape", "per_backward")
                            or f"_{kind}_" in k} for r in rows]}
    fused = entry("dxdw", "conv3x3x3_dxdw",
                  "bcp_tpu_torch/kernels/csrc/conv3x3x3_dxdw.cu",
                  "bcp_tpu/ops/conv3d.py:448", "dx and dW together")
    fused["library"] = "conv3d_input + conv3d_weight, two calls"
    for key in ("dx_then_dw_ms", "dxdw_device_ms", "dx_then_dw_device_ms"):
        fused[key.replace("dxdw_", "")] = sum(
            r[f"bf16_{key}"] * r["per_backward"] for r in rows)
    for r, out in zip(rows, fused["shapes"]):
        for name in ("bf16", "f32"):
            out[f"{name}_dx_then_dw_ms"] = r[f"{name}_dx_then_dw_ms"]
        out["bf16_dx_then_dw_device_ms"] = r["bf16_dx_then_dw_device_ms"]
    dw = entry("dw", "conv3x3x3_dw",
               "bcp_tpu_torch/kernels/csrc/conv3x3x3_dw.cu",
               "bcp_tpu/ops/conv3d.py:323", "dW")
    for key in ("dw_device_ms", "dw_library_device_ms"):
        dw[key.replace("dw_", "")] = sum(
            r[f"bf16_{key}"] * r["per_backward"] for r in rows)
    print(f"kernel C over the 20 bf16 launches of a batch-{B} backward: "
          f"{dw['ms']:.4f} ms (conv3d_weight {dw['library_ms']:.4f}); on "
          f"the device {dw['device_ms']:.4f} (conv3d_weight "
          f"{dw['library_device_ms']:.4f}), bound {dw['bound_ms']:.4f}",
          flush=True)
    return [entry("dx", "conv3x3x3_dx",
                  "bcp_tpu_torch/kernels/csrc/conv3x3x3.cu",
                  "bcp_tpu/ops/conv3d.py:188", "dx"),
            dw, fused]


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


def phase_train_step(torch):
    """One pre-train and one self-train update in f32 on the card against
    the same updates on the CPU: V-Net n_filters 16 at a STEP_PATCH patch,
    the same seeded weights, batch, mask offsets and dropout keep masks.
    The self-train update runs on the CPU's pseudo-labels on both sides (a
    voxel at the 0.5 threshold may flip between the two; the count of
    flipped voxels is printed).

    Compared are the updates, not the weights: (after - start) of every
    student and teacher tensor (parameters, BN running statistics) and the
    SGD momentum buffers (start 0), each within STEP_REL of the largest
    |update| among its module's tensors of the same kind (parameters or
    running statistics), plus 4 f32 ulps of the tensor's start value
    (the after - start of an f32 weight is no finer). A module shares a
    scale because a bias in front of a BatchNorm has no gradient in exact
    arithmetic: its update is rounding noise. Against its module's scale,
    f32 noise is still a few percent in the deep layers, whose train-mode
    BatchNorm sees 16 values a channel at 32^3: the worst tensor of the
    card against the CPU is 5.5 % on an H100 (a transposed conv's weight
    in the self-train update). A zero or missing update of a module's
    weight, or a skipped EMA, is off by 100 % of that scale. An
    update that the CPU leaves exactly 0 (the teacher's BN statistics)
    must be 0 on the card too. Losses to 1e-4 relative.

    The card runs the two updates twice: with the unfused backward
    (kernel B as dx, kernel C) and with ``fused_bwd=True`` (kernel D),
    each held to the same limits against the one CPU run."""
    import copy
    from bcp_tpu_torch.config import la_config
    from bcp_tpu_torch.data.synthetic import la_cases
    from bcp_tpu_torch.ops.masks import cuboid_mask, cuboid_starts
    from bcp_tpu_torch.train.state import (TrainState, build_model,
                                           build_optimizer)
    from bcp_tpu_torch.train.steps import (pretrain_step, pseudo_labels,
                                           selftrain_update)
    cfg = la_config(n_filters=16, patch_size=STEP_PATCH,
                    compute_dtype="float32")
    cases = la_cases(8, STEP_PATCH, seed=SEED + 6)
    img = np.stack([c[0] for c in cases])[:, None]
    lab = np.stack([c[1] for c in cases])
    host = {"img_a": img[0:2], "img_b": img[2:4], "uimg_a": img[4:6],
            "uimg_b": img[6:8], "lab_a": lab[0:2], "lab_b": lab[2:4]}
    rng = np.random.default_rng(SEED + 7)
    starts = cuboid_starts(rng, STEP_PATCH)

    def keep(n):   # the two channel dropouts: 16 nf and nf channels
        return [rng.random((n, 256)) < 0.5, rng.random((n, 16)) < 0.5]
    keeps = {"pre": keep(2), "teacher": keep(4), "student": keep(4)}
    start = build_model(cfg, "train", "cpu", seed=SEED).state_dict()

    def run(dev, plab=None, fused=False):
        def state():
            m = build_model(cfg.replace(fused_bwd=fused), "train", dev)
            m.load_state_dict(start)
            t = copy.deepcopy(m)
            for p in t.parameters():
                p.requires_grad_(False)
            return TrainState(m, t, build_optimizer(cfg, m.parameters()))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        mask = cuboid_mask(STEP_PATCH, starts, device=dev)
        k = {n: [torch.from_numpy(a).to(dev) for a in v]
             for n, v in keeps.items()}
        pre = state()
        m_pre = pretrain_step(pre, batch, mask, cfg, dropout=k["pre"])
        st = state()
        own = pseudo_labels(st, batch, cfg, dropout=k["teacher"])
        plab = own if plab is None else plab.to(dev)
        m_self = selftrain_update(st, batch, plab, mask, cfg,
                                  dropout=k["student"])
        delta = {}
        for tag, mod in (("pre", pre.model), ("self", st.model),
                         ("teacher", st.teacher)):
            for n, v in mod.state_dict().items():
                if not n.endswith("num_batches_tracked"):
                    delta[f"{tag}.{n}"] = v.cpu().double() - start[n].double()
        for tag, s in (("pre", pre), ("self", st)):
            for n, p in s.model.named_parameters():
                delta[f"{tag}.momentum.{n}"] = s.optimizer.state[p][
                    "momentum_buffer"].cpu().double()
        losses = {f"pre.{n}": float(v) for n, v in m_pre.items()}
        losses.update({f"self.{n}": float(v) for n, v in m_self.items()})
        return delta, losses, own.cpu()

    t0 = time.perf_counter()
    want, want_loss, plab = run("cpu")
    t_cpu = time.perf_counter() - t0

    def group(n):   # (module, running statistics?)
        head, last = n.rsplit(".", 1)
        return head, last.startswith("running")
    scale = {}
    for n, d in want.items():
        g = group(n)
        scale[g] = max(scale.get(g, 0.0), d.abs().max().item())
    ulp = float(np.finfo(np.float32).eps)
    from bcp_tpu_torch.ops.conv3d import conv3x3x3_dxdw
    results = {}
    for fused in (False, True):
        before = conv3x3x3_dxdw.launches
        t0 = time.perf_counter()
        got, got_loss, card_plab = run(DEVICE, plab, fused)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        # the pre-train and the self-train backward: 20 convs each
        d_launches = conv3x3x3_dxdw.launches - before
        if d_launches != (40 if fused else 0):
            fail(f"f32 train step fused_bwd={fused}: {d_launches} launches "
                 f"of the fused backward kernel")
        results[fused] = _compare_step(
            torch, want, want_loss, got, got_loss, start, scale, ulp, group,
            {"fused_bwd": fused, "fused_kernel_launches": d_launches,
             "pseudo_label_flips": int((card_plab != plab).sum().item()),
             "pseudo_label_voxels": int(plab.sum().item()),
             "cpu_s": t_cpu, "card_s": t_card})
    return results


def _compare_step(torch, want, want_loss, got, got_loss, start, scale, ulp,
                  group, extra):
    """The card's updates ``got`` held against the CPU's ``want`` (see
    :func:`phase_train_step`)."""
    ratios, checked, zeroes = [], {}, {}
    for n, d in want.items():
        s = scale[group(n)]
        base = 0.0 if ".momentum." in n else \
            start[n.split(".", 1)[1]].abs().max().item()
        limit = STEP_REL * s + 4 * ulp * base if s > 0 else 0.0
        err = (got[n] - d).abs().max().item()
        ratios.append((err / limit if limit else
                       (0.0 if err == 0 else np.inf), n))
        kind = n.split(".")[0] + (".momentum" if ".momentum." in n else "")
        # would a zero update of this tensor fail the check?
        checked[kind] = checked.get(kind, 0) + int(
            d.abs().max().item() > limit)
        zeroes[kind] = zeroes.get(kind, 0) + 1
    lworst = max((abs(got_loss[n] - want_loss[n]) / max(abs(want_loss[n]),
                                                        1e-12), n)
                 for n in want_loss)
    ratios.sort(reverse=True)
    worst = ratios[0]
    moved = [v for v in scale.values() if v > 0]
    result = {"patch": list(STEP_PATCH), "tensors": len(want),
              "rel_limit": STEP_REL, "worst_err_over_limit": worst[0],
              "worst_tensor": worst[1],
              "next_worst": [[r, n] for r, n in ratios[1:4]],
              "smallest_module_update": min(moved),
              "largest_module_update": max(moved),
              "zero_update_would_fail": {k: f"{checked[k]} of {zeroes[k]}"
                                         for k in zeroes},
              "max_rel_loss_err": lworst[0], **extra}
    print("f32 train step card vs cpu: " + json.dumps(result), flush=True)
    if not all(np.isfinite(v) for v in got_loss.values()):
        fail(f"f32 train step: non-finite losses {got_loss}")
    if worst[0] > 1.0 or lworst[0] > 1e-4:
        fail(f"f32 train step on the card differs from the CPU: {result}")
    return result


def device_profile(torch, fn, trace_path: str):
    """:func:`device_summary` of one call of ``fn`` under
    ``torch.profiler``, device activity only."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)
    return device_summary(trace_path)


def device_summary(trace_path: str, top: int = 12):
    """Kernel time by name, device busy time and idle share of an exported
    ``torch.profiler`` trace (None when it holds no device activity). The
    spans are read from the Chrome trace rather than ``prof.events()``,
    which builds a Python object per event and takes minutes on a long
    trace."""
    spans = trace_spans(trace_path)
    if not spans:
        return None
    by_name = kernels_by_name(spans)
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
            "device_ops": len(spans),
            "top": [{"name": n[:90], "ms": ms, "calls": c}
                    for n, (ms, c) in ranked[:top]]}


def trace_spans(trace_path: str):
    """(start, end, name) of each device span of an exported trace."""
    with open(trace_path) as f:
        trace = json.load(f)
    return [(e["ts"], e["ts"] + e["dur"], e["name"])
            for e in trace.get("traceEvents", [])
            if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def kernels_by_name(spans):
    """name -> (device ms, calls) of the spans."""
    by_name = {}
    for start, end, name in spans:
        ms, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, calls + 1)
    return by_name


def host_summary(trace_path: str):
    """What the host spent in an exported trace of CPU and CUDA activity:
    CUDA runtime calls (kernel launches, synchronisations, their summed
    time) and the span of the traced CPU ops. Host tracing slows the host,
    so idle shares come from a device-only trace instead."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]
    api = [e for e in events if e.get("cat") == "cuda_runtime"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    if not ops:
        return None
    return {"kernel_launches": sum("LaunchKernel" in e["name"] for e in api),
            "synchronizations": sum("Synchronize" in e["name"]
                                    for e in api),
            "runtime_api_ms": sum(e["dur"] for e in api) / 1e3,
            "cpu_op_span_ms": (max(e["ts"] + e["dur"] for e in ops)
                               - min(e["ts"] for e in ops)) / 1e3}


def phase_main_path(torch, pth: str, workdir: str):
    from bcp_tpu_torch.cli import test_la
    from bcp_tpu_torch.data.datasets import VolumeList
    from bcp_tpu_torch.data.synthetic import la_cases
    from bcp_tpu_torch.eval.sliding_window import window_starts
    cases = la_cases(2, LA_VOLUME, seed=SEED + 2)
    args = test_la.build_parser().parse_args(
        ["--torch_ckpt", pth, "--snapshot_root", workdir, "--root_path",
         workdir, "--stride_xy", "18", "--stride_z", "4", "--eval_batch",
         str(EVAL_BATCH), "--nms", "1", "--device", DEVICE,
         "--patch_size", *map(str, PATCH)])
    n_win = len(window_starts(LA_VOLUME, PATCH, 18, 4))
    chunks = -(-n_win // EVAL_BATCH)

    counters = kernel_counters()
    read_launches(counters, reset=True)
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        avg = test_la.test_calculate_metric(args, dataset=VolumeList(cases))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(counters)
    print(out.getvalue(), end="")
    want = {"scatter_add_windows": 0,
            "softmax_scatter_add_windows": 2 * chunks,
            "conv3x3x3_same": 2 * chunks * sum(n for _, n in CONV_STAGES),
            "conv3x3x3_dx": 0, "conv3x3x3_dw": 0, "conv3x3x3_dxdw": 0}
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
    trace = os.path.join(workdir, "trace.json")
    prof = device_profile(torch, lambda: evaluator.infer(
        cases[1][0], return_score=False), trace)
    print("main path profile, one volume: " + (
        json.dumps(prof) if prof else "no device activity in the trace "
        "(not measured)"), flush=True)
    a_ms = None
    if prof:
        a_ms = check_chunk_epilogue(trace_spans(trace), chunks)
    result = {"volumes": 2, "windows_per_volume": n_win,
              "cli_s": wall, "cli_windows_per_s": 2 * n_win / wall,
              "cli_s_per_volume": wall / 2,
              "steady_s_per_volume": steady / 2,
              "steady_windows_per_s": 2 * n_win / steady,
              "max_abs_prob_sum_err": float(np.abs(sums - 1.0).max()),
              "average_metric": [float(v) for v in avg],
              "overlap_add_device_ms_per_launch": a_ms}
    print("main path: " + json.dumps(result), flush=True)
    return launches, a_ms


def check_chunk_epilogue(spans, chunks: int) -> float:
    """One volume's trace: one fused overlap-add a chunk and no softmax
    kernel; prints the elementwise and reduction kernels left, in calls a
    chunk (the net's, since the chunk's own passes went into A). Returns
    the overlap-add's device ms a launch in the evaluator."""
    by_name = kernels_by_name(spans)
    fused = sum(c for n, (_, c) in by_name.items()
                if "overlap_add_kernel" in n)
    fused_ms = sum(ms for n, (ms, _) in by_name.items()
                   if "overlap_add_kernel" in n)
    softmax = {n[:90]: c for n, (_, c) in by_name.items()
               if "softmax" in n.lower()}
    left = {n[:90]: [round(ms, 4), c / chunks]
            for n, (ms, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])
            if "elementwise" in n or "reduce" in n.lower()}
    print(f"chunk epilogue, one volume: {fused} overlap-add launches for "
          f"{chunks} chunks, {fused_ms / max(fused, 1):.4f} device ms a "
          f"launch; softmax kernels {softmax}; elementwise and "
          f"reduction kernels left [ms, calls a chunk]: {json.dumps(left)}",
          flush=True)
    if fused != chunks or softmax:
        fail(f"the trace of one volume holds {fused} overlap-add kernels "
             f"for {chunks} chunks and softmax kernels {softmax}")
    return fused_ms / fused


def kernel_counters():
    from bcp_tpu_torch.ops.conv3d import (conv3x3x3_dw, conv3x3x3_dx,
                                          conv3x3x3_dxdw, conv3x3x3_same)
    from bcp_tpu_torch.ops.scatter import (scatter_add_windows,
                                           softmax_scatter_add_windows)
    return {f.__name__: f for f in (scatter_add_windows,
                                    softmax_scatter_add_windows,
                                    conv3x3x3_same, conv3x3x3_dx,
                                    conv3x3x3_dw, conv3x3x3_dxdw)}


def read_launches(counters, reset: bool = False):
    out = {name: f.launches for name, f in counters.items()}
    if reset:
        for f in counters.values():
            f.launches = 0
    return out


class StepClock:
    """The trainer's ``on_step`` hook for the training main path. Per stage
    it keeps the time each iteration ends; over the STEADY_STEPS iterations
    after the WARMUP_STEPS first, the kernel launches and the peak device
    memory; then it traces the next iteration's device activity and the
    one after it on the host (CPU ops and CUDA runtime calls), each
    between two synchronisations, so each trace holds one whole step.
    One iteration before the timed ones it waits for the trainer's
    background jobs (the evaluator warm-up that each stage submits after
    its first step), so that the timed and traced steps, and their launch
    counts, hold the training loop alone."""

    def __init__(self, torch, counters, workdir: str, trainer):
        self.torch, self.counters, self.workdir = torch, counters, workdir
        self.trainer = trainer
        self.times, self.launches, self.peak_gib = {}, {}, {}
        self.traces = {}
        self._prof = None

    def __call__(self, stage: str, it: int) -> None:
        torch = self.torch
        self.times.setdefault(stage, []).append(time.perf_counter())
        timed_end = WARMUP_STEPS + STEADY_STEPS
        if it == WARMUP_STEPS - 1:
            self.trainer.wait_for_validations()
        elif it == WARMUP_STEPS:
            self.launches[stage] = read_launches(self.counters)
            torch.cuda.reset_peak_memory_stats()
        elif it == timed_end:
            now = read_launches(self.counters)
            self.launches[stage] = {k: v - self.launches[stage][k]
                                    for k, v in now.items()}
            self.peak_gib[stage] = torch.cuda.max_memory_allocated() / 2**30
            self._trace(stage, "device")
        elif it == timed_end + 1:
            self._trace(stage, "host")
        elif it == timed_end + 2:
            self._trace(stage, None)

    def _trace(self, stage: str, what):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        if self._prof is not None:
            prof, path = self._prof
            prof.stop()
            prof.export_chrome_trace(path)
            self._prof = None
        if what is not None:
            acts = [ProfilerActivity.CUDA] + (
                [ProfilerActivity.CPU] if what == "host" else [])
            path = os.path.join(self.workdir, f"{what}_{stage}.json")
            self.traces[(stage, what)] = path
            self._prof = (profile(activities=acts), path)
            self._prof[0].start()

    def steady(self, stage: str):
        """ms per step over the timed iterations, from the loop's own
        iteration ends (each waits for the step before it)."""
        t = self.times[stage]
        return (t[WARMUP_STEPS + STEADY_STEPS - 1] - t[WARMUP_STEPS - 1]) \
            / STEADY_STEPS * 1e3


def phase_training(torch, workdir: str):
    """The training main path: ``cli.train_la``'s core at full width on
    synthetic LA data (TRAIN_VOLUMES train volumes of TRAIN_VOLUME, the
    first 4 labelled, and one LA_VOLUME validation volume), STAGE_ITERS
    iterations a stage with a validation at the last, which writes the
    pre-train stage's best .pth that the self-train stage starts from.
    Timed and traced inside the trainer's own loop by ``StepClock``. The
    flags are the CLI's defaults: the training volumes in the device
    store, validation on the background workers (each stage's evaluator
    warm-up counts as a validation), ``fused_bwd`` off. Returns the
    path's launches and what the fused-backward path reuses."""
    from bcp_tpu_torch.cli import train_la
    from bcp_tpu_torch.data.datasets import VolumeList
    from bcp_tpu_torch.data.feed import BCPBatchFeeder
    from bcp_tpu_torch.data.synthetic import la_cases
    train = VolumeList(la_cases(TRAIN_VOLUMES, TRAIN_VOLUME, seed=SEED + 3))
    val = la_cases(1, LA_VOLUME, seed=SEED + 4)
    run = run_train_cli(
        torch, ["--pre_max_iteration", str(STAGE_ITERS),
                "--self_max_iteration", str(STAGE_ITERS), "--snapshot_root",
                workdir], train, val, workdir)
    trainer, stages, clock, launches = (run["trainer"], run["stages"],
                                        run["clock"], run["launches"])
    cfg = trainer.cfg
    if not (cfg.device_data_cache and cfg.async_val) or cfg.fused_bwd:
        fail(f"the CLI's defaults changed: {cfg}")
    chunks, convs = val_chunks(cfg), sum(n for _, n in CONV_STAGES)
    v = trainer.validations
    want = {"scatter_add_windows": 0,
            "softmax_scatter_add_windows": v * chunks,
            "conv3x3x3_same": convs * (3 * STAGE_ITERS + v * chunks),
            "conv3x3x3_dx": convs * 2 * STAGE_ITERS,
            "conv3x3x3_dw": convs * 2 * STAGE_ITERS,
            "conv3x3x3_dxdw": 0}
    print(f"training path launches {launches} (expected {want}: "
          f"{STAGE_ITERS} pre-train and {STAGE_ITERS} self-train steps, "
          f"{v} validations of {chunks} chunks, warm-ups included)",
          flush=True)
    if launches != want or v < 4:
        fail(f"training path launches {launches}, expected {want} with at "
             f"least 4 validations (a warm-up and one at the last step, per "
             f"stage)")
    losses = {stage: stage_losses(stages[stage][1], clock, stage,
                                  range(1, STAGE_ITERS + 1))
              for stage in ("pre", "self")}
    check_checkpoints(stages)

    for stage in ("pre", "self"):
        steady = steady_step(clock, cfg, stage, fused=False)
        # the host's share of a batch. Store: the draws and the crops'
        # launches on this thread (then with the crops' device time);
        # host feed: numpy crops built by the feeder's own code, on this
        # thread once its worker has stopped
        feeder = BCPBatchFeeder(cfg, stage, train, DEVICE,
                                store_cache=trainer.feed_store_cache)
        next(feeder)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            next(feeder)
        steady["store_batch_build_host_ms"] = (
            (time.perf_counter() - t0) / 3 * 1e3)
        torch.cuda.synchronize()
        steady["store_batch_build_synced_ms"] = (
            (time.perf_counter() - t0) / 3 * 1e3)
        feeder = BCPBatchFeeder(cfg.replace(device_data_cache=False), stage,
                                train, DEVICE)
        feeder.close()
        t0 = time.perf_counter()
        for _ in range(3):
            feeder.build()
        steady["host_feed_batch_build_ms"] = (
            (time.perf_counter() - t0) / 3 * 1e3)
        print(f"steady {stage}-train step: " + json.dumps(steady),
              flush=True)
    result = {"train_volumes": TRAIN_VOLUMES, "volume": list(TRAIN_VOLUME),
              "iterations_per_stage": STAGE_ITERS, "validations": v,
              "device_data_cache": cfg.device_data_cache,
              "async_val": cfg.async_val, "fused_bwd": cfg.fused_bwd,
              "cli_s": run["wall"], "losses": losses,
              "best_dice": {s: d for s, (d, _) in stages.items()}}
    print("training path: " + json.dumps(result), flush=True)
    return launches, {"train": train, "val": val,
                      "pre_best": stages["pre"][1]}


def run_train_cli(torch, flags, train, val, workdir, clock=True):
    """``cli.train_la``'s core on the in-memory volumes: the trainer of
    the flags (``build_trainer``), then its stages (``run_stages``), which
    is what ``train_la.train`` does; in two calls here because the step
    hook wants the trainer. Launch counts are set to 0 just before the
    stages run and read just after."""
    from bcp_tpu_torch.cli import train_la
    args = train_la.build_parser().parse_args(
        ["--labelnum", "4", "--root_path", workdir, "--device", DEVICE,
         *flags])
    out = io.StringIO()
    counters = kernel_counters()
    with contextlib.redirect_stdout(out):
        trainer = train_la.build_trainer(
            args, train_dataset=train, val_cases=val,
            eval_every=STAGE_ITERS, patch_size=PATCH)
        if clock:
            trainer.on_step = StepClock(torch, counters, workdir, trainer)
        else:
            seen = []
            trainer.on_step = lambda stage, it: seen.append((stage, it))
        read_launches(counters, reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stages = train_la.run_stages(trainer, args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(counters)
    return {"trainer": trainer, "stages": stages, "launches": launches,
            "clock": trainer.on_step if clock else seen, "wall": wall,
            "stdout": out.getvalue()}


def val_chunks(cfg) -> int:
    """Evaluator chunks of one validation of the one LA_VOLUME volume."""
    from bcp_tpu_torch.eval.sliding_window import window_starts
    return -(-len(window_starts(LA_VOLUME, PATCH, cfg.stride_xy,
                                cfg.stride_z)) // cfg.eval_batch)


def stage_losses(best_path: str, clock, stage: str, iterations):
    """The losses a stage logged, one per iteration of ``iterations`` and
    all finite; the hook must have run as often."""
    log = open(os.path.join(os.path.dirname(best_path), "log.txt")).read()
    found = re.findall(r"iteration (\d+) : loss: (\S+)", log)
    want = list(iterations)
    losses = [float(x) for _, x in found[-len(want):]]
    if [int(i) for i, _ in found[-len(want):]] != want \
            or not np.isfinite(losses).all():
        fail(f"{stage}-train losses {found}")
    hook = clock.times.get(stage, ()) if isinstance(clock, StepClock) \
        else [c for c in clock if c[0] == stage]
    if len(hook) != len(want):
        fail(f"{stage}-train: the trainer's hook ran {len(hook)} times")
    return losses


def check_checkpoints(stages) -> None:
    from bcp_tpu_torch.convert import load_reference_checkpoint
    from bcp_tpu_torch.models import create_model
    for stage, (dice, path) in stages.items():
        model = create_model("VNet", 2, device=DEVICE)
        model.load_state_dict(load_reference_checkpoint(path), strict=True)
        print(f"{stage}-train: best dice {dice}, {path} loads strictly into "
              f"the eval model", flush=True)


def steady_step(clock, cfg, stage: str, fused: bool):
    """The timed iterations of one stage: launches per step as expected,
    ms/step, patches/s, peak memory and the two one-step traces."""
    convs = sum(n for _, n in CONV_STAGES)
    per = {"conv3x3x3_same": convs * (2 if stage == "self" else 1),
           "conv3x3x3_dx": 0 if fused else convs,
           "conv3x3x3_dw": 0 if fused else convs,
           "conv3x3x3_dxdw": convs if fused else 0,
           "scatter_add_windows": 0, "softmax_scatter_add_windows": 0}
    timed = clock.launches[stage]
    if timed != {k: n * STEADY_STEPS for k, n in per.items()}:
        fail(f"{STEADY_STEPS} {stage}-train steps (fused_bwd={fused}) "
             f"launched {timed}, expected {per} each")
    ms = clock.steady(stage)
    patches = cfg.batch_size if stage == "self" else cfg.labeled_bs
    return {"fused_bwd": fused, "ms_per_step": ms,
            "patches_per_s": patches / ms * 1e3,
            "patches_per_step": patches, "launches_per_step": per,
            "peak_mem_gib": clock.peak_gib[stage],
            "profile": device_summary(clock.traces[(stage, "device")]),
            "host": host_summary(clock.traces[(stage, "host")])}


def phase_training_fused(torch, workdir: str, shared):
    """The fused-backward path: the self-train stage once more, from the
    main run's pre-train checkpoint, with ``--fused_bwd 1`` in a snapshot
    root of its own, timed and traced like the main run's (same process,
    same card: the two ms/step can be compared); then ``--resume`` with
    ``--self_max_iteration`` raised by 3 on that stage; then the unfused
    self-train stage once more in a third root, so that the run reads
    unfused, fused, unfused and shows how far two runs of one
    configuration lie apart on this host. Returns the launches of the
    fused runs and of the last run."""
    import shutil
    root = os.path.join(workdir, "fused")
    pre_dir = os.path.join(root, "LA_BCP_4_labeled", "pre_train")
    os.makedirs(pre_dir)
    shutil.copy(shared["pre_best"], pre_dir)
    flags = ["--stage", "self", "--fused_bwd", "1", "--snapshot_root", root]
    run = run_train_cli(
        torch, flags + ["--self_max_iteration", str(STAGE_ITERS)],
        shared["train"], shared["val"], workdir)
    trainer, launches = run["trainer"], run["launches"]
    cfg = trainer.cfg
    chunks, convs = val_chunks(cfg), sum(n for _, n in CONV_STAGES)
    v = trainer.validations
    want = {"scatter_add_windows": 0,
            "softmax_scatter_add_windows": v * chunks,
            "conv3x3x3_same": convs * (2 * STAGE_ITERS + v * chunks),
            "conv3x3x3_dx": 0, "conv3x3x3_dw": 0,
            "conv3x3x3_dxdw": convs * STAGE_ITERS}
    print(f"fused-backward path launches {launches} (expected {want}: "
          f"{STAGE_ITERS} self-train steps, {v} validations)", flush=True)
    if launches != want or not cfg.fused_bwd:
        fail(f"fused-backward path launches {launches}, expected {want}")
    losses = stage_losses(run["stages"]["self"][1], run["clock"], "self",
                          range(1, STAGE_ITERS + 1))
    check_checkpoints(run["stages"])
    steady = steady_step(run["clock"], cfg, "self", fused=True)
    print("steady self-train step, fused backward: " + json.dumps(steady),
          flush=True)

    # resume: 3 more steps of the same stage
    last = STAGE_ITERS + 3
    again = run_train_cli(
        torch, flags + ["--resume", "--self_max_iteration", str(last)],
        shared["train"], shared["val"], workdir, clock=False)
    log = open(os.path.join(os.path.dirname(again["stages"]["self"][1]),
                            "log.txt")).read()
    resumed = re.findall(r"resumed from \S+ at step (\d+)", log)
    steps = [it for _, it in again["clock"]]
    print(f"resume: logged 'resumed ... at step {resumed}', hook saw "
          f"iterations {steps}, launches {again['launches']}", flush=True)
    if resumed != [str(STAGE_ITERS)] \
            or steps != list(range(STAGE_ITERS + 1, last + 1)) \
            or again["launches"]["conv3x3x3_dxdw"] != convs * 3 \
            or again["launches"]["conv3x3x3_dx"] != 0:
        fail(f"resume went wrong: resumed at {resumed}, iterations {steps}, "
             f"launches {again['launches']}")
    more = stage_losses(again["stages"]["self"][1], again["clock"], "self",
                        range(STAGE_ITERS + 1, last + 1))
    result = {"iterations": STAGE_ITERS, "validations": v,
              "cli_s": run["wall"], "losses": losses,
              "best_dice": run["stages"]["self"][0],
              "resumed_at": int(resumed[0]), "resumed_to": steps[-1],
              "resumed_losses": more, "resume_cli_s": again["wall"]}
    print("fused-backward path: " + json.dumps(result), flush=True)

    root = os.path.join(workdir, "unfused_again")
    pre_dir = os.path.join(root, "LA_BCP_4_labeled", "pre_train")
    os.makedirs(pre_dir)
    shutil.copy(shared["pre_best"], pre_dir)
    third = run_train_cli(
        torch, ["--stage", "self", "--snapshot_root", root,
                "--self_max_iteration", str(STAGE_ITERS)],
        shared["train"], shared["val"], workdir)
    stage_losses(third["stages"]["self"][1], third["clock"], "self",
                 range(1, STAGE_ITERS + 1))
    print("steady self-train step, unfused again: " + json.dumps(
        steady_step(third["clock"], third["trainer"].cfg, "self",
                    fused=False)), flush=True)
    return ({k: launches[k] + again["launches"][k] for k in launches},
            third["launches"])


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

    # scratch inside the checkout (git-ignored), removed on the way out
    work_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "_work")
    os.makedirs(work_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work_root) as workdir:
        entries = phase_overlap_add(torch, rates, workdir)
        entries += phase_kernels(torch, rates)
        entries += phase_backward_kernels(torch, rates)
        pth = os.path.join(workdir, "VNet_best_model.pth")
        torch.save(seeded_vnet(torch, DEVICE, SEED).state_dict(), pth)
        phase_slice(torch, pth)
        phase_train_step(torch)
        launches = {}
        launches["test_la"], a_ms = phase_main_path(torch, pth, workdir)
        launches["train_la"], shared = phase_training(torch, workdir)
        (launches["train_la_fused_bwd"],
         launches["train_la_unfused_again"]) = phase_training_fused(
            torch, workdir, shared)
    for e in entries:
        if e["name"] == "softmax_scatter_add_windows":
            # device ms a launch inside the evaluator (phase 4's trace)
            e["main_path_device_ms"] = a_ms
        by_path = {path: counts[e["name"]]
                   for path, counts in launches.items()}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
        # the probs entry of A, the port of the TPU function, is on no
        # path since the evaluator takes the fused entry
        if e["launches"] == 0 and e.get("on_main_path", True):
            fail(f"no path launched {e['name']}")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
