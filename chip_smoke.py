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

6. the ACDC step, f32, card against CPU (``phase_acdc_step``): the 2-D
   U-Net at n_filters 16 on 128x128 slices, batch 8, one pre-train and one
   self-train update from the same seeded weights, mask and element-wise
   dropout keep masks, held to phase 3's STEP_REL rule (the teacher's BN
   statistics, which ACDC's EMA moves, included); then the eval model in
   bf16 on the card against f32 on the CPU at 256x256: the share of argmax
   labels that agree (at least 0.9);
7. the ACDC training path: ``cli.train_acdc``'s core with the CLI's
   defaults (U-Net n_filters 16, 256x256, batch 24 with labeled_bs 12,
   bf16, the device slice store, background validation) on 64 synthetic
   slices of three native shapes (labelnum 1: 32 labelled) and two
   10x232x256 validation volumes, 15 + 15 iterations with a validation at
   the last; no launch of A-D; the checkpoints load strictly; the self-train
   stage's first step holds the pre-train best's weights and momentum
   buffers; timed and traced by ``StepClock`` as phase 5;
8. the ACDC inference path: ``cli.test_acdc``'s core from that self-train
   best on two 10x256x216 volumes, no launch of A-D, then the evaluator's
   steady s/volume and a trace of one volume.

(Phases 9-11, the pancreas kernels, step, training and test paths, are
described by their functions.)

12. ``--steps_per_dispatch 4`` (``phase_dispatch``), once per pipeline at
    its CLI's defaults (LA V-Net 112x112x80 batch 8, ACDC U-Net 256x256
    batch 24, pancreas 96^3 batch 8). First each graph step beside an
    eager step from the same state (``dispatch_lockstep``): losses and BN
    statistics bit for bit, the updates bit for bit where a second eager
    step is, else within STEP_REL of their module's largest. Then the
    train CLI's core four times from one seed, K = 1 (eager), K = 4 (the
    groups after each stage's first as CUDA graph replays), K = 1, K = 4,
    24 iterations a stage with a validation at the last: where the two
    eager runs agree bit for bit the graph runs must too; the graphs'
    captures and replays are counted, and their launches of A-D a step
    are the eager run's. Each run's steady step (host ms, device busy ms,
    idle share, host launches with a replay as one, synchronisations) is
    printed beside the card's name and power limit.

13. The JAX trainer's last options and ``--save_result``
    (``phase_masks_and_snapshots``, ``phase_save_result``): grid and slab
    masks on the card against the CPU, with the host ms a grid mask takes
    to paint and copy through the pinned buffers while the stream is busy
    (against a pageable copy); an LA grid-mask run at K = 4 timed beside
    phase 12's ratio-mask runs; an LA grid-mask run with image snapshots
    at K = 4 bit for bit its K = 1 run, ACDC's snapshots at K = 4 against
    K = 1; and the three test CLIs' NIfTI dumps read back, with s/volume
    with and without them. (``fuse_subbatches=False`` runs the fused
    step, ``train.steps``, so it has no phase of its own.)

14. Data parallelism and remat (``phase_data_parallel``,
    ``phase_data_parallel_cards``, ``phase_remat``): (a) ``cli.train_la``'s
    core at LA's full width in a world of one NCCL rank against the same
    run outside a world, at K = 1 (6 iterations a stage) and K = 4 (12: the
    second group's graphs capture the all-reduces), the final states bit
    for bit (else held to phase 12's rule, the worst printed), the graph
    counts, and the NCCL collectives a traced update issues; (b)
    ``cli.test_la``'s evaluator in that world, its score map and the CLI
    core's metrics equal to the plain ones'; (c) with two or more visible
    cards, two NCCL ranks against one process on the global batch (an f32
    update at full width under phase 3's rule, then ``train_la
    --num_devices 2 --steps_per_dispatch 4``), else one line that it was
    not run; ``python3 chip_smoke.py --only data_parallel_cards`` runs (c)
    alone; (d) ``--remat 1`` on LA and pancreas at their CLIs' defaults:
    the self-train step's ms and peak memory with and without remat, in
    turns, the updates equal.

15. Spatial partitioning (``phase_spatial_slabs``,
    ``phase_spatial_shared_card``, ``phase_spatial_cards``): (a) every
    halo'd conv of LA and pancreas at full width, S = 2 and 4, slab by
    slab in one process (neighbour planes through the exchange's own pad)
    against the whole-volume launch: B forward, B-as-dx, C, D and
    block_one's ``F.conv3d``, within phase 2's limits, each level printed
    as sliced or replicated; (b) the f32 update of LA and pancreas at S =
    2 by two gloo ranks sharing this card (K = 1) against one process,
    under phase 3's rule, with each rank's peak memory beside the one
    process's; (c) with two or more visible cards the same on two NCCL
    ranks, ``train_la --num_devices 2 --sp_devices 2 --steps_per_dispatch
    4`` and, with four, ``--num_devices 4 --sp_devices 2``, else a line
    that it was skipped; ``python3 chip_smoke.py --only spatial_cards``
    runs (c) alone.

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
# the ACDC phases: the f32 step card against CPU (U-Net n_filters 16 at
# 128x128, batch 8); train_acdc at the CLI's full width on 64 synthetic
# train slices of mixed native shapes (labelnum 1: the first 32 labelled,
# ACDC_PATIENTS_TO_SLICES[1]) and 2 validation volumes; test_acdc on 2
# volumes
ACDC_STEP_SLICE = (128, 128)
ACDC_SLICE = (256, 256)
ACDC_TRAIN_SHAPES = ((256, 216), (232, 256), (208, 224))
ACDC_TRAIN_SLICES = 64
ACDC_VAL_VOLUME = (10, 232, 256)
ACDC_TEST_VOLUME = (10, 256, 216)
# the pancreas phases: VNet_pancreas n_filters 16 at a 96^3 patch, whose
# 20 kernel convs a forward run at these (channels, X, Y, Z); the f32 step
# card against CPU at STEP_PATCH with a 16^3 copy-paste cube (64^3 does
# not fit) and its limit on a cancelling bias' gradient over its module's
# weight gradient (rounding leaves them at 1e-7 to 3e-5 on the CPU);
# train_pancreas at the CLI's full width on 6 labelled and 10 unlabelled
# volumes of mixed shapes (one side below 96) and 2 validation volumes;
# test_pancreas on 2 volumes
PANC_PATCH = (96, 96, 96)
PANC_STAGES = [((32, 48, 48, 48), 4), ((64, 24, 24, 24), 6),
               ((128, 12, 12, 12), 6), ((256, 6, 6, 6), 3),
               ((16, 96, 96, 96), 1)]
PANC_STEP_CUBE = 16
BIAS_NOISE = 1e-3
# the share of the f32 step's pseudo-label voxels that may flip between
# card and CPU (2 of 131072 on an H100; a faulty teacher flips ~half)
FLIP_SHARE = 1e-3
PANC_TRAIN_SHAPES = ((128, 128, 112), (136, 120, 104), (120, 136, 90))
PANC_LAB = 6
PANC_UNLAB = 10
PANC_TEST_VOLUME = (176, 144, 112)
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
                  group, extra, patch=STEP_PATCH,
                  label="f32 train step card vs cpu"):
    """The card's updates ``got`` held against the CPU's ``want`` (see
    :func:`phase_train_step`); ``label`` names the pair in the printed
    line."""
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
    result = {"patch": list(patch), "tensors": len(want),
              "rel_limit": STEP_REL, "worst_err_over_limit": worst[0],
              "worst_tensor": worst[1],
              "next_worst": [[r, n] for r, n in ratios[1:4]],
              "smallest_module_update": min(moved),
              "largest_module_update": max(moved),
              "zero_update_would_fail": {k: f"{checked[k]} of {zeroes[k]}"
                                         for k in zeroes},
              "max_rel_loss_err": lworst[0], **extra}
    print(f"{label}: " + json.dumps(result), flush=True)
    if not all(np.isfinite(v) for v in got_loss.values()):
        fail(f"{label}: non-finite losses {got_loss}")
    if worst[0] > 1.0 or lworst[0] > 1e-4:
        fail(f"{label}: the updates differ: {result}")
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
    time) and the span of the traced CPU ops. A CUDA graph's replay counts
    as one launch (``graph_launches`` counts them alone). Host tracing
    slows the host, so idle shares come from a device-only trace
    instead."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]
    api = [e for e in events if e.get("cat") == "cuda_runtime"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    if not ops:
        return None
    graphs = sum("GraphLaunch" in e["name"] for e in api)
    return {"kernel_launches": graphs + sum("LaunchKernel" in e["name"]
                                            for e in api),
            "graph_launches": graphs,
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
    # where one volume's device time goes. The launch counters above hold
    # the path's launches exactly; a trace can lose a few kernel records
    # (then other kernels' counts are off by one too), so a trace whose
    # epilogue check fails is taken again, up to three times
    trace = os.path.join(workdir, "trace.json")
    a_ms = None
    for attempt in range(3):
        prof = device_profile(torch, lambda: evaluator.infer(
            cases[1][0], return_score=False), trace)
        print("main path profile, one volume: " + (
            json.dumps(prof) if prof else "no device activity in the trace "
            "(not measured)"), flush=True)
        if not prof:
            break
        whole, a_ms = check_chunk_epilogue(trace_spans(trace), chunks)
        if whole:
            break
    else:
        fail(f"three traces of one volume lacked one fused overlap-add a "
             f"chunk ({chunks}) or held a softmax kernel")
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


def check_chunk_epilogue(spans, chunks: int):
    """One volume's trace: one fused overlap-add a chunk and no softmax
    kernel; prints the elementwise and reduction kernels left, in calls a
    chunk (the net's, since the chunk's own passes went into A). Returns
    (whether the trace holds that, the overlap-add's device ms a launch in
    the evaluator)."""
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
    return fused == chunks and not softmax, fused_ms / max(fused, 1)


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


def seeded_unet(torch, cfg, device, seed: int, calib_shape):
    """The config's U-Net (train mode) with torch's default init from
    ``seed`` and BN statistics calibrated on one batch of ``calib_shape``
    so that the random net's activations stay at unit scale."""
    from bcp_tpu_torch.models.layers import TorchBatchNorm
    from bcp_tpu_torch.train.state import build_model
    model = build_model(cfg, "train", "cpu", seed=seed)
    calib = torch.from_numpy(np.random.default_rng(seed).normal(
        size=calib_shape).astype(np.float32))

    def set_stats(mod, inputs):
        x = inputs[0].float()
        mod.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.running_var.copy_(x.var(dim=(0, 2, 3)))

    hooks = [m.register_forward_pre_hook(set_stats) for m in model.modules()
             if isinstance(m, TorchBatchNorm)]
    with torch.no_grad():
        model.eval()(calib)
    for h in hooks:
        h.remove()
    return model.train().to(device)


def phase_acdc_step(torch):
    """ACDC's pre-train and self-train updates in f32 on the card against
    the same updates on the CPU: the 2-D U-Net at n_filters 16 on
    ACDC_STEP_SLICE slices, batch 8 (2 + 2 labelled, 2 + 2 unlabelled),
    the same seeded weights, batch, mask offsets and element-wise dropout
    keep masks; the self-train update on the CPU's pseudo-labels on both
    sides (argmax, cleaned class by class; flips printed). Held to phase
    3's rule (``_compare_step``): every update, the teacher's BN running
    statistics (ACDC's EMA of the whole state) included, within STEP_REL
    of its module's largest. Then the eval model in bf16 on the card
    against f32 on the CPU: the share of argmax labels that agree."""
    import copy
    from bcp_tpu_torch.config import acdc_config
    from bcp_tpu_torch.data.synthetic import acdc_cases
    from bcp_tpu_torch.ops.masks import cuboid_mask, cuboid_starts
    from bcp_tpu_torch.train.state import (TrainState, build_model,
                                           build_optimizer)
    from bcp_tpu_torch.train.steps import (pretrain_step, pseudo_labels,
                                           selftrain_update)
    cfg = acdc_config(n_filters=16, patch_size=ACDC_STEP_SLICE,
                      batch_size=8, labeled_bs=4, compute_dtype="float32")
    slices, _ = acdc_cases(8, (ACDC_STEP_SLICE,), seed=SEED + 8)
    img = np.stack([c[0] for c in slices])[:, None]
    lab = np.stack([c[1] for c in slices])
    host = {"img_a": img[0:2], "img_b": img[2:4], "uimg_a": img[4:6],
            "uimg_b": img[6:8], "lab_a": lab[0:2], "lab_b": lab[2:4]}
    rng = np.random.default_rng(SEED + 9)
    starts = cuboid_starts(rng, ACDC_STEP_SLICE)
    rates = (0.05, 0.1, 0.2, 0.3, 0.5)

    def keep(n):   # the five encoder dropouts, element-wise
        h, w = ACDC_STEP_SLICE
        return [rng.random((n, 16 << i, h >> i, w >> i)) < 1.0 - p
                for i, p in enumerate(rates)]
    keeps = {"pre": keep(2), "teacher": keep(4), "student": keep(4)}
    start = seeded_unet(torch, cfg, "cpu", SEED, (8, 1, *ACDC_STEP_SLICE)
                        ).state_dict()

    def run(dev, plab=None):
        def state():
            m = build_model(cfg, "train", dev)
            m.load_state_dict(start)
            t = copy.deepcopy(m)
            for p in t.parameters():
                p.requires_grad_(False)
            return TrainState(m, t, build_optimizer(cfg, m.parameters()))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        mask = cuboid_mask(ACDC_STEP_SLICE, starts, device=dev)
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
    t0 = time.perf_counter()
    got, got_loss, card_plab = run(DEVICE, plab)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    teacher_stats = [n for n in want if n.startswith("teacher.")
                     and n.rsplit(".", 1)[1].startswith("running")]
    if not teacher_stats or not all(want[n].abs().max() > 0
                                    for n in teacher_stats):
        fail("ACDC f32 step: the teacher's BN statistics did not move "
             "(the EMA of the whole state)")
    result = _compare_step(
        torch, want, want_loss, got, got_loss, start, scale,
        float(np.finfo(np.float32).eps), group,
        {"variant": "acdc", "slice": list(ACDC_STEP_SLICE),
         "teacher_bn_statistics": len(teacher_stats),
         "pseudo_label_flips": int((card_plab != plab).sum().item()),
         "pseudo_label_pixels": int(plab.numel()),
         "cpu_s": t_cpu, "card_s": t_card}, patch=ACDC_STEP_SLICE)

    # bf16 on the card against f32 on the CPU, eval mode, 256x256
    _, vols = acdc_cases(0, n_volumes=1, volume_shape=(8, *ACDC_SLICE),
                         seed=SEED + 10)
    x = torch.from_numpy(vols[0][0][:, None])
    full = acdc_config(compute_dtype="float32")
    weights = seeded_unet(torch, full, "cpu", SEED + 1,
                          (8, 1, *ACDC_SLICE)).state_dict()
    labels = {}
    for dev, dtype in ((DEVICE, "bfloat16"), ("cpu", "float32")):
        model = build_model(full.replace(compute_dtype=dtype), "test", dev)
        model.load_state_dict(weights)
        with torch.no_grad():
            labels[dev] = model(x.to(dev))[0].argmax(1).cpu()
    agree = float((labels[DEVICE] == labels["cpu"]).float().mean())
    classes = int(len(torch.unique(labels["cpu"])))
    print(f"ACDC bf16 forward on the card vs f32 on the CPU (8 slices of "
          f"{ACDC_SLICE}): {agree:.6f} of the argmax labels agree "
          f"({classes} classes predicted)", flush=True)
    if agree < 0.9:
        fail(f"ACDC bf16 labels agree with f32 on {agree} of the pixels")
    result["bf16_label_agreement"] = agree
    return result


def acdc_flags(workdir: str, *extra):
    """``cli.train_acdc``'s flags: the CLI's defaults (batch 24 with
    labeled_bs 12, bf16, 256x256, the device store), labelnum 1."""
    return ["--labelnum", "1", "--root_path", workdir, "--snapshot_root",
            workdir, "--device", DEVICE, *extra]


def phase_acdc_training(torch, workdir: str):
    """The ACDC training path: ``cli.train_acdc``'s core at full width (the
    2-D U-Net, n_filters 16, 256x256, batch 24 with labeled_bs 12, bf16,
    SGD, the EMA of the whole state, argmax pseudo-labels with per-class
    largest-CC, the device slice store) on ACDC_TRAIN_SLICES synthetic
    slices of ACDC_TRAIN_SHAPES and 2 ACDC_VAL_VOLUME validation volumes,
    STAGE_ITERS iterations a stage with a validation at the last. Timed
    and traced inside the trainer's loop by ``StepClock``; no kernel of
    A-D launches. The self-train stage must start from the pre-train
    best's weights and momentum buffers (read at its first step)."""
    from bcp_tpu_torch.cli import train_acdc
    from bcp_tpu_torch.cli.train_la import run_stages
    from bcp_tpu_torch.convert import load_reference_checkpoint
    from bcp_tpu_torch.data.datasets import SliceList
    from bcp_tpu_torch.data.synthetic import acdc_cases
    from bcp_tpu_torch.train import trainer as trainer_mod
    from bcp_tpu_torch.train.checkpoints import load_optimizer_state
    from bcp_tpu_torch.train.state import build_model
    os.makedirs(workdir)
    slices, val = acdc_cases(ACDC_TRAIN_SLICES, ACDC_TRAIN_SHAPES, 2,
                             ACDC_VAL_VOLUME, seed=SEED + 11)
    train = SliceList(slices)
    args = train_acdc.build_parser().parse_args(
        acdc_flags(workdir, "--pre_iterations", str(STAGE_ITERS),
                   "--max_iterations", str(STAGE_ITERS)))
    first = {}
    step = trainer_mod.selftrain_step

    def spy(state, *a, **k):
        if not first:
            first["opt"] = {i: s["momentum_buffer"].to("cpu", copy=True)
                            for i, s in
                            state.optimizer.state_dict()["state"].items()}
            first["model"] = {n: v.to("cpu", copy=True) for n, v in
                              state.model.state_dict().items()}
            first["step"] = state.step
        return step(state, *a, **k)

    counters = kernel_counters()
    out = io.StringIO()
    trainer_mod.selftrain_step = spy
    try:
        with contextlib.redirect_stdout(out):
            trainer = train_acdc.build_trainer(
                args, train_dataset=train, val_cases=val,
                eval_every=STAGE_ITERS)
            clock = StepClock(torch, counters, workdir, trainer)
            trainer.on_step = clock
            read_launches(counters, reset=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stages = run_stages(trainer, args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches(counters)
    finally:
        trainer_mod.selftrain_step = step
    cfg = trainer.cfg
    print(f"ACDC training path launches {launches} (expected 0 each)",
          flush=True)
    if any(launches.values()):
        fail(f"ACDC training path launched kernels of A-D: {launches}")
    if not (cfg.device_data_cache and cfg.async_val and cfg.ema_full_state
            and cfg.load_opt_state) or cfg.batch_size != 24 \
            or cfg.patch_size != ACDC_SLICE or cfg.n_filters is not None:
        fail(f"the ACDC CLI's defaults changed: {cfg}")
    losses = {stage: stage_losses(stages[stage][1], clock, stage,
                                  range(1, STAGE_ITERS + 1))
              for stage in ("pre", "self")}
    for stage, (dice, path) in stages.items():
        model = build_model(cfg, "test", DEVICE)
        model.load_state_dict(load_reference_checkpoint(path), strict=True)
        print(f"ACDC {stage}-train: best dice {dice}, {path} loads strictly "
              f"into the eval model", flush=True)
    pre_opt = load_optimizer_state(stages["pre"][1])["state"]
    pre_net = load_reference_checkpoint(stages["pre"][1])
    if first.get("step") != 0 or len(first["opt"]) != len(pre_opt) \
            or not pre_opt or not all(
                torch.equal(first["opt"][i], s["momentum_buffer"])
                for i, s in pre_opt.items()) or not all(
                torch.equal(first["model"][n], v)
                for n, v in pre_net.items()):
        fail("the ACDC self-train stage did not start from the pre-train "
             "best's weights and optimizer")
    print(f"ACDC self-train stage starts from {stages['pre'][1]}: its "
          f"weights and {len(pre_opt)} momentum buffers", flush=True)
    for stage in ("pre", "self"):
        steady = acdc_steady(clock, cfg, stage)
        print(f"steady ACDC {stage}-train step: " + json.dumps(steady),
              flush=True)
    result = {"train_slices": ACDC_TRAIN_SLICES,
              "slice_shapes": [list(s) for s in ACDC_TRAIN_SHAPES],
              "val_volumes": [list(ACDC_VAL_VOLUME)] * 2,
              "iterations_per_stage": STAGE_ITERS,
              "validations": trainer.validations, "cli_s": wall,
              "losses": losses,
              "best_dice": {s: d for s, (d, _) in stages.items()}}
    print("ACDC training path: " + json.dumps(result), flush=True)
    return launches, stages["self"][1]


def acdc_steady(clock, cfg, stage: str):
    """The timed ACDC iterations of one stage: no kernel of A-D, ms/step,
    slices/s (24 a self-train step, 12 labelled a pre-train step), peak
    memory and the two one-step traces."""
    timed = clock.launches[stage]
    if any(timed.values()):
        fail(f"{STEADY_STEPS} ACDC {stage}-train steps launched {timed}")
    ms = clock.steady(stage)
    n = cfg.batch_size if stage == "self" else cfg.labeled_bs
    return {"ms_per_step": ms, "slices_per_s": n / ms * 1e3,
            "slices_per_step": n, "peak_mem_gib": clock.peak_gib[stage],
            "profile": device_summary(clock.traces[(stage, "device")]),
            "host": host_summary(clock.traces[(stage, "host")])}


def phase_acdc_test(torch, best: str, workdir: str):
    """The ACDC inference path: ``cli.test_acdc``'s core from the
    self-train stage's best file on 2 synthetic ACDC_TEST_VOLUME volumes
    (bf16, the per-slice evaluator), launch counts reset before and read
    after; three class lines of four finite metrics. Then the steady
    s/volume of the evaluator and a trace of one volume: device busy time
    and idle share."""
    from bcp_tpu_torch.cli import test_acdc
    from bcp_tpu_torch.data.datasets import VolumeList
    from bcp_tpu_torch.data.synthetic import acdc_cases
    _, cases = acdc_cases(0, n_volumes=2, volume_shape=ACDC_TEST_VOLUME,
                          seed=SEED + 12)
    args = test_acdc.build_parser().parse_args(
        ["--torch_ckpt", best, "--snapshot_root", workdir, "--device",
         DEVICE])
    counters = kernel_counters()
    read_launches(counters, reset=True)
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        avg = test_acdc.test_calculate_metric(args,
                                              dataset=VolumeList(cases))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(counters)
    print(out.getvalue(), end="")
    print(f"ACDC test path launches {launches} (expected 0 each)",
          flush=True)
    if any(launches.values()):
        fail(f"ACDC test path launched kernels of A-D: {launches}")
    if avg.shape != (3, 4) or not np.isfinite(avg).all():
        fail(f"test_acdc: expected 3 classes of 4 finite metrics, {avg}")
    _, evaluator = test_acdc.build_evaluator(args)
    preds = list(evaluator.predict_volumes(img for img, _ in cases))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = list(evaluator.predict_volumes(img for img, _ in cases))
    steady = (time.perf_counter() - t0) / 2
    if [p.shape for p in preds] != [ACDC_TEST_VOLUME] * 2:
        fail(f"test_acdc label volumes {[p.shape for p in preds]}")
    trace = os.path.join(workdir, "acdc_trace.json")
    prof = device_profile(torch, lambda: evaluator.predict_volume(
        cases[1][0]), trace)
    result = {"volumes": 2, "volume": list(ACDC_TEST_VOLUME),
              "cli_s": wall, "cli_s_per_volume": wall / 2,
              "steady_s_per_volume": steady,
              "average_metric": avg.mean(axis=0).tolist(),
              "profile_one_volume": prof}
    print("ACDC test path: " + json.dumps(result), flush=True)
    return launches


def phase_pancreas_kernels(torch, rates):
    """Kernels B (forward and as dx) and C at the pancreas V-Net's stage
    shapes (a 96^3 patch: planes of 96^2 down to 6^2): the forward at batch
    2 (the pre-train student), 4 (the teacher and the concatenated student)
    and 16 (the evaluator's chunk), dx and dW at batch 2 and 4; bf16, and
    f32 at batch 4; phase 2's limits and the same bits on a second run.
    Kernel D (dx and dW in one launch, ``fused_bwd``) at batch 4: dx to
    B's limits, dW to C's, the same bits on a second run. Then the device
    time (CUDA graphs) of B, B-as-dx, C and D at batch 4 beside
    ``F.conv3d``, ``conv3d_input``, ``conv3d_weight`` and, for D,
    ``conv3d_input`` then ``conv3d_weight``, and each one's bound, summed
    over the 20 launches of a forward or backward. Returns {kernel name:
    those sums and the per-shape rows}."""
    import torch.nn.functional as F
    from torch.nn.grad import conv3d_input, conv3d_weight
    from bcp_tpu_torch.ops.conv3d import (conv_variant, conv3x3x3_dw,
                                          conv3x3x3_dw_reference,
                                          conv3x3x3_dx, conv3x3x3_dxdw,
                                          conv3x3x3_dxdw_reference,
                                          conv3x3x3_same,
                                          conv3x3x3_same_reference,
                                          dw_variant, dxdw_variant,
                                          flip_transpose)
    bf16_peak, f32_peak, hbm = rates
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)

    def rand(dt, *shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def check(what, k, k2, p, rel):
        """Phase 2's limits: f32 forward and dx to rtol = atol = 1e-4, bf16
        to max|k - p| <= rel max|p| (rel 1e-2), dW to 1e-3 max|p|."""
        torch.cuda.synchronize()
        if not torch.equal(k, k2):
            fail(f"pancreas {what}: two runs differ")
        err = float((k.float() - p.float()).abs().max().item())
        if (rel is None and not torch.allclose(k, p, rtol=1e-4, atol=1e-4))\
                or (rel is not None
                    and err > rel * float(p.float().abs().max().item())):
            fail(f"pancreas {what}: max err {err}")
        return err

    rows, per = [], {"conv3x3x3_same": [], "conv3x3x3_dx": [],
                     "conv3x3x3_dw": [], "conv3x3x3_dxdw": []}
    for (c, X, Y, Z), n in PANC_STAGES:
        for B, dtypes, backward in ((2, (torch.bfloat16,), True),
                                    (4, (torch.float32, torch.bfloat16),
                                     True),
                                    (16, (torch.bfloat16,), False)):
            row = {"shape": f"{B}x{c}@{X}x{Y}x{Z}", "per_pass": n,
                   "conv_variant": conv_variant(B, X, Y, Z, c, c,
                                                sms)._asdict()}
            if backward:
                row["dw_variant"] = str(tuple(dw_variant(B, X, Y, Z, c, c,
                                                         sms)))
            for dt in dtypes:
                name = "f32" if dt == torch.float32 else "bf16"
                rel = None if dt == torch.float32 else 1e-2
                x = rand(dt, B, c, X, Y, Z).contiguous(
                    memory_format=torch.channels_last_3d)
                w = (rand(torch.float32, c, c, 3, 3, 3)
                     / (27 * c) ** 0.5).to(dt)
                row[f"{name}_fwd_max_abs_err"] = check(
                    f"B {name} {row['shape']}", conv3x3x3_same(x, w),
                    conv3x3x3_same(x, w), conv3x3x3_same_reference(x, w),
                    rel)
                if backward:
                    dy = rand(dt, B, c, X, Y, Z).contiguous(
                        memory_format=torch.channels_last_3d)
                    row[f"{name}_dx_max_abs_err"] = check(
                        f"B-as-dx {name} {row['shape']}",
                        conv3x3x3_dx(dy, w), conv3x3x3_dx(dy, w),
                        conv3x3x3_same_reference(dy, flip_transpose(w)),
                        rel)
                    row[f"{name}_dw_max_abs_err"] = check(
                        f"C {name} {row['shape']}", conv3x3x3_dw(x, dy),
                        conv3x3x3_dw(x, dy), conv3x3x3_dw_reference(x, dy),
                        1e-3)
                if backward and B == 4:
                    row["dxdw_variant"] = str(tuple(dxdw_variant(
                        B, X, Y, Z, c, sms)))
                    (ddx, ddw), (ddx2, ddw2) = (conv3x3x3_dxdw(x, dy, w)
                                                for _ in range(2))
                    pdx, pdw = conv3x3x3_dxdw_reference(x, dy, w)
                    row[f"{name}_dxdw_max_abs_err"] = max(
                        check(f"D dx {name} {row['shape']}", ddx, ddx2, pdx,
                              rel),
                        check(f"D dW {name} {row['shape']}", ddw, ddw2, pdw,
                              1e-3))
                    del ddx, ddw, ddx2, ddw2, pdx, pdw
                if B == 4 and dt == torch.bfloat16:
                    M, es = B * X * Y * Z, x.element_size()
                    for kind, nbytes, fn, lib in (
                            ("conv3x3x3_same", (2 * M * c + 27 * c * c) * es,
                             lambda: conv3x3x3_same(x, w),
                             lambda: F.conv3d(x, w, padding=1)),
                            ("conv3x3x3_dx", (2 * M * c + 27 * c * c) * es,
                             lambda: conv3x3x3_dx(dy, w),
                             lambda: conv3d_input(x.shape, w, dy,
                                                  padding=1)),
                            ("conv3x3x3_dw", 2 * M * c * es + 27 * c * c * 4,
                             lambda: conv3x3x3_dw(x, dy),
                             lambda: conv3d_weight(x, w.shape, dy,
                                                   padding=1)),
                            ("conv3x3x3_dxdw",
                             (3 * M * c + 27 * c * c) * es + 27 * c * c * 4,
                             lambda: conv3x3x3_dxdw(x, dy, w),
                             lambda: (conv3d_input(x.shape, w, dy, padding=1),
                                      conv3d_weight(x, w.shape, dy,
                                                    padding=1)))):
                        flop = (2 if kind == "conv3x3x3_dxdw" else 1) \
                            * 2 * M * 27 * c * c
                        t = {"shape": row["shape"], "per_pass": n,
                             "device_ms": device_ms(torch, fn),
                             "library_device_ms": device_ms(torch, lib),
                             "bound_ms": max(flop / bf16_peak,
                                             nbytes / hbm) * 1e3,
                             "bound_by": ("operations" if flop / bf16_peak
                                          >= nbytes / hbm else "bytes")}
                        per[kind].append(t)
                        row[f"{kind}_device_ms"] = t["device_ms"]
                        row[f"{kind}_library_device_ms"] = \
                            t["library_device_ms"]
                del x, w
                if backward:
                    del dy
            rows.append(row)
            print(f"pancreas kernels {row['shape']}: " + json.dumps(
                {k: v for k, v in row.items() if k != "shape"}), flush=True)
    out = {}
    for kind, ts in per.items():
        tot = {key: sum(t[key] * t["per_pass"] for t in ts)
               for key in ("device_ms", "library_device_ms", "bound_ms")}
        ops = sum(t["per_pass"] * t["bound_ms"] for t in ts
                  if t["bound_by"] == "operations")
        key = {"conv3x3x3_same": "bf16_fwd", "conv3x3x3_dx": "bf16_dx",
               "conv3x3x3_dw": "bf16_dw",
               "conv3x3x3_dxdw": "bf16_dxdw"}[kind] + "_max_abs_err"
        errs = [r[key] for r in rows if key in r]
        what = "forward" if kind == "conv3x3x3_same" else "backward"
        out[kind] = {"per": f"the 20 bf16 launches of a batch-4 {what} at "
                            f"the pancreas 96^3 patch",
                     **tot, "bound_by": "operations"
                     if ops >= tot["bound_ms"] / 2 else "bytes",
                     "max_abs_err": max(errs), "shapes": ts}
        print(f"pancreas {kind} over a batch-4 pass: {tot['device_ms']:.4f} "
              f"ms on the device (library {tot['library_device_ms']:.4f}, "
              f"bound {tot['bound_ms']:.4f})", flush=True)
    return out


def phase_pancreas_step(torch):
    """Pancreas' pre-train and self-train updates in f32 on the card
    against the CPU: the instance-norm V-Net at n_filters 16 on STEP_PATCH
    patches, batch 8 (2 + 2 labelled, 2 + 2 unlabelled), Adam, the same
    start, batch and PANC_STEP_CUBE copy-paste cube; the self-train update
    on the CPU's pseudo-labels on both sides, as phases 3 and 6 do (the
    flips of the card's own pseudo-labels are printed: the random
    teacher's probabilities sit near the 0.5 threshold, so f32 rounding
    flips a few voxels; more than FLIP_SHARE of them is a fault). Adam's first update is lr * g / (|g| + eps), so the biases in front
    of an instance norm, whose gradient is 0 up to rounding, move by about
    lr with a sign the rounding picks: the updates are not comparable in
    f32, the gradients are. Each gradient within STEP_REL of its module's
    largest on the CPU (phase 3's rule), except those cancelling biases,
    which must stay below BIAS_NOISE of their module's weight gradient on
    both sides (rounding leaves them at 1e-7 to 3e-5 of it; a norm that failed
    to take out the mean would leave them near 1). Adam itself is held in
    f64 on the CPU (``tests/test_torch_pancreas_ops.py``). The teacher
    must have moved by the EMA of the new student: alpha * start + (1 -
    alpha) * student on the card. Losses and ``train_dice`` to 1e-4
    relative."""
    import copy
    from bcp_tpu_torch.config import pancreas_config
    from bcp_tpu_torch.data.synthetic import pancreas_cases
    from bcp_tpu_torch.ops.masks import cuboid_mask_fixed, fixed_starts
    from bcp_tpu_torch.train.state import (TrainState, build_model,
                                           build_optimizer)
    from bcp_tpu_torch.train.steps import (pretrain_step, pseudo_labels,
                                           selftrain_update)
    cfg = pancreas_config(n_filters=16, patch_size=STEP_PATCH,
                          mask_patch=PANC_STEP_CUBE, compute_dtype="float32")
    lab, unlab, _ = pancreas_cases(4, 4, 0, (STEP_PATCH,), seed=SEED + 14)
    img = np.stack([c[0] for c in lab + unlab])[:, None]
    labs = np.stack([c[1] for c in lab]).astype(np.uint8)
    host = {"img_a": img[0:2], "img_b": img[2:4], "uimg_a": img[4:6],
            "uimg_b": img[6:8], "lab_a": labs[0:2], "lab_b": labs[2:4]}
    starts = fixed_starts(np.random.default_rng(SEED + 15), STEP_PATCH,
                          PANC_STEP_CUBE)
    # torch's default init from SEED: instance norm has no statistics to
    # calibrate
    start = build_model(cfg, "train", "cpu", seed=SEED).state_dict()

    def run(dev, plab=None):
        def state():
            m = build_model(cfg, "train", dev)
            m.load_state_dict(start)
            t = copy.deepcopy(m)
            for p in t.parameters():
                p.requires_grad_(False)
            return TrainState(m, t, build_optimizer(cfg, m.parameters()))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        mask = cuboid_mask_fixed(STEP_PATCH, starts, PANC_STEP_CUBE, dev)
        pre = state()
        m_pre = pretrain_step(pre, batch, mask, cfg)
        st = state()
        own = pseudo_labels(st, batch, cfg)
        plab = own if plab is None else plab.to(dev)
        m_self = selftrain_update(st, batch, plab, mask, cfg)
        grads = {f"{tag}.{n}": p.grad.cpu().double()
                 for tag, s in (("pre", pre), ("self", st))
                 for n, p in s.model.named_parameters()}
        ema = max(float((t.cpu().double() - (
            cfg.ema_alpha * start[n].double() + (1 - cfg.ema_alpha)
            * st.model.state_dict()[n].cpu().double())).abs().max())
            for n, t in st.teacher.state_dict().items())
        moved = sum(not torch.equal(t.cpu(), start[n])
                    for n, t in st.teacher.state_dict().items())
        losses = {f"pre.{n}": float(v) for n, v in m_pre.items()}
        losses.update({f"self.{n}": float(v) for n, v in m_self.items()})
        return grads, losses, own.cpu(), ema, moved

    t0 = time.perf_counter()
    want, want_loss, plab, _, _ = run("cpu")
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, got_loss, card_plab, ema_err, moved = run(DEVICE, plab)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0

    def cancelling(n):      # a conv bias in front of an instance norm
        return n.endswith(".bias") and ".branchs.0.1." not in n
    scale = {}
    for n, g in want.items():
        mod = n.rsplit(".", 1)[0]
        if not cancelling(n):
            scale[mod] = max(scale.get(mod, 0.0), g.abs().max().item())
    n_moving = sum(n.startswith("self.") and not cancelling(n) for n in want)
    ratios, noise = [], []
    for n, g in want.items():
        s = scale[n.rsplit(".", 1)[0]]
        if cancelling(n):
            noise.append((max(got[n].abs().max().item(),
                              g.abs().max().item()) / s, n))
        else:
            ratios.append(((got[n] - g).abs().max().item()
                           / (STEP_REL * s), n))
    ratios.sort(reverse=True)
    noise.sort(reverse=True)
    lworst = max((abs(got_loss[n] - want_loss[n]) / max(abs(want_loss[n]),
                                                        1e-12), n)
                 for n in want_loss)
    flips = int((card_plab != plab).sum().item())
    result = {"variant": "pancreas", "patch": list(STEP_PATCH),
              "tensors": len(want), "rel_limit": STEP_REL,
              "worst_grad_err_over_limit": ratios[0][0],
              "worst_tensor": ratios[0][1],
              "next_worst": [[r, n] for r, n in ratios[1:4]],
              "cancelling_biases": len(noise),
              "worst_bias_grad_over_weight_grad": noise[0][0],
              "worst_bias": noise[0][1], "bias_noise_limit": BIAS_NOISE,
              "max_rel_loss_err": lworst[0],
              "pseudo_label_flips": flips,
              "pseudo_label_voxels": int(plab.numel()),
              "pseudo_label_foreground": int(plab.sum().item()),
              "teacher_tensors_moved": moved,
              "teacher_max_abs_err_vs_ema": ema_err,
              "cpu_s": t_cpu, "card_s": t_card}
    print("pancreas f32 train step card vs cpu: " + json.dumps(result),
          flush=True)
    if not all(np.isfinite(v) for v in got_loss.values()):
        fail(f"pancreas f32 step: non-finite losses {got_loss}")
    if ratios[0][0] > 1.0 or noise[0][0] > BIAS_NOISE or lworst[0] > 1e-4 \
            or flips > FLIP_SHARE * plab.numel() or moved < n_moving \
            or ema_err > 1e-6:
        fail(f"pancreas f32 step on the card differs from the CPU: {result}")
    return result


def pancreas_flags(workdir: str, *extra):
    """``cli.train_pancreas``'s flags: the CLI's defaults (96^3, four
    streams of 2, Adam 1e-3, bf16, the device store); one pre-train epoch
    (6 labelled x5 / 2 = 15 iterations) and three self-train epochs
    (min(15, 10 / 2) = 5 each)."""
    return ["--data_root", workdir, "--snapshot_root", workdir, "--device",
            DEVICE, "--pretraining_epochs", "1", "--self_training_epochs",
            "3", *extra]


def phase_pancreas_training(torch, workdir: str):
    """The pancreas training path: ``cli.train_pancreas``'s core at full
    width (VNet_pancreas n_filters 16, 96^3, batch 8 as four streams of 2,
    Adam 1e-3, bf16, the fixed 64^3 cube, binary pseudo-labels with
    largest-CC NMS at connectivity 2, the device store, background
    validation, ``fused_bwd`` off) on PANC_LAB + PANC_UNLAB synthetic
    volumes of PANC_TRAIN_SHAPES (one side below 96: the +1 padding) and
    two PANC_TEST_VOLUME validation volumes (centre-cropped: one window
    each), STAGE_ITERS iterations a stage with a validation at the last.
    Timed and traced inside the trainer's loop by ``StepClock``; launches
    per step and per path exact; the self-train stage must start from the
    pre-train best's weights and Adam state (read at its first step)."""
    from bcp_tpu_torch.cli import train_pancreas
    from bcp_tpu_torch.cli.train_la import run_stages
    from bcp_tpu_torch.convert import load_reference_checkpoint
    from bcp_tpu_torch.data.datasets import PancreasList
    from bcp_tpu_torch.data.synthetic import pancreas_cases
    from bcp_tpu_torch.models import create_model
    from bcp_tpu_torch.train import trainer as trainer_mod
    from bcp_tpu_torch.train.checkpoints import load_optimizer_state
    os.makedirs(workdir)
    lab, unlab, val = pancreas_cases(PANC_LAB, PANC_UNLAB, 2,
                                     PANC_TRAIN_SHAPES, PANC_TEST_VOLUME,
                                     seed=SEED + 16)
    train = (PancreasList(lab), PancreasList(unlab, "train_unlab"))
    args = train_pancreas.build_parser().parse_args(pancreas_flags(workdir))
    first = {}
    step = trainer_mod.selftrain_step

    def spy(state, *a, **k):
        if not first:
            first["opt"] = {i: {n: v.to("cpu", copy=True) for n, v in
                                s.items()} for i, s in
                            state.optimizer.state_dict()["state"].items()}
            first["model"] = {n: v.to("cpu", copy=True) for n, v in
                              state.model.state_dict().items()}
            first["step"] = state.step
        return step(state, *a, **k)

    counters = kernel_counters()
    out = io.StringIO()
    trainer_mod.selftrain_step = spy
    try:
        with contextlib.redirect_stdout(out):
            trainer = train_pancreas.build_trainer(
                args, train_dataset=train, val_cases=val,
                eval_every=STAGE_ITERS)
            clock = StepClock(torch, counters, workdir, trainer)
            trainer.on_step = clock
            read_launches(counters, reset=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stages = run_stages(trainer, args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches(counters)
    finally:
        trainer_mod.selftrain_step = step
    cfg = trainer.cfg
    if not (cfg.device_data_cache and cfg.async_val and cfg.load_opt_state)\
            or cfg.fused_bwd or cfg.ema_full_state \
            or cfg.optimizer != "adam" or cfg.batch_size != 8 \
            or cfg.patch_size != PANC_PATCH or cfg.n_filters is not None \
            or cfg.compute_dtype != "bfloat16" \
            or (cfg.pre_iterations, cfg.self_iterations) != (STAGE_ITERS,) * 2:
        fail(f"the pancreas CLI's defaults changed: {cfg}")
    convs = sum(n for _, n in PANC_STAGES)
    v = trainer.validations
    want = {"scatter_add_windows": 0,
            "softmax_scatter_add_windows": 2 * v,
            "conv3x3x3_same": convs * (3 * STAGE_ITERS + 2 * v),
            "conv3x3x3_dx": convs * 2 * STAGE_ITERS,
            "conv3x3x3_dw": convs * 2 * STAGE_ITERS,
            "conv3x3x3_dxdw": 0}
    print(f"pancreas training path launches {launches} (expected {want}: "
          f"{STAGE_ITERS} pre-train and {STAGE_ITERS} self-train steps, {v} "
          f"validations of 2 one-window volumes, warm-ups included)",
          flush=True)
    if launches != want or v < 4:
        fail(f"pancreas training path launches {launches}, expected {want} "
             f"with at least 4 validations")
    losses = {}
    for stage, (dice, path) in stages.items():
        log = open(os.path.join(os.path.dirname(path), "log.txt")).read()
        found = re.findall(r"Epoch : \d+, .*loss_all: ([^,\s]+)", log)
        losses[stage] = [float(x) for x in found]
        if len(found) != STAGE_ITERS or not np.isfinite(losses[stage]).all() \
                or len(clock.times.get(stage, ())) != STAGE_ITERS:
            fail(f"pancreas {stage}-train meters {found}")
        model = create_model("VNet_pancreas", 2, device=DEVICE)
        model.load_state_dict(load_reference_checkpoint(path,
                                                        "VNet_pancreas"),
                              strict=True)
        print(f"pancreas {stage}-train: best dice {dice}, {path} loads "
              f"strictly into the eval model", flush=True)
    pre_opt = load_optimizer_state(stages["pre"][1])["state"]
    pre_net = load_reference_checkpoint(stages["pre"][1], "VNet_pancreas")
    if first.get("step") != 0 or len(first["opt"]) != len(pre_opt) \
            or not pre_opt or not all(
                int(first["opt"][i]["step"]) == int(s["step"]) == STAGE_ITERS
                and torch.equal(first["opt"][i]["exp_avg"], s["exp_avg"])
                and torch.equal(first["opt"][i]["exp_avg_sq"],
                                s["exp_avg_sq"])
                for i, s in pre_opt.items()) or not all(
                torch.equal(first["model"][n], t.cpu())
                for n, t in pre_net.items()):
        fail("the pancreas self-train stage did not start from the pre-train "
             "best's weights and Adam state")
    print(f"pancreas self-train stage starts from {stages['pre'][1]}: its "
          f"weights and the Adam state of {len(pre_opt)} tensors at step "
          f"{STAGE_ITERS}", flush=True)
    for stage in ("pre", "self"):
        steady = steady_step(clock, cfg, stage, fused=False)
        steady["volumes_per_step"] = steady.pop("patches_per_step")
        steady["volumes_per_s"] = steady.pop("patches_per_s")
        print(f"steady pancreas {stage}-train step: " + json.dumps(steady),
              flush=True)
    result = {"train_volumes": [PANC_LAB, PANC_UNLAB],
              "volume_shapes": [list(s) for s in PANC_TRAIN_SHAPES],
              "val_volumes": [list(PANC_TEST_VOLUME)] * 2,
              "iterations_per_stage": STAGE_ITERS, "validations": v,
              "cli_s": wall, "losses": losses,
              "best_dice": {s: d for s, (d, _) in stages.items()}}
    print("pancreas training path: " + json.dumps(result), flush=True)
    return launches, stages["self"][1]


def phase_pancreas_test(torch, best: str, workdir: str):
    """The pancreas inference path: ``cli.test_pancreas``'s core from the
    self-train stage's best file on 2 synthetic PANC_TEST_VOLUME volumes
    (centre-cropped to 96^3: one window each, stride 16/4, argmax, bf16),
    launch counts reset before and read after: kernel A's fused entry once
    a volume, 20 kernel-B convs a volume; four finite metrics. Then the
    evaluator's steady s/volume, a trace of one volume (busy, idle), and
    the card's bf16 labels against the CPU's f32 labels of the same weights
    on one volume (at least 0.9 of the voxels agree)."""
    from bcp_tpu_torch.cli import test_pancreas
    from bcp_tpu_torch.cli.common import load_eval_model
    from bcp_tpu_torch.data.datasets import VolumeList
    from bcp_tpu_torch.data.synthetic import pancreas_cases
    from bcp_tpu_torch.data.transforms import pancreas_test_transform
    from bcp_tpu_torch.eval.sliding_window import SlidingWindowEvaluator
    _, _, cases = pancreas_cases(0, 0, 2, test_shape=PANC_TEST_VOLUME,
                                 seed=SEED + 17)
    args = test_pancreas.build_parser().parse_args(
        ["--torch_ckpt", best, "--snapshot_root", workdir, "--device",
         DEVICE])
    counters = kernel_counters()
    read_launches(counters, reset=True)
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        avg = test_pancreas.test_calculate_metric(args,
                                                  dataset=VolumeList(cases))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(counters)
    print(out.getvalue(), end="")
    convs = sum(n for _, n in PANC_STAGES)
    want = {"scatter_add_windows": 0, "softmax_scatter_add_windows": 2,
            "conv3x3x3_same": 2 * convs, "conv3x3x3_dx": 0,
            "conv3x3x3_dw": 0, "conv3x3x3_dxdw": 0}
    print(f"pancreas test path launches {launches} (expected {want})",
          flush=True)
    if launches != want:
        fail(f"pancreas test path launches {launches}, expected {want}")
    rows = re.findall(r"^\d\d,\t(\S+), (\S+), (\S+), (\S+)$", out.getvalue(),
                      re.M)
    if np.array(rows, np.float64).shape != (2, 4) \
            or not np.isfinite(np.array(rows, np.float64)).all() \
            or avg.shape != (4,) or not np.isfinite(avg).all():
        fail(f"test_pancreas: expected 2 case lines of 4 finite metrics, "
             f"{rows}, {avg}")
    cfg, evaluator = test_pancreas.build_evaluator(args)
    cropped = [pancreas_test_transform(img, lab, cfg.patch_size)
               for img, lab in cases]
    list(evaluator.infer_cases((img for img, _ in cropped), rule="argmax"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = list(evaluator.infer_cases((img for img, _ in cropped),
                                       rule="argmax"))
    steady = (time.perf_counter() - t0) / 2
    if [p.shape for p in preds] != [PANC_PATCH] * 2:
        fail(f"test_pancreas label volumes {[p.shape for p in preds]}")
    trace = os.path.join(workdir, "pancreas_trace.json")
    prof = device_profile(torch, lambda: evaluator.infer(
        cropped[1][0], rule="argmax", return_score=False), trace)
    cpu_model = load_eval_model(cfg.replace(compute_dtype="float32"), best,
                                device="cpu")
    cpu_ev = SlidingWindowEvaluator(cpu_model, cfg.patch_size, 2,
                                    cfg.stride_xy, cfg.stride_z, batch=1,
                                    device="cpu")
    cpu_label = cpu_ev.infer(cropped[0][0], rule="argmax",
                             return_score=False)[0]
    agree = float((cpu_label == preds[0]).mean())
    print(f"pancreas bf16 labels on the card vs f32 on the CPU (one "
          f"{PANC_PATCH} volume): {agree:.6f} agree (foreground: card "
          f"{int(preds[0].sum())}, cpu {int(cpu_label.sum())} voxels)",
          flush=True)
    if agree < 0.9:
        fail(f"pancreas bf16 labels agree with f32 on {agree} of the voxels")
    result = {"volumes": 2, "volume": list(PANC_TEST_VOLUME),
              "cli_s": wall, "cli_s_per_volume": wall / 2,
              "steady_s_per_volume": steady,
              "average_metric": avg.tolist(),
              "bf16_label_agreement": agree,
              "profile_one_volume": prof}
    print("pancreas test path: " + json.dumps(result), flush=True)
    return launches



# ---------------------------------------------------------------------------
# steps_per_dispatch: K updates a host visit as CUDA graph replays

#: iterations a stage of the dispatch phases: 6 groups of DISPATCH_K, with
#: a validation at the last; groups 1-2 warm up (eager, then the captures),
#: 3-4 are timed, 5 is traced on the device and 6 on the host
DISPATCH_K = 4
DISPATCH_ITERS = 6 * DISPATCH_K
#: the LA dispatch phases validate on one small volume (4 windows)
DISPATCH_LA_VAL = (130, 130, 84)
#: SM cycles the stream sleeps while phase 13 times a grid mask's writes
#: (about 50 ms on an H100)
MASK_BUSY_CYCLES = 100_000_000


class DispatchClock:
    """The trainer's ``on_step`` hook for the dispatch phases: the host
    time each iteration is reported, launches and peak memory over
    iterations 9-16 (groups 3-4), a device-only trace of iterations 17-20
    and a host trace of 21-24, each between two synchronisations. At
    iteration 4 it waits for the stage's evaluator warm-up, so that no
    background work falls into the window. With K = 4 the trainer calls
    it four times after each group is enqueued; with K = 1 after each
    step: the same iterations bound the same windows either way."""

    def __init__(self, torch, counters, workdir: str, trainer, tag: str):
        self.torch, self.counters, self.workdir = torch, counters, workdir
        self.trainer, self.tag = trainer, tag
        self.times, self.launches, self.peak_gib = {}, {}, {}
        self.reserved_gib, self.traces, self._prof = {}, {}, None
        w = DISPATCH_K
        self.marks = {w: "drain", 2 * w: "window", 4 * w: "device",
                      5 * w: "host", 6 * w: "end"}

    def __call__(self, stage: str, it: int) -> None:
        torch = self.torch
        self.times.setdefault(stage, {})[it] = time.perf_counter()
        mark = self.marks.get(it)
        if mark == "drain":
            self.trainer.wait_for_validations()
        elif mark == "window":
            self.launches[stage] = read_launches(self.counters)
            torch.cuda.reset_peak_memory_stats()
        elif mark is not None:
            if mark == "device":
                now = read_launches(self.counters)
                self.launches[stage] = {k: v - self.launches[stage][k]
                                        for k, v in now.items()}
                self.peak_gib[stage] = (torch.cuda.max_memory_allocated()
                                        / 2**30)
                # a graph's pool is reserved, not allocated, between replays
                self.reserved_gib[stage] = torch.cuda.memory_reserved() / 2**30
            self._trace(stage, None if mark == "end" else mark)

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
            path = os.path.join(self.workdir,
                                f"dispatch_{self.tag}_{what}_{stage}.json")
            self.traces[(stage, what)] = path
            self._prof = (profile(activities=acts), path)
            self._prof[0].start()

    def steady(self, stage: str):
        """Per step over the timed groups: host ms, launches of A-D; over
        the traced ones: device busy ms, idle share, host launches (a
        replay counts as one) and synchronisations."""
        w = DISPATCH_K
        t = self.times[stage]
        n = 2 * w
        dev = device_summary(self.traces[(stage, "device")])
        host = host_summary(self.traces[(stage, "host")])
        return {"ms_per_step": (t[4 * w] - t[2 * w]) / n * 1e3,
                "kernel_launches_per_step": {
                    k: v / n for k, v in self.launches[stage].items() if v},
                "peak_mem_gib": self.peak_gib[stage],
                "reserved_gib": self.reserved_gib[stage],
                "busy_ms_per_step": dev["busy_ms"] / w if dev else None,
                "idle_share": dev["idle_share"] if dev else None,
                "device_ops_per_step": dev["device_ops"] / w if dev else None,
                "host_launches_per_step":
                    host["kernel_launches"] / w if host else None,
                "graph_launches_per_step":
                    host["graph_launches"] / w if host else None,
                "synchronizations_per_step":
                    host["synchronizations"] / w if host else None}


def dispatch_data(variant: str):
    """The synthetic train and validation data of a dispatch phase: the
    training phases' data (LA with one small validation volume)."""
    if variant == "la":
        from bcp_tpu_torch.data.datasets import VolumeList
        from bcp_tpu_torch.data.synthetic import la_cases
        return (VolumeList(la_cases(TRAIN_VOLUMES, TRAIN_VOLUME,
                                    seed=SEED + 3)),
                la_cases(1, DISPATCH_LA_VAL, seed=SEED + 4))
    if variant == "acdc":
        from bcp_tpu_torch.data.datasets import SliceList
        from bcp_tpu_torch.data.synthetic import acdc_cases
        slices, val = acdc_cases(ACDC_TRAIN_SLICES, ACDC_TRAIN_SHAPES, 2,
                                 ACDC_VAL_VOLUME, seed=SEED + 11)
        return SliceList(slices), val
    from bcp_tpu_torch.data.datasets import PancreasList
    from bcp_tpu_torch.data.synthetic import pancreas_cases
    lab, unlab, val = pancreas_cases(PANC_LAB, PANC_UNLAB, 2,
                                     PANC_TRAIN_SHAPES, PANC_TEST_VOLUME,
                                     seed=SEED + 16)
    return (PancreasList(lab), PancreasList(unlab, "train_unlab")), val


def dispatch_cli(variant: str, root: str, K: int,
                 iters: int = DISPATCH_ITERS):
    """(CLI module, parsed flags, config overrides) of a dispatch run: the
    CLI's defaults, ``iters`` iterations a stage with a validation at the
    last, ``--steps_per_dispatch K``."""
    n = str(iters)
    if variant == "la":
        from bcp_tpu_torch.cli import train_la as cli
        flags = ["--labelnum", "4", "--root_path", root, "--snapshot_root",
                 root, "--device", DEVICE, "--pre_max_iteration", n,
                 "--self_max_iteration", n]
        over = {"patch_size": PATCH}
    elif variant == "acdc":
        from bcp_tpu_torch.cli import train_acdc as cli
        flags = acdc_flags(root, "--pre_iterations", n, "--max_iterations",
                           n)
        over = {}
    else:
        from bcp_tpu_torch.cli import train_pancreas as cli
        flags = pancreas_flags(root)
        over = {"pre_iterations": iters, "self_iterations": iters}
    args = cli.build_parser().parse_args(
        flags + ["--steps_per_dispatch", str(K)])
    return cli, args, dict(over, eval_every=iters)


def dispatch_lockstep(torch, variant: str, data, root: str):
    """Each graph step held to an eager step from the same state, at the
    CLI's widths: per stage, a ``DispatchGroups`` group of DISPATCH_K eager
    steps (the warm-up), then DISPATCH_K graph steps, each beside an eager
    step (``pretrain_step`` / ``selftrain_step``, K = 1's) on a copy of the
    state the graph step started from, with the same batch and draws. The
    forward is deterministic, so the losses and the BN statistics must be
    the same bit for bit; the updates (student, teacher, optimizer state)
    bit for bit where a second eager step from that state is, else within
    STEP_REL of their module's largest eager update. Returns the worst
    ratio of update error to limit and whether the eager steps were
    bit-identical."""
    from bcp_tpu_torch.data.feed import BCPBatchFeeder
    from bcp_tpu_torch.train.checkpoints import snapshot
    from bcp_tpu_torch.train.graphs import DispatchGroups
    from bcp_tpu_torch.train.state import init_state, load_optimizer
    from bcp_tpu_torch.train.steps import pretrain_step, selftrain_step
    from bcp_tpu_torch.train.trainer import (copy_paste_box,
                                             copy_paste_mask,
                                             iteration_draws)
    cli, args, over = dispatch_cli(variant, root, DISPATCH_K)
    cfg = cli.config_from_args(args, **over) if variant != "pancreas" else \
        cli.config_from_args(args, data[0], **over)
    K, dev = DISPATCH_K, torch.device(DEVICE)
    ulp = float(np.finfo(np.float32).eps)
    out = {}
    for stage in ("pre", "self"):
        seed = cfg.seed + (stage == "self")
        feeder = BCPBatchFeeder(cfg, stage, data[0], dev, stack=K)
        try:
            groups_in = [next(feeder) for _ in range(2)]
        finally:
            feeder.close()
        graph = init_state(cfg, dev)
        gen = torch.Generator(device=dev)

        def draws(it, g=gen):
            return copy_paste_box(cfg, iteration_draws(seed, it, g)), g
        groups = DispatchGroups(graph, cfg, stage, K, draws, static=True)
        groups.run(groups_in[0], 1)
        step = groups.graph_step
        eager = [init_state(cfg, dev) for _ in range(2)]
        egen = torch.Generator(device=dev)
        worst, exact = (0.0, ""), True
        for j in range(K):
            it = K + 1 + j
            sub = {k: v[j] for k, v in groups_in[1].items()}
            start = snapshot(graph)
            got = step.step(sub, draws(it))
            got = dict(zip(step.names, got.tolist()))
            after = {}
            for which, e in enumerate(eager[:2 if j == 0 else 1]):
                e.model.load_state_dict(start["model"])
                e.teacher.load_state_dict(start["teacher"])
                load_optimizer(e.optimizer, {
                    "state": {i: {k: v.clone() for k, v in st.items()}
                              for i, st in start["optimizer"]["state"]
                              .items()},
                    "param_groups": start["optimizer"]["param_groups"]})
                e.step = start["step"]
                mask = copy_paste_mask(cfg, iteration_draws(seed, it, egen),
                                       dev)
                m = pretrain_step(e, sub, mask, cfg, egen) \
                    if stage == "pre" else selftrain_step(
                        e, sub, mask, cfg, egen, egen)
                after[which] = ({k: float(v) for k, v in m.items()},
                                snapshot(e))
            want_loss, want = after[0]
            if got != want_loss:
                fail(f"dispatch {variant} {stage}-train step {it}: graph "
                     f"losses {got}, eager {want_loss} from one state")
            have = snapshot(graph)
            if j == 0:
                exact = _state_equal(after[1][1], want)
            ratio = _lockstep_ratio(start, have, want, exact, ulp)
            worst = max(worst, (ratio[0], f"{stage}@{it}.{ratio[1]}"))
        groups.close()
        out[stage] = {"worst": worst, "eager_bit_identical": exact}
    return out


def _flat(snap):
    """name -> tensor of a ``checkpoints.snapshot``: the student, the
    teacher and the optimizer state, the latter by its parameter's name
    (the state_dict's parameters in order: the model holds no buffer
    between them that the optimizer counts)."""
    out = {f"model.{k}": v for k, v in snap["model"].items()}
    out.update({f"teacher.{k}": v for k, v in snap["teacher"].items()})
    names = [k for k, v in snap["model"].items()
             if v.is_floating_point() and not k.endswith(
                 ("running_mean", "running_var"))]
    for i, st in snap["optimizer"]["state"].items():
        out.update({f"opt.{names[i]}.{k}": v for k, v in st.items()})
    return out


def _state_equal(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return sorted(fa) == sorted(fb) and all(
        fa[k].shape == fb[k].shape and bool((fa[k] == fb[k]).all())
        for k in fa)


def _lockstep_ratio(start, got, want, exact: bool, ulp: float):
    """Worst (error / limit, tensor) of one step's updates, ``got``'s
    against ``want``'s from the same ``start``: bit for bit when ``exact``
    and for the running statistics (the forward is deterministic); else
    each update within STEP_REL of the largest eager update of its module
    and kind (an optimizer statistic shares its parameter's module) plus
    4 f32 ulps of its start."""
    s, g, w = _flat(start), _flat(got), _flat(want)

    def kind(k):
        # (module, what): a bias shares its module's scale, as in phase 3
        if k.startswith("opt."):
            name, stat = k.rsplit(".", 1)
            return name.rsplit(".", 1)[0], stat
        return k.rsplit(".", 1)[0], "running" in k

    def upd(t, k):
        return t[k].double() - s[k].double()
    scale = {}
    for k, v in w.items():
        if v.is_floating_point():
            scale[kind(k)] = max(scale.get(kind(k), 0.0),
                                 upd(w, k).abs().max().item())
    worst = (0.0, "")
    for k, v in w.items():
        err = (g[k].double() - v.double()).abs().max().item()
        if exact or not v.is_floating_point() or "running" in k:
            ratio = 0.0 if err == 0 else np.inf
        else:
            limit = (STEP_REL * scale[kind(k)]
                     + 4 * ulp * s[k].double().abs().max().item())
            ratio = err / limit if limit else (0.0 if err == 0 else np.inf)
        worst = max(worst, (ratio, k))
    return worst


def dispatch_run(torch, variant: str, K: int, root: str, data, tag: str,
                 iters: int = DISPATCH_ITERS, log_images: bool = False,
                 **extra):
    """One run of the variant's train CLI core at the CLI's defaults with
    ``--steps_per_dispatch K``, ``iters`` iterations a stage and a
    validation at the last, timed by :class:`DispatchClock`, its losses
    recorded by the trainer's ``on_metrics`` hook, its launch counts set to
    0 just before the stages and read just after. ``extra`` overrides the
    config (``fuse_subbatches``, ``mask_kind``, ``eval_every``);
    ``log_images`` turns the trainer's image snapshots on."""
    from bcp_tpu_torch.cli.train_la import run_stages
    cli, args, over = dispatch_cli(variant, root, K, iters)
    over.update(extra)
    counters = kernel_counters()
    losses = {}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer = cli.build_trainer(args, train_dataset=data[0],
                                    val_cases=data[1], **over)
        trainer.log_images = log_images
        clock = DispatchClock(torch, counters, root, trainer, tag)
        if iters != DISPATCH_ITERS:     # times only: no window, no traces
            clock.marks = {}
        trainer.on_step = clock
        trainer.on_metrics = lambda stage, it, m: losses.setdefault(
            stage, {}).__setitem__(it, m)
        read_launches(counters, reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stages = run_stages(trainer, args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(counters)
    cfg = trainer.cfg
    if cfg.steps_per_dispatch != K or cfg.fused_bwd \
            or not (cfg.device_data_cache and cfg.async_val):
        fail(f"dispatch {variant}: the CLI's defaults changed: {cfg}")
    for stage in ("pre", "self"):
        seen = sorted(losses.get(stage, {}))
        if seen != list(range(1, iters + 1)) \
                or sorted(clock.times[stage]) != seen \
                or not all(np.isfinite(v) for m in losses[stage].values()
                           for v in m.values()):
            fail(f"dispatch {variant} K={K} {stage}-train: losses of "
                 f"iterations {seen}: {losses.get(stage)}")
    return {"trainer": trainer, "stages": stages, "clock": clock,
            "losses": losses, "launches": launches, "wall": wall,
            "cfg": cfg, "root": root}


def dispatch_state(torch, run, stage: str):
    """(end, start) tensors of a run's stage, by name: the student, the
    teacher and the optimizer state of its ``last_state.pt`` (the state at
    the last iteration's validation), and where the stage started: the
    seeded initial weights (pre-train) or the pre-train best's weights and,
    with ``load_opt_state``, its optimizer state (self-train)."""
    from bcp_tpu_torch.convert import load_reference_checkpoint
    from bcp_tpu_torch.train.checkpoints import load_optimizer_state
    from bcp_tpu_torch.train.state import build_model
    cfg = run["cfg"]
    path = os.path.join(os.path.dirname(run["stages"][stage][1]),
                        "last_state.pt")
    saved = torch.load(path, map_location="cpu", weights_only=False)
    # optimizer state by its parameter's name: a bias shares its module's
    # scale (its gradient may be rounding noise in front of a norm)
    names = [n for n, _ in build_model(cfg, "train", "cpu").named_parameters()]
    end = {}
    for part in ("model", "teacher"):
        end.update({f"{part}.{k}": v for k, v in saved[part].items()})
    for i, st in saved["optimizer"]["state"].items():
        end.update({f"opt.{names[i]}.{k}": v for k, v in st.items()
                    if isinstance(v, torch.Tensor)})
    if stage == "pre":
        weights = build_model(cfg, "train", "cpu").state_dict()
        opt = {}
    else:
        pre = run["stages"]["pre"][1]
        weights = load_reference_checkpoint(pre, cfg.net_type)
        opt = (load_optimizer_state(pre)["state"] if cfg.load_opt_state
               else {})
    start = {}
    for part in ("model", "teacher"):
        start.update({f"{part}.{k}": v for k, v in weights.items()})
    for i, st in opt.items():
        start.update({f"opt.{names[i]}.{k}": v for k, v in st.items()
                      if isinstance(v, torch.Tensor)})
    return end, start


def dispatch_hold(torch, got, want, exact: bool):
    """``got`` (a run's (end, start) per stage and losses) held to
    ``want``'s: bit for bit when ``exact``; else every tensor's update
    (end - start; optimizer state without a start counts from 0) within
    STEP_REL of the largest update of ``want``'s among its module's
    tensors of the same kind (parameters, running statistics, each
    optimizer statistic), plus 4 f32 ulps of its start, and every loss
    within STEP_REL of how far ``want``'s losses of that stage moved.
    Returns the worst ratio of error to limit (0 when bit for bit) and
    where, by stage and kind ("pre.param", "self.running", "pre.opt",
    "self.loss", ...)."""
    ulp = float(np.finfo(np.float32).eps)
    worst = {}

    def note(ratio, where):
        kind = ("loss" if ".loss." in where else "opt" if ".opt." in where
                else "running" if "running" in where else "param")
        key = f"{where.split('.', 1)[0]}.{kind}"
        worst[key] = max(worst.get(key, (0.0, "")), (ratio, where))
    for stage in ("pre", "self"):
        (g_end, g_start), (w_end, w_start) = got[stage], want[stage]
        if sorted(g_end) != sorted(w_end):
            fail(f"dispatch: {stage}-train states hold other tensors")

        def upd(end, start, k):
            d = end[k].double()
            return d - start[k].double() if k in start else d

        def kind(k):
            # (module, what): parameters, running statistics, or one
            # optimizer statistic (momentum, Adam's two moments, its step)
            if k.startswith("opt."):
                name, stat = k.rsplit(".", 1)
                return name.rsplit(".", 1)[0], stat
            return k.rsplit(".", 1)[0], "running" in k
        scale = {}
        for k, v in w_end.items():
            if v.is_floating_point():
                scale[kind(k)] = max(scale.get(kind(k), 0.0), upd(
                    w_end, w_start, k).abs().max().item())
        for k, v in w_end.items():
            if exact or not v.is_floating_point():
                err = (g_end[k].double() - v.double()).abs().max().item()
                ratio = 0.0 if err == 0 else np.inf
            else:
                base = w_start[k].double().abs().max().item() \
                    if k in w_start else 0.0
                limit = STEP_REL * scale[kind(k)] + 4 * ulp * base
                err = (upd(g_end, g_start, k)
                       - upd(w_end, w_start, k)).abs().max().item()
                ratio = err / limit if limit else (0.0 if err == 0
                                                   else np.inf)
            note(ratio, f"{stage}.{k}")
        wl, gl = want["losses"][stage], got["losses"][stage]
        for name in wl[1]:
            series = [wl[i][name] for i in sorted(wl)]
            moved = max(series) - min(series)
            for i in sorted(wl):
                err = abs(gl[i][name] - wl[i][name])
                limit = 0.0 if exact else STEP_REL * moved
                ratio = err / limit if limit else (0.0 if err == 0
                                                   else np.inf)
                note(ratio, f"{stage}.loss.{name}@{i}")
    return worst


def phase_dispatch(torch, workdir: str, variant: str, smi: str):
    """``--steps_per_dispatch 4`` on one pipeline at the CLI's defaults
    (LA: V-Net n_filters 16, 112x112x80, batch 8; ACDC: U-Net, 256x256,
    batch 24; pancreas: 96^3, batch 8, Adam): four runs of the train CLI's
    core from one seed, K = 1 (eager), K = 4 (CUDA graphs), K = 1, K = 4,
    each DISPATCH_ITERS iterations a stage with a validation at the last,
    both stages. First each graph step is held to an eager step from the
    same state (:func:`dispatch_lockstep`). Then the runs: where the two
    eager runs agree bit for bit, each graph run must too. Where they do
    not (ACDC: its bilinear upsample adds gradients with atomics, in bf16,
    and in the self-train stage a flipped pseudo-label pixel can move a
    whole component in or out of the NMS's pick), two independent runs of
    48 steps lie further apart than STEP_REL, eager against eager too, so
    :func:`dispatch_hold`'s ratios of both are printed and the lockstep
    comparison is what holds the graphs. Each graph run
    captures once per stage and program (pre-train: one graph; self-train:
    T and S) and replays from its second group on, and its launches of
    A-D a timed step are the eager run's. The steady step of each run (ms,
    device busy ms, idle share, host launches and synchronisations) is
    printed beside the card's name and power limit. Returns the launches
    of the eager and the graph runs, and the steady steps by stage."""
    data = dispatch_data(variant)
    lockstep = dispatch_lockstep(torch, variant, data,
                                 os.path.join(workdir, f"lockstep_{variant}"))
    runs = []
    for i, K in enumerate((1, DISPATCH_K, 1, DISPATCH_K)):
        root = os.path.join(workdir, f"dispatch_{variant}_{i}")
        os.makedirs(root)
        runs.append(dispatch_run(torch, variant, K, root, data,
                                 f"{variant}{i}"))
    held = []
    for run in runs:
        run["state"] = {stage: dispatch_state(torch, run, stage)
                        for stage in ("pre", "self")}
        run["state"]["losses"] = run["losses"]
    ref = runs[0]["state"]
    exact = all(r == 0 for r, _ in dispatch_hold(
        torch, runs[2]["state"], ref, exact=True).values())
    # the second eager run under the rule: the card's own run-to-run noise
    eager_ratio = dispatch_hold(torch, runs[2]["state"], ref, exact=False)
    for run in (runs[1], runs[3]):
        held.append(dispatch_hold(torch, run["state"], ref, exact=False))
    steady = {}
    for i, run in enumerate(runs):
        K = run["cfg"].steps_per_dispatch
        way = "graphs" if K > 1 else "eager"
        counts = run["trainer"].graph_counts
        if K > 1:
            groups = DISPATCH_ITERS // K
            want = {"pre": {"captures": 1, "replays": (groups - 1) * K},
                    "self": {"captures": 2,
                             "replays": 2 * (groups - 1) * K}}
            if counts != want:
                fail(f"dispatch {variant} run {i}: graph counts {counts}, "
                     f"expected {want}")
        for stage in ("pre", "self"):
            s = run["clock"].steady(stage)
            steady.setdefault(stage, {}).setdefault(way, []).append(s)
            if s["kernel_launches_per_step"] != runs[0]["clock"].steady(
                    stage)["kernel_launches_per_step"]:
                fail(f"dispatch {variant} run {i} {stage}-train: launches "
                     f"a step {s['kernel_launches_per_step']}, the eager "
                     f"run's {runs[0]['clock'].steady(stage)}")
    result = {"card": smi, "K": DISPATCH_K, "iterations": DISPATCH_ITERS,
              "runs": ["eager", "graphs", "eager", "graphs"],
              "eager_vs_eager_bit_identical": exact,
              "eager_vs_eager_worst": eager_ratio,
              "graphs_vs_eager_worst": held,
              "lockstep": lockstep,
              "graph_counts": runs[1]["trainer"].graph_counts,
              "cli_s": [r["wall"] for r in runs]}
    print(f"dispatch {variant}: " + json.dumps(result), flush=True)
    for stage in ("pre", "self"):
        print(f"dispatch {variant} steady {stage}-train step ({smi}): "
              + json.dumps(steady[stage]), flush=True)
    if exact and any(r > 0 for h in held for r, _ in h.values()):
        fail(f"dispatch {variant}: the eager runs agree bit for bit and a "
             f"graph run does not: {result}")
    if any(v["worst"][0] > 1.0 for v in lockstep.values()):
        fail(f"dispatch {variant}: a graph step differs from the eager step "
             f"from its state: {lockstep}")
    launches = {}
    for tag, picks in (("k1", (0, 2)), (f"k{DISPATCH_K}", (1, 3))):
        launches[f"train_{variant}_{tag}"] = {
            k: sum(runs[i]["launches"][k] for i in picks)
            for k in runs[0]["launches"]}
    return launches, steady


# ---------------------------------------------------------------------------
# the JAX trainer's last options: grid and slab masks, image snapshots; and
# the NIfTI dumps of --save_result

@contextlib.contextmanager
def recorded_images():
    """The ``(tag, step, array)`` of each image the trainer hands its
    writer (the card's machine has no tensorboardX)."""
    from bcp_tpu_torch.utils.logging import MetricWriter
    calls = []
    old = MetricWriter.image, MetricWriter.images
    MetricWriter.image = lambda self, tag, img, it: calls.append(
        (tag, it, np.array(img)))
    MetricWriter.images = lambda self, tag, imgs, it=None: calls.append(
        (tag, it, np.array(imgs)))
    try:
        yield calls
    finally:
        MetricWriter.image, MetricWriter.images = old


def phase_masks_and_snapshots(torch, workdir: str, smi: str, ratio_steady):
    """Grid and slab masks and the image snapshots on the card. (1) The
    masks built on the card equal the CPU's bit for bit from the same
    starts (LA 112x112x80, ACDC 256x256, grid and slab). The host ms to
    draw a grid mask and write it through ``graphs.PinnedMask``: ten on an
    idle stream, then two while the stream sleeps for MASK_BUSY_CYCLES,
    beside two pageable copies under the same sleep; a pinned write must
    return in under half the sleep (it does not wait for the stream), and
    what it wrote is the mask. (2) LA at ``train_la``'s defaults with
    ``mask_kind="grid"`` at K = 4, as phase 12 runs it: its steady steps
    printed beside phase 12's ratio-mask K = 4 runs (``ratio_steady``),
    its launches of A-D a step equal to theirs. (3) LA with the grid mask
    and ``log_images``, 8 + 8 iterations, eval_every 4 (images at
    self-train iterations 1 and 5), at K = 1 and K = 4 (iteration 5 then
    comes from a graph group): the runs' states and losses bit for bit,
    the grids (80, 3, 342, 114) with their white separators equal, and the
    snapshot's mask the step's own (the mask of ``iteration_draws`` at
    that iteration) and pseudo-labels equal both ways. (4) ACDC at its
    defaults with ``log_images``, 20 + 20 iterations (panels at iteration
    20 of each stage), K = 1 and K = 4: the images and ground truths bit
    for bit, the predictions agreeing on at least 0.9 of the pixels, the
    states held by phase 12's rule."""
    from bcp_tpu_torch.config import acdc_config, la_config
    from bcp_tpu_torch.data.feed import labeled_count
    from bcp_tpu_torch.ops.masks import (boxes_mask, grid_mask, grid_starts,
                                         slab_mask)
    from bcp_tpu_torch.train import trainer as trainer_mod
    from bcp_tpu_torch.train.trainer import (copy_paste_box,
                                             copy_paste_mask,
                                             iteration_draws)
    from bcp_tpu_torch.train.graphs import PinnedMask, write_box
    rng = np.random.default_rng(SEED + 24)
    host_ms = {}
    for name, S, axis, frac in (("la", PATCH, -1, 8 / 27),
                                ("acdc", ACDC_SLICE, 0, 4 / 9)):
        starts = grid_starts(rng, S)
        start = int(rng.integers(0, S[axis] - int(S[axis] * frac) - 1))
        for kind, fn in (("grid", lambda d: grid_mask(S, starts, device=d)),
                         ("slab", lambda d: slab_mask(S, start, axis, frac,
                                                      device=d))):
            if not torch.equal(fn(DEVICE).cpu(), fn("cpu")):
                fail(f"{kind} mask {name}: the card's differs from the CPU's")
        cfg = (la_config if name == "la" else acdc_config)(
            patch_size=S).replace(mask_kind="grid")
        buf = torch.empty(S, dtype=torch.int32, device=DEVICE)
        pinned = PinnedMask(S)

        def boxes(it):
            return copy_paste_box(cfg, iteration_draws(0, it,
                                                       torch.Generator()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in range(1, 11):
            write_box(buf, boxes(it), pinned)
        host_ms[f"{name}_idle_stream"] = (time.perf_counter() - t0) / 10 * 1e3
        torch.cuda.synchronize()
        for how in ("pinned", "pageable"):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            torch.cuda._sleep(MASK_BUSY_CYCLES)
            e1.record()
            t0 = time.perf_counter()
            for it in (11, 12):
                if how == "pinned":
                    write_box(buf, boxes(it), pinned)
                else:
                    buf.copy_(boxes_mask(S, boxes(it)), non_blocking=True)
            host_ms[f"{name}_busy_stream_{how}"] = \
                (time.perf_counter() - t0) / 2 * 1e3
            torch.cuda.synchronize()
            host_ms[f"{name}_busy_stream_sleep"] = e0.elapsed_time(e1)
            if not torch.equal(buf.cpu(), boxes_mask(S, boxes(12))):
                fail(f"grid mask {name}: the {how} write is not the mask")
        if host_ms[f"{name}_busy_stream_pinned"] \
                >= host_ms[f"{name}_busy_stream_sleep"] / 4:
            fail(f"grid mask {name}: a pinned write waited for the "
                 f"stream: {host_ms}")
    print(f"grid and slab masks: card equals CPU; host ms to draw and "
          f"write a grid mask ({smi}): {json.dumps(host_ms)}", flush=True)

    launches = {}
    data = dispatch_data("la")
    root = os.path.join(workdir, "la_grid_timed")
    os.makedirs(root)
    run = dispatch_run(torch, "la", DISPATCH_K, root, data, "grid_timed",
                       mask_kind="grid")
    launches[f"train_la_grid_k{DISPATCH_K}"] = run["launches"]
    groups = DISPATCH_ITERS // DISPATCH_K
    if run["trainer"].graph_counts != {
            "pre": {"captures": 1, "replays": (groups - 1) * DISPATCH_K},
            "self": {"captures": 2,
                     "replays": 2 * (groups - 1) * DISPATCH_K}}:
        fail(f"la grid K = {DISPATCH_K}: graph counts "
             f"{run['trainer'].graph_counts}")
    for stage in ("pre", "self"):
        grid = run["clock"].steady(stage)
        ratio = ratio_steady[stage]["graphs"]
        if grid["kernel_launches_per_step"] != \
                ratio[0]["kernel_launches_per_step"]:
            fail(f"la grid {stage}-train: launches a step "
                 f"{grid['kernel_launches_per_step']}, the ratio mask's "
                 f"{ratio[0]['kernel_launches_per_step']}")
        print(f"la grid mask K = {DISPATCH_K} steady {stage}-train step "
              f"({smi}): " + json.dumps({"grid": grid,
                                         "ratio (phase 12)": ratio}),
              flush=True)

    runs, seen = {}, []
    orig = trainer_mod.make_la_snapshot

    def spy(state, batch, mask, plab):
        seen.append((mask.cpu().clone(), plab.cpu().clone()))
        return orig(state, batch, mask, plab)
    trainer_mod.make_la_snapshot = spy
    try:
        for K in (1, DISPATCH_K):
            root = os.path.join(workdir, f"la_grid_k{K}")
            os.makedirs(root)
            with recorded_images() as images:
                run = dispatch_run(torch, "la", K, root, data, f"grid{K}",
                                   iters=8, log_images=True,
                                   mask_kind="grid", eval_every=4)
            run["images"], run["seen"] = images, seen[:]
            seen.clear()
            run["state"] = {s: dispatch_state(torch, run, s)
                            for s in ("pre", "self")}
            run["state"]["losses"] = run["losses"]
            runs[K] = run
            launches[f"train_la_grid_snapshots_k{K}"] = run["launches"]
    finally:
        trainer_mod.make_la_snapshot = orig
    cfg = runs[1]["cfg"]
    held = dispatch_hold(torch, runs[DISPATCH_K]["state"], runs[1]["state"],
                         exact=True)
    H, W, D = PATCH
    tags = [(t, i) for t, i, _ in runs[1]["images"]]
    per_epoch = max(labeled_count(cfg) // cfg.labeled_bs, 1)
    want_tags = [(f"Epoch_{(it - 1) // per_epoch}_Iter_{it}_{w}", None)
                 for it in (1, 5) for w in ("labeled", "unlabel")]
    result = {"la_grid_k4_vs_k1_worst": held,
              "la_graph_counts": runs[DISPATCH_K]["trainer"].graph_counts,
              "la_image_tags": [t for t, _ in tags]}
    if tags != [(t, i) for t, i, _ in runs[DISPATCH_K]["images"]]:
        fail(f"la snapshots: tags differ between K = 1 and K = 4: {tags}")
    if [t for t, _ in tags] != [t for t, _ in want_tags]:
        fail(f"la snapshots: tags {tags}, expected {want_tags}")
    for (t, _, a), (_, _, b) in zip(runs[1]["images"],
                                    runs[DISPATCH_K]["images"]):
        if a.shape != (D, 3, 3 * H + 6, W + 2) or a.dtype != np.float32 \
                or not (a[:, :, H:H + 2] == 1).all() \
                or not (a[:, :, :, W:] == 1).all():
            fail(f"la snapshot {t}: grid {a.shape} {a.dtype}")
        if not np.array_equal(a, b):
            fail(f"la snapshot {t}: K = 4's grid differs from K = 1's")
    for K, run in runs.items():
        if len(run["seen"]) != 2:
            fail(f"la snapshots K = {K}: {len(run['seen'])} snapshots")
        for it, (mask, plab) in zip((1, 5), run["seen"]):
            own = copy_paste_mask(cfg, iteration_draws(
                cfg.seed + 1, it, torch.Generator()))
            if not torch.equal(mask, own):
                fail(f"la snapshot K = {K} iteration {it}: not the step's "
                     f"own mask")
    for (_, p1), (_, p4) in zip(runs[1]["seen"], runs[DISPATCH_K]["seen"]):
        if not torch.equal(p1, p4):
            fail("la snapshots: the pseudo-labels differ between K = 1 "
                 "and K = 4")
    if any(r > 0 for r, _ in held.values()):
        fail(f"la grid: K = 4 differs from K = 1: {held}")
    if DEVICE == "cuda" and result["la_graph_counts"]["self"] != {
            "captures": 2, "replays": 2 * DISPATCH_K}:
        fail(f"la grid K = 4: graph counts {result['la_graph_counts']}")

    data = dispatch_data("acdc")
    acdc = {}
    for K in (1, DISPATCH_K):
        root = os.path.join(workdir, f"acdc_k{K}")
        os.makedirs(root)
        with recorded_images() as images:
            run = dispatch_run(torch, "acdc", K, root, data, f"snap{K}",
                               iters=20, log_images=True)
        run["images"] = images
        run["state"] = {s: dispatch_state(torch, run, s)
                        for s in ("pre", "self")}
        run["state"]["losses"] = run["losses"]
        acdc[K] = run
        launches[f"train_acdc_snapshots_k{K}"] = run["launches"]
    a1, a4 = acdc[1]["images"], acdc[DISPATCH_K]["images"]
    want_tags = [f"pre_train/Mixed_{p}" for p in
                 ("Image", "Prediction", "GroundTruth")] + [
        f"train/{s}_{p}" for s in ("Un", "L")
        for p in ("Image", "Prediction", "GroundTruth")]
    if [(t, i) for t, i, _ in a1] != [(t, 20) for t in want_tags] or \
            [(t, i) for t, i, _ in a4] != [(t, 20) for t in want_tags]:
        fail(f"acdc snapshots: {[(t, i) for t, i, _ in a1]} / "
             f"{[(t, i) for t, i, _ in a4]}, expected {want_tags} at 20")
    agree = {}
    for (t, _, x), (_, _, y) in zip(a1, a4):
        if x.shape != (1, *ACDC_SLICE) or x.dtype != np.float32:
            fail(f"acdc snapshot {t}: {x.shape} {x.dtype}")
        if t.endswith("Prediction"):
            agree[t] = float((x == y).mean())
            if agree[t] < 0.9:
                fail(f"acdc snapshot {t}: K = 4 agrees with K = 1 on "
                     f"{agree[t]} of the pixels")
        elif not np.array_equal(x, y):
            fail(f"acdc snapshot {t}: K = 4 differs from K = 1")
    result.update({
        "acdc_prediction_agreement": agree,
        "acdc_k4_vs_k1_worst": dispatch_hold(
            torch, acdc[DISPATCH_K]["state"], acdc[1]["state"],
            exact=False),
        "acdc_image_tags": want_tags, "card": smi})
    print("grid masks and snapshots: " + json.dumps(result), flush=True)
    return launches


def phase_save_result(torch, workdir: str, pth: str, acdc_best: str,
                      panc_best: str):
    """``--save_result 1`` on the three test CLIs' cores, on phase 4's,
    8's and 11's synthetic volumes and checkpoints: each run once without
    and once with the dumps (s/volume of both), launch counts reset before
    and read after the dump run. Every ``{name}_{pred,img,gt}.nii.gz``
    exists, reads back through ``data.preprocess.read_nifti`` equal (as
    float32) to the prediction, image and label the CLI handed its writer,
    whose images and labels are the evaluated volumes (pancreas': the
    centre crops); the case lines with and without the dumps are the
    same."""
    from bcp_tpu_torch.cli import common, test_acdc, test_la, test_pancreas
    from bcp_tpu_torch.data.datasets import VolumeList
    from bcp_tpu_torch.data.preprocess import read_nifti
    from bcp_tpu_torch.data.synthetic import (acdc_cases, la_cases,
                                              pancreas_cases)
    from bcp_tpu_torch.data.transforms import pancreas_test_transform
    _, acdc_vols = acdc_cases(0, n_volumes=2, volume_shape=ACDC_TEST_VOLUME,
                              seed=SEED + 12)
    _, _, panc_vols = pancreas_cases(0, 0, 2, test_shape=PANC_TEST_VOLUME,
                                     seed=SEED + 17)
    panc_crops = [pancreas_test_transform(i, l, PANC_PATCH)
                  for i, l in panc_vols]
    clis = (
        ("la", test_la, la_cases(2, LA_VOLUME, seed=SEED + 2), None,
         ["--torch_ckpt", pth, "--stride_xy", "18", "--stride_z", "4",
          "--eval_batch", str(EVAL_BATCH), "--nms", "1", "--patch_size",
          *map(str, PATCH)]),
        ("acdc", test_acdc, acdc_vols, None, ["--torch_ckpt", acdc_best]),
        ("pancreas", test_pancreas, panc_vols, panc_crops,
         ["--torch_ckpt", panc_best]))
    counters = kernel_counters()
    written = []
    orig = common.ResultWriter.write

    def spy(self, paths, volumes, spacing=(1.0, 1.0, 1.0)):
        written.append((list(paths), [np.array(v, np.float32)
                                      for v in volumes]))
        return orig(self, paths, volumes, spacing)
    common.ResultWriter.write = spy
    launches, result = {}, {}
    try:
        for name, cli, cases, evaluated, flags in clis:
            lines, wall, counts = {}, {}, {}
            for dump in (0, 1):
                root = os.path.join(workdir, f"{name}_{dump}")
                args = cli.build_parser().parse_args(
                    flags + ["--snapshot_root", root, "--device", DEVICE,
                             "--save_result", str(dump)])
                if name == "la":
                    args.root_path = root
                read_launches(counters, reset=True)
                written.clear()
                out = io.StringIO()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    cli.test_calculate_metric(args, dataset=VolumeList(cases))
                wall[dump] = (time.perf_counter() - t0) / len(cases)
                lines[dump] = out.getvalue().splitlines()
                counts[dump] = read_launches(counters)
            launches[f"test_{name}_save_result"] = counts[1]
            if counts[0] != counts[1]:
                fail(f"save_result {name}: launches {counts[1]} with the "
                     f"dumps, {counts[0]} without")
            if lines[0] != lines[1]:
                fail(f"save_result {name}: the dump run printed "
                     f"{lines[1]}, the plain run {lines[0]}")
            files = 0
            for i, (paths, vols) in enumerate(written):
                img, lab = (evaluated or cases)[i]
                if [os.path.basename(p) for p in paths] != [
                        f"{i:02d}_{t}.nii.gz" for t in ("pred", "img", "gt")]:
                    fail(f"save_result {name}: files {paths}")
                for path, vol, want in zip(paths, vols, (None, img, lab)):
                    back = read_nifti(path)
                    if not np.array_equal(back, vol) or (
                            want is not None and not np.array_equal(
                                vol, np.asarray(want, np.float32))):
                        fail(f"save_result {name}: {path} does not read "
                             f"back as what was evaluated")
                    files += 1
            if files != 3 * len(cases):
                fail(f"save_result {name}: {files} files")
            result[name] = {"files": files, "s_per_volume": wall[0],
                            "s_per_volume_with_dumps": wall[1]}
    finally:
        common.ResultWriter.write = orig
    print("save_result: " + json.dumps(result), flush=True)
    return launches


# ---------------------------------------------------------------------------
# 14. data parallelism (--num_devices) and --remat

#: a stage's iterations in phase 14 (a) by K: at K = 4 the first group
#: runs eagerly, the second captures the graphs, the third only replays;
#: the steady ms a step are those of the last four iterations
DP_ITERS = {1: 6, DISPATCH_K: 3 * DISPATCH_K}
#: timed self-train steps of phase 14 (d), after REMAT_WARMUP
REMAT_STEPS = 5
REMAT_WARMUP = 2


def world_device(torch):
    """The device of phase 14's world of one rank: this card."""
    return torch.device("cuda", torch.cuda.current_device())


def collective_calls(trace_path: str):
    """What an exported trace of CPU and CUDA activity holds of the
    collectives: the dispatcher's ``c10d::`` ops the host called, the
    process group's ``nccl:<collective>`` annotations, and the device
    kernels named ``nccl``."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]
    return {"c10d_ops": sum(e.get("cat") == "cpu_op"
                            and e["name"].startswith("c10d::")
                            for e in events),
            "nccl_annotations": sum(e.get("cat") == "user_annotation"
                                    and e["name"].startswith("nccl:")
                                    for e in events),
            "nccl_kernels": sum(e.get("cat") == "kernel"
                                and "nccl" in e["name"].lower()
                                for e in events)}


def dp_batch(torch, cfg, rows: int, seed: int):
    """A global LA or pancreas batch of ``rows`` rows a stream on the
    card: blob volumes cropped to the patch, labels uint8."""
    from bcp_tpu_torch.data.synthetic import la_cases
    cases = la_cases(4 * rows, tuple(cfg.patch_size), seed=seed)
    img = torch.from_numpy(np.stack([c[0] for c in cases])[:, None])
    lab = torch.from_numpy(np.stack([c[1] for c in cases]).astype(np.uint8))
    dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    out = {}
    for i, k in enumerate(("a", "b", "ua", "ub")):
        sl = slice(i * rows, (i + 1) * rows)
        if k.startswith("u"):
            out[f"uimg_{k[1]}"] = img[sl].to(DEVICE, dt)
        else:
            out[f"img_{k}"] = img[sl].to(DEVICE, dt)
            out[f"lab_{k}"] = lab[sl].to(DEVICE)
    return out


def phase_data_parallel(torch, workdir: str, pth: str, smi: str):
    """Phase 14 (a) and (b): the data-parallel code (``parallel.mesh``) in
    a world of one NCCL rank on this card, against the same code outside a
    world.

    (a) ``cli.train_la``'s core at LA's full width (the dispatch phase's
    flags: V-Net n_filters 16, 112x112x80, batch 8, bf16, the device
    store), DP_ITERS iterations a stage at K = 1 and at K = 4 (three
    groups: the second captures CUDA graphs whose capture holds the step's
    all-reduces, the third replays them), once outside a world and once
    inside, with the host ms a step of the last four iterations of each
    stage: every BatchNorm
    statistic, loss sum and the gradients go through an all-reduce, the
    evaluator's score map too, validation runs inline. The world's final
    states must equal the plain runs' bit for bit; where they do not they
    are held to phase 12's rule (STEP_REL) and the worst tensor is
    printed. A traced self-train update in the world counts the
    collectives the host issued and the NCCL kernels the card ran (a
    one-rank in-place sum may need none).

    (b) ``cli.test_la``'s evaluator in the world: one 240x200x96 volume's
    score map equal to the plain evaluator's bit for bit, and the test
    CLI's core on phase 4's two volumes, its metrics equal to the plain
    core's.

    Returns the launches of the world's paths."""
    from bcp_tpu_torch.cli import test_la
    from bcp_tpu_torch.config import la_config
    from bcp_tpu_torch.data.datasets import VolumeList
    from bcp_tpu_torch.data.synthetic import la_cases
    from bcp_tpu_torch.eval.sliding_window import window_starts
    from bcp_tpu_torch.parallel import mesh
    from bcp_tpu_torch.train.state import init_state
    from bcp_tpu_torch.train.steps import selftrain_step
    from bcp_tpu_torch.train.trainer import copy_paste_mask, iteration_draws
    card = world_device(torch)
    data = dispatch_data("la")
    launches, runs, result = {}, {}, {"card": smi}
    for K in (1, DISPATCH_K):
        for way in ("plain", "world"):
            root = os.path.join(workdir, f"dp_{way}_k{K}")
            os.makedirs(root)
            ctx = (mesh.process_group(0, 1, card) if way == "world"
                   else contextlib.nullcontext())
            with ctx:
                if way == "world" and mesh.world_size() != 1:
                    fail("phase 14: the world is not of one rank")
                run = dispatch_run(torch, "la", K, root, data,
                                   f"dp_{way}{K}", iters=DP_ITERS[K])
            run["state"] = {stage: dispatch_state(torch, run, stage)
                            for stage in ("pre", "self")}
            run["state"]["losses"] = run["losses"]
            runs[(way, K)] = run
        launches[f"train_la_world1_k{K}"] = runs[("world", K)]["launches"]
        got, want = runs[("world", K)], runs[("plain", K)]
        # the plain run's background worker validates once more a stage
        # (its evaluator warm-up); the world validates inline, no warm-up
        extra = want["trainer"].validations - got["trainer"].validations
        chunks = -(-len(window_starts(DISPATCH_LA_VAL, PATCH,
                                      got["cfg"].stride_xy,
                                      got["cfg"].stride_z))
                   // got["cfg"].eval_batch)
        expect = dict(want["launches"])
        expect["softmax_scatter_add_windows"] -= extra * chunks
        expect["conv3x3x3_same"] -= extra * chunks * sum(
            n for _, n in CONV_STAGES)
        if extra != 2 or got["launches"] != expect:
            fail(f"phase 14 K={K}: the world's launches {got['launches']} "
                 f"({got['trainer'].validations} validations), the plain "
                 f"run's {want['launches']} ({extra} validations more)")
        exact = all(r == 0 for r, _ in dispatch_hold(
            torch, got["state"], want["state"], exact=True).values())
        n = DP_ITERS[K]
        entry = {"iterations": n, "bit_identical": exact,
                 "graph_counts": got["trainer"].graph_counts,
                 "cli_s": {"plain": want["wall"], "world": got["wall"]},
                 # host clock of the loop's last four iterations
                 "ms_per_step": {
                     way: {stage: (r["clock"].times[stage][n]
                                   - r["clock"].times[stage][n - 4]) / 4e-3
                           for stage in ("pre", "self")}
                     for way, r in (("plain", want), ("world", got))}}
        if not exact:
            held = dispatch_hold(torch, got["state"], want["state"],
                                 exact=False)
            entry["held_to_step_rel"] = held
            entry["why"] = ("the world's sums differ in the last bits from "
                            "the one-device path's")
            if any(r > 1.0 for r, _ in held.values()):
                fail(f"phase 14 K={K}: the world's state differs from the "
                     f"plain run's beyond STEP_REL: {entry}")
        if K > 1:
            groups = DP_ITERS[K] // K
            want_counts = {"pre": {"captures": 1,
                                   "replays": (groups - 1) * K},
                           "self": {"captures": 2,
                                    "replays": 2 * (groups - 1) * K}}
            if got["trainer"].graph_counts != want_counts:
                fail(f"phase 14: graph counts {got['trainer'].graph_counts}"
                     f", expected {want_counts}")
        result[f"k{K}"] = entry

    # the collectives of one traced self-train update in the world
    from torch.profiler import ProfilerActivity, profile
    cfg = la_config(labelnum=4, patch_size=PATCH)
    with mesh.process_group(0, 1, card):
        state = init_state(cfg, DEVICE)
        batch = dp_batch(torch, cfg, 2, SEED + 30)
        gen = torch.Generator(device=DEVICE)
        for it in (1, 2):
            mask = copy_paste_mask(cfg, iteration_draws(1, it, gen), DEVICE)
            if it == 2:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
            selftrain_step(state, batch, mask, cfg, gen, gen)
        torch.cuda.synchronize()
        prof.stop()
    trace = os.path.join(workdir, "dp_world_self_step.json")
    prof.export_chrome_trace(trace)
    calls = collective_calls(trace)
    result["self_step_collectives"] = calls
    if not calls["c10d_ops"] or not calls["nccl_annotations"]:
        fail(f"phase 14: the world's self-train update issued no NCCL "
             f"collective: {calls}")

    # (b) the evaluator and the test CLI's core in the world
    cases = la_cases(2, LA_VOLUME, seed=SEED + 2)
    args = test_la.build_parser().parse_args(
        ["--torch_ckpt", pth, "--snapshot_root", workdir, "--root_path",
         workdir, "--stride_xy", "18", "--stride_z", "4", "--eval_batch",
         str(EVAL_BATCH), "--nms", "1", "--device", DEVICE, "--detail", "0",
         "--patch_size", *map(str, PATCH)])
    _, plain_ev = test_la.build_evaluator(args)
    _, want_score = plain_ev.infer(cases[0][0])
    counters = kernel_counters()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        want_avg = test_la.test_calculate_metric(args,
                                                 dataset=VolumeList(cases))
        with mesh.process_group(0, 1, card):
            _, world_ev = test_la.build_evaluator(args)
            _, got_score = world_ev.infer(cases[0][0])
            read_launches(counters, reset=True)
            got_avg = test_la.test_calculate_metric(
                args, dataset=VolumeList(cases))
            launches["test_la_world1"] = read_launches(counters)
    result["test_la"] = {
        "score_bit_identical": bool(np.array_equal(got_score, want_score)),
        "score_max_abs_err": float(np.abs(got_score - want_score).max()),
        "metrics_world": list(map(float, got_avg)),
        "metrics_plain": list(map(float, want_avg))}
    print("data parallel, world of one NCCL rank: " + json.dumps(result),
          flush=True)
    if not result["test_la"]["score_bit_identical"] \
            or not np.array_equal(got_avg, want_avg):
        fail(f"phase 14: the world's evaluator differs from the plain one: "
             f"{result['test_la']}")
    return launches


def _dp_updates(torch, cfg_kw, start, host, starts, keeps, plab=None):
    """One f32 pre-train and one self-train update at LA's full width from
    ``start`` on this rank's rows of the global batch ``host`` (numpy),
    the mask at ``starts``, the global keep masks ``keeps``; the
    self-train update on ``plab`` (the global pseudo-labels) when given.
    Returns (deltas, losses, the global pseudo-labels) on the host. In a
    world each rank keeps its rows (``mesh.shard_rows`` /
    ``mesh.rank_rows``)."""
    import copy
    from bcp_tpu_torch.config import la_config
    from bcp_tpu_torch.ops.masks import cuboid_mask
    from bcp_tpu_torch.parallel import mesh
    from bcp_tpu_torch.train.state import (TrainState, build_model,
                                           build_optimizer)
    from bcp_tpu_torch.train.steps import pretrain_step, pseudo_labels, \
        selftrain_update
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = la_config(**cfg_kw)

    def state():
        m = build_model(cfg, "train", DEVICE)
        m.load_state_dict(start)
        t = copy.deepcopy(m)
        for p in t.parameters():
            p.requires_grad_(False)
        return TrainState(m, t, build_optimizer(cfg, m.parameters()))
    batch = {k: mesh.shard_rows(torch.from_numpy(v)).to(DEVICE)
             for k, v in host.items()}
    mask = cuboid_mask(cfg.patch_size, starts, device=DEVICE)
    k = {n: [mesh.rank_rows(torch.from_numpy(a), g).to(DEVICE)
             for a in v] for n, (g, v) in keeps.items()}
    pre = state()
    m_pre = pretrain_step(pre, batch, mask, cfg, dropout=k["pre"])
    st = state()
    own = pseudo_labels(st, batch, cfg, dropout=k["teacher"])
    # every rank's (group, row) in rank order -> the global batch's
    # (group, rank, row)
    own = mesh.gather_rows(own)
    own = own.view(mesh.world_size(), 2, -1, *own.shape[1:]).transpose(
        0, 1).reshape(-1, *own.shape[1:]).cpu()
    use = own if plab is None else torch.from_numpy(plab)
    m_self = selftrain_update(st, batch, mesh.rank_rows(use, 2).to(DEVICE),
                              mask, cfg, dropout=k["student"])
    delta = {}
    for tag, mod in (("pre", pre.model), ("self", st.model),
                     ("teacher", st.teacher)):
        for n, v in mod.state_dict().items():
            if not n.endswith("num_batches_tracked"):
                delta[f"{tag}.{n}"] = (v.cpu().double()
                                       - start[n].double()).float()
    for tag, s_ in (("pre", pre), ("self", st)):
        for n, p in s_.model.named_parameters():
            delta[f"{tag}.momentum.{n}"] = s_.optimizer.state[p][
                "momentum_buffer"].cpu().float()
    losses = {f"pre.{n}": float(v) for n, v in m_pre.items()}
    losses.update({f"self.{n}": float(v) for n, v in m_self.items()})
    return delta, losses, own.numpy()


def phase_data_parallel_cards(torch, workdir: str, smi: str):
    """Phase 14 (c), with two or more visible cards: one f32 pre-train and
    one self-train update at LA's full width (n_filters 16, 112x112x80)
    on two ranks (``parallel.mesh.launch``, NCCL over two cards, each rank
    the reference batch of 8) against one process on the global batch of
    16, held to phase 3's rule (the self-train update on the one
    process's pseudo-labels on both sides); then ``cli.train_la`` with
    ``--num_devices 2 --steps_per_dispatch 4`` (host feed, 2 x 4
    iterations a stage, the second group's graphs capturing the NCCL
    all-reduces across the two cards), its final state printed against
    one process's run on the global batch under phase 12's rule. On one
    card it prints that it was not run."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"data parallel over cards: not run, {n} card visible (it "
              f"needs two)", flush=True)
        return {}
    from bcp_tpu_torch.config import la_config
    from bcp_tpu_torch.data.synthetic import la_cases
    from bcp_tpu_torch.ops.masks import cuboid_starts
    from bcp_tpu_torch.parallel import mesh
    from bcp_tpu_torch.train.state import build_model
    W = 2
    cfg_kw = dict(labelnum=4, patch_size=PATCH, compute_dtype="float32")
    cfg = la_config(**cfg_kw)
    cases = la_cases(8 * W, PATCH, seed=SEED + 31)
    img = np.stack([c[0] for c in cases])[:, None]
    lab = np.stack([c[1] for c in cases]).astype(np.uint8)
    r = 2 * W
    host = {"img_a": img[0:r], "img_b": img[r:2 * r],
            "uimg_a": img[2 * r:3 * r], "uimg_b": img[3 * r:4 * r],
            "lab_a": lab[0:r], "lab_b": lab[r:2 * r]}
    rng = np.random.default_rng(SEED + 32)
    starts = cuboid_starts(rng, PATCH)
    start = build_model(cfg, "train", "cpu", seed=SEED).state_dict()
    nf = start["encoder.block_one.conv.0.weight"].shape[0]

    def keep(rows):   # the V-Net's two channel dropouts
        return [rng.random((rows, 16 * nf)) < 0.5,
                rng.random((rows, nf)) < 0.5]
    keeps = {"pre": (1, keep(r)), "teacher": (2, keep(2 * r)),
             "student": (2, keep(2 * r))}
    t0 = time.perf_counter()
    want, want_loss, plab = _dp_updates(torch, cfg_kw, start, host, starts,
                                        keeps)
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, got_loss, got_plab = mesh.launch(
        _dp_updates_rank, W, DEVICE, cfg_kw, start, host, starts, keeps,
        plab)
    t_two = time.perf_counter() - t0

    def group(name):
        head, last = name.rsplit(".", 1)
        return head, last.startswith("running")
    scale = {}
    for name, d in want.items():
        g = group(name)
        scale[g] = max(scale.get(g, 0.0), d.abs().max().item())
    step = _compare_step(
        torch, {k: v.double() for k, v in want.items()}, want_loss,
        {k: v.double() for k, v in got.items()}, got_loss, start, scale,
        float(np.finfo(np.float32).eps), group,
        {"ranks": W, "rows_a_rank": 8, "cards": n, "card": smi,
         "pseudo_label_flips": int((got_plab != plab).sum()),
         "one_process_s": t_one, "two_ranks_s": t_two},
        patch=PATCH, label="data parallel two ranks vs one process")

    # the CLI on two cards at K = 4 against one process on the global batch
    from bcp_tpu_torch.cli import train_la
    data = dispatch_data("la")
    iters = str(2 * DISPATCH_K)
    runs = {}
    for tag, extra in (("two", ["--num_devices", "2"]),
                       ("one", ["--batch_size", "16", "--labeled_bs", "8"])):
        root = os.path.join(workdir, f"dp_cards_{tag}")
        os.makedirs(root)
        args = train_la.build_parser().parse_args(
            ["--labelnum", "4", "--root_path", root, "--snapshot_root", root,
             "--device", DEVICE, "--pre_max_iteration", iters,
             "--self_max_iteration", iters, "--steps_per_dispatch",
             str(DISPATCH_K), "--device_data_cache", "0", *extra])
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            _, stages = train_la.train(args, train_dataset=data[0],
                                       val_cases=data[1], patch_size=PATCH,
                                       eval_every=2 * DISPATCH_K)
        wall = time.perf_counter() - t0
        run = {"stages": stages, "cfg": train_la.config_from_args(
            args, patch_size=PATCH), "wall": wall}
        for stage in ("pre", "self"):
            found = logged_losses(stages[stage][1])
            if sorted(found) != list(range(1, 2 * DISPATCH_K + 1)) \
                    or not all(np.isfinite(v) for m in found.values()
                               for v in m.values()):
                fail(f"train_la {tag} {stage}-train: losses {found}")
        run["state"] = {stage: dispatch_state(torch, run, stage)
                        for stage in ("pre", "self")}
        run["state"]["losses"] = {stage: logged_losses(
            run["stages"][stage][1]) for stage in ("pre", "self")}
        runs[tag] = run
    held = dispatch_hold(torch, runs["two"]["state"], runs["one"]["state"],
                         exact=False)
    cli = {"card": smi, "K": DISPATCH_K, "iterations": 2 * DISPATCH_K,
           "held_to_step_rel": held,
           "cli_s": {k: v["wall"] for k, v in runs.items()}}
    print("data parallel train_la two cards vs one process: "
          + json.dumps(cli), flush=True)
    return {"step": step, "cli": cli}


def logged_losses(best_path: str):
    """{iteration: {loss name: value}} of a stage's ``log.txt``."""
    log = open(os.path.join(os.path.dirname(best_path), "log.txt")).read()
    return {int(it): {k: float(v) for k, v in re.findall(
        r"(\w+): (\S+)", rest)}
        for it, rest in re.findall(r"iteration (\d+) : (.*)", log)}


def _dp_updates_rank(*args):
    import torch
    return _dp_updates(torch, *args)


def phase_remat(torch, workdir: str, smi: str):
    """Phase 14 (d): ``--remat 1`` on LA (112x112x80, batch 8, bf16) and
    pancreas (96^3, batch 8, bf16), the CLIs' defaults: the self-train
    step from one seeded state with and without remat, in turns (plain,
    remat, plain, remat), REMAT_WARMUP steps then REMAT_STEPS timed ones
    (host clock around synchronised steps) and the peak memory of the
    timed ones (``torch.cuda.max_memory_allocated``). The remat runs'
    states after all steps equal the plain runs' bit for bit, else are
    held to phase 12's rule. Returns the launches of each variant's remat
    runs."""
    from bcp_tpu_torch.config import la_config, pancreas_config
    from bcp_tpu_torch.train.checkpoints import snapshot
    from bcp_tpu_torch.train.state import init_state
    from bcp_tpu_torch.train.steps import selftrain_step
    from bcp_tpu_torch.train.trainer import copy_paste_mask, iteration_draws
    counters = kernel_counters()
    launches, report = {}, {"card": smi}
    for variant, cfg in (("la", la_config(labelnum=4, patch_size=PATCH)),
                         ("pancreas", pancreas_config())):
        batch = dp_batch(torch, cfg, 2, SEED + 33)
        runs, warm = [], None
        for remat in (False, True, False, True):
            state = init_state(cfg.replace(remat=remat), DEVICE)
            gen = torch.Generator(device=DEVICE)
            if remat:
                read_launches(counters, reset=True)
            times = []
            for it in range(1, REMAT_WARMUP + REMAT_STEPS + 1):
                mask = copy_paste_mask(cfg, iteration_draws(3, it, gen),
                                       DEVICE)
                if it == REMAT_WARMUP + 1:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    if warm is None:    # the rule's start: plain, warm
                        warm = snapshot(state)
                t0 = time.perf_counter()
                selftrain_step(state, batch, mask, cfg, gen, gen)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            if remat:
                counts = read_launches(counters)
                launches[f"remat_{variant}"] = {
                    k: launches.get(f"remat_{variant}", {}).get(k, 0) + v
                    for k, v in counts.items()}
            runs.append({"remat": remat,
                         "ms_per_step": 1e3 * float(np.mean(
                             times[REMAT_WARMUP:])),
                         "peak_mem_gib": torch.cuda.max_memory_allocated()
                         / 2**30,
                         "state": snapshot(state)})
        exact = all(_state_equal(runs[i]["state"], runs[i - 1]["state"])
                    for i in (1, 3))
        entry = {"runs": [{k: v for k, v in r.items() if k != "state"}
                          for r in runs],
                 "updates_bit_identical": exact}
        if not exact:
            worst = max(_lockstep_ratio(warm, runs[i]["state"],
                                        runs[i - 1]["state"], False,
                                        float(np.finfo(np.float32).eps))
                        for i in (1, 3))
            entry["held_to_step_rel"] = worst
            if worst[0] > 1.0:
                fail(f"remat {variant}: the updates differ from the plain "
                     f"ones beyond STEP_REL: {entry}")
        report[variant] = entry
        print(f"remat {variant} self-train step ({smi}): "
              + json.dumps(entry), flush=True)
    return launches


#: phase 15's splits of the leading spatial axis
SP_SPLITS = (2, 4)
#: phase 15 (a)'s batch: the self-train student's concat batch of a rank
SP_BATCH = 4


def sp_levels(patch, nf: int):
    """(level, channels, shape) of the V-Net's five levels at ``patch``."""
    return [(lvl, nf << lvl, tuple(s >> lvl for s in patch))
            for lvl in range(5)]


def phase_spatial_slabs(torch, smi: str):
    """Phase 15 (a): every halo'd conv of a space split, slab by slab in one
    process, against the whole-volume launch, at LA's (112x112x80) and
    pancreas' (96^3) full width (n_filters 16), S = 2 and 4, bf16, batch
    SP_BATCH. Each slab gets its neighbours' planes through
    ``mesh.halo_slabs`` (the exchange's own ``pad_slab``); at each sliced
    level (``layers.gathered_level``) with Ci = Co: kernel B on the padded
    slabs through ``Conv3x3x3Function``'s halo forward (its crop) against B
    on the whole volume; B-as-dx on the zero-padded dy of each slab,
    folded back by ``mesh.fold_slabs``, against B-as-dx of the whole; C's
    f32 dW summed over the slabs against C of the whole; D's dx and dW the
    same way; at level 0 block_one's ``F.conv3d`` (Ci = 1, VALID in x).
    Limits are phase 2's: forward and dx max|slabs - whole| <= 1e-2
    max|whole|, dW 1e-3. Prints each level as sliced or replicated, and
    the CUDA-event ms of B's forward on the whole volume beside the S
    slabs' pads and forwards (the split's overhead on one card: the pad
    copies and the 2 / Xs extra planes). Returns the launches made on the
    slabs."""
    from bcp_tpu_torch.models.layers import gathered_level
    from bcp_tpu_torch.ops.conv3d import (Conv3x3x3Function, conv3x3x3_dw,
                                          conv3x3x3_dx, conv3x3x3_dxdw,
                                          conv3x3x3_same)
    from bcp_tpu_torch.parallel import mesh
    import torch.nn.functional as F
    counters = kernel_counters()
    report, launches = {"card": smi}, {}
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 40)
    cl = torch.channels_last_3d

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=DEVICE).to(
            torch.bfloat16).contiguous(memory_format=cl)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item() / max(
            b.float().abs().max().item(), 1e-30)

    for variant, patch in (("la", PATCH), ("pancreas", PANC_PATCH)):
        for S in SP_SPLITS:
            first = gathered_level(patch[0] // S, 4)
            rows = []
            for lvl, C, shape in sp_levels(patch, 16):
                sliced = first is None or lvl <= first
                row = {"level": lvl, "channels": C, "shape": list(shape),
                       "slab": shape[0] // S if sliced else shape[0],
                       "split": "sliced" if sliced else "replicated"}
                rows.append(row)
                if not sliced:
                    continue
                x, dy = rnd(SP_BATCH, C, *shape), rnd(SP_BATCH, C, *shape)
                w = rnd(C, C, 3, 3, 3).contiguous()
                with torch.no_grad():
                    want = {"forward": conv3x3x3_same(x, w),
                            "dx": conv3x3x3_dx(dy, w),
                            "dw": conv3x3x3_dw(x, dy)}
                    want["dxdw_dx"], want["dxdw_dw"] = conv3x3x3_dxdw(x, dy,
                                                                      w)
                    read_launches(counters, reset=True)
                    pads = mesh.halo_slabs(x, S)
                    dys = [F.pad(d, (0, 0, 0, 0, 1, 1)).contiguous(
                        memory_format=cl) for d in dy.chunk(S, 2)]
                    got = {"forward": torch.cat([Conv3x3x3Function.apply(
                               p, w, False, True) for p in pads], 2),
                           "dx": mesh.fold_slabs([conv3x3x3_dx(d, w)
                                                  for d in dys]),
                           "dw": sum(conv3x3x3_dw(p, d)
                                     for p, d in zip(pads, dys))}
                    fused = [conv3x3x3_dxdw(p, d, w)
                             for p, d in zip(pads, dys)]
                    got["dxdw_dx"] = mesh.fold_slabs([f[0] for f in fused])
                    got["dxdw_dw"] = sum(f[1] for f in fused)
                    counts = read_launches(counters)
                    row["whole_forward_ms"] = cuda_ms(
                        torch, lambda: conv3x3x3_same(x, w))
                    row["slabs_pad_and_forward_ms"] = cuda_ms(
                        torch, lambda: [Conv3x3x3Function.apply(
                            p, w, False, True)
                            for p in mesh.halo_slabs(x, S)])
                    read_launches(counters, reset=True)
                launches = {k: launches.get(k, 0) + v
                            for k, v in counts.items()}
                for k in want:
                    row[k] = err(got[k], want[k])
                    limit = 1e-3 if k.endswith("dw") else 1e-2
                    if not row[k] <= limit:
                        fail(f"phase 15 (a) {variant} S={S} level {lvl}: "
                             f"{k} of the slabs differs from the whole "
                             f"volume's: {row}")
                if lvl == 0:    # block_one: Ci = 1, F.conv3d
                    x1, w1 = rnd(SP_BATCH, 1, *shape), rnd(C, 1, 3, 3, 3)
                    with torch.no_grad():
                        whole = F.conv3d(x1, w1, padding=1)
                        part = torch.cat([F.conv3d(p, w1, padding=(0, 1, 1))
                                          for p in mesh.halo_slabs(x1, S)],
                                         2)
                    row["block_one_f_conv3d"] = err(part, whole)
                    if not row["block_one_f_conv3d"] <= 1e-2:
                        fail(f"phase 15 (a) {variant} S={S}: block_one's "
                             f"F.conv3d on the slabs differs: {row}")
                del x, dy, w, want, got, fused, pads, dys
            report[f"{variant}_S{S}"] = {"gathered_level": first,
                                         "levels": rows}
            print(f"spatial slabs {variant} S={S}: " + json.dumps(
                report[f"{variant}_S{S}"]), flush=True)
    return launches


def _sp_config(variant: str):
    from bcp_tpu_torch.config import la_config, pancreas_config
    if variant == "la":
        return la_config(labelnum=4, patch_size=PATCH,
                         compute_dtype="float32")
    return pancreas_config(compute_dtype="float32")


def sp_inputs(torch, variant: str):
    """Phase 15's global f32 inputs of one data index: the reference batch
    (2 + 2 labelled, 2 + 2 unlabelled rows) of blob volumes at the
    variant's full-width patch, the copy-paste mask, LA's channel-dropout
    keep masks, the seeded start state_dict."""
    from bcp_tpu_torch.data.synthetic import la_cases
    from bcp_tpu_torch.ops.masks import (cuboid_mask, cuboid_mask_fixed,
                                         cuboid_starts, fixed_starts)
    from bcp_tpu_torch.train.state import build_model
    cfg = _sp_config(variant)
    patch = tuple(cfg.patch_size)
    cases = la_cases(8, patch, seed=SEED + 41)
    img = np.stack([c[0] for c in cases])[:, None]
    lab = np.stack([c[1] for c in cases]).astype(np.uint8)
    host = {"img_a": img[0:2], "img_b": img[2:4], "uimg_a": img[4:6],
            "uimg_b": img[6:8], "lab_a": lab[0:2], "lab_b": lab[2:4]}
    rng = np.random.default_rng(SEED + 42)
    start = build_model(cfg, "train", "cpu", seed=SEED).state_dict()
    if variant == "la":
        mask = cuboid_mask(patch, cuboid_starts(rng, patch))
        nf = start["encoder.block_one.conv.0.weight"].shape[0]

        def keep(rows):   # the V-Net's two channel dropouts
            return [rng.random((rows, 16 * nf)) < 0.5,
                    rng.random((rows, nf)) < 0.5]
        # pre-train: the 2 mixed labelled rows; the teacher's and the
        # student's concat forwards: 2 + 2 rows in two groups
        keeps = {"pre": (1, keep(2)), "teacher": (2, keep(4)),
                 "student": (2, keep(4))}
    else:
        mask = cuboid_mask_fixed(patch, fixed_starts(rng, patch,
                                                     cfg.mask_patch),
                                 cfg.mask_patch)
        keeps = {}
    return host, mask.numpy().astype(np.int32), keeps, start


def _sp_updates(torch, variant: str, inputs, plab, sp: int):
    """One f32 pre-train and one self-train update of ``variant`` at full
    width from phase 15's ``inputs`` on this rank's part of the global
    batch (a world of one data index: every row, x slab s of ``sp``; the
    whole batch outside a world), the self-train update on the pseudo-
    labels ``plab`` (the one process's) when given. Returns (parameter
    gradients, f32 updates and optimizer state of the two updates, losses,
    this side's own whole pseudo-labels, the peak GiB of the updates from
    after the state is built, the launches, and in a world the
    collectives the self-train step issued, by ``c10d`` op, from a host
    trace of it)."""
    import copy
    from bcp_tpu_torch.parallel import mesh
    from bcp_tpu_torch.train.state import (TrainState, build_model,
                                           build_optimizer)
    from bcp_tpu_torch.train.steps import (pretrain_step, pseudo_labels,
                                           selftrain_update)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh.set_space(sp if mesh.active() else 1)
    if mesh.data_size() != 1:
        raise ValueError("phase 15's updates run one data index")
    host, mask, keeps, start = inputs
    cfg = _sp_config(variant)

    def state():
        m = build_model(cfg, "train", DEVICE)
        m.load_state_dict(start)
        t = copy.deepcopy(m)
        for p in t.parameters():
            p.requires_grad_(False)
        return TrainState(m, t, build_optimizer(cfg, m.parameters()))
    batch = {k: mesh.shard_space(torch.from_numpy(v), 1 if k.startswith(
        "lab") else 2).contiguous().to(DEVICE) for k, v in host.items()}
    mask_t = torch.from_numpy(mask).to(DEVICE)
    k = {n: [mesh.rank_rows(torch.from_numpy(a), grp).to(DEVICE)
             for a in v] for n, (grp, v) in keeps.items()}
    counters = kernel_counters()
    read_launches(counters, reset=True)
    pre = state()
    st = state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m_pre = pretrain_step(pre, batch, mask_t, cfg, dropout=k.get("pre"))
    # the self-train step's collectives, counted on the host
    trace = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU]) if mesh.active()
        else contextlib.nullcontext())
    with trace:
        own = pseudo_labels(st, batch, cfg, dropout=k.get("teacher"))
        own = mesh.gather_space(own, 1).cpu()
        use = own if plab is None else torch.from_numpy(plab)
        m_self = selftrain_update(st, batch, mesh.shard_space(
            use, 1).to(DEVICE), mask_t, cfg, dropout=k.get("student"))
        torch.cuda.synchronize()
    calls = ({e.key: e.count for e in trace.key_averages()
              if e.key.startswith("c10d::")} if mesh.active() else {})
    peak = torch.cuda.max_memory_allocated() / 2**30
    grads = {f"{tag}.{n}": p.grad.cpu().double()
             for tag, s_ in (("pre", pre), ("self", st))
             for n, p in s_.model.named_parameters()}
    delta = {}
    for tag, mod in (("pre", pre.model), ("self", st.model),
                     ("teacher", st.teacher)):
        for n, v in mod.state_dict().items():
            if not n.endswith("num_batches_tracked"):
                delta[f"{tag}.{n}"] = (v.cpu().double()
                                       - start[n].double()).float()
    for tag, s_ in (("pre", pre), ("self", st)):
        for n, p in s_.model.named_parameters():
            buf = s_.optimizer.state[p].get("momentum_buffer")
            if buf is not None:
                delta[f"{tag}.momentum.{n}"] = buf.cpu().float()
    losses = {f"pre.{n}": float(v) for n, v in m_pre.items()}
    losses.update({f"self.{n}": float(v) for n, v in m_self.items()})
    return (grads, delta, losses, own.numpy(), peak, read_launches(counters),
            calls)


def _hold_sp(torch, variant, want, got, start, extra, label):
    """The split run's update ``got`` against the one process's ``want``
    under phase 3's rule: LA's updates and momentum buffers (SGD) as phase
    14 (c) holds them; pancreas' gradients as phase 9 does (Adam's first
    update turns the zero gradient of a conv bias in front of an instance
    norm into a move of about lr with a sign the rounding picks: those
    biases must stay below BIAS_NOISE of their module's weight
    gradient)."""
    wg, wd, wl, plab = want[:4]
    gg, gd, gl, gplab = got[:4]
    extra = dict(extra, pseudo_label_flips=int((gplab != plab).sum()),
                 pseudo_label_voxels=int(plab.size))
    if gplab.shape != plab.shape or \
            extra["pseudo_label_flips"] > FLIP_SHARE * plab.size:
        fail(f"{label}: the pseudo-labels differ: {extra}")
    if variant == "la":
        def group(name):
            head, last = name.rsplit(".", 1)
            return head, last.startswith("running")
        scale = {}
        for name, d in wd.items():
            scale[group(name)] = max(scale.get(group(name), 0.0),
                                     d.abs().max().item())
        return _compare_step(
            torch, {k: v.double() for k, v in wd.items()}, wl,
            {k: v.double() for k, v in gd.items()}, gl, start, scale,
            float(np.finfo(np.float32).eps), group, extra, patch=PATCH,
            label=label)

    def cancelling(n):      # a conv bias in front of an instance norm
        return n.endswith(".bias") and ".branchs.0.1." not in n
    scale = {}
    for n, g_ in wg.items():
        if not cancelling(n):
            mod = n.rsplit(".", 1)[0]
            scale[mod] = max(scale.get(mod, 0.0), g_.abs().max().item())
    ratios, noise = [], []
    for n, g_ in wg.items():
        s_ = scale[n.rsplit(".", 1)[0]]
        if cancelling(n):
            e = max(gg[n].abs().max().item(), g_.abs().max().item())
            noise.append((e / s_ if s_ else (0.0 if e == 0 else np.inf), n))
        else:
            e = (gg[n] - g_).abs().max().item()
            ratios.append((e / (STEP_REL * s_) if s_ else
                           (0.0 if e == 0 else np.inf), n))
    ratios.sort(reverse=True)
    noise.sort(reverse=True)
    lworst = max((abs(gl[n] - wl[n]) / max(abs(wl[n]), 1e-12), n)
                 for n in wl)
    result = {"patch": list(PANC_PATCH), "tensors": len(wg),
              "rel_limit": STEP_REL,
              "worst_grad_err_over_limit": ratios[0][0],
              "worst_tensor": ratios[0][1],
              "next_worst": [[r, n] for r, n in ratios[1:4]],
              "worst_bias_grad_over_weight_grad": noise[0][0],
              "bias_noise_limit": BIAS_NOISE, "max_rel_loss_err": lworst[0],
              **extra}
    print(f"{label}: " + json.dumps(result), flush=True)
    if not all(np.isfinite(v) for v in gl.values()) or ratios[0][0] > 1.0 \
            or noise[0][0] > BIAS_NOISE or lworst[0] > 1e-4:
        fail(f"{label}: the split update differs: {result}")
    return result


def _sp_rank(*args):
    import torch
    return _sp_updates(torch, *args)


def _shared_card_rank(rank: int, tmp: str, variant: str, inputs, plab):
    """One of two gloo ranks sharing ``cuda:0`` (phase 15 (b)):
    :func:`_sp_updates` at S = 2 (gloo reduces, all-gathers and
    reduce-scatters CUDA tensors through the host). Each rank writes its
    result."""
    import pickle
    import torch
    from bcp_tpu_torch import kernels
    from bcp_tpu_torch.parallel import mesh
    with mesh.process_group(rank, 2, "cuda:0", "file://" + os.path.join(
            tmp, "store"), backend="gloo"):
        kernels.build_for_world()
        out = _sp_updates(torch, variant, inputs, plab, 2)
    with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def phase_spatial_shared_card(torch, smi: str):
    """Phase 15 (b): ``train_la``'s and ``train_pancreas``' f32 update at
    full width with S = 2 on this one card: two gloo ranks share
    ``cuda:0`` (NCCL refuses two ranks on one card), K = 1 (gloo captures
    nothing), against one process on the whole batch under phase 3's rule
    (:func:`_hold_sp`), with each rank's peak memory beside the one
    process's and the collectives of rank 0's self step. Returns the
    launches of rank 0's updates."""
    import pickle
    import shutil
    import torch.multiprocessing as mp
    launches, report = {}, {"card": smi}
    for variant in ("la", "pancreas"):
        inputs = sp_inputs(torch, variant)
        one = _sp_updates(torch, variant, inputs, None, 1)
        torch.cuda.empty_cache()
        tmp = tempfile.mkdtemp(prefix="bcp_sp_")
        try:
            t0 = time.perf_counter()
            mp.start_processes(_shared_card_rank,
                               args=(tmp, variant, inputs, one[3]),
                               nprocs=2, join=True, start_method="spawn")
            t_two = time.perf_counter() - t0
            outs = []
            for r in range(2):
                with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                    outs.append(pickle.load(f))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        got = outs[0]
        report[variant] = _hold_sp(
            torch, variant, one, got, inputs[3],
            {"card": smi, "S": 2, "ranks_on_one_card": 2,
             "peak_gib_one_process": one[4],
             "peak_gib_ranks": [o[4] for o in outs],
             "self_step_collectives_rank0": got[6], "ranks_s": t_two},
            f"spatial S=2 two gloo ranks on one card vs one process "
            f"({variant})")
        launches[f"train_{variant}_sp2_shared_card"] = got[5]
    return launches


def phase_spatial_cards(torch, workdir: str, smi: str):
    """Phase 15 (c), with two or more visible cards: the f32 full-width
    update of LA and pancreas at N = S = 2 on two NCCL ranks against one
    process (:func:`_hold_sp`, each rank's peak memory beside the one
    process's); then ``cli.train_la`` at LA's full width with
    ``--num_devices 2 --sp_devices 2 --steps_per_dispatch 4`` (host feed,
    2 x 4 iterations a stage: the second group's CUDA graphs capture the
    halo all-gathers, the gathers and the space sums) and, with four
    cards, ``--num_devices 4 --sp_devices 2`` for one step a stage; their
    losses finite. On one card it prints that it was skipped and why."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"spatial partitioning over cards: skipped, {n} card visible "
              f"(it needs two; on a machine with several cards run "
              f"python3 chip_smoke.py --only spatial_cards)", flush=True)
        return {}
    from bcp_tpu_torch.cli import train_la
    from bcp_tpu_torch.parallel import mesh
    report = {"card": smi, "cards": n}
    for variant in ("la", "pancreas"):
        inputs = sp_inputs(torch, variant)
        t0 = time.perf_counter()
        one = _sp_updates(torch, variant, inputs, None, 1)
        t_one = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        got = mesh.launch(_sp_rank, 2, DEVICE, variant, inputs, one[3], 2)
        t_two = time.perf_counter() - t0
        report[variant] = _hold_sp(
            torch, variant, one, got, inputs[3],
            {"card": smi, "S": 2, "peak_gib_one_process": one[4],
             "peak_gib_rank0": got[4], "launches_rank0": got[5],
             "self_step_collectives_rank0": got[6],
             "one_process_s": t_one, "two_ranks_s": t_two},
            f"spatial S=2 two NCCL ranks vs one process ({variant})")
    data = dispatch_data("la")
    runs = [("n2_sp2_k4", 2, ["--steps_per_dispatch", str(DISPATCH_K)],
             2 * DISPATCH_K)]
    if n >= 4:
        runs.append(("n4_sp2_k1", 4, [], 1))
    for tag, ranks, extra, iters in runs:
        root = os.path.join(workdir, f"sp_cards_{tag}")
        os.makedirs(root)
        args = train_la.build_parser().parse_args(
            ["--labelnum", "4", "--root_path", root, "--snapshot_root", root,
             "--device", DEVICE, "--pre_max_iteration", str(iters),
             "--self_max_iteration", str(iters), "--device_data_cache", "0",
             "--num_devices", str(ranks), "--sp_devices", "2", *extra])
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            _, stages = train_la.train(args, train_dataset=data[0],
                                       val_cases=data[1], patch_size=PATCH,
                                       eval_every=iters)
        entry = {"ranks": ranks, "sp": 2, "iterations": iters,
                 "cli_s": time.perf_counter() - t0}
        for stage in ("pre", "self"):
            found = logged_losses(stages[stage][1])
            if sorted(found) != list(range(1, iters + 1)) \
                    or not all(np.isfinite(v) for m in found.values()
                               for v in m.values()):
                fail(f"train_la {tag} {stage}-train: losses {found}")
            entry[f"{stage}_last_losses"] = found[iters]
            log = open(os.path.join(os.path.dirname(stages[stage][1]),
                                    "log.txt")).read()
            want = (f"mesh over {ranks} devices: data={ranks // 2} space=2 "
                    f"(global batch {8 * ranks // 2})")
            if want not in log:
                fail(f"train_la {tag}: no mesh line {want!r}")
        report[f"train_la_{tag}"] = entry
        print(f"spatial train_la {tag}: " + json.dumps(entry), flush=True)
    return report


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    import bcp_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from bcp_tpu_torch import kernels
    t_start = time.perf_counter()
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
    only = {"data_parallel_cards": phase_data_parallel_cards,
            "spatial_cards": phase_spatial_cards}
    if len(sys.argv) == 3 and sys.argv[1] == "--only" \
            and sys.argv[2] in only:
        # phase 14 (c) or 15 (c) alone, for a machine with several cards
        with tempfile.TemporaryDirectory(dir=work_root) as workdir:
            if not only[sys.argv[2]](torch, workdir, smi):
                fail(f"--only {sys.argv[2]} needs two visible cards")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}: run with none, or with "
             f"--only data_parallel_cards or --only spatial_cards")
    with tempfile.TemporaryDirectory(dir=work_root) as workdir:
        entries = phase_overlap_add(torch, rates, workdir)
        entries += phase_kernels(torch, rates)
        entries += phase_backward_kernels(torch, rates)
        pancreas = phase_pancreas_kernels(torch, rates)
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
        phase_acdc_step(torch)
        launches["train_acdc"], acdc_best = phase_acdc_training(
            torch, os.path.join(workdir, "acdc"))
        launches["test_acdc"] = phase_acdc_test(torch, acdc_best, workdir)
        phase_pancreas_step(torch)
        launches["train_pancreas"], panc_best = phase_pancreas_training(
            torch, os.path.join(workdir, "pancreas"))
        launches["test_pancreas"] = phase_pancreas_test(torch, panc_best,
                                                        workdir)
        steady = {}
        for variant in ("la", "acdc", "pancreas"):
            counts, steady[variant] = phase_dispatch(
                torch, os.path.join(workdir, "dispatch"), variant, smi)
            launches.update(counts)
        launches.update(phase_masks_and_snapshots(
            torch, os.path.join(workdir, "options"), smi, steady["la"]))
        launches.update(phase_save_result(
            torch, os.path.join(workdir, "save_result"), pth, acdc_best,
            panc_best))
        launches.update(phase_data_parallel(
            torch, os.path.join(workdir, "data_parallel"), pth, smi))
        phase_data_parallel_cards(
            torch, os.path.join(workdir, "data_parallel_cards"), smi)
        launches.update(phase_remat(torch, os.path.join(workdir, "remat"),
                                    smi))
        launches["spatial_slabs"] = phase_spatial_slabs(torch, smi)
        launches.update(phase_spatial_shared_card(torch, smi))
        phase_spatial_cards(torch, os.path.join(workdir, "spatial_cards"),
                            smi)
    for e in entries:
        if e["name"] in pancreas:
            # B's, B-as-dx's and C's device times at the 96^3 stage shapes
            e["pancreas"] = pancreas[e["name"]]
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
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
