#!/usr/bin/env python3
"""Check and time the variants of the port's bf16 3x3x3 conv kernel
(``bcp_tpu_torch/kernels/csrc/conv3x3x3.cu``) on one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/torch_conv_variants.py --check
    PYTHONPATH=. python3 scripts/torch_conv_variants.py --sweep [--out F.json]
    PYTHONPATH=. python3 scripts/torch_conv_variants.py --profile
    PYTHONPATH=. python3 scripts/torch_conv_variants.py --dxdw [--out F.json]
    PYTHONPATH=. python3 scripts/torch_conv_variants.py --dw [--out F.json] \
        [--old DIR]
    PYTHONPATH=. python3 scripts/torch_conv_variants.py --pancreas --check \
        --sweep --dw --dxdw

``--pancreas`` runs any of the others at the pancreas V-Net's stage shapes
(a 96^3 patch: 16@96^3 down to 256@6^3) instead of the LA V-Net's
(112x112x80), with the forward at batch 16 (the evaluator's chunk), 4 and
2.

``--check`` holds the kernel against the plain version
(``conv3x3x3_same_reference``; bf16 max|k - p| <= 1e-2 max|p|) with the
variant :func:`bcp_tpu_torch.ops.conv3d.conv_variant` picks and with forced
variants (two and four tiles per box, streamed and persistent weights, two
and four warpgroups, every ring depth, K splits, every N tile, the
flipped taps of dx) at the V-Net's stage shapes and at ragged ones, and
checks that two runs give the same bits. ``--sweep`` times every variant
that fits in shared memory at the five stage shapes at batch 8 and 4 (device
time of the whole wrapper call, weight packing included: 20 calls in a CUDA
graph, median of 7 replays) beside ``F.conv3d`` in the same process, prints
the fastest few, what ``conv_variant`` picks and the sums over the 20
launches of a V-Net forward, and writes all of them as JSON. The picker's
rules were set from this sweep. ``--profile`` prints the device time of
each kernel a wrapper call launches (weight packing, the conv, the K
splits' second pass) and of ``F.conv3d``'s.

``--dxdw`` does for the fused backward (kernel D,
``bcp_tpu_torch/kernels/csrc/conv3x3x3_dxdw.cu``) what ``--sweep`` does for
the conv: at the five stage shapes of the batch-4 backward it checks and
times (device time in a CUDA graph) every (ci tile, co group) pair with
every ring depth that fits and with a half, the picked and a double number
of splits, beside kernel B as dx followed by kernel C and beside
``conv3d_input`` + ``conv3d_weight``, prints what
:func:`bcp_tpu_torch.ops.conv3d.dxdw_variant` picks and the sums over the
20 launches of one backward. The picker's rules were set from it.

``--dw`` does the same for the weight gradient (kernel C,
``bcp_tpu_torch/kernels/csrc/conv3x3x3_dw.cu``) at the five stage shapes of
the batch-4 backward and at the odd, ragged and Ci != Co shapes of the
card-only tests: every (ci tile, co group) pair that divides the shape,
with boxes of 3 and 4 z planes, with every ring depth that fits, with
half, the picked and double the splits (and one split where it picks at
most 16), and with the picked splits rounded to thread-block clusters of
2, 4 and 8 CTAs that add their partial sums through distributed shared
memory, is held against ``conv3x3x3_dw_reference`` (max|k - p| <= 1e-3
max|p|, the same bits twice) and timed on the device beside
``torch.nn.grad.conv3d_weight``; it prints what
:func:`bcp_tpu_torch.ops.conv3d.dw_variant` picks, CUDA-event times of the
picked variant and of ``conv3d_weight``, and the sums over the 20 launches
of one backward (picked, best variant of each shape, library). With
``--old DIR`` (a checkout of another commit, e.g. ``git archive`` of the
parent unpacked under ``_work/``) it also times that commit's
``conv3x3x3_dw`` at the same shapes, in a child process whose
``PYTHONPATH`` is DIR, on the same card. The picker's rules were set from
it.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from bcp_tpu_torch.ops import conv3d as C

STAGES = [(16, 112, 112, 80), (32, 56, 56, 40), (64, 28, 28, 20),
          (128, 14, 14, 10), (256, 7, 7, 5)]
PANCREAS_STAGES = [(16, 96, 96, 96), (32, 48, 48, 48), (64, 24, 24, 24),
                   (128, 12, 12, 12), (256, 6, 6, 6)]
#: the forward's batches: the evaluator's chunk, the student's forward;
#: ``--pancreas`` sets the pancreas evaluator's 16, then 4 and 2
BATCHES = [8, 4]


def cuda_ms(fn, n: int = 10) -> float:
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


def device_ms(fn, n: int = 20) -> float:
    """Device time of one call: ``n`` calls captured in a CUDA graph and
    replayed, so that a slow host does not show in the time of a short
    kernel."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay, 7) / n


def case(B, ci, co, X, Y, Z, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, ci, X, Y, Z), generator=gen, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    w = (torch.randn((co, ci, 3, 3, 3), generator=gen, device="cuda")
         / (27 * ci) ** 0.5).to(torch.bfloat16)
    return x, w


def variants(B, X, Y, Z, ci, co, sms):
    """Every variant of the shape that fits: tiles per warpgroup, N tile,
    warpgroups, K split, weights streamed or persistent, ring depth, one to
    four CTAs per SM."""
    chunks = ci // 16
    out = []
    for tiles, bn, wg, ksplit, persist, stages, per_sm in itertools.product(
            (4, 2), (64, 32, 16), (2, 4), (1, 2, 4, 8, 16), (False, True),
            (2, 3, 4), (1, 2, 3, 4)):
        if co % bn or chunks % ksplit:
            continue
        if wg == 4 and bn * tiles > 128:
            continue      # four warpgroups have 128 registers a thread
        if math.ceil(Z / tiles) * tiles >= Z + 2 * tiles:
            continue      # taller than the volume twice over
        boxes = B * math.prod(math.ceil(v / t) for v, t in zip(
            (X, Y, Z), (*C.CONV_TILE, tiles)))
        groups = math.ceil(boxes / wg)
        gy = (co // bn) * ksplit
        gx = min(groups, max(1, per_sm * sms // gy))
        v = C.ConvVariant(tiles, bn, wg, stages, persist, ksplit, gx)
        if per_sm * (v.smem_bytes(ci) + 1024) > C.CONV_SMEM_LIMIT + 1024:
            continue
        if ksplit > 1 and groups * (co // bn) >= 4 * sms:
            continue      # no use for a K split: plenty of units
        if v not in out:
            out.append(v)
    return out


def close(k, p, tol=1e-2):
    err = float((k.float() - p.float()).abs().max())
    return err, err <= tol * float(p.float().abs().max())


def check() -> int:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bad = 0
    shapes = [(B, c, c, X, Y, Z) for B in BATCHES
              for c, X, Y, Z in STAGES[1:]]
    shapes += [(2, 16, 16, 112, 112, 80), (2, 16, 16, 6, 5, 7),
               (1, 32, 64, 4, 4, 3), (2, 256, 256, 3, 5, 4),
               (1, 32, 48, 9, 11, 13), (1, 48, 16, 23, 19, 21),
               (1, 16, 16, 1, 1, 1), (1, 64, 32, 200, 3, 2),
               (3, 128, 64, 7, 7, 5)]
    for B, ci, co, X, Y, Z in shapes:
        x, w = case(B, ci, co, X, Y, Z)
        want = C.conv3x3x3_same_reference(x, w)
        want_dx = C.conv3x3x3_same_reference(x, w.flip((2, 3, 4)))
        picked = C.conv_variant(B, X, Y, Z, ci, co, sms)
        todo = [picked]
        if X * Y * Z <= 28 * 28 * 20:     # forced variants at modest sizes
            todo += [v for v in variants(B, X, Y, Z, ci, co, sms)
                     if v != picked]
        worst = 0.0
        for v in todo:
            got = C._launch_conv(x, w, "check", variant=v)
            again = C._launch_conv(x, w, "check", variant=v)
            got_dx = C._launch_conv(x, w, "check", flip=True, variant=v)
            torch.cuda.synchronize()
            err, ok = close(got, want)
            err_dx, ok_dx = close(got_dx, want_dx)
            worst = max(worst, err, err_dx)
            if not (ok and ok_dx and torch.equal(got, again)):
                bad += 1
                print(f"FAILED {B}x{ci}->{co}@{X}x{Y}x{Z} {v}: err {err:.3g} "
                      f"dx err {err_dx:.3g} same bits "
                      f"{torch.equal(got, again)}", flush=True)
        print(f"checked {B}x{ci}->{co}@{X}x{Y}x{Z}: {len(todo)} variants, "
              f"worst err {worst:.3g} (max|plain| "
              f"{float(want.float().abs().max()):.3g}), picked {picked}",
              flush=True)
    print(f"check: {bad} failures", flush=True)
    return 1 if bad else 0


def sweep(out_path: str) -> int:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for B in BATCHES:
        for c, X, Y, Z in STAGES:
            x, w = case(B, c, c, X, Y, Z)
            lib = device_ms(lambda: F.conv3d(x, w, padding=1))
            picked = C.conv_variant(B, X, Y, Z, c, c, sms)
            timed = []
            for v in variants(B, X, Y, Z, c, c, sms):
                ms = device_ms(
                    lambda: C._launch_conv(x, w, "sweep", variant=v))
                timed.append((ms, v))
            timed.sort(key=lambda t: t[0])
            pick_ms = device_ms(lambda: C._launch_conv(x, w, "sweep"))
            print(f"{B}x{c}@{X}x{Y}x{Z}: F.conv3d {lib:.4f} ms; picked "
                  f"{pick_ms:.4f} ms {picked}", flush=True)
            for ms, v in timed[:8]:
                print(f"    {ms:.4f} ms {v} smem {v.smem_bytes(c)}",
                      flush=True)
            rows.append({"shape": f"{B}x{c}@{X}x{Y}x{Z}", "library_ms": lib,
                         "picked_ms": pick_ms, "picked": picked._asdict(),
                         "variants": [dict(v._asdict(), ms=ms)
                                      for ms, v in timed]})
    per_forward = {16: 1, 32: 4, 64: 6, 128: 6, 256: 3}
    for B in BATCHES:
        mine = [r for r in rows if r["shape"].startswith(f"{B}x")]
        count = [per_forward[int(r["shape"].split("x")[1].split("@")[0])]
                 for r in mine]
        for key in ("picked_ms", "library_ms"):
            total = sum(n * r[key] for n, r in zip(count, mine))
            print(f"batch {B}, the 20 launches of a V-Net forward, {key}: "
                  f"{total:.4f}", flush=True)
        best = sum(n * min(v["ms"] for v in r["variants"])
                   for n, r in zip(count, mine))
        print(f"batch {B}, the 20 launches of a V-Net forward, best variant "
              f"of each shape: {best:.4f}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card)
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


def dxdw_variants(B, X, Y, Z, c, sms):
    """Each candidate of the shape with every ring depth that fits, and
    with a half and a double number of splits."""
    out = []
    for v in C.dxdw_candidates(B, X, Y, Z, c, sms):
        boxes = C.dxdw_boxes(B, X, Y, Z)
        for stages in range(2, v.stages + 1):
            for splits in {max(1, v.splits // 2), v.splits,
                           min(boxes, 2 * v.splits)}:
                u = v._replace(stages=stages, splits=splits)
                if splits * 27 * c * c * 4 <= 2 * C.DW_WORKSPACE_BYTES \
                        and u not in out:
                    out.append(u)
    return out


def dxdw(out_path: str) -> int:
    from torch.nn.grad import conv3d_input, conv3d_weight
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B, per_backward = 4, {16: 1, 32: 4, 64: 6, 128: 6, 256: 3}
    rows, bad = [], 0
    for c, X, Y, Z in STAGES:
        x, w = case(B, c, c, X, Y, Z, seed=1)
        dy, _ = case(B, c, c, X, Y, Z, seed=2)
        want_dx, want_dw = C.conv3x3x3_dxdw_reference(x, dy, w)
        picked = C.dxdw_variant(B, X, Y, Z, c, sms)
        timed = []
        for v in dxdw_variants(B, X, Y, Z, c, sms):
            got_dx, got_dw = C.conv3x3x3_dxdw(x, dy, w, variant=v)
            again_dx, again_dw = C.conv3x3x3_dxdw(x, dy, w, variant=v)
            err, ok = close(got_dx, want_dx)
            err_w, ok_w = close(got_dw, want_dw, 1e-3)
            same = torch.equal(got_dx, again_dx) and torch.equal(got_dw,
                                                                 again_dw)
            if not (ok and ok_w and same):
                bad += 1
                print(f"FAILED {B}x{c}@{X}x{Y}x{Z} {v}: dx err {err:.3g} "
                      f"dW err {err_w:.3g} same bits {same}", flush=True)
            del got_dx, got_dw, again_dx, again_dw
            timed.append((device_ms(
                lambda: C.conv3x3x3_dxdw(x, dy, w, variant=v)), v))
        timed.sort(key=lambda t: t[0])
        pick_ms = device_ms(lambda: C.conv3x3x3_dxdw(x, dy, w))
        pair_ms = device_ms(lambda: (C.conv3x3x3_dx(dy, w),
                                     C.conv3x3x3_dw(x, dy)))
        lib = device_ms(lambda: (conv3d_input(x.shape, w, dy, padding=1),
                                 conv3d_weight(x, w.shape, dy, padding=1)))
        print(f"{B}x{c}@{X}x{Y}x{Z}: D picked {pick_ms:.4f} ms {picked}; "
              f"B-as-dx then C {pair_ms:.4f}; conv3d_input + conv3d_weight "
              f"{lib:.4f}", flush=True)
        for ms, v in timed[:8]:
            print(f"    {ms:.4f} ms {v} smem {v.smem_bytes()}", flush=True)
        rows.append({"shape": f"{B}x{c}@{X}x{Y}x{Z}",
                     "per_backward": per_backward[c], "picked_ms": pick_ms,
                     "picked": picked._asdict(), "dx_then_dw_ms": pair_ms,
                     "library_ms": lib,
                     "variants": [dict(v._asdict(), ms=ms)
                                  for ms, v in timed]})
        del x, dy, w, want_dx, want_dw
    for key in ("picked_ms", "dx_then_dw_ms", "library_ms"):
        total = sum(r["per_backward"] * r[key] for r in rows)
        print(f"batch {B}, the 20 launches of a backward, {key}: "
              f"{total:.4f}", flush=True)
    best = sum(r["per_backward"] * min(v["ms"] for v in r["variants"])
               for r in rows)
    print(f"batch {B}, the 20 launches of a backward, best variant of each "
          f"shape: {best:.4f}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card)
    print(f"dxdw: {bad} failures", flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 1 if bad else 0


ODD_DW_SHAPES = [
    (2, 16, 16, 6, 5, 7), (1, 32, 64, 4, 4, 3), (2, 256, 256, 3, 5, 4),
    (1, 32, 48, 9, 11, 13), (2, 256, 256, 7, 7, 5), (1, 16, 16, 20, 18, 16),
    (1, 48, 64, 9, 11, 13)]
PER_BACKWARD = {16: 1, 32: 4, 64: 6, 128: 6, 256: 3}


def dw_case(B, ci, co, X, Y, Z):
    x, _ = case(B, ci, ci, X, Y, Z, seed=1)
    dy, _ = case(B, co, co, X, Y, Z, seed=2)
    return x, dy


def dw_variants(B, X, Y, Z, ci, co, sms):
    """Each candidate of the shape with every ring depth that fits, and
    with half, the picked and double the splits (and one where it picks
    at most 16) without clusters, and with the picked splits rounded to
    clusters of 2, 4 and 8."""
    out = []
    for v in C.dw_candidates(B, X, Y, Z, ci, co, sms):
        boxes = C.dw_boxes(B, X, Y, Z, v.tiles)
        for stages in range(C.DW_MIN_STAGES, v.stages + 1):
            for splits in sorted({1 if v.splits <= 16 else v.splits,
                                  max(1, v.splits // 2), v.splits,
                                  min(boxes, 2 * v.splits)}):
                if splits * 27 * ci * co * 4 <= 2 * C.DW_WORKSPACE_BYTES:
                    out.append(v._replace(stages=stages, splits=splits,
                                          cluster=1))
            for cluster in (2, 4, 8):
                splits = round(v.splits / cluster) * cluster
                if cluster <= splits <= boxes:
                    out.append(v._replace(stages=stages, splits=splits,
                                          cluster=cluster))
    return list(dict.fromkeys(out))


def old_dw_times() -> int:
    """Device and event times of this checkout's ``conv3x3x3_dw`` (bf16)
    at the ``--dw`` shapes, as one JSON line (the ``--old`` child)."""
    rows = {}
    shapes = [(4, c, c, X, Y, Z) for c, X, Y, Z in STAGES] + ODD_DW_SHAPES
    for B, ci, co, X, Y, Z in shapes:
        x, dy = dw_case(B, ci, co, X, Y, Z)
        rows[f"{B}x{ci}->{co}@{X}x{Y}x{Z}"] = {
            "device_ms": device_ms(lambda: C.conv3x3x3_dw(x, dy)),
            "event_ms": cuda_ms(lambda: C.conv3x3x3_dw(x, dy))}
    print(json.dumps(rows), flush=True)
    return 0


def dw(out_path: str, old: str) -> int:
    from torch.nn.grad import conv3d_weight
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    old_rows = {}
    if old:
        run = subprocess.run(
            [sys.executable, __file__, "--old-dw-times"]
            + (["--pancreas"] if STAGES == PANCREAS_STAGES else []),
            capture_output=True,
            text=True, env={**os.environ, "PYTHONPATH": os.path.abspath(old)})
        if run.returncode != 0:
            print(run.stdout + run.stderr, flush=True)
            return 1
        old_rows = json.loads(run.stdout.strip().splitlines()[-1])
    rows, bad = [], 0
    shapes = [(4, c, c, X, Y, Z) for c, X, Y, Z in STAGES] + ODD_DW_SHAPES
    for B, ci, co, X, Y, Z in shapes:
        shape = f"{B}x{ci}->{co}@{X}x{Y}x{Z}"
        x, dy = dw_case(B, ci, co, X, Y, Z)
        want = C.conv3x3x3_dw_reference(x, dy)
        picked = C.dw_variant(B, X, Y, Z, ci, co, sms)
        timed = []
        for v in dw_variants(B, X, Y, Z, ci, co, sms):
            got = C.conv3x3x3_dw(x, dy, variant=v)
            again = C.conv3x3x3_dw(x, dy, variant=v)
            err, ok = close(got, want, 1e-3)
            same = torch.equal(got, again)
            if not (ok and same):
                bad += 1
                print(f"FAILED {shape} {v}: err {err:.3g} same bits {same}",
                      flush=True)
            del got, again
            timed.append((device_ms(
                lambda: C.conv3x3x3_dw(x, dy, variant=v)), v))
        timed.sort(key=lambda t: t[0])
        lib = lambda: conv3d_weight(x, (co, ci, 3, 3, 3), dy, padding=1)
        row = {"shape": shape,
               "per_backward": PER_BACKWARD[ci] if B == 4 else 0,
               "picked": picked._asdict(),
               "picked_ms": device_ms(lambda: C.conv3x3x3_dw(x, dy)),
               "picked_event_ms": cuda_ms(lambda: C.conv3x3x3_dw(x, dy)),
               "library_ms": device_ms(lib),
               "library_event_ms": cuda_ms(lib),
               "old": old_rows.get(shape),
               "variants": [dict(v._asdict(), ms=ms) for ms, v in timed]}
        rows.append(row)
        was = (f"; old C {row['old']['device_ms']:.4f} (events "
               f"{row['old']['event_ms']:.4f})" if row["old"] else "")
        print(f"{shape}: C picked {row['picked_ms']:.4f} ms (events "
              f"{row['picked_event_ms']:.4f}) {tuple(picked)}; conv3d_weight "
              f"{row['library_ms']:.4f} (events {row['library_event_ms']:.4f})"
              f"{was}", flush=True)
        for ms, v in timed[:6]:
            print(f"    {ms:.4f} ms {tuple(v)} smem {v.smem_bytes()}",
                  flush=True)
        del x, dy, want
    stage_rows = [r for r in rows if r["per_backward"]]
    sums = {key: sum(r["per_backward"] * r[key] for r in stage_rows)
            for key in ("picked_ms", "picked_event_ms", "library_ms",
                        "library_event_ms")}
    sums["best_ms"] = sum(r["per_backward"] * r["variants"][0]["ms"]
                          for r in stage_rows)
    if old_rows:
        for key in ("device_ms", "event_ms"):
            sums[f"old_{key}"] = sum(r["per_backward"] * r["old"][key]
                                     for r in stage_rows)
    for key, total in sums.items():
        print(f"batch 4, the 20 launches of a backward, {key}: {total:.4f}",
              flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card)
    print(f"dw: {bad} failures", flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"card": card, "sums": sums, "rows": rows}, f, indent=1)
    return 1 if bad else 0


def profile() -> int:
    """Device time by kernel name of the wrapper call with the picked
    variant and of ``F.conv3d``, 10 calls each under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    for B in BATCHES:
        for c, X, Y, Z in STAGES:
            x, w = case(B, c, c, X, Y, Z)
            for name, fn in (("kernel", lambda: C._launch_conv(x, w, "p")),
                             ("F.conv3d", lambda: F.conv3d(x, w, padding=1))):
                fn()
                torch.cuda.synchronize()
                with tprofile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        fn()
                    torch.cuda.synchronize()
                for e in prof.key_averages():
                    if e.device_time_total > 0:
                        print(f"{B}x{c}@{X}x{Y}x{Z} {name}: "
                              f"{e.device_time_total / e.count:9.1f} us x "
                              f"{e.count // 10}  {e.key[:90]}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--dxdw", action="store_true")
    ap.add_argument("--dw", action="store_true")
    ap.add_argument("--old", default="", help="--dw: a checkout of the "
                    "commit whose kernel C to time beside")
    ap.add_argument("--old-dw-times", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", default="")
    ap.add_argument("--pancreas", action="store_true",
                    help="the pancreas V-Net's 96^3 stage shapes")
    args = ap.parse_args()
    if args.pancreas:
        STAGES[:] = PANCREAS_STAGES
        BATCHES[:] = [16, 4, 2]
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    rc = 0
    if args.check:
        rc |= check()
    if args.sweep:
        rc |= sweep(args.out)
    if args.profile:
        rc |= profile()
    if args.dxdw:
        rc |= dxdw(args.out)
    if args.dw:
        rc |= dw(args.out, args.old)
    if args.old_dw_times:
        rc |= old_dw_times()
    return rc


if __name__ == "__main__":
    sys.exit(main())
