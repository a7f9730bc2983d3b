#!/usr/bin/env python3
"""Time kernel A, the overlap-add (``bcp_tpu_torch/kernels/csrc/
scatter_add.cu``), beside another commit's kernel A on one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/torch_overlap_add.py --old DIR [--out F]

DIR is a checkout of the other commit (``git archive <commit> | tar -x -C
_work/parent``). Its ``scatter_add.cu`` is built with the port's nvcc flags
into ``_work/`` and its ``scatter_add_windows_f32``, whose C signature every
commit of the port keeps, is called through ``ctypes`` in this process. All
entries run on the same chunks and with the same timers as ``chip_smoke.py``
phase 2 (a cold L2: events after a 512 MB read; a warm L2: the same launch
20 times in a CUDA graph): the first chunk (8 windows of 112x112x80x2) of
the LA grid of a 240x200x96 volume, whose launches take 16-byte vectors, and
of a 240x200x97 volume, whose odd last z start halves them. This script only
times: phase 2 and the card-only tests check the entries.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke
from bcp_tpu_torch import kernels
from bcp_tpu_torch.eval.sliding_window import window_starts
from bcp_tpu_torch.ops import scatter as S

PATCH = (112, 112, 80)
VOLUMES = {"4-wide": (240, 200, 96), "2-wide": (240, 200, 97)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def old_launcher(old: str):
    """The other commit's ``scatter_add_windows_f32``, built and loaded."""
    src = os.path.join(old, "bcp_tpu_torch/kernels/csrc/scatter_add.cu")
    out = os.path.join(ROOT, "_work", "libscatter_add_old.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, src],
                   check=True)
    fn = ctypes.CDLL(out).scatter_add_windows_f32
    fn.argtypes = list(kernels.SIGNATURES["scatter_add"][
        "scatter_add_windows_f32"])
    fn.restype = ctypes.c_int

    def launch(score, probs, starts):
        X, Y, Z, C = score.shape
        px, py, pz = probs.shape[1:4]
        kernels.check(fn(score.data_ptr(), probs.data_ptr(),
                         starts.ctypes.data, len(starts), X, Y, Z, C, px, py,
                         pz, kernels.stream_handle(score.device)),
                      "the old scatter_add_windows_f32")
    return launch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="a checkout of the commit "
                    "whose kernel A to time beside")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    old = old_launcher(args.old)
    flush = torch.zeros(128 << 20, device="cuda")
    rows = {}
    for tag, volume in VOLUMES.items():
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
        starts = window_starts(volume, PATCH, 18, 4)[:8]
        score = torch.rand((*volume, 2), generator=gen, device="cuda")
        probs = torch.rand((8, *PATCH, 2), generator=gen, device="cuda")
        logits = 4 * torch.randn((8, *PATCH, 2), generator=gen,
                                 device="cuda")
        fns = {"probs": lambda: S.scatter_add_windows(score, probs, starts),
               "fused": lambda: S.softmax_scatter_add_windows(
                   score, logits, starts, 8),
               "old": lambda: old(score, probs, starts)}
        rows[tag] = {k: {"cold_ms": chip_smoke.cold_ms(torch, fn, flush),
                         "warm_l2_device_ms": chip_smoke.device_ms(torch, fn)}
                     for k, fn in fns.items()}
        print(f"{tag} chunk of {volume}: {json.dumps(rows[tag])}",
              flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card.strip(), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
