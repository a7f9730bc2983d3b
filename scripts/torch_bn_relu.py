"""Times the fused train-mode bias + BatchNorm + ReLU (``ops/bn_relu.py``)
on the card at the UNet3D's BatchNorm shapes of an LA self-train step
(batch 4 in two groups, 112 x 112 x 80 patches), beside the plain chain it
replaces (the conv's bias add, ``TorchBatchNorm``'s train branch,
``F.relu``, and autograd's backward of them) and, as a yardstick only,
``F.batch_norm`` + ``F.relu`` (cuDNN's or ATen's, one group):

    PYTHONPATH=. python3 scripts/torch_bn_relu.py [--out F.json]

For each shape it prints one JSON line: the device ms of each kernel of
the fused op (profiler, median of the timed launches), forward and
backward ms by CUDA events (median of 10 runs of 5 calls each), the bytes
bound (forward 6 bytes an element, backward 10, at 3.35 TB/s), and the
plain chain's and the yardstick's forward and backward ms; then the sums
over a UNet3D batch-4 pass (each shape times its BatchNorms). The last
line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from bcp_tpu_torch import kernels
from bcp_tpu_torch.models.layers import TorchBatchNorm

#: (C, X, Y, Z) of each UNet3D level at an LA patch, and its BatchNorms a
#: pass (two in the encoder block, two in the decoder block; one encoder
#: block at the bottom)
LEVELS = [((64, 112, 112, 80), 4), ((256, 56, 56, 40), 4),
          ((256, 28, 28, 20), 4), ((512, 14, 14, 10), 4),
          ((1024, 7, 7, 5), 2)]
BATCH, GROUPS = 4, 2
HBM = 3.35e12


def device() -> str:
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except OSError:
        limit = "power limit not read"
    return f"{torch.cuda.get_device_name(0)} ({limit})"


def event_ms(fn, runs: int = 10, calls: int = 5) -> float:
    """Median over ``runs`` of the CUDA-event ms of ``calls`` calls, a
    call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return statistics.median(out)


def kernel_ms(fn, calls: int = 10) -> dict:
    """Device ms a call of each kernel ``fn`` launches (profiler)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t and "batch_norm_relu" in e.key:
            name = re.search(r"batch_norm_relu_\w+", e.key).group(0)
            out[name] = out.get(name, 0.0) + t / 1e3 / calls
    return out


def one_shape(C: int, spatial, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(C)
    shape = (BATCH, C, *spatial)
    cl = torch.channels_last_3d
    y = (torch.randn(shape, generator=gen, device=dev)
         + torch.randn((1, C, 1, 1, 1), generator=gen, device=dev)).to(
        torch.bfloat16).contiguous(memory_format=cl)
    g = (torch.randn(shape, generator=gen, device=dev) * 1e-3).to(
        torch.bfloat16).contiguous(memory_format=cl)
    cb = torch.randn(C, device=dev, requires_grad=True)
    bn = TorchBatchNorm(C, dtype=torch.bfloat16, groups=GROUPS).to(dev)
    yg = y.clone().requires_grad_(True)

    def fused_fwd():
        with torch.no_grad():
            return bn.relu_of_biased(y, cb)

    def fused_both():
        out = bn.relu_of_biased(yg, cb)
        torch.autograd.grad(out, (yg, cb, bn.weight, bn.bias), g)

    def plain_fwd():
        with torch.no_grad():
            return F.relu(bn(y + cb.to(y.dtype).view(1, -1, 1, 1, 1)))

    def plain_both():
        out = F.relu(bn(yg + cb.to(y.dtype).view(1, -1, 1, 1, 1)))
        torch.autograd.grad(out, (yg, cb, bn.weight, bn.bias), g)

    def lib_fwd():
        with torch.no_grad():
            return F.relu(F.batch_norm(
                y + cb.to(y.dtype).view(1, -1, 1, 1, 1), None, None,
                bn.weight, bn.bias, True, 0.1, bn.eps))

    def lib_both():
        out = F.relu(F.batch_norm(
            yg + cb.to(y.dtype).view(1, -1, 1, 1, 1), None, None,
            bn.weight, bn.bias, True, 0.1, bn.eps))
        torch.autograd.grad(out, (yg, cb, bn.weight, bn.bias), g)

    n = y.numel()
    row = {"shape": list(shape), "groups": GROUPS,
           "bound_fwd_ms": 1e3 * 6 * n / HBM,
           "bound_bwd_ms": 1e3 * 10 * n / HBM}
    row["fused_fwd_ms"] = event_ms(fused_fwd)
    row["fused_fwd_bwd_ms"] = event_ms(fused_both)
    row["fused_kernels_ms"] = kernel_ms(fused_both)
    row["plain_fwd_ms"] = event_ms(plain_fwd)
    row["plain_fwd_bwd_ms"] = event_ms(plain_both)
    row["library_fwd_ms"] = event_ms(lib_fwd)
    row["library_fwd_bwd_ms"] = event_ms(lib_both)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device: this script times kernels")
    dev = torch.device("cuda")
    kernels.library("batch_norm_relu")
    rows = []
    for (C, *spatial), count in LEVELS:
        row = one_shape(C, spatial, dev)
        row["bns_a_pass"] = count
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = [k for k, v in rows[0].items() if isinstance(v, float)]
    total = {k: sum(r[k] * r["bns_a_pass"] for r in rows) for k in keys}
    total["fused_kernels_ms"] = {
        name: sum(r["fused_kernels_ms"].get(name, 0.0) * r["bns_a_pass"]
                  for r in rows) for name in rows[0]["fused_kernels_ms"]}
    out = {"unet3d_batch4_pass": total, "device": device()}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, **out}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
