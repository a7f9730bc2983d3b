"""The operation counts behind ``mfu.*`` and ``conv_roofline.*`` against
``torch.utils.flop_counter.FlopCounterMode`` on the plain reference nets
at a small size, forward and backward, and the byte counts against the
tensors' own sizes."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_helpers import ROOT  # noqa: F401  (puts the checkout on the path)
from benchmark import convs, counts
from benchmark.reference import nets

NETS = [("vnet", {"n_filters": 4, "n_classes": 2}),
        ("unet3d", {"feat_channels": [8, 16, 16, 24, 32], "n_classes": 2})]


@pytest.mark.parametrize("net,widths", NETS)
def test_conv_counts_match_flop_counter(net, widths):
    torch.manual_seed(0)
    model = nets.build(net, widths).train()
    x = torch.randn(2, 1, 32, 32, 16)
    rec = convs.Recorder()
    rec.role = "student"
    with FlopCounterMode(display=False) as fwd:
        y = model(x)
    rec.close()
    assert convs.flops(rec.calls) == fwd.get_total_flops()
    with FlopCounterMode(display=False) as bwd:
        y.square().mean().backward()
    backward = sum(convs.work(c, True)[0] for c in rec.calls)
    assert backward == bwd.get_total_flops()
    assert convs.flops(rec.calls, ("student",)) == (
        fwd.get_total_flops() + bwd.get_total_flops())
    # the convs of the image need no dx, and the counts leave it out
    assert all(c["dx"] == (c["x"][1] != 1) for c in rec.calls)


def test_bytes_read_once_written_once():
    conv = torch.nn.Conv3d(16, 32, 3, padding=1, bias=True)
    x = torch.randn(2, 16, 8, 8, 8)
    y = conv(x)
    shapes = (tuple(x.shape), tuple(conv.weight.shape), tuple(y.shape))
    fwd = counts.conv_bytes(*shapes, bias=True, itemsize=2)
    assert fwd == 2 * (x.numel() + conv.weight.numel() + y.numel() + 32)
    bwd = counts.backward_bytes(*shapes, bias=True, dx=True, itemsize=2)
    # dy, x, w read; dx, dw, dbias written
    assert bwd == 2 * (y.numel() + x.numel() + conv.weight.numel()
                       + x.numel() + conv.weight.numel() + 32)
    assert counts.bound_s(2e12, 1.0, (1e12, 1e12)) == 2.0
    assert counts.bound_s(1.0, 3e12, (1e12, 1e12)) == 3.0


def test_peaks_by_card_name():
    assert counts.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert counts.peaks("some other card") is None
