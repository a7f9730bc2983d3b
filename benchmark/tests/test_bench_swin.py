"""The SwinUNETR reference (``benchmark/reference/archs/swin_unetr.py``) as
the benchmark takes it: found by name, every parameter drawn from the
seed (the relative position tables by the default N(0, 0.02^2) rule, the
same for equal seeds), no dropout, and a step's operations (convs, linear
layers and the file's ``extra_flops`` for q k^T and p v) equal to
``FlopCounterMode``'s count at a small size; the cell's attention counts
and the readers of its kernels."""

from __future__ import annotations

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_helpers import ROOT
from benchmark import convs, counts, data, harness, window_attn_counts
from benchmark.reference import bcp, nets

WIDTHS = {"feature_size": 12, "depths": [2, 2, 2, 2],
          "num_heads": [3, 6, 12, 24], "window_size": 7, "patch_size": 2,
          "mlp_ratio": 4.0, "n_classes": 2}
PATCH = (64, 32, 32)
SEED = 2**31 + 41


def test_found_by_name():
    assert type(nets.build("swin_unetr", WIDTHS)).__name__ == "RefSwinUNETR"
    assert nets.dropout_shapes("swin_unetr", WIDTHS, PATCH, 2) == []


def test_every_parameter_drawn_from_the_seed():
    a = data.seeded_weights("swin_unetr", WIDTHS, SEED, "cpu")
    b = data.seeded_weights("swin_unetr", WIDTHS, SEED, "cpu")
    c = data.seeded_weights("swin_unetr", WIDTHS, SEED + 1, "cpu")
    params = dict(nets.build("swin_unetr", WIDTHS).named_parameters())
    assert set(params) == set(a)
    tables = [n for n in params if n.endswith("relative_position_bias_table")]
    assert len(tables) == 8
    for name in params:
        assert torch.equal(a[name], b[name]), name
        if ".norm" in name:
            assert torch.all(a[name] == name.endswith("weight")), name
        else:
            assert not torch.equal(a[name], c[name]), name
    for name in tables:
        assert a[name].shape == (13 ** 3, params[name].shape[1])
        assert 0.015 < float(a[name].std()) < 0.025, name


def test_step_count_matches_flop_counter():
    torch.manual_seed(0)
    model = nets.build("swin_unetr", WIDTHS).train()
    n = 1
    x = torch.randn(n, 1, *PATCH)
    keeps = bcp.keep_masks(torch.Generator(), nets.dropout_shapes(
        "swin_unetr", WIDTHS, PATCH, n), "cpu")
    rec = convs.Recorder()
    with FlopCounterMode(display=False) as counted:
        rec.role = "teacher"
        rec.forward(x)
        with torch.no_grad():
            model(x, keeps)
        rec.role = "student"
        rec.forward(x)
        model(x, keeps).square().mean().backward()
    rec.close()
    assert sum(c["linear"] for c in rec.calls) == 2 * (8 * 4 + 4)
    extra = convs.extra_flops("swin_unetr", WIDTHS, PATCH, rec.samples,
                              ("student",))
    assert extra > 0
    assert convs.flops(rec.calls, ("student",)) + extra \
        == counted.get_total_flops()



def test_attention_counts_of_the_cell():
    """The cell's attention launches at 96^3: eight blocks, the forward's
    operations the architecture's ``extra_flops``, the backward's 2.5
    times them, and a step's bound bytes-bound."""
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                      "swin_unetr_la.json")))
    w, patch = cfg["widths"], cfg["patch_size"]
    got = list(window_attn_counts.blocks(w, patch))
    assert [g[:2] for g in got] == [(343, 343)] * 2 + [(64, 343)] * 2 \
        + [(8, 343)] * 2 + [(1, 216)] * 2
    assert [g[2:] for g in got] == [(48, 3)] * 2 + [(96, 6)] * 2 \
        + [(192, 12)] * 2 + [(384, 24)] * 2
    table = 13 ** 3
    fwd = sum(window_attn_counts.launch(*g, 2, False, table)[0]
              for g in got)
    bwd = sum(window_attn_counts.launch(*g, 2, True, table)[0]
              for g in got)
    assert fwd == nets.extra_flops("swin_unetr", w, patch, 2)
    assert 2 * bwd == 5 * fwd
    peak = counts.PEAKS["H100 80GB HBM3"]
    bound = window_attn_counts.step_bound_s(cfg, peak)
    ops = sum(window_attn_counts.launch(*g, n, b, table)[0] for g in got
              for n, b in ((4, False), (4, False), (4, True)))
    assert bound > ops / peak[0]
    assert 0.5e-3 < bound < 1e-3


def _trace_ctx(names):
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": 10.0 * i,
               "dur": 5.0} for i, n in enumerate(names)]
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                      "swin_unetr_la.json")))
    return {"device": torch.device("cuda"), "config": cfg,
            "peaks": counts.PEAKS["H100 80GB HBM3"],
            "traces": {"device": {"events": events, "steps": 2,
                                  "window_s": 1.0}}}


def test_readers_of_the_attention_kernels():
    """Both readers read the ``window_attn_*`` kernels alone, and leave
    their metric out where no such kernel ran (as on a program without
    them) or without a device trace."""
    reg = harness.Registry(ROOT)
    cell = reg.cell("swin_unetr_la.self_k4")
    ms = cell.readers["window_attn_ms_per_step.train"]
    roof = cell.readers["window_attn_roofline.train"]
    ctx = _trace_ctx(["window_attn_fwd(__nv_bfloat16 const*, int)",
                      "window_attn_bwd_dq(float const*)",
                      "window_attn_dt_sum(float const*)",
                      "void conv3x3x3_bf16_kernel<16, 4, 4>(int)"])
    assert ms.read(ctx) == pytest.approx(1e3 * 15e-6 / 2)
    bound = window_attn_counts.step_bound_s(ctx["config"], ctx["peaks"])
    assert roof.read(ctx) == pytest.approx(100 * bound * 2 / 15e-6)
    bare = _trace_ctx(["void conv3x3x3_bf16_kernel<16, 4, 4>(int)"])
    assert ms.read(bare) is None and roof.read(bare) is None
    bare["traces"] = {}
    assert ms.read(bare) is None and roof.read(bare) is None
