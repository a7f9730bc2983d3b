"""A reference architecture added as one new file: a toy with a conv, a
linear layer, a LayerNorm, a free parameter, an element-wise dropout at
p = 0.1 and an attention product (``toy_arch.py``) is copied beside the
benchmark's architecture files, and the benchmark finds it by name, draws
every parameter from the seed, draws its keep masks as the port does and
counts its step's operations as ``FlopCounterMode`` does."""

from __future__ import annotations

import glob
import os
import shutil

import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from bench_helpers import ROOT
from benchmark import convs, data
from benchmark.reference import bcp, nets

from bcp_tpu_torch.models import layers

TOY = {"dim": 16, "heads": 2, "n_classes": 2}
PATCH = (8, 8, 4)
SEED = 2**31 + 29

#: an architecture whose only parameter is an integer one: no draw covers it
UNDRAWN = '''
import torch
from torch import nn


class Counter(nn.Module):
    def __init__(self):
        super().__init__()
        self.count = nn.Parameter(torch.zeros(3, dtype=torch.int64),
                                  requires_grad=False)


def build(widths, quantize=None):
    return Counter()


def dropout_shapes(widths, patch, n):
    return []
'''

#: the toy with its free parameters filled by a rule of its own
OVERRIDE = '''

def seed_free(named, generator):
    for _, t in named:
        t.fill_(0.25)
'''


@pytest.fixture
def archs(tmp_path, monkeypatch):
    """An architecture directory that holds the benchmark's files and the
    toy's, with the toy twice more: ``undrawn.py`` and ``toy_fixed.py``
    (its own ``seed_free``)."""
    where = tmp_path / "archs"
    where.mkdir()
    for path in glob.glob(os.path.join(nets.ARCHS, "*.py")):
        shutil.copy(path, where)
    toy = open(os.path.join(ROOT, "benchmark", "tests", "toy_arch.py")).read()
    (where / "toy.py").write_text(toy)
    (where / "toy_fixed.py").write_text(toy + OVERRIDE)
    (where / "undrawn.py").write_text(UNDRAWN)
    monkeypatch.setattr(nets, "ARCHS", str(where))
    return where


def test_found_by_name(archs):
    assert type(nets.build("toy", TOY)).__name__ == "Toy"
    assert type(nets.build("vnet", {"n_filters": 4, "n_classes": 2})
                ).__name__ == "RefVNet"
    with pytest.raises(ValueError, match="toy.*unet3d.*vnet"):
        nets.build("swin", TOY)


def test_every_parameter_drawn_from_the_seed(archs):
    a = data.seeded_weights("toy", TOY, SEED, "cpu")
    b = data.seeded_weights("toy", TOY, SEED, "cpu")
    c = data.seeded_weights("toy", TOY, SEED + 1, "cpu")
    params = dict(nets.build("toy", TOY).named_parameters())
    assert set(params) <= set(a)
    for name in params:
        assert torch.equal(a[name], b[name]), name
        if name.startswith("norm."):
            assert torch.all(a[name] == (name == "norm.weight")), name
        else:
            assert not torch.equal(a[name], c[name]), name
    # the free parameter from its own stream, N(0, 0.02^2)
    assert 0.005 < float(a["pos"].std()) < 0.04
    # a linear layer's weight within +-1/sqrt(fan_in)
    assert float(a["qkv.weight"].abs().max()) <= TOY["dim"] ** -0.5


def test_free_parameters_by_the_files_rule(archs):
    w = data.seeded_weights("toy_fixed", TOY, SEED, "cpu")
    assert torch.all(w["pos"] == 0.25)


def test_a_parameter_no_draw_covers_is_an_error(archs):
    with pytest.raises(ValueError, match="count"):
        data.seeded_weights("undrawn", {}, SEED, "cpu")


def test_keep_masks_are_the_ports(archs):
    drops = nets.dropout_shapes("toy", TOY, PATCH, 3)
    assert [p for _, p in drops] == [0.1, 0.5]
    port = nn.Sequential(layers.Dropout(0.1), layers.ChannelDropout(0.5))
    g_port, g_ref = torch.Generator(), torch.Generator()
    g_port.manual_seed(SEED)
    g_ref.manual_seed(SEED)
    want = layers.draw_keep_masks(port, [s for s, _ in drops], g_port)
    got = bcp.keep_masks(g_ref, drops, "cpu")
    assert len(got) == 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(torch.rand(4, generator=g_ref),
                       torch.rand(4, generator=g_port))


def test_step_count_matches_flop_counter(archs):
    torch.manual_seed(0)
    model = nets.build("toy", TOY).train()
    n = 2
    x = torch.randn(n, 1, *PATCH)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    keeps = bcp.keep_masks(gen, nets.dropout_shapes("toy", TOY, PATCH, n),
                           "cpu")
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
    assert rec.samples == {"teacher": n, "student": n}
    assert any(c["linear"] for c in rec.calls)
    extra = convs.extra_flops("toy", TOY, PATCH, rec.samples, ("student",))
    # q k^T and p v, 2 T^2 dim a sample each (T = 32 tokens): the
    # teacher's forward, the student's forward and its backward twice that
    assert extra == (1 + 3) * 2 * 2 * n * 32 * 32 * TOY["dim"]
    step = convs.flops(rec.calls, ("student",)) + extra
    assert step == counted.get_total_flops()
