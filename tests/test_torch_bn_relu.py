"""The fused train-mode bias + BatchNorm + ReLU (``ops/bn_relu.py``) on the
CPU: its plain version (explicit statistics and apply, the closed-form
backward) against autograd through the chain it replaces
(``Conv3x3x3``'s bias add, ``TorchBatchNorm``'s train branch, ``F.relu``)
in f64; which tensors the route takes; the nets that route through it
keep their state_dict names; and whole train-mode nets with every
(conv, BN, ReLU) forced through the fused op's plain version against the
plain chain. The kernels themselves are held on the card by
``tests/test_torch_bn_relu_cuda.py``."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from bcp_tpu_torch.models import create_model, layers
from bcp_tpu_torch.models.layers import (Conv3x3x3, ConvBNReLUStages,
                                         TorchBatchNorm, bn_groups,
                                         dropout_draws, frozen_running_stats)
from bcp_tpu_torch.ops import bn_relu as br
from bcp_tpu_torch.parallel import mesh
from torch_port_helpers import ZOO

TOL = 1e-10


def _bn(C, G, seed):
    rng = np.random.default_rng(seed)
    bn = TorchBatchNorm(C, groups=G).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, C)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.3, C)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.1, C)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, C)))
        bn.num_batches_tracked.fill_(3)
    return bn


def _inputs(C, spatial, seed):
    rng = np.random.default_rng(seed + 1)
    shape = (4, C, *spatial)
    # channel means away from 0, so the statistics' terms matter
    y = rng.normal(0.0, 1.0, shape) * rng.uniform(0.5, 2.0, (1, C, 1, 1, 1))
    y = y + rng.normal(0.0, 1.0, (1, C, 1, 1, 1))
    g = rng.normal(0.0, 1.0, shape)
    cb = rng.normal(0.0, 0.5, C)
    return (torch.from_numpy(y), torch.from_numpy(g),
            torch.from_numpy(cb))


@pytest.mark.parametrize("spatial", [(3, 5, 7), (4, 3, 5)])
@pytest.mark.parametrize("C", [16, 64])
@pytest.mark.parametrize("update", [True, False])
@pytest.mark.parametrize("G", [1, 2])
def test_plain_version_is_the_chain_in_f64(G, update, C, spatial):
    y, g, cb = _inputs(C, spatial, seed=C + G)
    bn_a, bn_b = _bn(C, G, seed=C), _bn(C, G, seed=C)
    bn_a.update_running = bn_b.update_running = update

    ya = y.clone().requires_grad_(True)
    cba = cb.clone().requires_grad_(True)
    out_a = F.relu(bn_a(ya + cba.view(1, -1, 1, 1, 1)))
    out_a.backward(g)

    yb = y.clone().requires_grad_(True)
    cbb = cb.clone().requires_grad_(True)
    out_b = bn_b.relu_of_biased(yb, cbb)
    out_b.backward(g)

    def close(a, b):
        return torch.allclose(a, b, rtol=0, atol=TOL)

    assert close(out_a, out_b)
    assert (out_b > 0).any() and (out_b == 0).any()
    for name in ("running_mean", "running_var"):
        assert close(getattr(bn_a, name), getattr(bn_b, name)), name
    assert int(bn_a.num_batches_tracked) == int(bn_b.num_batches_tracked) \
        == 3 + G * update
    assert close(ya.grad, yb.grad)
    assert close(cba.grad, cbb.grad)
    assert close(bn_a.weight.grad, bn_b.weight.grad)
    assert close(bn_a.bias.grad, bn_b.bias.grad)
    assert ya.grad.abs().max() > 1e-3 and bn_b.weight.grad.abs().max() > 1e-3


def test_plain_backward_reads_only_y_and_the_statistics():
    y, g, cb = _inputs(16, (3, 4, 5), seed=0)
    bn = _bn(16, 2, seed=0)
    yb = y.clone().requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        bn.relu_of_biased(yb, cb.clone().requires_grad_(True))
    assert saved == [tuple(y.shape), (16,), (16,), (5, 2, 16)]


def _cl(shape, dtype=torch.bfloat16):
    t = torch.zeros(shape, dtype=dtype)
    fmt = {4: torch.channels_last, 5: torch.channels_last_3d}.get(t.dim())
    return t.contiguous(memory_format=fmt) if fmt else t


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as on the card, for the route's other
    conditions."""

    @property
    def is_cuda(self):
        return True


def _card(t):
    return t.as_subclass(_OnCard)


ROUTES = {
    "bf16 channels_last_3d": (_cl((2, 16, 3, 4, 5)), None, True),
    "bf16 channels_last 2-D": (_cl((2, 24, 4, 5)), None, True),
    "C 24": (_cl((2, 24, 3, 4, 5)), None, True),
    "compute dtype bf16": (_cl((2, 64, 3, 4, 5)), torch.bfloat16, True),
    "f32": (_cl((2, 16, 3, 4, 5), torch.float32), None, False),
    "f64": (_cl((2, 16, 3, 4, 5), torch.float64), None, False),
    "compute dtype f32": (_cl((2, 16, 3, 4, 5)), torch.float32, False),
    "NCDHW": (torch.zeros((2, 16, 3, 4, 5), dtype=torch.bfloat16), None,
              True),
    "C 12": (_cl((2, 12, 3, 4, 5)), None, False),
    "(N, F) rows": (torch.zeros((4, 16), dtype=torch.bfloat16), None, False),
    "a channel slice": (_cl((2, 32, 3, 4, 5))[:, 8:24], None, True),
    "empty": (_cl((0, 16, 3, 4, 5)), None, False),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_by_dtype_and_channels(case):
    y, dtype, want = ROUTES[case]
    params = (torch.ones(y.shape[1]),) * 4
    assert br.fused_route(_card(y), dtype, params) is want
    # a CPU tensor never takes the kernels
    assert br.fused_route(y, dtype, params) is False


def _cast(bn, how):
    if how == "half":
        bn.half()
    elif how == "bf16 weight":
        bn.weight.data = bn.weight.data.to(torch.bfloat16)
    elif how == "f64 running var":
        bn.running_var = bn.running_var.double()
    elif how == "strided bias":
        bn.bias.data = torch.zeros(2 * bn.num_features)[::2]
    return bn


@pytest.mark.parametrize("how", ["none", "half", "bf16 weight",
                                 "f64 running var", "strided bias"])
def test_route_refuses_cast_batch_norm_parameters(how):
    """A BatchNorm whose parameters or running averages are not dense f32
    (a model cast with ``.half()``, say) keeps the plain chain: the
    kernels read them as f32."""
    bn = _cast(TorchBatchNorm(16, dtype=torch.bfloat16), how)
    y = _card(_cl((2, 16, 3, 4, 5)))
    params = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    assert br.fused_route(y, bn.compute_dtype, params) is (how == "none")


def test_kernels_refuse_what_they_would_misread():
    """The wrappers' own check: y dense channels_last (the op lays any
    other layout out first), the conv bias bf16, the parameters and the
    statistics f32, num_batches_tracked int64."""
    y = _card(_cl((2, 16, 3, 4, 5)))
    cb, w = torch.zeros(16, dtype=torch.bfloat16), torch.ones(16)
    st = torch.zeros((5, 2, 16))
    count = torch.zeros((), dtype=torch.long)
    br._check(y, cb, "ok", (w, w), st=st, groups=2, count=count)
    bad = {
        "NCDHW": dict(y=_card(torch.zeros((2, 16, 3, 4, 5),
                                          dtype=torch.bfloat16))),
        "a channel slice": dict(y=_card(_cl((2, 32, 3, 4, 5))[:, 8:24])),
        "f32 conv bias": dict(cb=torch.zeros(16)),
        "bf16 weight": dict(params=(w.to(torch.bfloat16), w)),
        "f32 statistics of another G": dict(st=torch.zeros((5, 1, 16))),
        "bf16 statistics": dict(st=st.to(torch.bfloat16)),
        "f32 count": dict(count=torch.zeros(())),
    }
    for what, change in bad.items():
        kw = dict(y=y, cb=cb, params=(w, w), st=st, count=count)
        kw.update(change)
        with pytest.raises(ValueError):
            br._check(kw["y"], kw["cb"], what, kw["params"], st=kw["st"],
                      groups=2, count=kw["count"])


def test_route_refuses_a_world_of_several_ranks(monkeypatch):
    y = _card(_cl((2, 16, 3, 4, 5)))
    assert br.fused_route(y)
    monkeypatch.setattr(mesh, "_WORLD",
                        mesh.World(0, 2, torch.device("cpu")))
    assert mesh.active()
    assert not br.fused_route(y)
    # a world of one rank: its statistics' all-reduce is the identity
    monkeypatch.setattr(mesh, "_WORLD",
                        mesh.World(0, 1, torch.device("cpu")))
    assert mesh.active()
    assert br.fused_route(y)


@pytest.mark.parametrize("rows_g,C,G,want", [
    (2 * 112 * 112 * 80, 64, 2, (528, 64)),     # UNet3D level 0
    (2 * 56 * 56 * 40, 256, 2, (528, 256)),     # level 1
    (2 * 7 * 7 * 5, 1024, 2, (16, 256)),        # level 4
    (4 * 112 * 112 * 80, 16, 1, (1056, 16)),    # V-Net level 0
    (10, 24, 2, (1, 24)),
    (3 * 7, 320, 1, (1, 160)),
])
def test_geometry(rows_g, C, G, want):
    chunks, ctile = br.bn_geometry(rows_g, C, G, 132)
    assert (chunks, ctile) == want
    assert C % ctile == 0 and ctile % br.VEC == 0
    assert 1 <= chunks <= rows_g


def _names_as_sequential(stages):
    plain = nn.Sequential(*stages)
    return list(plain.state_dict())


def test_vnet_state_dict_names_unchanged():
    model = create_model("VNet", 2, mode="train", device="cpu", n_filters=4)
    blocks = [m for m in model.modules() if isinstance(m, ConvBNReLUStages)]
    assert len(blocks) == 9
    for blk in blocks:
        assert list(blk.state_dict()) == _names_as_sequential(list(blk))
    sd = model.state_dict()
    for key in ("encoder.block_one.conv.0.weight",
                "encoder.block_one.conv.1.running_var",
                "encoder.block_two.conv.3.bias",
                "encoder.block_two.conv.4.num_batches_tracked",
                "decoder.block_six.conv.7.running_mean"):
        assert key in sd
    fresh = create_model("VNet", 2, mode="test", device="cpu", n_filters=4)
    fresh.load_state_dict(sd, strict=True)


def test_unet3d_state_dict_names_unchanged():
    kw, _ = ZOO["unet_3D"]
    model = create_model("unet_3D", 2, mode="train", device="cpu", **kw)
    sd = model.state_dict()
    want = {f"conv_blk1.{m}.{p}" for m in ("conv1", "conv2")
            for p in ("weight", "bias")}
    want |= {f"conv_blk1.{m}.{p}" for m in ("bn1", "bn2")
             for p in ("weight", "bias", "running_mean", "running_var",
                       "num_batches_tracked")}
    want |= {"conv_blk1.residual.weight"}
    assert {k for k in sd if k.startswith("conv_blk1.")} == want
    assert len(sd) == 5 * 15 + 4 * (15 + 2) + 2
    fresh = create_model("unet_3D", 2, mode="test", device="cpu", **kw)
    fresh.load_state_dict(sd, strict=True)


def _forced(monkeypatch):
    """Every train-mode (conv, BN, ReLU) through the fused op's plain
    version: the route taken on the CPU."""
    calls = []

    def route(y, dtype=None, params=()):
        calls.append(tuple(y.shape))
        return True
    monkeypatch.setattr(layers, "fused_route", route)
    return calls


NETS = {
    "unet_3D": (lambda: create_model("unet_3D", 2, mode="train",
                                     device="cpu", **ZOO["unet_3D"][0]),
                (2, 1, 16, 16, 16), 18),
    "VNet": (lambda: create_model("VNet", 2, mode="train", device="cpu",
                                  n_filters=4), (2, 1, 16, 16, 16), 21),
    "VNet_remat": (lambda: create_model("VNet", 2, mode="train",
                                        device="cpu", n_filters=4,
                                        remat=True), (2, 1, 16, 16, 16), 42),
    "unetr": (lambda: create_model("unetr", 2, mode="train", device="cpu",
                                   **ZOO["unetr"][0]), (2, 1, 16, 16, 16), 17),
}


def _run(model, x, teacher):
    gen = torch.Generator().manual_seed(0)
    with bn_groups(model, 2), dropout_draws(model, generator=gen):
        if teacher:
            with torch.no_grad(), frozen_running_stats(model):
                out = layers.logits_of(model(x))
            return out, {}
        out = layers.logits_of(model(x))
        (out.square().mean() + out.mean()).backward()
    return out.detach(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("teacher", [False, True])
@pytest.mark.parametrize("net", sorted(NETS))
def test_nets_through_the_fused_op_match_the_plain_chain(net, teacher,
                                                         monkeypatch):
    build, shape, fused_calls = NETS[net]
    torch.manual_seed(0)
    plain = build().double()
    with torch.no_grad():
        for m in plain.modules():
            if isinstance(m, TorchBatchNorm):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.3)
            if isinstance(m, Conv3x3x3):
                m.bias.normal_(0.0, 0.3)
    fused = copy.deepcopy(plain)
    x = torch.randn(shape, dtype=torch.float64)
    want, want_g = _run(plain, x, teacher)
    calls = _forced(monkeypatch)
    got, got_g = _run(fused, x, teacher)
    assert len(calls) == (fused_calls // 2 if teacher and net == "VNet_remat"
                          else fused_calls)
    scale = want.abs().max()
    assert torch.allclose(got, want, rtol=0, atol=1e-10 * scale)
    for k, g in want_g.items():
        assert torch.allclose(got_g[k], g, rtol=0,
                              atol=1e-9 * max(g.abs().max(), 1e-3)), k
    for (k, a), b in zip(plain.state_dict().items(),
                         fused.state_dict().values()):
        assert torch.allclose(a.double(), b.double(), rtol=0,
                              atol=1e-12), k
