"""The eval-mode (3^3 conv, BatchNorm, ReLU) stage with kernel B's epilogue
(``ops.conv3d.conv3x3x3_same_bn_relu``, routed by
``models.layers.eval_fused_route``) on the CPU: its plain version against
the eager chain of the eval modules (``Conv3x3x3`` with its bias,
``TorchBatchNorm``'s eval branch, ``F.relu``) bit for bit in bf16; which
calls the route takes and refuses; what the wrapper refuses; kernel B's
picker with the epilogue's shared memory; and whole eval nets with every
kernel-taking stage through the route: the same logits, and every
``Conv3x3x3`` still a module call with its input and output shapes, as the
benchmark's forward hook records them. The kernel itself is held on the
card by ``tests/test_torch_conv_bn_relu_eval_cuda.py``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from bcp_tpu_torch.models import create_model, layers
from bcp_tpu_torch.models.layers import Conv3x3x3, TorchBatchNorm
from bcp_tpu_torch.ops import conv3d
from bcp_tpu_torch.parallel import mesh
from torch_port_helpers import ZOO

BF16 = torch.bfloat16


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def _stage(ci: int, co: int, bias: bool, seed: int):
    """An eval-mode (conv, BN) pair computing in bf16, with running
    averages, weight, bias and conv bias away from their defaults."""
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    conv = Conv3x3x3(ci, co, dtype=BF16, bias=bias).eval()
    bn = TorchBatchNorm(co, dtype=BF16).eval()
    with torch.no_grad():
        if bias:
            conv.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.3, co)))
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, co)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.3, co)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.5, co)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.05, 2.0, co)))
    return conv, bn


@pytest.mark.parametrize("spatial", [(3, 4, 5), (8, 8, 2)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("C", [16, 32, 64])
def test_plain_version_is_the_eager_chain(C, bias, spatial):
    """relu(bn(conv(x))) of the eval modules, bit for bit: the conv, the
    bias add, the affine from the running averages and the ReLU in the
    same bf16 roundings, with and without a conv bias."""
    conv, bn = _stage(C, C, bias, seed=C + bias)
    x = torch.randn(2, C, *spatial).to(BF16)
    with torch.no_grad():
        want = F.relu(bn(conv(x)))
        got = conv3d.conv3x3x3_same_bn_relu(
            x, conv.weight.to(BF16), conv.bias, bn.running_mean,
            bn.running_var, bn.weight, bn.bias, bn.eps)
    assert got.dtype == BF16 and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))
    # the ReLU is there, and not everything is cut by it
    assert (got == 0).any() and (got > 0).any()


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as on the card, for the route's other
    conditions."""

    @property
    def is_cuda(self):
        return True


def _route_case(case: str, monkeypatch):
    """(conv, bn, x, grad) of one route case."""
    ci = 1 if case == "Ci = 1" else 16
    conv, bn = _stage(ci, 32, True, seed=0)
    x = torch.zeros((2, ci, 3, 4, 5), dtype=BF16)
    grad = case == "grad enabled"
    if case == "f32 net":
        conv.compute_dtype = bn.compute_dtype = None
        x = x.float()
    elif case == "f32 input, bf16 conv":
        x = x.float()
    elif case == "BN computing in f32":
        bn.compute_dtype = torch.float32
    elif case == "train mode":
        bn.train()
    elif case == "space split":
        monkeypatch.setattr(mesh, "_WORLD", mesh.World(
            0, 2, torch.device("cpu"), sp=2))
        assert mesh.space_split()
    elif case == "BN cast to half":
        bn.half()
    elif case == "BN bf16 weight":
        bn.weight.data = bn.weight.data.to(BF16)
    elif case == "f64 running var":
        bn.running_var = bn.running_var.double()
    elif case == "strided BN bias":
        bn.bias.data = torch.zeros(64)[::2]
    elif case == "strided conv bias":
        conv.bias.data = torch.zeros(64)[::2]
    elif case == "empty batch":
        x = x[:0]
    if case != "CPU tensor":
        x = x.as_subclass(_OnCard)
    return conv, bn, x, grad


ROUTE = {"bf16 on the card": True, "f32 input, bf16 conv": True,
         "CPU tensor": False, "f32 net": False, "grad enabled": False,
         "train mode": False, "Ci = 1": False, "space split": False,
         "BN computing in f32": False, "BN cast to half": False,
         "BN bf16 weight": False, "f64 running var": False,
         "strided BN bias": False, "strided conv bias": False,
         "empty batch": False}


@pytest.mark.parametrize("case", sorted(ROUTE))
def test_route_takes_and_refuses(case, monkeypatch):
    """The route takes an eval stage without autograd on a card tensor that
    the conv computes in bf16 with channels kernel B takes, no space split,
    and the BatchNorm's and conv's tensors dense f32; every other call
    keeps the chain."""
    conv, bn, x, grad = _route_case(case, monkeypatch)
    with torch.set_grad_enabled(grad):
        assert layers.eval_fused_route(conv, bn, x) is ROUTE[case]


def test_wrapper_refuses_what_the_epilogue_would_misread():
    """The wrapper's own check on the card path: bf16 only, each tensor
    dense f32 of Co on x's device (no fallback: it raises)."""
    x = torch.zeros((2, 16, 3, 4, 5), dtype=BF16)
    ok = torch.zeros(32)
    conv3d._check_epilogue(x, 32, (ok, ok, ok, ok, None))
    with pytest.raises(TypeError):
        conv3d._check_epilogue(x.float(), 32, (ok, ok, ok, ok, ok))
    bad = {"bf16": ok.to(BF16), "of another C": torch.zeros(16),
           "strided": torch.zeros(64)[::2], "f64": ok.double()}
    for what, t in bad.items():
        for i in range(5):
            params = [ok] * 5
            params[i] = t
            with pytest.raises(ValueError):
                conv3d._check_epilogue(x, 32, tuple(params))


#: kernel B's stages of an LA eval forward at batch 8: (Ci, Co, X, Y, Z)
B_STAGES = sorted({
    (64, 64, 112, 112, 80), (64, 256, 56, 56, 40), (256, 256, 56, 56, 40),
    (256, 256, 28, 28, 20), (256, 512, 14, 14, 10), (512, 512, 14, 14, 10),
    (512, 1024, 7, 7, 5), (1024, 1024, 7, 7, 5), (1024, 512, 14, 14, 10),
    (512, 256, 28, 28, 20), (512, 256, 56, 56, 40), (128, 64, 112, 112, 80),
    (16, 16, 112, 112, 80), (32, 32, 56, 56, 40), (64, 64, 28, 28, 20),
    (128, 128, 14, 14, 10), (256, 256, 7, 7, 5)})


@pytest.mark.parametrize("shape", B_STAGES)
def test_epilogue_keeps_the_variant_of_each_la_stage(shape):
    """The epilogue's coefficients (8 bytes an output channel of a CTA)
    fit beside each LA eval stage's variant: the picker, counting them,
    picks what it picks without them, so the stage's conv runs as before."""
    ci, co, X, Y, Z = shape
    v = conv3d.conv_variant(8, X, Y, Z, ci, co, 132)
    assert conv3d.conv_variant(8, X, Y, Z, ci, co, 132, epi=True) == v
    assert v.smem_bytes(ci, True) == v.smem_bytes(ci) + 8 * v.bn
    assert v.smem_bytes(ci, True) <= conv3d.CONV_SMEM_LIMIT


def _eval_net(name: str):
    if name == "unet_3D":
        kw = ZOO["unet_3D"][0]
    else:
        kw = dict(n_filters=16)
    torch.manual_seed(0)
    model = create_model(name, 2, mode="test", compute_dtype=BF16,
                         device="cpu", **kw)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, TorchBatchNorm):
                C = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, C)))
                m.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.2, C)))
                m.running_mean.copy_(torch.from_numpy(
                    rng.normal(0.0, 0.2, C)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 2.0, C)))
    return model


def _recorded_forward(model, x):
    """The logits, and each conv module call as the benchmark's recorder
    takes it (a global forward hook): class, input and output shapes."""
    calls = []

    def hook(module, args, output):
        if isinstance(module, (nn.Conv3d, nn.ConvTranspose3d)):
            calls.append((type(module).__name__, tuple(args[0].shape),
                          tuple(output.shape)))
    handle = nn.modules.module.register_module_forward_hook(hook)
    try:
        with torch.no_grad():
            out = layers.logits_of(model(x))
    finally:
        handle.remove()
    return out, calls


#: net -> the stages the route takes in an eval forward (kernel B's), the
#: Conv3x3x3 modules of the net
NETS = {"unet_3D": (17, 18), "VNet": (20, 21)}


@pytest.mark.parametrize("net", sorted(NETS))
def test_eval_nets_through_the_route_keep_logits_and_module_calls(
        net, monkeypatch):
    """A whole eval forward with every stage the route would take on the
    card run through ``conv(x, bn=bn)`` (its plain version here): logits
    bit for bit, and the recorder sees every ``Conv3x3x3`` call with the
    same input and output shapes."""
    model = _eval_net(net)
    x = torch.randn(ZOO["unet_3D"][1]).to(BF16)
    want, want_calls = _recorded_forward(model, x)

    taken = []

    def route(conv, bn, x_):
        ok = (not bn.training and not torch.is_grad_enabled()
              and conv3d.kernel_takes(conv.in_channels, conv.out_channels))
        taken.append(ok)
        return ok
    monkeypatch.setattr(layers, "eval_fused_route", route)
    got, got_calls = _recorded_forward(model, x)
    fused, convs = NETS[net]
    assert sum(taken) == fused
    assert sum(c[0] == "Conv3x3x3" for c in got_calls) == convs
    assert got_calls == want_calls
    assert torch.equal(_bits(got.to(BF16)), _bits(want.to(BF16)))
    assert torch.equal(got, want)


def test_module_call_without_bn_is_the_conv_and_its_bias():
    """``conv(x)`` without ``bn`` stays the conv plus its bias (what the
    benchmark times alone); with ``bn`` it is the whole stage."""
    conv, bn = _stage(16, 16, True, seed=3)
    x = torch.randn(1, 16, 3, 4, 5).to(BF16)
    with torch.no_grad():
        y = conv(x)
        want = conv3d.conv3x3x3_same_reference(x, conv.weight.to(BF16))
        assert torch.equal(_bits(y), _bits(conv.add_bias(want)))
        assert torch.equal(_bits(conv(x, bn=bn)),
                           _bits(F.relu(bn(y))))
