"""Kernel B's eval epilogue (``kernels/csrc/conv3x3x3.cu``, entry
``conv3x3x3_bf16_bn_relu``, through ``ops.conv3d.conv3x3x3_same_bn_relu``)
on the card: the fused stage bit for bit against the plain chain on the
card (kernel B's plain store, the bias add, the eval BatchNorm, the ReLU)
at every kernel B stage of the UNet3D and the V-Net at LA's batch-8
window, the K-split stages included, and at ragged edges; whole eval
forwards of both nets with the route on and off; the launches of an eval
forward by path; and the plain store (every train-mode launch) as the
value the epilogue starts from. Every test needs a CUDA device and skips
without one; the file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_conv_bn_relu_eval_cuda.py
"""

import numpy as np
import pytest
import torch

from bcp_tpu_torch import kernels
from bcp_tpu_torch.models import create_model, layers
from bcp_tpu_torch.models.layers import (TorchBatchNorm, plain_eval_batch_norm,
                                         plain_train_batch_norm)
from bcp_tpu_torch.ops import conv3d

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16
#: LA's eval batch and window
BATCH = 8
WINDOW = (112, 112, 80)

#: kernel B's (Ci, Co, X, Y, Z) of an eval forward at LA's window: the
#: UNet3D's 17 (feature channels 64-1024) and the V-Net's 20 (16-256),
#: the K splits at 14x14x10 and 7x7x5 among them
UNET3D_B = [(64, 64, 112, 112, 80), (64, 256, 56, 56, 40),
            (256, 256, 56, 56, 40), (256, 256, 28, 28, 20),
            (256, 512, 14, 14, 10), (512, 512, 14, 14, 10),
            (512, 1024, 7, 7, 5), (1024, 1024, 7, 7, 5),
            (1024, 512, 14, 14, 10), (512, 256, 28, 28, 20),
            (512, 256, 56, 56, 40), (128, 64, 112, 112, 80)]
VNET_B = [(16, 16, 112, 112, 80), (32, 32, 56, 56, 40),
          (64, 64, 28, 28, 20), (128, 128, 14, 14, 10),
          (256, 256, 7, 7, 5)]
#: (B, Ci, Co, X, Y, Z): boxes cut by every edge, and one K split
RAGGED = [(2, 16, 32, 13, 11, 7), (3, 64, 64, 9, 10, 3),
          (1, 512, 128, 5, 6, 3)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    kernels.library("conv3x3x3")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def _case(B, ci, co, spatial, dev, seed, bias=True):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*s):
        return torch.randn(*s, generator=gen, device=dev)

    x = rnd(B, ci, *spatial).to(BF16).contiguous(
        memory_format=torch.channels_last_3d)
    w = (rnd(co, ci, 3, 3, 3) / (27 * ci) ** 0.5).to(BF16)
    bn = dict(mean=rnd(co) * 0.5, var=rnd(co).abs() + 0.05,
              gamma=rnd(co) * 0.3 + 1.0, beta=rnd(co) * 0.3)
    cb = rnd(co) * 0.3 if bias else None
    return x, w, cb, bn


def _check(x, w, cb, bn):
    """The fused stage against the chain on the card, bit for bit; one
    launch counted."""
    before = conv3d.conv3x3x3_same_bn_relu.launches
    got = conv3d.conv3x3x3_same_bn_relu(x, w, cb, bn["mean"], bn["var"],
                                        bn["gamma"], bn["beta"], 1e-5)
    assert conv3d.conv3x3x3_same_bn_relu.launches == before + 1
    want = conv3d.bn_relu_eval_chain(
        conv3d.conv3x3x3_same(x, w), cb, bn["mean"], bn["var"],
        bn["gamma"], bn["beta"], 1e-5)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == BF16
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    diff = (_bits(got) != _bits(want)).sum().item()
    assert diff == 0, f"{diff} of {got.numel()} values differ"
    assert (got == 0).any() and (got > 0).any()


@pytest.mark.parametrize("shape", sorted(set(UNET3D_B + VNET_B)))
def test_every_la_stage_bit_for_bit(cuda_device, shape):
    ci, co, X, Y, Z = shape
    _check(*_case(BATCH, ci, co, (X, Y, Z), cuda_device, seed=ci + co + X))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", RAGGED)
def test_ragged_edges_with_and_without_conv_bias(cuda_device, shape, bias):
    B, ci, co, X, Y, Z = shape
    _check(*_case(B, ci, co, (X, Y, Z), cuda_device, seed=X * Y + Z,
                  bias=bias))


def test_plain_store_is_what_the_epilogue_starts_from(cuda_device):
    """Every train-mode launch (and dx) runs the plain store. With an
    identity BatchNorm (mean 0, var 1, weight 1, bias 0: mul 1, add 0) and
    no conv bias the epilogue stores relu of the plain store's bits, up
    to the sign of a zero (the chain's + 0 makes -0 +0), on a plain
    variant and on a K split."""
    for B, ci, co, X, Y, Z in ((BATCH, 64, 64, 28, 28, 20),
                               (BATCH, 256, 256, 7, 7, 5)):
        x, w, _, _ = _case(B, ci, co, (X, Y, Z), cuda_device, seed=ci)
        one, zero = (torch.ones(co, device=cuda_device),
                     torch.zeros(co, device=cuda_device))
        plain = conv3d.conv3x3x3_same(x, w)
        again = conv3d.conv3x3x3_same(x, w)
        fused = conv3d.conv3x3x3_same_bn_relu(x, w, None, zero, one, one,
                                              zero, 1e-5)
        assert torch.equal(_bits(plain), _bits(again))
        want = torch.relu(plain) + 0.0
        assert torch.equal(_bits(fused), _bits(want))


def _net(name, dev):
    kw = {} if name == "unet_3D" else dict(n_filters=16)
    torch.manual_seed(0)
    model = create_model(name, 2, mode="test", compute_dtype=BF16,
                         device=dev, **kw)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, TorchBatchNorm):
                C = m.num_features

                def put(t, v):
                    t.copy_(torch.from_numpy(v).to(t))
                put(m.weight, rng.uniform(0.5, 1.5, C))
                put(m.bias, rng.normal(0.0, 0.2, C))
                put(m.running_mean, rng.normal(0.0, 0.2, C))
                put(m.running_var, rng.uniform(0.5, 2.0, C))
    return model


def _counts():
    return {f.__name__: f.launches for f in (
        conv3d.conv3x3x3_same_bn_relu, conv3d.conv3x3x3_same,
        plain_eval_batch_norm, plain_train_batch_norm)}


def _forward(model, x, grad=False):
    before = _counts()
    with torch.set_grad_enabled(grad):
        out = layers.logits_of(model(x))
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in _counts().items()}


#: net -> (fused stages, plain eval BatchNorms) of one eval forward: the
#: UNet3D's Ci = 1 first stage; the V-Net's and its 8 stride-2 blocks
NETS = {"unet_3D": (17, 1), "VNet": (20, 9)}


@pytest.mark.parametrize("net", sorted(NETS))
def test_eval_nets_bit_for_bit_and_their_launches(cuda_device, net,
                                                  monkeypatch):
    """A whole eval forward at LA's batch-8 window with the route on gives
    the route-off forward's logits bit for bit; the route takes every
    kernel B stage (none left to B's plain store) and the plain eval
    BatchNorm runs only where it must; with grad enabled or in train mode
    the route takes nothing."""
    fused, plain = NETS[net]
    model = _net(net, cuda_device)
    x = torch.randn(BATCH, 1, *WINDOW, device=cuda_device)
    on, n_on = _forward(model, x)
    assert n_on == {"conv3x3x3_same_bn_relu": fused, "conv3x3x3_same": 0,
                    "plain_eval_batch_norm": plain,
                    "plain_train_batch_norm": 0}
    with monkeypatch.context() as m:
        m.setattr(layers, "eval_fused_route", lambda *a: False)
        off, n_off = _forward(model, x)
    assert n_off["conv3x3x3_same_bn_relu"] == 0
    assert n_off["conv3x3x3_same"] == fused
    assert n_off["plain_eval_batch_norm"] == fused + plain
    assert torch.equal(_bits(on.to(BF16)), _bits(off.to(BF16)))
    assert torch.equal(on, off)

    graded, n_grad = _forward(model, x, grad=True)
    assert n_grad["conv3x3x3_same_bn_relu"] == 0
    assert n_grad["plain_eval_batch_norm"] == fused + plain
    assert torch.equal(graded.detach(), off)

    model.train()
    _, n_train = _forward(model, x[:2])
    assert n_train["conv3x3x3_same_bn_relu"] == 0
    assert n_train["plain_eval_batch_norm"] == 0
