"""The port's hand-written CUDA kernels against their plain versions, on
the card. Every test here needs a CUDA device and skips without one.

This file imports neither jax nor the JAX package, so it also runs on a
GPU host that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from bcp_tpu_torch.ops.conv3d import (Conv3x3x3Function, conv3x3x3_dw,
                                      conv3x3x3_dw_reference, conv3x3x3_dx,
                                      conv3x3x3_dxdw,
                                      conv3x3x3_dxdw_reference,
                                      conv3x3x3_same,
                                      conv3x3x3_same_reference)
from bcp_tpu_torch.ops.scatter import (scatter_add_windows,
                                       scatter_add_windows_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _conv_case(B, X, Y, Z, Ci, Co, seed):
    """Logical NCDHW x and (Co, Ci, 3, 3, 3) w from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, Ci, X, Y, Z)).astype(np.float32)
    w = (rng.normal(size=(Co, Ci, 3, 3, 3)) / np.sqrt(27 * Ci)).astype(
        np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(2, 6, 5, 7, 16, 16), (1, 4, 4, 3, 32, 64),
                                   (2, 3, 5, 4, 256, 256),
                                   (1, 9, 11, 13, 32, 48),
                                   (2, 7, 7, 5, 256, 256)])
def test_conv_kernel_matches_plain(cuda_device, shape, dtype, tol):
    """f32 to rtol = atol = 1e-4; bf16 (f32 sums in another order, one
    rounding) to max|kernel - plain| <= 1e-2 max|plain|."""
    x, w = (t.to(cuda_device, dtype) for t in _conv_case(*shape, seed=4))
    before = conv3x3x3_same.launches
    got = conv3x3x3_same(x, w)
    want = conv3x3x3_same_reference(x, w)
    torch.cuda.synchronize()
    assert conv3x3x3_same.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item()


def test_conv_kernel_refuses_what_it_does_not_take(cuda_device):
    x, w = (t.to(cuda_device) for t in _conv_case(1, 4, 4, 4, 8, 16, 0))
    with pytest.raises(ValueError, match="does not take"):
        conv3x3x3_same(x, w)
    with pytest.raises(TypeError):
        conv3x3x3_same(x.half(), w.half())


DW_SHAPES = [(2, 6, 5, 7, 16, 16), (1, 4, 4, 3, 32, 64),
             (2, 3, 5, 4, 256, 256), (1, 9, 11, 13, 32, 48),
             (2, 7, 7, 5, 256, 256), (1, 20, 18, 16, 16, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_dw_kernel_matches_plain(cuda_device, shape, dtype):
    """Kernel C against its plain version: both sum the same exact
    products in f32, in another order, so max|kernel - plain| <= 1e-3
    max|plain|; two runs give the same bits (no float atomics)."""
    x, _ = _conv_case(*shape, seed=5)
    dy, _ = _conv_case(*shape[:4], shape[5], shape[5], seed=6)
    x, dy = (t.to(cuda_device, dtype).contiguous(
        memory_format=torch.channels_last_3d) for t in (x, dy))
    before = conv3x3x3_dw.launches
    got = conv3x3x3_dw(x, dy)
    again = conv3x3x3_dw(x, dy)
    want = conv3x3x3_dw_reference(x, dy)
    torch.cuda.synchronize()
    assert conv3x3x3_dw.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, again)
    err = (got - want).abs().max().item()
    assert err <= 1e-3 * want.abs().max().item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-2)])
def test_function_grads_on_card_match_autograd_of_plain(cuda_device, dtype,
                                                        tol):
    """``Conv3x3x3Function``'s (dx, dW) through kernels B and C against
    autograd through the plain conv, each within tol * max|plain| (bf16:
    dx and dW are rounded to bf16 once; f32: sums in another order)."""
    x, w = (t.to(cuda_device, dtype) for t in _conv_case(2, 8, 9, 7, 32, 16,
                                                         seed=7))
    dy = torch.randn((2, 16, 8, 9, 7), device=cuda_device).to(dtype)
    x.requires_grad_()
    w.requires_grad_()
    fwd, dx_n, dw_n = (conv3x3x3_same.launches, conv3x3x3_dx.launches,
                       conv3x3x3_dw.launches)
    got = torch.autograd.grad(Conv3x3x3Function.apply(x, w), (x, w), dy)
    assert (conv3x3x3_same.launches, conv3x3x3_dx.launches,
            conv3x3x3_dw.launches) == (fwd + 1, dx_n + 1, dw_n + 1)
    want = torch.autograd.grad(conv3x3x3_same_reference(x, w), (x, w), dy)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        assert g.dtype == dtype and g.shape == p.shape
        err = (g.float() - p.float()).abs().max().item()
        assert err <= tol * p.float().abs().max().item()


DXDW_SHAPES = [(2, 6, 5, 7, 16), (1, 4, 4, 3, 32), (2, 3, 5, 4, 256),
               (1, 9, 11, 13, 48), (2, 7, 7, 5, 128), (1, 20, 18, 16, 16),
               (1, 5, 6, 9, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DXDW_SHAPES)
def test_dxdw_kernel_matches_plain(cuda_device, shape, dtype):
    """Kernel D against its plain version at odd, ragged shapes: dx to
    kernel B's limits (f32 rtol = atol = 1e-4; bf16 max|k - p| <= 1e-2
    max|p|), dW to kernel C's (<= 1e-3 max|p|); one launch a call; two
    runs give the same bits (no float atomics)."""
    B, X, Y, Z, C = shape
    x, w = _conv_case(B, X, Y, Z, C, C, seed=8)
    dy, _ = _conv_case(B, X, Y, Z, C, C, seed=9)
    x, dy = (t.to(cuda_device, dtype).contiguous(
        memory_format=torch.channels_last_3d) for t in (x, dy))
    w = w.to(cuda_device, dtype)
    before = conv3x3x3_dxdw.launches
    others = (conv3x3x3_dx.launches, conv3x3x3_dw.launches)
    dx, dw = conv3x3x3_dxdw(x, dy, w)
    dx2, dw2 = conv3x3x3_dxdw(x, dy, w)
    torch.cuda.synchronize()
    assert conv3x3x3_dxdw.launches == before + 2
    assert (conv3x3x3_dx.launches, conv3x3x3_dw.launches) == others
    want_dx, want_dw = conv3x3x3_dxdw_reference(x, dy, w)
    assert dx.dtype == dtype and dx.shape == x.shape
    assert dx.is_contiguous(memory_format=torch.channels_last_3d)
    assert dw.dtype == torch.float32 and dw.shape == (C, C, 3, 3, 3)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    if dtype == torch.float32:
        torch.testing.assert_close(dx, want_dx, rtol=1e-4, atol=1e-4)
    else:
        err = (dx.float() - want_dx.float()).abs().max().item()
        assert err <= 1e-2 * want_dx.float().abs().max().item()
    err = (dw - want_dw).abs().max().item()
    assert err <= 1e-3 * want_dw.abs().max().item()


def test_dxdw_kernel_refuses_what_it_does_not_take(cuda_device):
    x, w = _conv_case(1, 4, 4, 4, 16, 32, seed=0)     # Ci != Co
    dy, _ = _conv_case(1, 4, 4, 4, 32, 32, seed=1)
    with pytest.raises(ValueError):
        conv3x3x3_dxdw(x.to(cuda_device), dy.to(cuda_device),
                       w.to(cuda_device))
    x, w = _conv_case(1, 4, 4, 4, 16, 16, seed=2)
    dy = x.clone()
    before = conv3x3x3_dxdw.launches
    with pytest.raises(ValueError, match="on cpu"):      # CPU / GPU mixes
        conv3x3x3_dxdw(x.to(cuda_device), dy, w.to(cuda_device))
    with pytest.raises(ValueError, match="on cpu"):
        conv3x3x3_dxdw(x, dy.to(cuda_device), w)
    with pytest.raises(TypeError):
        conv3x3x3_dxdw(x.to(cuda_device).half(), dy.to(cuda_device).half(),
                       w.to(cuda_device).half())
    x8, w8 = _conv_case(1, 4, 4, 4, 8, 8, seed=3)
    with pytest.raises(ValueError, match="does not take"):
        conv3x3x3_dxdw(x8.to(cuda_device), x8.to(cuda_device),
                       w8.to(cuda_device))
    assert conv3x3x3_dxdw.launches == before


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-2)])
def test_fused_function_grads_on_card(cuda_device, dtype, tol):
    """``Conv3x3x3Function`` with ``fused=True``: one launch of kernel D
    and none of B-as-dx or C, its (dx, dW) within tol * max|plain| of
    autograd through the plain conv."""
    x, w = (t.to(cuda_device, dtype) for t in _conv_case(2, 8, 9, 7, 32, 32,
                                                         seed=7))
    dy = torch.randn((2, 32, 8, 9, 7), device=cuda_device).to(dtype)
    x.requires_grad_()
    w.requires_grad_()
    counts = (conv3x3x3_dx.launches, conv3x3x3_dw.launches,
              conv3x3x3_dxdw.launches)
    got = torch.autograd.grad(Conv3x3x3Function.apply(x, w, True), (x, w),
                              dy)
    assert (conv3x3x3_dx.launches, conv3x3x3_dw.launches,
            conv3x3x3_dxdw.launches) == (counts[0], counts[1], counts[2] + 1)
    want = torch.autograd.grad(conv3x3x3_same_reference(x, w), (x, w), dy)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        assert g.dtype == dtype and g.shape == p.shape
        err = (g.float() - p.float()).abs().max().item()
        assert err <= tol * p.float().abs().max().item()


def _scatter_case(seed, X=40, Y=36, Z=28, C=2, B=6, p=(16, 12, 8)):
    rng = np.random.default_rng(seed)
    score = rng.random((X, Y, Z, C)).astype(np.float32)
    probs = rng.random((B, *p, C)).astype(np.float32)
    starts = np.stack([rng.integers(0, X - p[0] + 1, B),
                       rng.integers(0, Y - p[1] + 1, B),
                       rng.integers(0, Z - p[2] + 1, B)], 1).astype(np.int32)
    starts[-1] = starts[0]   # a window repeated
    return score, probs, starts


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_kernel_equals_plain(cuda_device, seed):
    score, probs, starts = _scatter_case(seed)
    s_dev = torch.from_numpy(score).to(cuda_device)
    p_dev = torch.from_numpy(probs).to(cuda_device)
    want = scatter_add_windows_reference(s_dev.clone(), p_dev, starts)
    before = scatter_add_windows.launches
    got = scatter_add_windows(s_dev.clone(), p_dev, starts)
    torch.cuda.synchronize()
    assert scatter_add_windows.launches == before + 1
    assert torch.equal(got, want)
