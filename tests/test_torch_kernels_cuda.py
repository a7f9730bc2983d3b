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
                                      conv3x3x3_same_reference,
                                      flip_transpose)
from bcp_tpu_torch import kernels
from bcp_tpu_torch.ops.scatter import (scatter_add_windows,
                                       scatter_add_windows_reference,
                                       softmax_scatter_add_windows,
                                       softmax_scatter_add_windows_reference)

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


# (B, X, Y, Z, Ci, Co): small and odd shapes with streamed weights and K
# splits, Ci != Co, then the V-Net's kinds of stage: weights staged once per
# CTA with two CTAs per SM (16 channels) or four warpgroups per CTA (32),
# streamed weights shared by four warpgroups (64), a K split with
# persistent weights (128; 256 at a ragged 7x7x5, batch 1 too)
CONV_SHAPES = [(2, 6, 5, 7, 16, 16), (1, 4, 4, 3, 32, 64),
               (2, 3, 5, 4, 256, 256), (1, 9, 11, 13, 32, 48),
               (2, 7, 7, 5, 256, 256), (1, 40, 36, 48, 16, 16),
               (2, 56, 56, 40, 32, 32), (4, 28, 28, 20, 64, 64),
               (8, 14, 14, 10, 128, 128), (8, 7, 7, 5, 256, 256),
               (1, 7, 7, 5, 256, 256), (3, 7, 7, 5, 128, 64),
               (1, 23, 19, 21, 48, 16)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_kernel_matches_plain(cuda_device, shape, dtype, tol):
    """f32 to rtol = atol = 1e-4; bf16 (f32 sums in another order, one
    rounding) to max|kernel - plain| <= 1e-2 max|plain|. The shapes take
    every kind of variant the bf16 kernel's picker returns."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_kernel_same_bits_twice(cuda_device, shape, dtype):
    """Forward and dx give the same bits on a second run: the K splits'
    partial sums are added in a fixed order, not with atomics. dx equals
    the forward kernel on the flipped, io-transposed weights made by
    torch."""
    x, w = (t.to(cuda_device, dtype) for t in _conv_case(*shape, seed=7))
    dy, _ = _conv_case(*shape[:4], shape[5], shape[5], seed=8)
    dy = dy.to(cuda_device, dtype)
    got, again = conv3x3x3_same(x, w), conv3x3x3_same(x, w)
    dx, dx_again = conv3x3x3_dx(dy, w), conv3x3x3_dx(dy, w)
    by_forward = conv3x3x3_same(dy, flip_transpose(w).contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(dx, dx_again)
    assert torch.equal(dx, by_forward)


#: (B, X, Y, Z, Ci, Co) of the model zoo's widest convs: UNet3D's bottom
#: level at the LA patch (7x7x5) at 1024 -> 1024 and 512 -> 1024, and its
#: dec_conv_blk4 (and UNETR's dec9_conv0) at 1024 -> 512 (14x14x10)
ZOO_SHAPES = [(2, 7, 7, 5, 1024, 1024), (2, 7, 7, 5, 512, 1024),
              (2, 14, 14, 10, 1024, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ZOO_SHAPES)
def test_kernels_at_the_zoos_widths(cuda_device, shape, dtype):
    """B forward, B-as-dx and C at up to 1024 channels, within phase 2's
    limits (f32 forward and dx to rtol = atol = 1e-4, bf16 to 1e-2
    max|plain|, dW to 1e-3 max|plain|), the same bits on a second run."""
    x, w = (t.to(cuda_device, dtype) for t in _conv_case(*shape, seed=9))
    dy, _ = _conv_case(*shape[:4], shape[5], shape[5], seed=10)
    dy = dy.to(cuda_device, dtype)

    def hold(got, again, want, rel):
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        if rel is None:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        else:
            err = (got.float() - want.float()).abs().max().item()
            assert err <= rel * want.float().abs().max().item()

    rel = None if dtype == torch.float32 else 1e-2
    hold(conv3x3x3_same(x, w), conv3x3x3_same(x, w),
         conv3x3x3_same_reference(x, w), rel)
    hold(conv3x3x3_dx(dy, w), conv3x3x3_dx(dy, w),
         conv3x3x3_same_reference(dy, flip_transpose(w)), rel)
    xc, dyc = (t.contiguous(memory_format=torch.channels_last_3d)
               for t in (x, dy))
    hold(conv3x3x3_dw(xc, dyc), conv3x3x3_dw(xc, dyc),
         conv3x3x3_dw_reference(xc, dyc), 1e-3)


def test_conv_kernel_refuses_what_it_does_not_take(cuda_device):
    x, w = (t.to(cuda_device) for t in _conv_case(1, 4, 4, 4, 8, 16, 0))
    with pytest.raises(ValueError, match="does not take"):
        conv3x3x3_same(x, w)
    with pytest.raises(TypeError):
        conv3x3x3_same(x.half(), w.half())


# (B, X, Y, Z, Ci, Co): odd and ragged shapes, Ci != Co; 48 -> 64 takes a
# ci tile of 16 beside a co group of 32
DW_SHAPES = [(2, 6, 5, 7, 16, 16), (1, 4, 4, 3, 32, 64),
             (2, 3, 5, 4, 256, 256), (1, 9, 11, 13, 32, 48),
             (2, 7, 7, 5, 256, 256), (1, 20, 18, 16, 16, 16),
             (1, 9, 11, 13, 48, 64)]


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


#: kernel C's bf16 variants: two of the V-Net's stage shapes (batch 2,
#: small volumes) and a ragged one (X, Y not multiples of 8, Z not of 3)
DW_VARIANT_SHAPES = [(2, 16, 16, 12, 32, 32), (2, 8, 8, 6, 128, 128),
                     (1, 13, 11, 7, 64, 96)]


@pytest.mark.parametrize("shape", DW_VARIANT_SHAPES)
def test_dw_every_variant_matches_plain(cuda_device, shape):
    """Every (ci tile, co group) pair and box depth kernel C's picker can
    return for the shape, with its stages and splits, with three stages
    and one split, and with splits added through thread-block clusters
    (two clusters of 2, one of 8): within 1e-3 max|plain|, the same bits on
    a second run, one launch a call, and the picked variant among them."""
    from bcp_tpu_torch.ops import conv3d
    B, X, Y, Z, Ci, Co = shape
    x, _ = _conv_case(B, X, Y, Z, Ci, Co, seed=13)
    dy, _ = _conv_case(B, X, Y, Z, Co, Co, seed=14)
    x, dy = (t.to(cuda_device, torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d) for t in (x, dy))
    want = conv3x3x3_dw_reference(x, dy)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    found = conv3d.dw_candidates(B, X, Y, Z, Ci, Co, sms)
    assert conv3d.dw_variant(B, X, Y, Z, Ci, Co, sms) in found
    variants = list(found) + [v._replace(stages=3, splits=1, cluster=1)
                              for v in found]
    variants += [v._replace(splits=s, cluster=c) for v in found
                 for s, c in ((4, 2), (8, 8))]
    for v in variants:
        before = conv3x3x3_dw.launches
        got = conv3x3x3_dw(x, dy, variant=v)
        again = conv3x3x3_dw(x, dy, variant=v)
        torch.cuda.synchronize()
        assert conv3x3x3_dw.launches == before + 2, v
        assert got.shape == want.shape and got.dtype == torch.float32, v
        assert torch.equal(got, again), v
        err = (got - want).abs().max().item()
        assert err <= 1e-3 * want.abs().max().item(), (v, err)


def test_dw_kernel_refuses_a_variant_that_does_not_fit(cuda_device):
    """Kernel C's launcher refuses a variant whose ring does not fit in
    shared memory (four stages of (32, 32) with boxes of 4 planes: 256512
    bytes) or whose splits do not fill its clusters; the wrapper raises
    and counts no launch (no fallback)."""
    from bcp_tpu_torch.ops.conv3d import DwVariant
    x, _ = _conv_case(1, 8, 8, 8, 32, 32, seed=15)
    x = x.to(cuda_device, torch.bfloat16)
    before = conv3x3x3_dw.launches
    for v in (DwVariant(32, 32, 4, 1, 4, 1), DwVariant(32, 32, 3, 3, 3, 2)):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            conv3x3x3_dw(x, x, variant=v)
    assert conv3x3x3_dw.launches == before


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


#: kernel D's bf16 variants: each of the V-Net's channel counts at batch 2
#: on small volumes, then ragged ones (X, Y not multiples of 8, Z not of 3)
DXDW_VARIANT_SHAPES = [(2, 16, 12, 10, 7), (2, 32, 9, 16, 6),
                       (2, 64, 8, 8, 5), (2, 128, 7, 9, 4),
                       (2, 256, 7, 7, 5), (1, 48, 13, 11, 2),
                       (3, 64, 5, 17, 10)]


@pytest.mark.parametrize("shape", DXDW_VARIANT_SHAPES)
def test_dxdw_every_variant_matches_plain(cuda_device, shape):
    """Every variant kernel D's picker can return for the shape (each
    (ci tile, co group) pair that divides C, with its stages and splits),
    and a one-split, two-stage run of each: bf16 dx within 1e-2 max|p|,
    dW within 1e-3 max|p|, two runs bit-identical, one launch a call."""
    from bcp_tpu_torch.ops import conv3d
    B, C, X, Y, Z = shape
    x, w = _conv_case(B, X, Y, Z, C, C, seed=11)
    dy, _ = _conv_case(B, X, Y, Z, C, C, seed=12)
    x, dy = (t.to(cuda_device, torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d) for t in (x, dy))
    w = w.to(cuda_device, torch.bfloat16)
    want_dx, want_dw = conv3x3x3_dxdw_reference(x, dy, w)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    found = conv3d.dxdw_candidates(B, X, Y, Z, C, sms)
    assert conv3d.dxdw_variant(B, X, Y, Z, C, sms) in found
    variants = list(found) + [v._replace(stages=2, splits=1) for v in found]
    for v in variants:
        before = conv3x3x3_dxdw.launches
        dx, dw = conv3x3x3_dxdw(x, dy, w, variant=v)
        dx2, dw2 = conv3x3x3_dxdw(x, dy, w, variant=v)
        torch.cuda.synchronize()
        assert conv3x3x3_dxdw.launches == before + 2, v
        assert torch.equal(dx, dx2) and torch.equal(dw, dw2), v
        err = (dx.float() - want_dx.float()).abs().max().item()
        assert err <= 1e-2 * want_dx.float().abs().max().item(), (v, err)
        err = (dw - want_dw).abs().max().item()
        assert err <= 1e-3 * want_dw.abs().max().item(), (v, err)


@pytest.mark.parametrize("C,ci_tile", [(16, 16), (32, 32), (64, 16),
                                        (256, 16)])
def test_dxdw_pack_kernel_matches_plain(cuda_device, C, ci_tile):
    """Kernel D's ``pack_weights`` writes exactly the order its plain
    statement gives."""
    from bcp_tpu_torch import kernels
    from bcp_tpu_torch.ops.conv3d import dxdw_pack_reference
    _, w = _conv_case(1, 1, 1, 1, C, C, seed=C)
    w = w.to(cuda_device, torch.bfloat16)
    wpk = torch.empty(27 * C * C, dtype=torch.bfloat16, device=cuda_device)
    kernels.check(kernels.library("conv3x3x3_dxdw").conv3x3x3_dxdw_pack(
        w.data_ptr(), wpk.data_ptr(), C, ci_tile,
        kernels.stream_handle(w.device)), "conv3x3x3_dxdw_pack")
    torch.cuda.synchronize()
    assert torch.equal(wpk, dxdw_pack_reference(w, ci_tile))


def test_wgmma_mn_probe(cuda_device, tmp_path):
    """``scripts/wgmma_mn_probe.cu``: wgmma with both operands MN-major in
    kernel D's slab layout, and the dW engine on one tile, against host
    products; it exits 0 when every check passes."""
    import subprocess
    from pathlib import Path
    from bcp_tpu_torch import kernels
    root = Path(__file__).resolve().parent.parent
    exe = tmp_path / "wgmma_mn_probe"
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,"
                    "code=sm_90a", "-O3", "-std=c++17", "-I",
                    str(kernels.CSRC), "-o", str(exe),
                    str(root / "scripts" / "wgmma_mn_probe.cu")],
                   check=True)
    run = subprocess.run([str(exe)], capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "all checks pass" in run.stdout


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


# kernel A's two entries: (map, classes, windows, patch, z starts, the
# vector width the launch takes; the fused entry takes it at C = 2 and its
# generic kernel at any other C). Width 4 needs Z*C, pz*C and every start's
# z*C to be multiples of 4; odd starts or an odd Z halve it, and with an odd
# C they leave single floats. Every case has a repeated window and one at
# the map's far corner.
OVERLAP_CASES = [((40, 36, 28), 2, 6, (16, 12, 8), "even", 4),
                 ((40, 36, 28), 2, 6, (16, 12, 8), "odd", 2),
                 ((40, 36, 27), 2, 6, (16, 12, 8), "even", 2),
                 ((40, 36, 28), 3, 6, (16, 12, 8), "four", 4),
                 ((40, 36, 28), 3, 6, (16, 12, 8), "odd", 1),
                 ((33, 20, 27), 1, 5, (9, 7, 5), "odd", 1),
                 ((30, 26, 40), 4, 9, (12, 10, 16), "even", 4),
                 ((30, 26, 40), 9, 5, (12, 10, 16), "odd", 1)]


def _overlap_case(case, seed):
    (X, Y, Z), C, B, p, zs, _ = case
    rng = np.random.default_rng(seed)
    score = rng.random((X, Y, Z, C)).astype(np.float32)
    src = (3 * rng.normal(size=(B, *p, C))).astype(np.float32)
    z = rng.integers(0, Z - p[2] + 1, B)
    if zs == "even":
        z -= z % 2
    elif zs == "four":
        z -= z % 4
    else:
        z[0] = 2 * rng.integers(0, (Z - p[2]) // 2) + 1
    starts = np.stack([rng.integers(0, X - p[0] + 1, B),
                       rng.integers(0, Y - p[1] + 1, B), z],
                      1).astype(np.int32)
    starts[1] = starts[0]                                  # repeated
    starts[2] = (X - p[0], Y - p[1], Z - p[2] - (Z - p[2]) % 4
                 if zs in ("even", "four") and Z % 2 == 0 else Z - p[2])
    return score, src, starts


@pytest.mark.parametrize("case", OVERLAP_CASES)
def test_overlap_add_vector_width(cuda_device, case):
    score, src, starts = _overlap_case(case, 0)
    s, p = (torch.from_numpy(a).to(cuda_device) for a in (score, src))
    Z, C, pz = score.shape[2], score.shape[3], src.shape[3]
    lib = kernels.library("scatter_add")
    assert lib.overlap_add_vector_width(
        s.data_ptr(), p.data_ptr(), starts.ctypes.data, len(starts), Z, C,
        pz) == case[-1]


@pytest.mark.parametrize("case", OVERLAP_CASES)
def test_overlap_add_probs_entry_is_the_in_order_loop(cuda_device, case):
    """Bit for bit the in-order loop, the same bits on a second run; the
    launch moves its own counter by one and not the fused entry's."""
    score, probs, starts = _overlap_case(case, 1)
    s_dev = torch.from_numpy(score).to(cuda_device)
    p_dev = torch.from_numpy(probs).abs().to(cuda_device)
    want = scatter_add_windows_reference(s_dev.clone(), p_dev, starts)
    before = (scatter_add_windows.launches,
              softmax_scatter_add_windows.launches)
    got = scatter_add_windows(s_dev.clone(), p_dev, starts)
    again = scatter_add_windows(s_dev.clone(), p_dev, starts)
    torch.cuda.synchronize()
    assert (scatter_add_windows.launches,
            softmax_scatter_add_windows.launches) == (before[0] + 2,
                                                      before[1])
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.parametrize("padded", [0, 2])
@pytest.mark.parametrize("case", OVERLAP_CASES)
def test_overlap_add_fused_entry_matches_plain(cuda_device, case, padded):
    """Within 1e-6 max|plain| of torch.softmax then the in-order loop (the
    same bits where the two softmaxes sum in the same order), the same bits
    on a second run. The padded windows' logits are NaN: a read of one
    would show. The launch moves its own counter by one."""
    score, logits, starts = _overlap_case(case, 2)
    n_valid = len(starts) - padded
    logits[n_valid:] = np.nan
    starts[n_valid:] = 0
    s_dev = torch.from_numpy(score).to(cuda_device)
    l_dev = torch.from_numpy(logits).to(cuda_device)
    want = softmax_scatter_add_windows_reference(s_dev.clone(), l_dev,
                                                 starts, n_valid)
    before = (scatter_add_windows.launches,
              softmax_scatter_add_windows.launches)
    got = softmax_scatter_add_windows(s_dev.clone(), l_dev, starts, n_valid)
    again = softmax_scatter_add_windows(s_dev.clone(), l_dev, starts,
                                        n_valid)
    torch.cuda.synchronize()
    assert (scatter_add_windows.launches,
            softmax_scatter_add_windows.launches) == (before[0],
                                                      before[1] + 1 + 1)
    assert torch.equal(got, again) and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item()


def test_overlap_add_refuses_cuda_tensors_it_cannot_take(cuda_device):
    """On a CUDA tensor the fused wrapper launches or raises: a score on
    another device than the logits and non-contiguous logits are refused
    and not handed to the plain version."""
    score, logits, starts = _overlap_case(OVERLAP_CASES[0], 3)
    s_dev = torch.from_numpy(score).to(cuda_device)
    l_dev = torch.from_numpy(logits).to(cuda_device)
    before = softmax_scatter_add_windows.launches
    with pytest.raises(ValueError, match="logits on"):
        softmax_scatter_add_windows(s_dev, torch.from_numpy(logits), starts,
                                    len(starts))
    with pytest.raises(ValueError, match="contiguous"):
        softmax_scatter_add_windows(
            s_dev, l_dev.transpose(1, 2).contiguous().transpose(1, 2),
            starts, len(starts))
    assert softmax_scatter_add_windows.launches == before
