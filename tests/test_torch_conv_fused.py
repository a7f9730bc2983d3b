"""The port's fused conv backward on the CPU: ``conv3x3x3_dxdw_reference``
(what kernel D computes) against the JAX package's fused Pallas kernel in
interpret mode, as ``tests/test_conv3d.py`` runs it, and
``Conv3x3x3Function`` with ``fused=True`` against ``fused=False``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcp_tpu.ops import conv3d as jax_conv3d
from bcp_tpu_torch.models.layers import Conv3x3x3
from bcp_tpu_torch.ops import conv3d
from bcp_tpu_torch.ops.conv3d import (Conv3x3x3Function, conv3x3x3_dw,
                                      conv3x3x3_dx, conv3x3x3_dxdw,
                                      conv3x3x3_dxdw_reference,
                                      fused_bwd_eligible)


def _case(B, X, Y, Z, C, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, X, Y, Z, C)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, C, C)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(B, X, Y, Z, C)).astype(np.float32)
    return x, w, dy


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 4, 1, 2, 3)


def _oidhw(w):
    return torch.from_numpy(np.ascontiguousarray(w)).permute(4, 3, 0, 1, 2)


@pytest.mark.parametrize("shape", [
    (1, 4, 8, 8, 16),      # G=8, single z tile
    (2, 4, 8, 16, 16),     # two z tiles
    (1, 2, 8, 8, 32),      # G=4
])
def test_plain_dxdw_matches_pallas_dxdw_interpret(shape):
    """The three shapes and the limit (rtol = atol = 2e-4) of
    `test_conv3d.py:231-254`."""
    x, w, dy = _case(*shape, seed=7)
    tiles = jax_conv3d.fused_bwd_eligible(x.shape, w.shape)
    assert tiles is not None
    want_dx, want_dw = jax_conv3d.conv3x3x3_dxdw(
        jnp.asarray(x), jnp.asarray(dy), jnp.asarray(w), tiles,
        interpret=True)
    got_dx, got_dw = conv3x3x3_dxdw_reference(_ncdhw(x), _ncdhw(dy),
                                              _oidhw(w))
    assert got_dx.dtype == got_dw.dtype == torch.float32
    np.testing.assert_allclose(got_dx.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(want_dx), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_dw.permute(2, 3, 4, 1, 0).numpy(),
                               np.asarray(want_dw), rtol=2e-4, atol=2e-4)


def test_wrapper_on_cpu_is_the_two_plain_versions_composed():
    x, w, dy = _case(1, 3, 4, 5, 16, seed=1)
    x, w, dy = _ncdhw(x), _oidhw(w), _ncdhw(dy)
    before = conv3x3x3_dxdw.launches
    dx, dw = conv3x3x3_dxdw(x, dy, w)
    assert conv3x3x3_dxdw.launches == before     # no kernel on the CPU
    assert torch.equal(dx, conv3x3x3_dx(dy, w))
    assert torch.equal(dw, conv3x3x3_dw(x, dy))
    assert dw.shape == (16, 16, 3, 3, 3)


@pytest.mark.parametrize("ci,co,want", [(16, 16, True), (256, 256, True),
                                        (32, 16, False), (16, 32, False),
                                        (8, 8, False), (1, 1, False)])
def test_fused_bwd_eligible(ci, co, want):
    """Ci == Co on top of the channel counts the kernels take
    (`test_conv3d.py:257-259`: (32, 16) is not)."""
    assert fused_bwd_eligible(ci, co) is want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_fused_equals_unfused(dtype):
    x, w, dy = _case(2, 3, 4, 3, 16, seed=2)
    grads = {}
    for fused in (False, True):
        xt = _ncdhw(x).to(dtype).requires_grad_()
        wt = _oidhw(w).to(dtype).requires_grad_()
        Conv3x3x3Function.apply(xt, wt, fused).backward(_ncdhw(dy))
        assert xt.grad.dtype == wt.grad.dtype == dtype
        grads[fused] = (xt.grad, wt.grad)
    assert torch.equal(grads[True][0], grads[False][0])
    assert torch.equal(grads[True][1], grads[False][1])


def test_function_fused_takes_the_fused_path_only_where_eligible(
        monkeypatch):
    """Fused, both gradients needed and Ci == Co: one call of the fused
    wrapper; otherwise the two separate ones (`layers.py:135-144`)."""
    calls = []
    real = conv3d.conv3x3x3_dxdw
    monkeypatch.setattr(conv3d, "conv3x3x3_dxdw",
                        lambda *a: calls.append("dxdw") or real(*a))
    rng = np.random.default_rng(3)

    def run(ci, co, fused, x_grad=True):
        x = torch.from_numpy(rng.normal(size=(1, ci, 2, 3, 2)).astype(
            np.float32)).requires_grad_(x_grad)
        w = torch.from_numpy(rng.normal(size=(co, ci, 3, 3, 3)).astype(
            np.float32)).requires_grad_()
        Conv3x3x3Function.apply(x, w, fused).sum().backward()
        return len(calls)

    assert run(16, 16, True) == 1
    assert run(16, 16, False) == 1
    assert run(16, 32, True) == 1             # Ci != Co
    assert run(16, 16, True, x_grad=False) == 1   # dW alone is needed
    assert run(32, 32, True) == 2


def test_function_fused_gradcheck_f64():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 16, 2, 3, 2))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(16, 16, 3, 3, 3)) * 0.1
                         ).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: Conv3x3x3Function.apply(a, b, True), (x, w))


def test_layer_carries_the_flag_to_the_function():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(1, 16, 3, 3, 2)).astype(np.float32))
    plain, fused = Conv3x3x3(16, 16), Conv3x3x3(16, 16, fused_bwd=True)
    fused.load_state_dict(plain.state_dict())
    grads = []
    for layer in (plain, fused):
        xi = x.clone().requires_grad_()
        layer(xi).square().sum().backward()
        grads.append((xi.grad, layer.weight.grad, layer.bias.grad))
    assert fused.fused_bwd and not plain.fused_bwd
    for a, b in zip(*grads):
        assert torch.equal(a, b)


#: the batch-4 backward's shapes of the self-train step (chip_smoke.py's
#: CONV_STAGES and TRAIN_CONCAT) and ragged ones: X or Y not a multiple of
#: 8, Z not a multiple of the box's 3 planes
DXDW_SHAPES = [(4, 32, 56, 56, 40), (4, 64, 28, 28, 20),
               (4, 128, 14, 14, 10), (4, 256, 7, 7, 5),
               (4, 16, 112, 112, 80), (2, 16, 13, 11, 7),
               (1, 48, 9, 20, 4), (3, 64, 7, 5, 11)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", DXDW_SHAPES)
def test_dxdw_variants_fit_and_cover_every_box(shape, sms):
    """Every candidate of kernel D (and so the one picked) fits in shared
    memory at its CTAs per SM, its (ci tile, co group) tiles C, and the
    CTAs of one tile, walking boxes split, split + splits, ..., visit each
    box of the volume exactly once."""
    B, C, X, Y, Z = shape
    found = conv3d.dxdw_candidates(B, X, Y, Z, C, sms)
    assert found and conv3d.dxdw_variant(B, X, Y, Z, C, sms) in found
    boxes = conv3d.dxdw_boxes(B, X, Y, Z)
    covered = (B * -(-X // 8) * 8 * -(-Y // 8) * 8
               * -(-Z // conv3d.DXDW_TILES) * conv3d.DXDW_TILES)
    assert boxes * 64 * conv3d.DXDW_TILES == covered >= B * X * Y * Z
    for v in found:
        assert (v.ci_tile, v.co_group) in conv3d.DXDW_PAIRS
        assert C % v.ci_tile == 0 and C % v.co_group == 0
        assert 2 <= v.stages <= conv3d.CONV_MAX_STAGES
        per_sm = v.ctas_per_sm()
        assert per_sm >= 1
        assert v.smem_bytes() <= conv3d.CONV_SMEM_LIMIT
        assert per_sm * (v.smem_bytes() + conv3d.CONV_CTA_RESERVED) \
            <= conv3d.CONV_SM_SMEM
        assert 1 <= v.splits <= boxes
        assert v.splits * 27 * C * C * 4 <= max(conv3d.DW_WORKSPACE_BYTES,
                                                27 * C * C * 4)
        walked = sorted(b for s in range(v.splits)
                        for b in range(s, boxes, v.splits))
        assert walked == list(range(boxes))


def test_dxdw_variant_rules():
    """(32, 32) unless its f32 copies of dx pass DXDW_DX_PARTIALS_BYTES
    (4x64@28x28x20: 32 MB, so (16, 64) with none), (16, 16) where 32 does
    not divide C (16 or 48 channels); the grid near one wave."""
    pick = {C: conv3d.dxdw_variant(B, X, Y, Z, C, 132)
            for B, C, X, Y, Z in DXDW_SHAPES[:5]}
    assert [(pick[C].ci_tile, pick[C].co_group)
            for C in (16, 32, 64, 128, 256)] == [
        (16, 16), (32, 32), (16, 64), (32, 32), (32, 32)]
    assert pick[32].splits == 132 and pick[16].splits == 264
    assert conv3d.dxdw_variant(1, 9, 20, 4, 48, 132)[:2] == (16, 16)
    assert conv3d.dxdw_variant(1, 8, 8, 8, 96, 132)[:2] == (32, 32)
    # past the workspace limit without a (16, 64): still (32, 32)
    assert conv3d.dxdw_variant(4, 32, 32, 32, 96, 132)[:2] == (32, 32)
    for C, v in pick.items():
        ctas = v.splits * (C // v.ci_tile) * (C // v.co_group)
        assert ctas <= 2 * 132


@pytest.mark.parametrize("C,ci_tile", [(16, 16), (32, 32), (64, 16),
                                        (64, 32), (128, 32)])
def test_dxdw_weight_packing_round_trips(C, ci_tile):
    """The packed order (flipped taps, K-major core matrices, one run per
    CTA) round-trips, and each element is where the source note says."""
    w = torch.from_numpy(np.random.default_rng(C + ci_tile).normal(
        size=(C, C, 3, 3, 3)).astype(np.float32))
    wpk = conv3d.dxdw_pack_reference(w, ci_tile)
    assert wpk.shape == (27 * C * C,)
    # the inverse permutation gives w back
    back = wpk.reshape(C // ci_tile, C // 16, 27, 2, ci_tile, 8).permute(
        1, 3, 5, 0, 4, 2).flip(5).reshape(C, C, 3, 3, 3)
    assert torch.equal(back, w)
    flat = w.reshape(C, C, 27)
    rng = np.random.default_rng(3)
    for _ in range(50):
        tile = int(rng.integers(C // ci_tile))
        chunk = int(rng.integers(C // 16))
        tap, half = int(rng.integers(27)), int(rng.integers(2))
        n, e = int(rng.integers(ci_tile)), int(rng.integers(8))
        idx = ((((tile * (C // 16) + chunk) * 27 + tap) * 2 + half)
               * ci_tile + n) * 8 + e
        assert wpk[idx] == flat[16 * chunk + 8 * half + e,
                                tile * ci_tile + n, 26 - tap]
