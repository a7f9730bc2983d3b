"""The port's conv backward (``Conv3x3x3Function``: dx through kernel B's
plain version, dW through kernel C's) against the JAX package: ``jax.grad``
of its Pallas conv in interpret mode and its Pallas dW kernel in interpret
mode, as ``tests/test_conv3d.py`` runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcp_tpu.ops import conv3d as jax_conv3d
from bcp_tpu_torch.ops.conv3d import (Conv3x3x3Function, conv3x3x3_dw,
                                      conv3x3x3_dw_reference, conv3x3x3_dx,
                                      dw_splits, flip_transpose)


def _case(B, X, Y, Z, Ci, Co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, X, Y, Z, Ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, Ci, Co)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(B, X, Y, Z, Co)).astype(np.float32)
    return x, w, dy


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 4, 1, 2, 3)


def _oidhw(w):
    return torch.from_numpy(np.ascontiguousarray(w)).permute(4, 3, 0, 1, 2)


@pytest.mark.parametrize("shape", [(1, 4, 8, 8, 16, 16), (1, 4, 8, 8, 32, 16),
                                   (1, 2, 8, 4, 32, 32)])
def test_function_grads_match_jax_grad_of_pallas_interpret(shape):
    """dx and dW of ``sum(y * dy)`` to rtol = atol = 2e-4, the JAX package's
    own limit for its kernel's grads (`test_conv3d.py:40-55`)."""
    x, w, dy = _case(*shape)
    tiles = jax_conv3d.pallas_conv_tiles(x.shape, w.shape)

    def loss(xv, wv):
        return (jax_conv3d.conv3x3x3_same(xv, wv, tiles, True)
                * jnp.asarray(dy)).sum()

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = _ncdhw(x).requires_grad_()
    wt = _oidhw(w).requires_grad_()
    y = Conv3x3x3Function.apply(xt, wt)
    y.backward(_ncdhw(dy))
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(gx), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(wt.grad.permute(2, 3, 4, 1, 0).numpy(),
                               np.asarray(gw), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("co", [16, 32])
def test_plain_dw_matches_pallas_dw_interpret(co):
    """`test_conv3d.py:99-115`'s case: f32 to rtol = atol = 2e-4."""
    B, X, Y, Z, Ci = 1, 4, 8, 8, 16
    x, _, dy = _case(B, X, Y, Z, Ci, co, seed=1)
    tiles = jax_conv3d.pallas_conv_tiles(x.shape, (3, 3, 3, Ci, co))
    want = jax_conv3d._conv3x3x3_dw_pallas(
        jax_conv3d.merge_zc(jnp.asarray(x)),
        jax_conv3d.merge_zc(jnp.asarray(dy)), Z, Ci, tiles[0], tiles[1],
        True)
    got = conv3x3x3_dw_reference(_ncdhw(x), _ncdhw(dy))
    assert got.dtype == torch.float32
    assert torch.equal(conv3x3x3_dw(_ncdhw(x), _ncdhw(dy)), got)
    np.testing.assert_allclose(got.permute(2, 3, 4, 1, 0).numpy(),
                               np.asarray(want), rtol=2e-4, atol=2e-4)


def test_plain_dx_is_the_conv_of_dy_with_flipped_weights():
    x, w, dy = _case(1, 3, 4, 5, 16, 32, seed=2)
    got = conv3x3x3_dx(_ncdhw(dy), _oidhw(w))
    _, vjp = jax.vjp(lambda xv: jax_conv3d._direct(xv, jnp.asarray(w)),
                     jnp.asarray(x))
    want, = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)
    assert flip_transpose(_oidhw(w)).shape == (16, 32, 3, 3, 3)


def test_function_gradcheck_f64():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 16, 2, 3, 2))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(16, 16, 3, 3, 3)) * 0.1
                         ).requires_grad_()
    assert torch.autograd.gradcheck(Conv3x3x3Function.apply, (x, w))


def test_bf16_backward_casts_dy_and_returns_w_dtype():
    """dy is cast to x's dtype before the backward; dW comes back in w's
    dtype (`_merged_bwd` :575, :584-585)."""
    x, w, dy = _case(1, 3, 3, 3, 16, 16, seed=4)
    xt = _ncdhw(x).bfloat16().requires_grad_()
    wt = _oidhw(w).bfloat16().requires_grad_()
    Conv3x3x3Function.apply(xt, wt).backward(_ncdhw(dy))   # f32 dy
    assert xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    want = conv3x3x3_dw_reference(xt.detach(), _ncdhw(dy).bfloat16())
    assert torch.equal(wt.grad, want.bfloat16())


@pytest.mark.parametrize("ci,co,bn,boxes,want", [
    (16, 16, 16, 31360, 264), (256, 256, 32, 12, 3), (256, 256, 32, 1000, 3),
    (128, 128, 32, 100, 9), (32, 32, 32, 5, 5), (256, 256, 16, 1000, 2)])
def test_dw_split_rule(ci, co, bn, boxes, want):
    """Enough CTAs for two per SM, at most one split per box, and the
    partial sums within 32 MB."""
    got = dw_splits(ci, co, bn, boxes, 132)
    assert got == want
    assert got * 27 * ci * co * 4 <= 32 << 20 or got == 1
