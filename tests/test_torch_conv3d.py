"""The port's 3^3 SAME conv against the JAX package: its Pallas kernel in
interpret mode and the numpy oracle ``reference_conv3x3x3``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from bcp_tpu.ops import conv3d as jax_conv3d
from bcp_tpu_torch.device import resolve_device
from bcp_tpu_torch.ops.conv3d import (BOX_VOXELS, MAX_HALO, conv3x3x3_same,
                                      conv3x3x3_same_reference, halo_box,
                                      kernel_takes, n_tile)


def _case(B, X, Y, Z, Ci, Co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, X, Y, Z, Ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, Ci, Co)) * 0.1).astype(np.float32)
    return x, w


def _to_torch(x, w):
    """NDHWC / DHWIO numpy -> logical NCDHW / (Co, Ci, 3, 3, 3) tensors."""
    return (torch.from_numpy(x).permute(0, 4, 1, 2, 3),
            torch.from_numpy(w).permute(4, 3, 0, 1, 2))


@pytest.mark.parametrize("shape", [
    (1, 4, 8, 8, 16, 16),
    (2, 4, 8, 16, 16, 16),
    (1, 4, 8, 8, 32, 16),
    (1, 2, 8, 4, 32, 32),
])
def test_plain_conv_matches_pallas_interpret_and_oracle(shape):
    B, X, Y, Z, Ci, Co = shape
    x, w = _case(B, X, Y, Z, Ci, Co)
    tiles = jax_conv3d.pallas_conv_tiles(x.shape, w.shape)
    want = np.asarray(jax_conv3d.conv3x3x3_same(
        jnp.asarray(x), jnp.asarray(w), tiles, True))
    oracle = jax_conv3d.reference_conv3x3x3(x, w)
    xt, wt = _to_torch(x, w)
    got = conv3x3x3_same(xt, wt).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)


def test_cpu_tensor_runs_plain_version_without_launch():
    x, w = _case(1, 3, 5, 4, 16, 32, seed=1)
    xt, wt = _to_torch(x, w)
    before = conv3x3x3_same.launches
    got = conv3x3x3_same(xt, wt)
    assert conv3x3x3_same.launches == before
    assert torch.equal(got, conv3x3x3_same_reference(xt, wt))
    np.testing.assert_allclose(got.numpy(), F.conv3d(xt, wt, padding=1)
                               .numpy(), rtol=1e-4, atol=1e-4)


def test_plain_bf16_rounds_f32_sum_once():
    x, w = _case(1, 4, 4, 4, 16, 16, seed=2)
    xt, wt = _to_torch(x, w)
    xb, wb = xt.bfloat16(), wt.bfloat16()
    got = conv3x3x3_same(xb, wb)
    assert got.dtype == torch.bfloat16
    want = conv3x3x3_same_reference(xb.float(), wb.float()).bfloat16()
    assert torch.equal(got, want)


def test_kernel_shape_rule():
    assert kernel_takes(16, 16) and kernel_takes(256, 256)
    assert kernel_takes(32, 48)
    assert not kernel_takes(1, 16) and not kernel_takes(8, 16)
    assert not kernel_takes(16, 8)


def test_asking_for_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("vol", [(112, 112, 80), (56, 56, 40), (28, 28, 20),
                                 (14, 14, 10), (7, 7, 5), (4, 4, 3),
                                 (1, 1, 1), (23, 19, 21), (200, 3, 2)])
def test_halo_box_within_kernel_limits(vol):
    tx, ty, tz = halo_box(*vol)
    assert 1 <= tx <= vol[0] and 1 <= ty <= vol[1] and 1 <= tz <= vol[2]
    assert tx * ty * tz <= BOX_VOXELS
    assert (tx + 2) * (ty + 2) * (tz + 2) <= MAX_HALO


def test_halo_box_fills_the_vnet_stages():
    """The V-Net's stages that tile exactly use every row of every box."""
    for vol in ((112, 112, 80), (56, 56, 40)):
        tx, ty, tz = halo_box(*vol)
        assert tx * ty * tz == BOX_VOXELS
        assert all(v % t == 0 for v, t in zip(vol, (tx, ty, tz)))


@pytest.mark.parametrize("co,ctas,want", [(256, 24, 32), (256, 8, 16),
                                          (128, 144, 64), (16, 62720, 16),
                                          (48, 1000, 16), (32, 7840, 32)])
def test_n_tile(co, ctas, want):
    assert n_tile(co, ctas, 132) == want
