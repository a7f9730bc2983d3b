"""The port's 3^3 SAME conv against the JAX package: its Pallas kernel in
interpret mode and the numpy oracle ``reference_conv3x3x3``."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from bcp_tpu.ops import conv3d as jax_conv3d
from bcp_tpu_torch.device import resolve_device
from bcp_tpu_torch.ops.conv3d import (BOX_VOXELS, CONV_MAX_STAGES,
                                      CONV_SMEM_LIMIT, MAX_HALO,
                                      conv3x3x3_same,
                                      conv3x3x3_same_reference, conv_tiles,
                                      conv_variant, halo_box, halo_bytes,
                                      kernel_takes)


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


STAGE_SHAPES = [(b, c, c, *vol) for b in (8, 4) for c, vol in (
    (16, (112, 112, 80)), (32, (56, 56, 40)), (64, (28, 28, 20)),
    (128, (14, 14, 10)), (256, (7, 7, 5)))]
#: the pancreas V-Net's stages at a 96^3 patch: batch 2 (the pre-train
#: forward), 4 (the teacher's and the concatenated student's) and 16 (the
#: evaluator's chunk)
PANCREAS_SHAPES = [(b, c, c, *vol) for b in (2, 4, 16) for c, vol in (
    (16, (96, 96, 96)), (32, (48, 48, 48)), (64, (24, 24, 24)),
    (128, (12, 12, 12)), (256, (6, 6, 6)))]
ODD_SHAPES = [(2, 16, 16, 6, 5, 7), (1, 32, 64, 4, 4, 3),
              (2, 256, 256, 3, 5, 4), (1, 32, 48, 9, 11, 13),
              (1, 48, 16, 23, 19, 21), (1, 16, 16, 1, 1, 1),
              (1, 64, 32, 200, 3, 2), (3, 128, 64, 7, 7, 5),
              (8, 64, 32, 7, 7, 5), (1, 16, 256, 112, 112, 80)]


@pytest.mark.parametrize("sms", [132, 108])
@pytest.mark.parametrize("shape", STAGE_SHAPES + PANCREAS_SHAPES
                         + ODD_SHAPES)
def test_conv_variant_fits_covers_and_fills(shape, sms):
    """Kernel B's variant is a pure function of shape and SM count; it fits
    the kernel's limits, its boxes cover the volume, its K split divides the
    Ci chunks, and it gives every SM a CTA where the work allows."""
    B, ci, co, X, Y, Z = shape
    v = conv_variant(B, X, Y, Z, ci, co, sms)
    assert v == conv_variant(B, X, Y, Z, ci, co, sms)
    assert v.tiles in conv_tiles(Z) and v.box == (8, 8, v.tiles)
    assert v.smem_bytes(ci) <= CONV_SMEM_LIMIT == 232448
    assert v.bn in (16, 32, 64) and co % v.bn == 0
    assert v.warpgroups in (2, 4) and 2 <= v.stages <= CONV_MAX_STAGES
    # four warpgroups of a CTA have 128 registers a thread: 64 accumulators
    assert v.warpgroups < 4 or v.bn * v.tiles <= 128
    chunks = ci // 16
    assert chunks % v.ksplit == 0
    boxes = B * math.prod(math.ceil(n / t) for n, t in zip((X, Y, Z), v.box))
    groups = math.ceil(boxes / v.warpgroups)
    row = co // v.bn * v.ksplit          # CTAs that one more of grid_x adds
    assert 1 <= v.grid_x <= groups
    assert v.ctas(co) == v.grid_x * row
    # all the groups at once, or within one row of a CTA per SM
    assert v.ctas(co) >= min(groups * row, sms - row + 1)
    # fewer units than SMs: all the parallelism K has is taken
    assert boxes * row >= sms or v.ksplit == chunks
    # weights stay for good only where a CTA walks on to more boxes
    assert not v.persist_w or groups > v.grid_x


@pytest.mark.parametrize("shape,want", [
    ((8, 16, 16, 112, 112, 80), (4, 16, 2, 2, True, 1, 264)),
    ((8, 32, 32, 56, 56, 40), (4, 32, 4, 2, True, 1, 132)),
    ((8, 64, 64, 28, 28, 20), (2, 64, 4, 2, False, 1, 132)),
    ((8, 128, 128, 14, 14, 10), (2, 64, 4, 2, True, 4, 16)),
    ((8, 256, 256, 7, 7, 5), (2, 64, 4, 2, True, 8, 4)),
    ((4, 256, 256, 7, 7, 5), (2, 64, 2, 4, True, 8, 4)),
])
def test_conv_variant_of_the_vnet_stages(shape, want):
    """The variants the H100 sweep (scripts/torch_conv_variants.py) found
    best at the V-Net's stages: four resident warpgroups per SM, weights
    once per CTA where they fit (two CTAs per SM at 16 channels), streamed
    weights at 64, a K split that makes the weights fit at 128 and 256."""
    B, ci, co, X, Y, Z = shape
    assert tuple(conv_variant(B, X, Y, Z, ci, co, 132)) == want


@pytest.mark.parametrize("Z,want", [(80, (4, 2)), (40, (4, 2)), (20, (4, 2)),
                                    (10, (2,)), (5, (2,)), (1, (2,)),
                                    (7, (4, 2)), (13, (2,)), (96, (4, 2))])
def test_conv_tiles_cover_z_with_the_fewest_planes(Z, want):
    assert conv_tiles(Z) == want
    for t in want:
        assert math.ceil(Z / t) * t == min(math.ceil(Z / u) * u
                                           for u in (4, 2))


@pytest.mark.parametrize("tiles", [2, 4])
def test_conv_halo_layout(tiles):
    """The halo of a box in kernel B's shared memory: two k halves of
    (tiles + 2) padded planes of 10 x 10 entries of 16 bytes; 8 voxels along
    y are one 128-byte core matrix, 8 lines along x lie 160 bytes apart, and
    the copies of a warp (z fastest, then the halves) spread over the bank
    groups: planes 2 and halves 1 (mod 8) units apart."""
    half = halo_bytes(tiles) // 2
    plane = (10 * 10 + 6) * 16
    assert half >= (tiles + 2) * plane and half % 16 == 0
    assert (plane // 16) % 8 == 2 and (half // 16) % 8 == 1
    # a warp's quarter of it holds the epilogue's 16 staging rows
    assert (halo_bytes(tiles) // 4) // 16 * 16 >= 16 * (64 * 2 + 16)
