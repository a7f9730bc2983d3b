"""Kernel C's picker (``ops/conv3d.py::dw_variant``) on the CPU: the variant
it returns for the self-train step's stage shapes and for the card-only
tests' odd shapes fits the kernel's registers, shared memory and
workspace, tiles the channels and fills the card; and the wrapper on a CPU
tensor is the plain version whatever variant it is handed."""

import numpy as np
import pytest
import torch

from bcp_tpu_torch.ops import conv3d
from bcp_tpu_torch.ops.conv3d import (DwVariant, conv3x3x3_dw,
                                      conv3x3x3_dw_reference, dw_candidates,
                                      dw_variant)

SMS = 132
#: registers of one SM, and those a thread keeps for addresses, indices
#: and the loop besides its dW sums
SM_REGISTERS = 65536
OTHER_REGISTERS = 24

#: (B, X, Y, Z, Ci, Co): the V-Net's five 3^3 conv stages at batch 4 (the
#: self-train student's backward) and 8, the pancreas stages at batch 2
#: (pre-train) and 4 (self-train), then the card-only tests' shapes
STAGES = [(32, 56, 56, 40), (64, 28, 28, 20), (128, 14, 14, 10),
          (256, 7, 7, 5), (16, 112, 112, 80)]
#: the pancreas V-Net's five stages at a 96^3 patch
PANCREAS_STAGES = [(16, 96, 96, 96), (32, 48, 48, 48), (64, 24, 24, 24),
                   (128, 12, 12, 12), (256, 6, 6, 6)]
SHAPES = ([(B, X, Y, Z, c, c) for B in (4, 8) for c, X, Y, Z in STAGES]
          + [(B, X, Y, Z, c, c) for B in (2, 4)
             for c, X, Y, Z in PANCREAS_STAGES]
          + [(2, 6, 5, 7, 16, 16), (1, 4, 4, 3, 32, 64),
             (2, 3, 5, 4, 256, 256), (1, 9, 11, 13, 32, 48),
             (2, 7, 7, 5, 256, 256), (1, 20, 18, 16, 16, 16),
             (1, 9, 11, 13, 48, 64)])


def _budget(v: DwVariant) -> int:
    """Registers a thread of v's three warpgroups may use at its CTAs per
    SM (allocated in units of 8)."""
    return SM_REGISTERS // (conv3d.DW_THREADS * v.ctas_per_sm()) // 8 * 8


@pytest.mark.parametrize("sms", [SMS, 114])
@pytest.mark.parametrize("shape", SHAPES)
def test_dw_variant_fits_and_fills(shape, sms):
    """The picked variant (and every candidate) divides Ci and Co, fits in
    shared memory and, with its dW sums, in registers; its splits' partial
    sums fit the workspace, no split lacks a box, and the CTAs fill a
    wave (``DW_WAVE`` of one per SM) where the boxes allow it."""
    B, X, Y, Z, ci, co = shape
    found = dw_candidates(B, X, Y, Z, ci, co, sms)
    v = dw_variant(B, X, Y, Z, ci, co, sms)
    assert v in found
    for u in found:
        boxes = conv3d.dw_boxes(B, X, Y, Z, u.tiles)
        assert u.tiles in conv3d.DW_TILES
        assert (u.ci_tile, u.co_group) in conv3d.DW_PAIRS
        assert ci % u.ci_tile == 0 and co % u.co_group == 0
        assert conv3d.DW_MIN_STAGES <= u.stages <= conv3d.CONV_MAX_STAGES
        assert u.smem_bytes() <= conv3d.CONV_SMEM_LIMIT
        per_sm = u.ctas_per_sm()
        assert per_sm >= 1
        assert per_sm * (u.smem_bytes() + conv3d.CONV_CTA_RESERVED) \
            <= conv3d.CONV_SM_SMEM
        assert u.sums() + OTHER_REGISTERS <= _budget(u)
        assert 1 <= u.splits <= boxes and u.splits % u.cluster == 0
        assert u.cluster in (1, conv3d.DW_CLUSTER)
        assert u.splits * 27 * ci * co * 4 <= max(
            conv3d.DW_WORKSPACE_BYTES, 27 * ci * co * 4)
    blocks = (ci // v.ci_tile) * (co // v.co_group)
    boxes = conv3d.dw_boxes(B, X, Y, Z, v.tiles)
    assert (v.splits * blocks >= conv3d.DW_WAVE * min(sms, boxes * blocks)
            or v.splits == boxes)


def test_dw_variant_rules():
    """What the sweep set (``scripts/torch_conv_variants.py --dw``)."""
    pick = {c: dw_variant(4, X, Y, Z, c, c, SMS) for c, X, Y, Z in STAGES}
    assert [tuple(pick[c]) for c in (16, 32, 64, 128, 256)] == [
        (16, 16, 3, 264, 4, 2), (32, 32, 3, 132, 4, 2), (32, 32, 3, 32, 4, 2),
        (32, 32, 3, 8, 4, 2), (32, 32, 4, 2, 3, 2)]
    # 32 does not divide Co or Ci
    assert dw_variant(1, 9, 11, 13, 32, 48, SMS)[:2] == (16, 16)
    assert dw_variant(1, 9, 11, 13, 48, 64, SMS)[:2] == (16, 16)
    # one box: the narrower tiles make the most CTAs, no cluster
    assert tuple(dw_variant(1, 4, 4, 3, 32, 64, SMS)) == (16, 16, 4, 1, 3, 1)
    # 256 channels: (32, 32) in a cluster of two beats (16, 16) unsplit
    assert tuple(dw_variant(2, 3, 5, 4, 256, 256, SMS)) == (
        32, 32, 3, 2, 4, 2)


def test_dw_variant_registers_and_smem_arithmetic():
    """The source note's table: dW sums a thread and a CTA's shared memory
    (the larger of the ring and the epilogue's tile) per (ci tile, co
    group)."""
    want = {(16, 16): (24, 26592, 32064, 27648),
            (32, 32): (96, 53184, 64128, 110592)}
    assert set(want) == set(conv3d.DW_PAIRS)
    for (a, b), (sums, stage3, stage4, tile) in want.items():
        for tiles, stage in ((3, stage3), (4, stage4)):
            for stages in (3, 4):
                v = DwVariant(a, b, stages, 1, tiles)
                assert v.sums() == sums
                assert v.smem_bytes() == max(stages * stage, tile)


@pytest.mark.parametrize("variant", [None, DwVariant(32, 16, 3, 3)])
def test_dw_wrapper_on_cpu_is_the_plain_version(variant):
    """On a CPU tensor the wrapper runs the plain version, with or without
    a variant, and counts no launch."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 32, 5, 4, 3)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(1, 16, 5, 4, 3)).astype(
        np.float32))
    before = conv3x3x3_dw.launches
    got = conv3x3x3_dw(x, dy, variant=variant)
    assert conv3x3x3_dw.launches == before
    assert torch.equal(got, conv3x3x3_dw_reference(x, dy))
    assert got.shape == (16, 32, 3, 3, 3)


@pytest.mark.parametrize("tiles", [3, 4])
def test_dw_boxes_cover_the_volume(tiles):
    """Boxes of 8 x 8 x tiles voxels cover each volume, and the CTAs of
    one (ci tile, co group), walking boxes split, split + splits, ...,
    visit each box exactly once."""
    for B, X, Y, Z, _, _ in SHAPES:
        boxes = conv3d.dw_boxes(B, X, Y, Z, tiles)
        covered = (B * -(-X // 8) * 8 * -(-Y // 8) * 8
                   * -(-Z // tiles) * tiles)
        assert boxes * 64 * tiles == covered >= B * X * Y * Z
        for splits in (1, 7, boxes):
            walked = sorted(b for s in range(splits)
                            for b in range(s, boxes, splits))
            assert walked == list(range(boxes))
